"""The port's RFLA-FCOS baseline against the JAX package's, on the CPU in f32:
- ops/tiny_metrics.py (center_distance2, wasserstein_similarity and the
  three kl modes) at rtol 1e-5 (XLA's and torch's log may differ in the
  last bit; the KL divides by squared widths of a few pixels), and below
  the smallest normal f32 in absolute terms (XLA flushes subnormals);
- core/rfla.py hierarchical_assign and models/rfla_fcos_head.py
  level_points_and_rfields / rfla_targets: the assignment and labels equal,
  the points, receptive fields and (l, t, r, b) targets bit for bit;
- the RFLAFCOS forward from weights carried by utils/jax_weights.py, every
  level's maps at 1e-4 (test_torch_models' bound);
- one RFLA step (train/rfla_baseline.py) from those weights and one batch,
  metrics at rtol 1e-3, the updated student and teacher with the step
  tests' bound;
- build_rfla_inference_fn from the same per-level head outputs (a stub
  model returns them on both sides, so JAX compiles the decode and NMS
  only), held as matched sets with the rules of test_torch_inference.py
  (2-ulp score ties).
The JAX functions compile once each; the port runs on one torch thread."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu import inference as jinf
from point_teacher_tpu.core import rfla as jrfla
from point_teacher_tpu.models import rfla_fcos_head as jhead
from point_teacher_tpu.ops import tiny_metrics as jtm
from point_teacher_tpu.train.config import InferenceCfg as JaxInferCfg
from point_teacher_tpu.train.config import PointTeacherConfig as JaxConfig
from point_teacher_tpu.train.optim import make_optimizer
from point_teacher_tpu.train.rfla_baseline import build_rfla_train_step as jax_build_step
from point_teacher_tpu.train.state import Batch as JaxBatch
from point_teacher_tpu.train.state import create_train_state as jax_create_state
from point_teacher_torch import inference as pinf
from point_teacher_torch.core import rfla as prfla
from point_teacher_torch.models import rfla_fcos_head as phead
from point_teacher_torch.ops import tiny_metrics as ptm
from point_teacher_torch.train import config as tconfig
from point_teacher_torch.train.rfla_baseline import build_rfla_train_step
from point_teacher_torch.train.state import create_train_state
from point_teacher_torch.utils.jax_weights import load_jax_params, port_arrays
from test_torch_fcos_baseline import (assert_updates_match, batch_arrays, one_thread,
                                      snapshot, torch_batch)
from test_torch_inference import ULP2, match_dets
from torch_port_env import port_test_module  # noqa: F401 (autouse)

NUM_CLASSES, IMG, G, NUM_IMAGES = 4, 64, 6, 4
_TRUNC_STD = 0.87962566103423978


def random_rfla_flax_params(seed=0, frozen_stages=1):
    """A random flax RFLAFCOS tree drawn with numpy as the flax init draws it
    (lecun-normal kernels truncated at 2 sigma, zero biases, the head's
    normal(0.01) convs and prior bias), with random FrozenBN statistics,
    random GroupNorm affines and per-level scales near 1. The structure
    comes from jax.eval_shape of the model's init, which compiles nothing."""
    model = jhead.RFLAFCOS(num_classes=NUM_CLASSES, frozen_stages=frozen_stages,
                           dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, IMG, IMG, 3))))
    r = np.random.RandomState(seed)

    def truncated(shape):
        x = r.randn(*shape)
        while (bad := np.abs(x) > 2).any():
            x[bad] = r.randn(int(bad.sum()))
        return x

    def draw(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        shape, leaf_name, module = leaf.shape, names[-1], names[-2]
        head = "bbox_head" in names
        if any("bn" in n for n in names[:-1]):
            x = {"var": lambda: r.uniform(0.5, 2.0, shape),
                 "scale": lambda: r.uniform(0.5, 1.5, shape)}.get(
                     leaf_name, lambda: r.randn(*shape) * 0.1)()
        elif "_gn" in module:
            x = r.uniform(0.5, 1.5, shape) if leaf_name == "scale" else r.randn(*shape) * 0.1
        elif leaf_name == "scales":
            x = r.uniform(0.9, 1.1, shape)
        elif leaf_name == "kernel" and head:
            x = r.randn(*shape) * 0.01
        elif leaf_name == "kernel":
            x = truncated(shape) * np.sqrt(1.0 / np.prod(shape[:-1])) / _TRUNC_STD
        else:
            x = np.full(shape, -np.log(99.0) if module == "conv_cls" else 0.0)
        return np.asarray(x, np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def _boxes(r, n, lo=0.0, hi=64.0, side=(1.0, 24.0)):
    c = r.uniform(lo, hi, (n, 2))
    wh = r.uniform(*side, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


# --------------------------------------------------------------------------
# tiny metrics, the assigner, the targets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fn,kw", [("center_distance2", {}), ("wasserstein_similarity", {}),
                                   ("kl_similarity", {"mode": "kl"}),
                                   ("kl_similarity", {"mode": "kl_10"}),
                                   ("kl_similarity", {"mode": "exp_kl"})],
                         ids=["center_distance2", "wd", "kl", "kl_10", "exp_kl"])
def test_tiny_metrics_match_jax(fn, kw):
    r = np.random.RandomState(0)
    gt, anchors = _boxes(r, 7, side=(1.0, 6.0)), _boxes(r, 300)
    want = np.asarray(getattr(jtm, fn)(jnp.asarray(gt), jnp.asarray(anchors), **kw))
    got = getattr(ptm, fn)(torch.from_numpy(gt), torch.from_numpy(anchors), **kw).numpy()
    assert got.shape == want.shape == (7, 300)
    # exp_kl underflows into subnormals, which XLA's CPU code flushes to 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=np.finfo(np.float32).tiny)


@pytest.fixture(scope="module")
def level_geometry():
    jp, jr, jsizes, jstr = jhead.level_points_and_rfields(IMG, jhead.RFLAFCOS.strides)
    pp, pr, psizes, pstr = phead.level_points_and_rfields(IMG)
    assert jsizes == psizes == [8, 4, 2, 1, 1]
    for a, b in ((pp, jp), (pr, jr), (pstr, jstr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return pp, pr


@pytest.mark.parametrize("cfg", [jrfla.HieAssignerCfg(),
                                 jrfla.HieAssignerCfg(assign_metric="wd", topk=(3, 2)),
                                 jrfla.HieAssignerCfg(ratio=1.5, inside=True),
                                 jrfla.HieAssignerCfg(assign_metric="kl_10", topk=(1, 1))],
                         ids=["kl_default", "wd", "ratio_inside", "kl_10"])
def test_hierarchical_assign_matches_jax(level_geometry, cfg):
    """The receptive fields of a 64 px image against 8 GTs (the last two
    padding, one GT duplicated so that a later GT overwrites an earlier
    one's claims)."""
    _, rfields = level_geometry
    r = np.random.RandomState(1)
    gt = _boxes(r, 8, side=(2.0, 20.0))
    gt[5] = gt[1]
    valid = np.array([True] * 6 + [False] * 2)
    want = np.asarray(jrfla.hierarchical_assign(jnp.asarray(rfields.numpy()), jnp.asarray(gt),
                                                jnp.asarray(valid), cfg))
    got = prfla.hierarchical_assign(rfields, torch.from_numpy(gt), torch.from_numpy(valid),
                                    prfla.HieAssignerCfg(*cfg))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 0 and not np.isin(want, [1, 6, 7]).any()


def test_rfla_targets_match_jax(level_geometry):
    points, rfields = level_geometry
    r = np.random.RandomState(2)
    gt = _boxes(r, G, side=(3.0, 30.0))
    labels = r.randint(0, NUM_CLASSES, G).astype(np.int32)
    valid = np.array([True] * (G - 1) + [False])
    jl, jt = jhead.rfla_targets(jnp.asarray(points.numpy()), jnp.asarray(rfields.numpy()),
                                jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid),
                                NUM_CLASSES)
    pl, ptg = phead.rfla_targets(points, rfields, torch.from_numpy(gt),
                                 torch.from_numpy(labels), torch.from_numpy(valid), NUM_CLASSES)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ptg.numpy(), np.asarray(jt))
    assert (pl.numpy() < NUM_CLASSES).sum() >= G - 1


def test_gen_trf_matches_jax():
    assert phead.gen_trf() == jhead.gen_trf() == (35, 91, 267, 427, 555, 811)


# --------------------------------------------------------------------------
# the model and one step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    common = dict(num_classes=NUM_CLASSES, img_size=IMG, max_gt=G, batch_size=B)
    jcfg, tcfg = JaxConfig(**common), tconfig.PointTeacherConfig(**common)
    jmodel, params = random_rfla_flax_params(seed=4, frozen_stages=jcfg.optim.frozen_stages)

    def build():
        model = phead.RFLAFCOS(num_classes=NUM_CLASSES, frozen_stages=tcfg.optim.frozen_stages,
                               dtype=torch.float32)
        return load_jax_params(model, params)

    return jcfg, tcfg, jmodel, params, one_thread(build)


B = 2


def test_rfla_forward_matches_jax(pair):
    _, _, jmodel, params, model = pair
    img = np.random.RandomState(5).uniform(0, 255, (B, IMG, IMG, 3)).astype(np.float32)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(img))
    with torch.no_grad():
        got = one_thread(lambda: model(torch.from_numpy(img)))
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            b = np.asarray(b)
            assert a.shape == b.shape, lvl
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(b).max()), err_msg=str(lvl))


@pytest.fixture(scope="module")
def step_run(pair):
    jcfg, tcfg, jmodel, params, _ = pair
    tx = make_optimizer(params, jcfg.optim)
    b = batch_arrays(6, num_classes=NUM_CLASSES)
    jstate = jax_create_state(params, tx, num_images=NUM_IMAGES, max_gt=G,
                              rng=jax.random.PRNGKey(0))
    jstate, jm = jax_build_step(jmodel, tx, jcfg)(
        jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}))

    def port():
        model = phead.RFLAFCOS(num_classes=NUM_CLASSES, frozen_stages=tcfg.optim.frozen_stages,
                               dtype=torch.float32)
        load_jax_params(model, params)
        state = create_train_state(model, tcfg.optim, NUM_IMAGES, G)
        before = snapshot(state.student)
        return state, before, build_rfla_train_step(tcfg)(state, torch_batch(b))

    state, before, tm = one_thread(port)
    return dict(jm={k: float(v) for k, v in jm.items()}, tm={k: float(v) for k, v in tm.items()},
                j0=port_arrays(params), jparams=port_arrays(jstate.params),
                jteacher=port_arrays(jstate.teacher_params), t0=before,
                tparams=snapshot(state.student), tteacher=snapshot(state.teacher))


def test_rfla_step_metrics_match_jax(step_run):
    jm, tm = step_run["jm"], step_run["tm"]
    assert set(tm) == set(jm) == {"loss_cls", "loss_bbox", "loss_centerness", "total_loss",
                                  "num_pos"}
    assert tm["num_pos"] == jm["num_pos"] > 0
    for k, want in jm.items():
        np.testing.assert_allclose(tm[k], want, rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("which", ["params", "teacher"])
def test_rfla_updated_params_match_jax(step_run, which):
    assert_updates_match(step_run["j0"], step_run[f"j{which}"], step_run["t0"],
                         step_run[f"t{which}"])


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------

# 128 px: 341 points over the 5 levels; nms_pre 100 a level keeps 185 of
# them (P3 cut from 256), 1,480 class-expanded candidates an image
INFER_IMG, INFER_C = 128, 8


def _level_outputs(seed):
    """Random per-level NHWC head outputs of a batch of B 128 px images:
    logits of which most pass score_thr, distances of 2-20 px."""
    r = np.random.RandomState(seed)
    outs = []
    for s in phead.STRIDES:
        n = -(-INFER_IMG // s)
        outs.append(((r.randn(B, n, n, INFER_C) * 1.5 - 1.0).astype(np.float32),
                     r.uniform(2, 20, (B, n, n, 4)).astype(np.float32),
                     r.randn(B, n, n, 1).astype(np.float32)))
    return outs


class _Stub:
    """A model whose forward returns the head outputs it is handed."""
    strides = phead.STRIDES

    def apply(self, params, images):
        return params


def test_rfla_inference_matches_jax():
    """Two batches through one compile of JAX's function: images filling
    the canvas, and images whose resized extent is smaller (the clamp); the
    port's canvas default (img_shapes None) equals the first bit for bit."""
    outs = _level_outputs(8)
    cfg = dict(nms_pre=100, score_thr=0.05, nms_iou=0.5, max_per_img=300)
    sf = np.asarray([[1.0, 1.0, 1.0, 1.0], [0.8, 0.75, 0.8, 0.75]], np.float32)
    imgs = np.zeros((B, INFER_IMG, INFER_IMG, 3), np.float32)
    jfn = jinf.build_rfla_inference_fn(_Stub(), JaxInferCfg(**cfg), INFER_IMG)
    pfn = pinf.build_rfla_inference_fn(tconfig.InferenceCfg(**cfg), INFER_IMG)
    touts = [tuple(torch.from_numpy(x) for x in lvl) for lvl in outs]

    def port(shp):
        return one_thread(lambda: pfn(lambda _images: touts, torch.from_numpy(imgs),
                                      torch.from_numpy(sf),
                                      None if shp is None else torch.from_numpy(shp)))

    groups = 0
    for shapes in (((128, 128), (128, 128)), ((100, 128), (128, 90))):
        shp = np.asarray(shapes, np.float32)
        want, got = jfn(outs, imgs, sf, shp), port(shp)
        for i in range(B):
            n = int(np.asarray(want[2][i]).sum())
            assert n == 300   # the output buffer fills
            groups += match_dets([x[i].numpy() for x in got], [np.asarray(x[i]) for x in want],
                                 rtol=1e-6, tie=ULP2)
        if shapes[0] == (128, 128):
            for a, b in zip(port(None), got):
                assert torch.equal(a, b)
    print(f"rfla inference: score tie groups {groups}")
