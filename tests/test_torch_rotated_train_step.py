"""The port's rotated phase-2 step against the JAX package, f32 on the CPU
(the rotated MIL stage alone is in test_torch_rotated_mil.py).

- One rotated phase-2 step, then two chained steps, of
  point_teacher_torch.train.rsteps against the JAX build_rotated_train_step
  (compiled once for the module), from the same params, batches and random
  draws (the JAX key chain replayed): every metric, the updated student and
  teacher params and the point caches.
(The training CLI with the SODA-A config is in test_torch_rotated_cli.py.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.core.proposals import FineProposalCfg
from point_teacher_tpu.train.config import OptimCfg, PointTeacherConfig
from point_teacher_tpu.train.optim import make_optimizer
from point_teacher_tpu.train.rsteps import build_rotated_train_step as jax_build_rstep
from point_teacher_tpu.train.state import Batch as JaxBatch
from point_teacher_tpu.train.state import create_train_state as jax_create_state
from point_teacher_tpu.utils.torch_port import load_torch_rotated_detector_into
from point_teacher_torch.core import proposals as tp
from point_teacher_torch.models.rotated_detector import StudentRotatedFCOS
from point_teacher_torch.train import config as tconfig
from point_teacher_torch.train.rsteps import build_rotated_train_step
from point_teacher_torch.train.state import Batch, create_train_state
from point_teacher_torch.train.steps import Draws
from point_teacher_torch.utils.jax_weights import load_jax_params
from test_torch_models import NUM_CLASSES
from test_torch_rotated_models import random_rotated_flax_params
from test_torch_train_step import FEAT_SCALE, assert_trees_and_updates_match

B, IMG, G, NNEG, NUM_IMAGES = 2, 64, 6, 8, 8
FINE = dict(base_ratios=(1.0,), shake_ratio=None, min_scale=0.0, gen_num_neg=NNEG)
EXT = dict(base_ratios=(1.0, 1.2, 0.8), shake_ratio=None, min_scale=4.0)
TOP_K = 3
REG_BIAS = 1.0
STEADY_SEED = 278


def _neg_draws(key, n):
    """The uniforms JAX's negative_proposals draws from the stage key, per image."""
    return np.stack([np.stack([np.asarray(jax.random.uniform(k4, (n,)))
                               for k4 in jax.random.split(k, 4)])
                     for k in jax.random.split(key, B)])


def _rboxes(r, n, lo, hi, wh=(6, 24)):
    cxy = r.uniform(lo, hi, (B, n, 2))
    size = r.uniform(*wh, (B, n, 2))
    ang = r.uniform(-np.pi / 2, np.pi / 2, (B, n, 1))
    return np.concatenate([cxy, size, ang], -1).astype(np.float32)


# --------------------------------------------------------------------------
# the rotated phase-2 step
# --------------------------------------------------------------------------

def _configs():
    common = dict(num_classes=NUM_CLASSES, img_size=IMG, max_gt=G, batch_size=B,
                  num_training_burninstep2=G, top_k=TOP_K)
    jcfg = PointTeacherConfig(fine_proposal_cfg=(FineProposalCfg(**FINE),),
                              fine_proposal_extensive_cfg=(FineProposalCfg(**EXT),),
                              num_training_burninstep1=G,
                              optim=OptimCfg(bn_affine_trainable=True), **common)
    tcfg = tconfig.PointTeacherConfig(
        fine_proposal_cfg=(tp.FineProposalCfg(**FINE),),
        fine_proposal_extensive_cfg=(tp.FineProposalCfg(**EXT),),
        optim=tconfig.OptimCfg(bn_affine_trainable=True), **common)
    return jcfg, tcfg


def _batch(seed):
    r = np.random.RandomState(seed)
    img = r.randint(0, 255, (B, IMG, IMG, 3)).astype(np.float32)
    rboxes = _rboxes(r, G, 10, IMG - 10, wh=(4, 12))
    valid = np.ones((B, G), bool)
    valid[:, -2:] = False
    return dict(image=img, gt_boxes=rboxes,
                gt_labels=r.randint(0, NUM_CLASSES, (B, G)).astype(np.int32),
                gt_valid=valid, image_ids=(np.arange(B) + 2 * seed).astype(np.int32))


def replay_rotated_draws(rng, batch, cfg):
    """The draws JAX's rotated phase-2 step makes from state.rng
    (train/rsteps.py:122, core/raugment.py:155-164, train/rsteps.py:63,
    train/mil.py:235-238), as the port's Draws."""
    _, k_pts, _, k_aug, _, k_mil = jax.random.split(rng, 6)
    point_u = np.asarray(jax.random.uniform(k_pts, batch["gt_boxes"][..., :2].shape))
    dirs, us, angles = [], [], []
    for k in jax.random.split(k_aug, B):
        k1, k2, k3 = jax.random.split(k, 3)
        dirs.append(int(jax.random.randint(k1, (), 0, 4)))
        us.append(float(jax.random.uniform(k2, (), minval=0.8, maxval=1.2)))
        angles.append(float(jax.random.randint(k3, (), 1, 20)))
    neg = []
    key = k_mil
    for stage in range(cfg.num_stages):
        key, sub = jax.random.split(key)
        neg.append(torch.from_numpy(_neg_draws(sub, cfg.fine_proposal_cfg[stage].gen_num_neg)))
    return Draws(torch.from_numpy(point_u.copy()), torch.tensor(dirs),
                 torch.tensor(us, dtype=torch.float32), tuple(neg),
                 torch.tensor(angles, dtype=torch.float32))


def _rescale_factors(rng, steps=2):
    """The rescale factors JAX's rotated strong augmentation draws for both
    images in `steps` steps from `rng` (core/raugment.py:155-164)."""
    scales = []
    for _ in range(steps):
        rng_next, _, _, k_aug, _, _ = jax.random.split(rng, 6)
        for k in jax.random.split(k_aug, B):
            u = jax.random.uniform(jax.random.split(k, 3)[1], (), minval=0.8, maxval=1.2)
            scales.append(float(jnp.round(u * 10.0) / 10.0))
        rng = rng_next
    return scales


def _steady_rng():
    """PRNGKey(STEADY_SEED), the first key whose two steps draw the rescale
    factor 1.0 for both images: at other factors XLA's fused multiply-adds
    round a few warped pixels differently from the port (ROADMAP.md queue 3);
    the rescale itself is held in test_torch_core.py and
    test_torch_rotated_core.py."""
    rng = jax.random.PRNGKey(STEADY_SEED)
    assert all(s == np.float32(1.0) for s in _rescale_factors(rng))
    return rng


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _torch_batch(b):
    return Batch(torch.from_numpy(b["image"]), torch.from_numpy(b["gt_boxes"]),
                 torch.from_numpy(b["gt_labels"]).long(), torch.from_numpy(b["gt_valid"]),
                 torch.from_numpy(b["image_ids"]).long())


@pytest.fixture(scope="module")
def runs():
    """Two chained rotated phase-2 steps of both packages from identical state;
    the JAX step is compiled once."""
    jcfg, tcfg = _configs()
    jmodel, params = random_rotated_flax_params(seed=5, frozen_stages=jcfg.optim.frozen_stages)
    # conditioning, as in test_torch_train_step.py: keep the bag logits out of
    # f32 sigmoid saturation
    agg = params["params"]["neck_agg"]["agg_conv4"]
    agg["kernel"] = agg["kernel"] * FEAT_SCALE
    agg["bias"] = agg["bias"] * FEAT_SCALE
    # the init's regression bias 0.1 predicts boxes of ~1.6 px, whose rotated
    # IoUs with the pseudo boxes are near 0, where -log(IoU) turns last-bit
    # differences (XLA's fused multiply-adds) into percent-level gradients;
    # REG_BIAS predicts boxes of ~16 px instead (ROADMAP.md queue 3)
    params["params"]["bbox_head"]["conv_reg"]["bias"] = np.full(4, REG_BIAS, np.float32)
    tx = make_optimizer(params, jcfg.optim)
    jstate = jax_create_state(params, tx, num_images=NUM_IMAGES, max_gt=G, rng=_steady_rng())
    jstep = jax_build_rstep(jmodel, tx, jcfg)

    port = StudentRotatedFCOS(num_classes=NUM_CLASSES, frozen_stages=tcfg.optim.frozen_stages,
                              dtype=torch.float32)
    load_jax_params(port, params)
    tstate = create_train_state(port, tcfg.optim, NUM_IMAGES, G)
    tstep = build_rotated_train_step(tcfg)

    # both packages start from `params`, the teacher a copy of the student
    start = jax.tree_util.tree_map(np.asarray, params)
    tstart = load_torch_rotated_detector_into(params, _snapshot(tstate.student),
                                                         num_stages=1)
    before = dict(jparams=start, jteacher=start, tparams=tstart, tteacher=tstart)
    out = []
    for seed in (0, 1):
        b = _batch(seed)
        draws = replay_rotated_draws(jstate.rng, b, jcfg)
        jstate, jm = jstep(jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
                           phase1=False)
        tm = tstep(tstate, _torch_batch(b), phase1=False, draws=draws)
        out.append(dict(
            jm={k: float(v) for k, v in jm.items()},
            tm={k: float(v) for k, v in tm.items()},
            jparams=jax.tree_util.tree_map(np.asarray, jstate.params),
            jteacher=jax.tree_util.tree_map(np.asarray, jstate.teacher_params),
            tparams=load_torch_rotated_detector_into(params, _snapshot(tstate.student),
                                                     num_stages=1),
            tteacher=load_torch_rotated_detector_into(params, _snapshot(tstate.teacher),
                                                      num_stages=1),
            jcache=[np.asarray(x) for x in (jstate.origin_points, jstate.refined_points,
                                            jstate.points_cached)],
            tcache=[x.numpy().copy() for x in (tstate.origin_points, tstate.refined_points,
                                               tstate.points_cached)],
            before=before,
        ))
        before = {k: out[-1][k] for k in before}
    return out


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_chained_steps"])
def test_rotated_metrics_match_jax(runs, step):
    jm, tm = runs[step]["jm"], runs[step]["tm"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_chained_steps"])
@pytest.mark.parametrize("which", ["params", "teacher"])
def test_rotated_updated_params_match_jax(runs, step, which):
    assert_trees_and_updates_match(runs[step], which)


def test_rotated_bn_affine_trains(runs):
    """bn_affine_trainable: a layer-3 BN affine moves in both packages, its
    running statistics do not."""
    bn0 = runs[0]["jparams"]["params"]["backbone"]["layer3_block0"]["bn1"]
    bn1 = runs[1]["jparams"]["params"]["backbone"]["layer3_block0"]["bn1"]
    tb1 = runs[1]["tparams"]["params"]["backbone"]["layer3_block0"]["bn1"]
    assert np.abs(bn1["scale"] - bn0["scale"]).max() > 0
    np.testing.assert_array_equal(bn1["var"], bn0["var"])
    np.testing.assert_array_equal(np.asarray(tb1["var"]), bn0["var"])


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_chained_steps"])
def test_rotated_point_caches_match_jax(runs, step):
    r = runs[step]
    for got, want in zip(r["tcache"][:2], r["jcache"][:2]):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(r["tcache"][2], r["jcache"][2])
