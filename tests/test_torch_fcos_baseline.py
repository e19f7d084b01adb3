"""The port's box-supervised FCOS baseline step
(point_teacher_torch.train.fcos_baseline) against the JAX
build_fcos_train_step, at 64 px in f32 on the CPU, from the same random
StudentFCOS weights (carried by utils/jax_weights.py) and the same batch:
every metric at rtol 1e-3, the updated student and EMA teacher leaf by leaf
with the bound the Point-Teacher step tests use. The step draws nothing, so
no random draw is injected. The JAX step compiles once; the port's runs on
one torch thread (ROADMAP.md queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.train.config import PointTeacherConfig as JaxConfig
from point_teacher_tpu.train.fcos_baseline import build_fcos_train_step as jax_build_step
from point_teacher_tpu.train.optim import make_optimizer
from point_teacher_tpu.train.state import Batch as JaxBatch
from point_teacher_tpu.train.state import create_train_state as jax_create_state
from point_teacher_torch.models.detector import StudentFCOS
from point_teacher_torch.train import config as tconfig
from point_teacher_torch.train.fcos_baseline import build_fcos_train_step
from point_teacher_torch.train.state import Batch, create_train_state
from point_teacher_torch.utils.jax_weights import load_jax_params, port_arrays
from test_torch_models import NUM_CLASSES, random_flax_params

B, IMG, G, NUM_IMAGES = 2, 64, 6, 4


def batch_arrays(seed, g=G, img=IMG, num_classes=NUM_CLASSES):
    """B images of random pixels with 4-16 px boxes, the last two GT slots padding."""
    r = np.random.RandomState(seed)
    cxy = r.uniform(10, img - 10, (B, g, 2))
    wh = r.uniform(4, 16, (B, g, 2))
    valid = np.ones((B, g), bool)
    valid[:, -2:] = False
    return dict(image=r.randint(0, 255, (B, img, img, 3)).astype(np.float32),
                gt_boxes=np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32),
                gt_labels=r.randint(0, num_classes, (B, g)).astype(np.int32),
                gt_valid=valid, image_ids=np.arange(B, dtype=np.int32))


def torch_batch(b):
    return Batch(torch.from_numpy(b["image"]), torch.from_numpy(b["gt_boxes"]),
                 torch.from_numpy(b["gt_labels"]).long(), torch.from_numpy(b["gt_valid"]),
                 torch.from_numpy(b["image_ids"]).long())


def snapshot(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def assert_updates_match(want0, want, got0, got):
    """Trees in the port's naming (numpy): every leaf after the step at rtol
    1e-3, and its update (after less before, in each package) within 2e-2 of
    the leaf's largest JAX update plus 2 ulps of its largest value and
    1e-12: the rule of test_torch_train_step.assert_trees_and_updates_match."""
    assert want.keys() == got.keys() == want0.keys() == got0.keys()
    for k in want:
        w, g = np.asarray(want[k]), got[k]
        if not (np.abs(g - w) <= 1e-5 + 1e-3 * np.abs(w)).all():
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=k)
        dw, dg = w - np.asarray(want0[k]), g - got0[k]
        tol = 2e-2 * float(np.abs(dw).max()) + 2 * float(np.spacing(np.abs(w).max())) + 1e-12
        err = float(np.abs(dg - dw).max())
        assert err <= tol, f"update of {k}: max |port - JAX| {err:.3e} > {tol:.3e}"


def one_thread(fn):
    """fn() with torch on one thread, the count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run():
    common = dict(num_classes=NUM_CLASSES, img_size=IMG, max_gt=G, batch_size=B)
    jcfg, tcfg = JaxConfig(**common), tconfig.PointTeacherConfig(**common)
    jmodel, params = random_flax_params(seed=7, frozen_stages=jcfg.optim.frozen_stages)
    tx = make_optimizer(params, jcfg.optim)
    b = batch_arrays(3)
    jstate = jax_create_state(params, tx, num_images=NUM_IMAGES, max_gt=G,
                              rng=jax.random.PRNGKey(0))
    jstate, jm = jax_build_step(jmodel, tx, jcfg)(
        jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}))

    def port():
        model = StudentFCOS(num_classes=NUM_CLASSES, frozen_stages=tcfg.optim.frozen_stages,
                            dtype=torch.float32)
        load_jax_params(model, params)
        state = create_train_state(model, tcfg.optim, NUM_IMAGES, G)
        before = snapshot(state.student)
        tm = build_fcos_train_step(tcfg)(state, torch_batch(b))
        return state, before, tm

    state, before, tm = one_thread(port)
    return dict(jm={k: float(v) for k, v in jm.items()}, tm={k: float(v) for k, v in tm.items()},
                j0=port_arrays(params), jparams=port_arrays(jstate.params),
                jteacher=port_arrays(jstate.teacher_params), t0=before,
                tparams=snapshot(state.student), tteacher=snapshot(state.teacher),
                step=(int(jstate.step), state.step))


def test_fcos_metrics_match_jax(run):
    assert set(run["tm"]) == set(run["jm"]) == {"loss_cls", "loss_bbox", "loss_centerness",
                                                "total_loss"}
    for k, want in run["jm"].items():
        np.testing.assert_allclose(run["tm"][k], want, rtol=1e-3, atol=1e-6, err_msg=k)
    assert run["step"] == (1, 1)


@pytest.mark.parametrize("which", ["params", "teacher"])
def test_fcos_updated_params_match_jax(run, which):
    assert_updates_match(run["j0"], run[f"j{which}"], run["t0"], run[f"t{which}"])
