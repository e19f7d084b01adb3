"""One phase-2 Point-Teacher step, then two chained steps, of the port
(point_teacher_torch.train.steps) against the JAX build_train_step: the
same params, batches and random draws (the JAX key chain replayed), in f32
on the CPU. Every metric key, the updated student and teacher params and the
point caches are compared. Also runs the port's training CLI on the CPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.core.proposals import FineProposalCfg
from point_teacher_tpu.train.config import PointTeacherConfig
from point_teacher_tpu.train.optim import make_optimizer
from point_teacher_tpu.train.state import Batch as JaxBatch
from point_teacher_tpu.train.state import create_train_state as jax_create_state
from point_teacher_tpu.train.steps import build_train_step as jax_build_step
from point_teacher_tpu.utils.torch_port import load_torch_detector_into
from point_teacher_torch.core.proposals import FineProposalCfg as TFineProposalCfg
from point_teacher_torch.models.detector import StudentFCOS
from point_teacher_torch.train import config as tconfig
from point_teacher_torch.train.state import Batch, create_train_state
from point_teacher_torch.train.steps import Draws, build_train_step
from point_teacher_torch.utils.jax_weights import load_jax_params
from test_torch_models import NUM_CLASSES, random_flax_params

B, IMG, G, NNEG, NUM_IMAGES = 2, 64, 6, 8, 8
FEAT_SCALE = np.float32(1e-2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs():
    fine = dict(base_ratios=(1.0,), shake_ratio=None, min_scale=0.0, gen_num_neg=NNEG)
    ext = dict(base_ratios=(1.0, 1.2, 0.8), shake_ratio=None, min_scale=4.0)
    common = dict(num_classes=NUM_CLASSES, img_size=IMG, max_gt=G, batch_size=B,
                  num_training_burninstep2=G)
    jcfg = PointTeacherConfig(fine_proposal_cfg=(FineProposalCfg(**fine),),
                              fine_proposal_extensive_cfg=(FineProposalCfg(**ext),),
                              num_training_burninstep1=G, **common)
    tcfg = tconfig.PointTeacherConfig(fine_proposal_cfg=(TFineProposalCfg(**fine),),
                                      fine_proposal_extensive_cfg=(TFineProposalCfg(**ext),),
                                      **common)
    return jcfg, tcfg


def _batch(seed):
    r = np.random.RandomState(seed)
    img = r.randint(0, 255, (B, IMG, IMG, 3)).astype(np.float32)
    cxy = r.uniform(10, IMG - 10, (B, G, 2))
    wh = r.uniform(4, 12, (B, G, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    valid = np.ones((B, G), bool)
    valid[:, -2:] = False
    return dict(image=img, gt_boxes=boxes,
                gt_labels=r.randint(0, NUM_CLASSES, (B, G)).astype(np.int32),
                gt_valid=valid, image_ids=(np.arange(B) + 2 * seed).astype(np.int32))


def replay_draws(rng, batch, cfg):
    """The draws JAX's phase-2 step makes from state.rng (train/steps.py:202,
    core/augment.py:134-138, train/steps.py:96, train/mil.py:523,
    core/proposals.py:150-154), as the port's Draws."""
    _, k_pts, _, k_aug, _, k_mil = jax.random.split(rng, 6)
    point_u = np.asarray(jax.random.uniform(k_pts, batch["gt_boxes"][..., :2].shape))
    dirs, us = [], []
    for k in jax.random.split(k_aug, B):
        k1, k2 = jax.random.split(k)
        dirs.append(int(jax.random.randint(k1, (), 0, 4)))
        us.append(float(jax.random.uniform(k2, (), minval=0.8, maxval=1.2)))
    neg = []
    key = k_mil
    for stage in range(cfg.num_stages):
        key, sub = jax.random.split(key)
        n = cfg.fine_proposal_cfg[stage].gen_num_neg
        neg.append(torch.from_numpy(np.stack([
            np.stack([np.asarray(jax.random.uniform(k4, (n,))) for k4 in jax.random.split(k, 4)])
            for k in jax.random.split(sub, B)])))
    return Draws(torch.from_numpy(point_u.copy()), torch.tensor(dirs),
                 torch.tensor(us, dtype=torch.float32), tuple(neg))


def _steady_rng():
    """The first PRNG key whose two steps draw the rescale factor 1.0 for both
    images. At other factors the bilinear warp rounds a few pixels that sit
    within an ulp of .5 differently in the two packages (ROADMAP.md queue 3),
    and those pixels move a few weight gradients by up to 2%; flips still
    vary, and the rescale itself is held in test_torch_core.py."""
    for seed in range(10000):
        rng = jax.random.PRNGKey(seed)
        scales = []
        for _ in range(2):
            rng_next, _, _, k_aug, _, _ = jax.random.split(rng, 6)
            for k in jax.random.split(k_aug, B):
                u = jax.random.uniform(jax.random.split(k)[1], (), minval=0.8, maxval=1.2)
                scales.append(float(jnp.round(u * 10.0) / 10.0))
            rng = rng_next
        if all(s == np.float32(1.0) for s in scales):
            return jax.random.PRNGKey(seed)
    raise AssertionError("no key found")


def assert_trees_and_updates_match(r, which):
    """Every leaf of the updated tree `which` ("params" or "teacher") at rtol
    1e-3, and its update (the leaf after the step less the leaf before it, in
    each package) within 2e-2 of the leaf's largest JAX update: a zeroed or
    wrong update on any leaf fails, though it moves the values by less than
    their tolerance. f32 rounding of the two values bounds how far an update
    is known: 2 units in the last place of the leaf's largest value (the EMA
    moves a teacher by about that), and 1e-12 for leaves whose gradient is 0
    up to rounding."""
    def leaves(tree):
        return dict(jax.tree_util.tree_leaves_with_path(tree))

    want, got = leaves(r[f"j{which}"]), leaves(r[f"t{which}"])
    want0, got0 = leaves(r["before"][f"j{which}"]), leaves(r["before"][f"t{which}"])
    assert want.keys() == got.keys() == want0.keys() == got0.keys()
    for k in want:
        name = jax.tree_util.keystr(k)
        w, g = np.asarray(want[k]), np.asarray(got[k])
        if not (np.abs(g - w) <= 1e-5 + 1e-3 * np.abs(w)).all():  # assert_allclose's rule, fast
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5, err_msg=name)
        dw, dg = w - np.asarray(want0[k]), g - np.asarray(got0[k])
        tol = 2e-2 * float(np.abs(dw).max()) + 2 * float(np.spacing(np.abs(w).max())) + 1e-12
        err = float(np.abs(dg - dw).max())
        assert err <= tol, f"update of {name}: max |port - JAX| {err:.3e} > {tol:.3e}"


def _snapshot(module):
    """A copy of the state dict: the converter's numpy arrays would otherwise
    alias the parameters that the next step updates in place."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _torch_batch(b):
    return Batch(torch.from_numpy(b["image"]), torch.from_numpy(b["gt_boxes"]),
                 torch.from_numpy(b["gt_labels"]).long(), torch.from_numpy(b["gt_valid"]),
                 torch.from_numpy(b["image_ids"]).long())


@pytest.fixture(scope="module")
def runs():
    """Two chained phase-2 steps of both packages from identical state. The
    port's step runs on one CPU thread, the thread count restored after:
    with several, torch sums the convolutions' weight gradients in an order
    that varies from run to run (ROADMAP.md queue 3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _two_steps()
    finally:
        torch.set_num_threads(threads)


def _two_steps():
    jcfg, tcfg = _configs()
    jmodel, params = random_flax_params(seed=5, frozen_stages=jcfg.optim.frozen_stages)
    # Conditioning (ROADMAP.md queue 3): the random init on raw 0-255 pixels
    # gives PSAGG features near 1e3 and bag logits far into f32 sigmoid
    # saturation, where gfocal's log(1 - p + eps) turns last-bit differences
    # of the logits into 0.3% of loss_mil_bags. Scaling the last PSAGG conv
    # keeps the logits in the range where f32 agrees.
    agg = params["params"]["neck_agg"]["agg_conv4"]
    agg["kernel"] = agg["kernel"] * FEAT_SCALE
    agg["bias"] = agg["bias"] * FEAT_SCALE
    tx = make_optimizer(params, jcfg.optim)
    jstate = jax_create_state(params, tx, num_images=NUM_IMAGES, max_gt=G, rng=_steady_rng())
    jstep = jax_build_step(jmodel, tx, jcfg)

    port = StudentFCOS(num_classes=NUM_CLASSES, frozen_stages=tcfg.optim.frozen_stages,
                       dtype=torch.float32)
    load_jax_params(port, params)
    tstate = create_train_state(port, tcfg.optim, NUM_IMAGES, G)
    tstep = build_train_step(tcfg)

    # both packages start from `params`, the teacher a copy of the student
    start = jax.tree_util.tree_map(np.asarray, params)
    tstart = load_torch_detector_into(params, _snapshot(tstate.student))
    before = dict(jparams=start, jteacher=start, tparams=tstart, tteacher=tstart)
    out = []
    for seed in (0, 1):
        b = _batch(seed)
        draws = replay_draws(jstate.rng, b, jcfg)
        jstate, jm = jstep(jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
                           phase1=False)
        tm = tstep(tstate, _torch_batch(b), phase1=False, draws=draws)
        out.append(dict(
            jm={k: float(v) for k, v in jm.items()},
            tm={k: float(v) for k, v in tm.items()},
            jparams=jax.tree_util.tree_map(np.asarray, jstate.params),
            jteacher=jax.tree_util.tree_map(np.asarray, jstate.teacher_params),
            tparams=load_torch_detector_into(params, _snapshot(tstate.student)),
            tteacher=load_torch_detector_into(params, _snapshot(tstate.teacher)),
            jcache=[np.asarray(x) for x in (jstate.origin_points, jstate.refined_points,
                                            jstate.points_cached)],
            tcache=[x.numpy().copy() for x in (tstate.origin_points, tstate.refined_points,
                                               tstate.points_cached)],
            before=before,
        ))
        before = {k: out[-1][k] for k in before}
    return out


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_chained_steps"])
def test_metrics_match_jax(runs, step):
    jm, tm = runs[step]["jm"], runs[step]["tm"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_chained_steps"])
@pytest.mark.parametrize("which", ["params", "teacher"])
def test_updated_params_match_jax(runs, step, which):
    assert_trees_and_updates_match(runs[step], which)


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_chained_steps"])
def test_point_caches_match_jax(runs, step):
    r = runs[step]
    for got, want in zip(r["tcache"][:2], r["jcache"][:2]):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(r["tcache"][2], r["jcache"][2])


def test_phase1_raises_not_implemented():
    """A phase-1 step raises before it touches the state."""
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="next slice"):
        build_train_step(tcfg)(None, _torch_batch(_batch(0)), phase1=True)


def test_cli_runs_on_cpu():
    cmd = [sys.executable, "-m", "point_teacher_torch.tools.train",
           os.path.join(REPO, "configs/point_teacher/aitodv2_point_teacher_0.py"),
           "--cpu", "--synthetic-data", "4", "--max-steps", "1", "--cfg-options",
           "pt.img_size=64", "pt.max_gt=6", "pt.burn_in_step=-1"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json
    records = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(records) == 1 and records[0]["step"] == 1
    for k in ("loss_cls", "loss_bbox", "loss_centerness", "total_loss"):
        assert np.isfinite(records[0][k]), k
