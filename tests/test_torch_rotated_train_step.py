"""The port's rotated step against the JAX package, f32 on the CPU (the
rotated MIL stage alone is in test_torch_rotated_mil.py).

point_teacher_torch.train.rsteps against the JAX build_rotated_train_step
(built once for the module, so each phase compiles once), from the same
params, batches and random draws (the JAX key chain replayed):
- phase 2: one step, then two chained steps;
- phase 1: one step with the gate open, then a chain across the phase
  switch (that phase-1 step, then a phase-2 step), and one step with the
  gate closed (an image without a valid GT keeps no synthetic box);
every metric, the updated student and teacher params, the point caches and
the gate.
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
from point_teacher_torch.train.steps import Draws, synthesize
from point_teacher_torch.utils.jax_weights import load_jax_params
from test_torch_models import NUM_CLASSES
from test_torch_rotated_models import random_rotated_flax_params
from test_torch_synthetic import SMALL_SHAPE_LIST, replay_syn_draws
from test_torch_train_step import PHASE1_IDS, FEAT_SCALE, assert_trees_and_updates_match
from torch_port_env import port_test_module  # noqa: F401 (autouse)

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
                  num_training_burninstep1=G, num_training_burninstep2=G, top_k=TOP_K,
                  shape_list=SMALL_SHAPE_LIST)
    jcfg = PointTeacherConfig(fine_proposal_cfg=(FineProposalCfg(**FINE),),
                              fine_proposal_extensive_cfg=(FineProposalCfg(**EXT),),
                              optim=OptimCfg(bn_affine_trainable=True), **common)
    tcfg = tconfig.PointTeacherConfig(
        fine_proposal_cfg=(tp.FineProposalCfg(**FINE),),
        fine_proposal_extensive_cfg=(tp.FineProposalCfg(**EXT),),
        optim=tconfig.OptimCfg(bn_affine_trainable=True), **common)
    return jcfg, tcfg


def _batch(seed, empty_image=None):
    """A batch of B images; `empty_image` has no valid GT."""
    r = np.random.RandomState(seed)
    img = r.randint(0, 255, (B, IMG, IMG, 3)).astype(np.float32)
    rboxes = _rboxes(r, G, 10, IMG - 10, wh=(4, 12))
    valid = np.ones((B, G), bool)
    valid[:, -2:] = False
    if empty_image is not None:
        valid[empty_image] = False
    return dict(image=img, gt_boxes=rboxes,
                gt_labels=r.randint(0, NUM_CLASSES, (B, G)).astype(np.int32),
                gt_valid=valid, image_ids=(np.arange(B) + 2 * seed).astype(np.int32))


def replay_rotated_draws(rng, batch, cfg, phase1=False):
    """The draws JAX's rotated step makes from state.rng
    (train/rsteps.py:122, core/raugment.py:155-164, train/rsteps.py:63,
    train/mil.py:235-238, and in phase 1 core/synthetic.py), as the port's
    Draws."""
    _, k_pts, k_syn, k_aug, _, k_mil = jax.random.split(rng, 6)
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
    syn = replay_syn_draws(k_syn, B, cfg.max_gt, len(cfg.shape_list)) if phase1 else None
    return Draws(torch.from_numpy(point_u.copy()), torch.tensor(dirs),
                 torch.tensor(us, dtype=torch.float32), tuple(neg),
                 torch.tensor(angles, dtype=torch.float32), syn=syn)


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
def chains():
    """The rotated step chains of both packages, each from identical state:
    two phase-2 steps; a phase-1 step then a phase-2 step; a phase-1 step
    whose gate is closed. The JAX step is built once, so each phase compiles
    once. The port's step runs on one CPU thread: with several, torch sums
    the convolutions' weight gradients in an order that varies from run to
    run (up to 1.5e-8 on a conv kernel after two steps, while XLA's results
    are bitwise the same), enough to move the closest update check across
    its bound in some runs (ROADMAP.md queue 3). The thread count is
    restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jcfg, tcfg = _configs()
        jmodel, params = random_rotated_flax_params(seed=5,
                                                    frozen_stages=jcfg.optim.frozen_stages)
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
        jstep = jax_build_rstep(jmodel, tx, jcfg)
        run = lambda plan: _run_chain(jcfg, tcfg, params, tx, jstep, plan)
        return dict(phase2=run([(False, _batch(0)), (False, _batch(1))]),
                    phase1=run([(True, _batch(0)), (False, _batch(1))]),
                    gate_closed=run([(True, _batch(2, empty_image=1))]))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(chains):
    return chains["phase2"]


@pytest.fixture(scope="module")
def phase1_runs(chains):
    """[phase-1 step (gate open), then a phase-2 step, phase-1 step (gate closed)]."""
    return chains["phase1"] + chains["gate_closed"]


def _run_chain(jcfg, tcfg, params, tx, jstep, plan):
    """Steps (phase1, batch) of both packages from `params`, the teacher a
    copy of the student; per step the metrics, the trees after it and before
    it, the point caches and each package's phase-1 gate."""
    jstate = jax_create_state(params, tx, num_images=NUM_IMAGES, max_gt=G, rng=_steady_rng())
    port = StudentRotatedFCOS(num_classes=NUM_CLASSES, frozen_stages=tcfg.optim.frozen_stages,
                              dtype=torch.float32)
    load_jax_params(port, params)
    tstate = create_train_state(port, tcfg.optim, NUM_IMAGES, G)
    tstep = build_rotated_train_step(tcfg)

    start = jax.tree_util.tree_map(np.asarray, params)
    tstart = load_torch_rotated_detector_into(params, _snapshot(tstate.student), num_stages=1)
    before = dict(jparams=start, jteacher=start, tparams=tstart, tteacher=tstart)
    out = []
    for phase1, b in plan:
        draws = replay_rotated_draws(jstate.rng, b, jcfg, phase1)
        fresh = not np.asarray(jstate.points_cached)[b["image_ids"]].any()
        jstate, jm = jstep(jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
                           phase1=phase1)
        tm = tstep(tstate, _torch_batch(b), phase1=phase1, draws=draws)
        gates = _gates(jstate, b, tcfg, draws, fresh) if phase1 else None
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
            before=before, gates=gates,
        ))
        before = {k: out[-1][k] for k in before}
    return out


def _gates(jstate, b, tcfg, draws, fresh):
    """Each package's phase-1 gate (every image kept a synthetic box). JAX's
    is read from its cache: on images seen for the first time the step
    writes the refined points, which start at 0, only where the gate is
    open (lamda 1: the sampled points, never 0)."""
    assert fresh, "the gate is read on images seen for the first time"
    jgate = bool((np.asarray(jstate.refined_points)[b["image_ids"]] != 0).all())
    tgate = synthesize(draws.syn, _torch_batch(b), tcfg, rotated=True)[3]
    return jgate, bool(tgate)


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


@pytest.mark.parametrize("step", [0, 1, 2], ids=PHASE1_IDS)
def test_rotated_phase1_metrics_match_jax(phase1_runs, step):
    test_rotated_metrics_match_jax(phase1_runs, step)


@pytest.mark.parametrize("step", [0, 1, 2], ids=PHASE1_IDS)
@pytest.mark.parametrize("which", ["params", "teacher"])
def test_rotated_phase1_updated_params_match_jax(phase1_runs, step, which):
    assert_trees_and_updates_match(phase1_runs[step], which)


@pytest.mark.parametrize("step", [0, 1, 2], ids=PHASE1_IDS)
def test_rotated_phase1_point_caches_match_jax(phase1_runs, step):
    test_rotated_point_caches_match_jax(phase1_runs, step)


@pytest.mark.parametrize("step,want", [(0, True), (2, False)], ids=["open", "closed"])
def test_rotated_phase1_gate_matches_jax(phase1_runs, step, want):
    """Both packages' gates agree, and the cases cover it open and closed;
    closed, the refined points stay unwritten."""
    r = phase1_runs[step]
    assert r["gates"] == (want, want)
    if not want:
        ids = np.arange(B) + 4  # _batch(2)'s image ids
        np.testing.assert_array_equal(r["tcache"][1][ids], 0.0)
        assert r["tcache"][2][ids].all()
