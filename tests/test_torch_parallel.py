"""Data parallelism of the port (point_teacher_torch.parallel) on the CPU: a
world of 2 gloo ranks spawned through parallel/launch.py, each rank on one
image of a global batch of 2 (64 px, 6 GT slots), against one process on
the whole batch (no process group), from the same weights and draws:
- HBB Point-Teacher: a phase-2 step, a phase-1 step with the gate open, and
  a phase-1 then a phase-2 step where rank 1's image has no valid GT (the
  gate closed on both ranks, every count 0 on rank 1); the rotated step
  (phase 2); one step of each baseline (fcos, rfla_fcos);
- every metric key, the updated student (and after two steps the teacher)
  and the point caches equal the one-process step's within rtol 1e-5 /
  atol 1e-6 (only the order of summation differs); student, teacher,
  optimizer state, caches and metrics are bit-equal across the ranks, and
  the caches hold both ranks' images;
- the anchor against JAX: the world's phase-2 HBB step against
  make_sharded_train_step over a mesh of 2 CPU devices (compiled once),
  with JAX's weights and draws, at test_torch_train_step.py's tolerance;
- TrainLoader's rows of the two ranks, stacked, equal one process's
  batches bit for bit; a batch of 3 on a world of 2 raises ValueError;
- a rank that raises ends the world with its error, and a world that hangs
  is killed at the launcher's timeout.
The world runs while this process builds the references (one torch
thread, as the ranks). JAX is imported inside the fixture only: the ranks
import this module and must not import it."""
import hashlib
import os
import shutil
import time

import numpy as np
import pytest
import torch
from PIL import Image

from point_teacher_torch.core import proposals as tp
from point_teacher_torch.data.loader import TrainLoader
from point_teacher_torch.models.detector import StudentFCOS
from point_teacher_torch.models.rfla_fcos_head import RFLAFCOS
from point_teacher_torch.models.rotated_detector import StudentRotatedFCOS
from point_teacher_torch.parallel import dist, launch
from point_teacher_torch.train import config as tconfig
from point_teacher_torch.train.fcos_baseline import build_fcos_train_step
from point_teacher_torch.train.rfla_baseline import build_rfla_train_step
from point_teacher_torch.train.rsteps import build_rotated_train_step
from point_teacher_torch.train.state import Batch, create_train_state
from point_teacher_torch.train.steps import build_train_step, make_draws, synthesize

B, IMG, G, NNEG, NUM_IMAGES, WORLD = 2, 64, 6, 8, 16, 2
NUM_CLASSES = 4
FINE = dict(base_ratios=(1.0,), shake_ratio=None, min_scale=0.0, gen_num_neg=NNEG)
EXT = dict(base_ratios=(1.0, 1.2, 0.8), shake_ratio=None, min_scale=4.0)
# test_torch_synthetic.py's shape priors for 64 px images
SMALL_SHAPE_LIST = ((5, 5, 0.5, 0.5), (2.5, 5, 0.5, 0.5), (7.5, 20, 0.5, 0.5),
                    (5, 12.5, 0.5, 0.5), (7.5, 30, 0.5, 0.5), (7.5, 10, 0.5, 0.5))
FEAT_SCALE, REG_BIAS = 1e-2, 1.0   # the step tests' conditioning of a random init
RTOL, ATOL = 1e-5, 1e-6


def hbb_config(rotated=False):
    extra = dict(top_k=3, optim=tconfig.OptimCfg(bn_affine_trainable=True)) if rotated else {}
    return tconfig.PointTeacherConfig(
        fine_proposal_cfg=(tp.FineProposalCfg(**FINE),),
        fine_proposal_extensive_cfg=(tp.FineProposalCfg(**EXT),),
        num_classes=NUM_CLASSES, img_size=IMG, max_gt=G, batch_size=B,
        num_training_burninstep1=G, num_training_burninstep2=G,
        shape_list=SMALL_SHAPE_LIST, **extra)


def batch_arrays(seed, rotated=False, empty_image=None):
    """A global batch of B images (test_torch_train_step.py's); the last two
    GT slots are padding, `empty_image` has no valid GT."""
    r = np.random.RandomState(seed)
    img = r.randint(0, 255, (B, IMG, IMG, 3)).astype(np.float32)
    cxy = r.uniform(10, IMG - 10, (B, G, 2))
    wh = r.uniform(4, 12, (B, G, 2))
    if rotated:
        ang = r.uniform(-np.pi / 2, np.pi / 2, (B, G, 1))
        boxes = np.concatenate([cxy, wh, ang], -1).astype(np.float32)
    else:
        boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    valid = np.ones((B, G), bool)
    valid[:, -2:] = False
    if empty_image is not None:
        valid[empty_image] = False
    return dict(image=img, gt_boxes=boxes,
                gt_labels=r.randint(0, NUM_CLASSES, (B, G)).astype(np.int32),
                gt_valid=valid, image_ids=(np.arange(B) + 2 * seed).astype(np.int32))


def rows_batch(a):
    """This rank's rows of a global numpy batch, as the port's Batch."""
    rows = dist.rank_rows(B)
    return Batch(torch.from_numpy(a["image"][rows]), torch.from_numpy(a["gt_boxes"][rows]),
                 torch.from_numpy(a["gt_labels"][rows]).long(),
                 torch.from_numpy(a["gt_valid"][rows]), torch.from_numpy(a["image_ids"][rows]).long())


def build(kind, state_dict=None):
    """(model, config, step) of a scenario kind; the weights `state_dict`,
    or the seeded init, conditioned as the step tests condition it."""
    cfg = hbb_config(rotated=kind == "rotated")
    if kind == "rfla":
        model = RFLAFCOS(num_classes=NUM_CLASSES, frozen_stages=cfg.optim.frozen_stages,
                         dtype=torch.float32, seed=3)
        return model, cfg, build_rfla_train_step(cfg)
    model_cls = StudentRotatedFCOS if kind == "rotated" else StudentFCOS
    model = model_cls(num_classes=NUM_CLASSES, frozen_stages=cfg.optim.frozen_stages,
                      dtype=torch.float32, seed=3)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        with torch.no_grad():
            conv = model.neck_agg.lateral_convs[4].conv
            conv.weight.mul_(FEAT_SCALE)
            conv.bias.mul_(FEAT_SCALE)
            if kind == "rotated":
                model.bbox_head.conv_reg.bias.fill_(REG_BIAS)
    step = {"hbb": build_train_step, "rotated": build_rotated_train_step,
            "fcos": build_fcos_train_step}[kind](cfg)
    return model, cfg, step


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def load_anchor(path):
    """The JAX anchor's weights and plan, which the parent writes to `path`
    while the world runs."""
    deadline = time.monotonic() + 120
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


def run_scenario(sc, save_to=None):
    """Run scenario `sc` (kind, [(phase1, batch, draws), ...]; or kind and
    the JAX anchor's file) in this process (the world's rank, or one
    process without a group). Returns per step the metrics and the phase-1
    gate; the state's digests; the caches. With `save_to` the student (and
    the teacher after a chain) goes to that file; without it, in the
    result."""
    kind, plan = sc
    state_dict = None
    if isinstance(plan, str):
        anchor = load_anchor(plan)
        state_dict, plan = anchor["model"], anchor["plan"]
    model, cfg, step = build(kind, state_dict)
    state = create_train_state(model, cfg.optim, NUM_IMAGES, G)
    steps = []
    for phase1, arrays, draws in plan:
        batch = rows_batch(arrays)
        gate = None
        if phase1:
            gate = bool(synthesize(dist.take_rows(draws.syn), batch, cfg, kind == "rotated")[3])
        kw = {} if draws is None else dict(draws=draws)
        metrics = step(state, batch, phase1=phase1, **kw)
        steps.append(dict(metrics={k: float(v) for k, v in metrics.items()}, gate=gate))
    caches = [t.clone() for t in (state.origin_points, state.refined_points,
                                  state.points_cached)]
    trace = [t for k in ("base", "bias") for t in state.optimizer.trace[k]]
    params = {"student": dict(state.student.state_dict())}
    if len(plan) > 1:
        params["teacher"] = dict(state.teacher.state_dict())
    out = dict(steps=steps, caches=caches, digests=dict(
        student=digest(state.student.state_dict().values()),
        teacher=digest(state.teacher.state_dict().values()),
        optimizer=digest(trace), caches=digest(caches)))
    if save_to:
        torch.save(params, save_to)
    else:
        out["params"] = params
    return out


class PngDataset:
    """The TrainLoader interface over PNG files: images of random pixels and
    4-16 px boxes."""

    def __init__(self, root, n=6):
        self.root, self.n = root, n
        r = np.random.RandomState(0)
        self.anns = []
        for i in range(n):
            Image.fromarray(r.randint(0, 255, (40 + 4 * i, 56, 3)).astype(np.uint8)).save(
                os.path.join(root, f"{i}.png"))
            xy = r.uniform(2, 30, (3, 2))
            self.anns.append(dict(boxes=np.concatenate([xy, xy + r.uniform(4, 16, (3, 2))], -1)
                                  .astype(np.float32), labels=r.randint(0, 4, 3)))

    def __len__(self):
        return self.n

    def get_ann(self, i):
        return self.anns[i]

    def image_path(self, i):
        return os.path.join(self.root, f"{i}.png")


def loader_batches(ds):
    return list(TrainLoader(ds, batch_size=2, max_gt=4, canvas=32, seed=0).epoch())


def world_main(out_dir, scenarios, ds):
    """Each rank: every scenario (rank 0 saves the states), the loader's
    rows, the ValueError of a batch of 3; results to out_dir/rank{r}.pt."""
    r = dist.rank()
    results = {name: run_scenario(sc, os.path.join(out_dir, f"{name}.pt") if r == 0 else None)
               for name, sc in scenarios.items()}
    try:
        dist.rank_rows(3)
        results["odd_batch"] = None
    except ValueError as e:
        results["odd_batch"] = str(e)
    results["loader"] = loader_batches(ds)
    results["world"] = dist.world()
    torch.save(results, os.path.join(out_dir, f"rank{r}.pt"))


def raise_on_rank1():
    if dist.rank() == 1:
        raise RuntimeError("rank 1 fails before the all-reduce")
    torch.distributed.all_reduce(torch.ones(1))


def sleep_forever():
    time.sleep(3600)


# --------------------------------------------------------------------------
# the world and its references
# --------------------------------------------------------------------------

def jax_draws():
    """test_torch_train_step.py's batch, its key (the rescale drawn 1.0) and
    the draws JAX's step makes from it, as the port's Draws."""
    from test_torch_train_step import _batch, _configs, _steady_rng, replay_draws

    rng, arrays = _steady_rng(), _batch(0)
    return rng, arrays, replay_draws(rng, arrays, _configs()[0])


def jax_anchor(rng, arrays, draws, path, start):
    """JAX's phase-2 HBB step on a mesh of 2 CPU devices from
    test_torch_train_step.py's random weights (conditioned as there), which
    go to the file `path` in the port's layout with the port's plan (the
    batch and JAX's draws). The step runs in start(run) (run() -> the JAX
    result for assert_trees_and_updates_match) while the file is written;
    returns what start returns."""
    import jax
    import jax.numpy as jnp
    from point_teacher_tpu.parallel.mesh import make_mesh, make_sharded_train_step
    from point_teacher_tpu.train.optim import make_optimizer
    from point_teacher_tpu.train.state import Batch as JaxBatch
    from point_teacher_tpu.train.state import create_train_state as jax_create_state
    from point_teacher_torch.utils.jax_weights import load_jax_params
    from test_torch_models import random_flax_params
    from test_torch_train_step import _configs

    jcfg, _ = _configs()
    jmodel, params = random_flax_params(seed=5, frozen_stages=jcfg.optim.frozen_stages)
    agg = params["params"]["neck_agg"]["agg_conv4"]
    agg["kernel"] = agg["kernel"] * np.float32(FEAT_SCALE)
    agg["bias"] = agg["bias"] * np.float32(FEAT_SCALE)
    tx = make_optimizer(params, jcfg.optim)
    jstate = jax_create_state(params, tx, num_images=NUM_IMAGES, max_gt=G, rng=rng)
    step = make_sharded_train_step(jmodel, tx, jcfg, make_mesh(jax.devices()[:2]))

    def run():
        new, jm = step(jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}), False)
        return dict(jm={k: float(v) for k, v in jm.items()},
                    jparams=jax.tree_util.tree_map(np.asarray, new.params),
                    start=jax.tree_util.tree_map(np.asarray, params), template=params)

    started = start(run)
    port = StudentFCOS(num_classes=NUM_CLASSES, frozen_stages=jcfg.optim.frozen_stages,
                       dtype=torch.float32)
    load_jax_params(port, params)
    torch.save(dict(model=port.state_dict(), plan=[(False, arrays, draws)]), path + ".tmp")
    os.replace(path + ".tmp", path)
    return started


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the world on the scenarios (the JAX anchor's last, once its
    file is written) and the one-process references (in a thread), then,
    while they run, the JAX anchor (its step in a thread); join. The ranks'
    results, the references and the JAX result."""
    import threading

    tmp = str(tmp_path_factory.mktemp("world"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        anchor = os.path.join(tmp, "anchor.pt")
        cfg = hbb_config()
        gen = torch.Generator().manual_seed(11)
        p1 = make_draws(gen, cfg, B, "cpu", phase1=True)
        p1_empty = make_draws(gen, cfg, B, "cpu", phase1=True)
        p2_empty = make_draws(gen, cfg, B, "cpu")
        rot = make_draws(gen, cfg, B, "cpu")
        empty = batch_arrays(3, empty_image=1)
        scenarios = {
            "hbb_phase1": ("hbb", [(True, batch_arrays(1), p1)]),
            "hbb_rank1_empty": ("hbb", [(True, empty, p1_empty), (False, empty, p2_empty)]),
            "rotated_phase2": ("rotated", [(False, batch_arrays(4, rotated=True), rot)]),
            "fcos": ("fcos", [(False, batch_arrays(5), None)]),
            "rfla": ("rfla", [(False, batch_arrays(6), None)]),
            "hbb_phase2": ("hbb", anchor),
        }
        ds_root = os.path.join(tmp, "pngs")
        os.makedirs(ds_root)
        ds = PngDataset(ds_root)
        out_dir = os.path.join(tmp, "out")
        os.makedirs(out_dir)
        done = {}

        def in_thread(name, fn, *args, **kw):
            def target():
                try:
                    done[name] = fn(*args, **kw)
                except BaseException as e:  # noqa: BLE001 - raised in the fixture
                    done[name] = e
            th = threading.Thread(target=target)
            th.start()
            return th

        world_th = in_thread("world", launch.spawn, world_main, WORLD, out_dir, scenarios, ds,
                             timeout=240)
        refs_th = in_thread("refs", lambda: {name: run_scenario(sc)
                                             for name, sc in scenarios.items()})
        jax_th = jax_anchor(*jax_draws(), anchor, lambda run: in_thread("jax", run))
        ref_loader = loader_batches(ds)
        for th in (refs_th, jax_th, world_th):
            th.join()
        for v in done.values():
            if isinstance(v, BaseException):
                raise v
        refs = done["refs"]
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(WORLD)]
        print(f"world of {WORLD}, references and JAX step: {time.perf_counter() - t0:.1f} s")
    finally:
        torch.set_num_threads(threads)
    plans = {name: load_anchor(anchor)["plan"] if name == "hbb_phase2" else plan
             for name, (_, plan) in scenarios.items()}
    yield dict(tmp=out_dir, anchor=anchor, refs=refs, ranks=ranks, plans=plans,
               ref_loader=ref_loader, jax=done["jax"])
    # the weights and states of ResNet-50 detectors (~2 GB in all)
    shutil.rmtree(tmp, ignore_errors=True)


SCENARIOS = ["hbb_phase2", "hbb_phase1", "hbb_rank1_empty", "rotated_phase2", "fcos", "rfla"]


def _world_params(world, name):
    return torch.load(os.path.join(world["tmp"], f"{name}.pt"), weights_only=True)


@pytest.mark.parametrize("name", SCENARIOS)
def test_world_metrics_equal_one_process(world, name):
    for got, want in zip(world["ranks"][0][name]["steps"], world["refs"][name]["steps"]):
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)
        assert got["gate"] == want["gate"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_world_state_equals_one_process(world, name):
    got, want = _world_params(world, name), world["refs"][name]["params"]
    assert got.keys() == want.keys()
    for which in got:
        assert got[which].keys() == want[which].keys()
        for k, v in want[which].items():
            g = got[which][k]
            if not bool(((g - v).abs() <= ATOL + RTOL * v.abs()).all()):  # allclose's rule, fast
                np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=RTOL, atol=ATOL,
                                           err_msg=f"{which}.{k}")
    for g, w in zip(world["ranks"][0][name]["caches"], world["refs"][name]["caches"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", SCENARIOS)
def test_ranks_are_bit_equal(world, name):
    r0, r1 = (r[name] for r in world["ranks"])
    assert r0["digests"] == r1["digests"]
    assert [s["metrics"] for s in r0["steps"]] == [s["metrics"] for s in r1["steps"]]
    # the caches hold both ranks' images (the baselines write none)
    ids = sorted({int(i) for _, a, _ in world["plans"][name] for i in a["image_ids"]})
    want = [] if name in ("fcos", "rfla") else ids
    assert torch.nonzero(r0["caches"][2]).flatten().tolist() == want


def test_gate_open_and_closed_on_both_ranks(world):
    for r in world["ranks"]:
        assert r["hbb_phase1"]["steps"][0]["gate"] is True
        assert r["hbb_rank1_empty"]["steps"][0]["gate"] is False
    assert world["refs"]["hbb_rank1_empty"]["steps"][0]["gate"] is False


def test_world_phase2_step_matches_jax_sharded_step(world):
    """The JAX anchor: metrics at rtol 1e-3, the updated student and teacher
    by test_torch_train_step.py's rule."""
    from point_teacher_tpu.utils.torch_port import load_torch_detector_into
    from test_torch_train_step import assert_trees_and_updates_match

    j = world["jax"]
    tm = world["ranks"][0]["hbb_phase2"]["steps"][0]["metrics"]
    assert set(tm) == set(j["jm"])
    for k, v in j["jm"].items():
        np.testing.assert_allclose(tm[k], v, rtol=1e-3, atol=1e-6, err_msg=k)
    got = _world_params(world, "hbb_phase2")["student"]
    start = load_anchor(world["anchor"])["model"]
    tparams = load_torch_detector_into(j["template"], {k: v.clone() for k, v in got.items()})
    tstart = load_torch_detector_into(j["template"], start)
    r = dict(jparams=j["jparams"], tparams=tparams,
             before=dict(jparams=j["start"], tparams=tstart))
    assert_trees_and_updates_match(r, "params")


def test_loader_rows_stack_to_one_process_batches(world):
    ref = world["ref_loader"]
    r0, r1 = (r["loader"] for r in world["ranks"])
    assert len(ref) == len(r0) == len(r1) == 3
    for want, a, b in zip(ref, r0, r1):
        for k in want:
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), want[k], err_msg=k)


def test_batch_the_world_does_not_divide_raises(world):
    for r in world["ranks"]:
        assert r["world"] == WORLD
        assert "does not split over 2 ranks" in r["odd_batch"]


def test_helpers_are_the_identity_without_a_group():
    x = torch.tensor([1.5, 2.0])
    assert not dist.active() and dist.world() == 1 and dist.rank() == 0
    assert dist.global_sum(x) is x
    assert dist.gather_rows(x)[0] is x
    assert dist.take_rows(x) is x
    assert dist.rank_rows(3) == slice(0, 3)
    assert dist.sum_losses({"loss": x}) == {"loss": x}


def test_a_rank_that_raises_ends_the_world():
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="rank 1 fails before the all-reduce"):
        launch.spawn(raise_on_rank1, WORLD, timeout=60)
    assert time.perf_counter() - t0 < 60


def test_a_hung_world_is_killed_at_the_timeout():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        launch.spawn(sleep_forever, WORLD, timeout=2)
    assert time.perf_counter() - t0 < 30
