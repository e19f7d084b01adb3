"""The port's supersteps (point_teacher_torch/train/superstep.py: the
build_*_train_step_scan functions, `--steps-per-dispatch K`) on the CPU, and
the host syncs taken off the step so that a card can capture it as a CUDA
graph.

- The rotated, fcos and rfla_fcos scans against K single steps of the port
  from one state (those steps are held against JAX in
  test_torch_rotated_train_step.py, test_torch_fcos_baseline.py and
  test_torch_rfla.py); the single steps run as a graph replay does: draws
  made before the step, learning rates written before it. The HBB scan is
  held against JAX's chained steps in test_torch_train_step.py, whose
  module fixture already runs them.
- No step of any trainer makes a host-syncing op (a read of a value, a
  data-dependent shape, a tensor made from host data) outside the plain
  versions that only the CPU runs.
- The optimizer's tensor learning rate against its former Python float.
- The training CLI with --steps-per-dispatch 3 against 1: the same steps,
  metrics, log and checkpoint.
The port runs on one CPU thread at 64 px."""
import contextlib
import copy
import io
import json
import os
import shutil
import tempfile
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from point_teacher_torch.config_io import apply_overrides, load_config
from point_teacher_torch.tools import train as cli
from point_teacher_torch.train.config import OptimCfg
from point_teacher_torch.train.optim import PointTeacherSGD, lr_at
from point_teacher_torch.train.state import create_train_state
from point_teacher_torch.train.steps import make_draws
from point_teacher_torch.train.superstep import StepGraph, check_capturable
from point_teacher_torch.utils.device import copy_from_host
from torch_port_env import port_test_module  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "rotated": "configs/point_teacher/sodaa_point_teacher_1x.py",
    "hbb": "configs/point_teacher/aitodv2_point_teacher_0.py",
    "fcos": "configs/baselines/aitodv2_fcos_r50_1x.py",
    "rfla_fcos": "configs/baselines/aitodv2_rfla_fcos_1x.py",
}
SMALL = ["pt.img_size=32", "pt.max_gt=4"]
NEG = 8  # negatives an image (the configs draw 200)


def _small(cfg):
    """The config at NEG negatives an image in every MIL stage."""
    pt = cfg["pt"]
    cfg["pt"] = pt._replace(fine_proposal_cfg=tuple(
        f._replace(gen_num_neg=NEG) for f in pt.fine_proposal_cfg))
    return cfg



# --------------------------------------------------------------------------
# host syncs
# --------------------------------------------------------------------------

ATEN = torch.ops.aten
SYNCING = {ATEN._local_scalar_dense.default, ATEN.nonzero.default, ATEN.masked_select.default,
           ATEN.equal.default, ATEN.is_nonzero.default, ATEN.allclose.default,
           ATEN.repeat_interleave.Tensor}
BOOL_INDEXED = {ATEN.index.Tensor, ATEN.index_put_.default, ATEN.index_put.default,
                ATEN._index_put_impl_.default}
# the plain versions the CPU runs where a card launches a kernel, and the
# first use of a constant table (utils/device.py: on a card an asynchronous
# copy from pinned memory, made once, at a warm-up step before any capture)
ALLOWED = ("finish_fixpoint_plain", "roi_align_rotated_plain", "roi_align_plain", "constant")


class SyncFinder(TorchDispatchMode):
    """Records every op that would make the host wait for a card, or copy
    host data to it: a value read (item, bool, tolist), a data-dependent
    shape (nonzero, masked_select, unique, a boolean index), and a tensor
    made from host data (torch.tensor, a list index). Ops inside the
    ALLOWED functions are let through."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        bad = func in SYNCING or "unique" in name or name.startswith("aten.lift_fresh")
        if func in BOOL_INDEXED:
            bad = bad or any(i is not None and i.dtype == torch.bool for i in args[1])
        if bad:
            stack = traceback.extract_stack()
            if not any(f.name in ALLOWED for f in stack):
                where = [f"{f.filename.rsplit('point_teacher_torch/', 1)[-1]}:{f.lineno}"
                         for f in stack if "point_teacher_torch" in f.filename]
                self.found.append((name, where[-3:]))
        return func(*args, **kwargs)


def _finder_sees_syncs():
    """The finder flags a value read, a boolean index and a tensor from host data."""
    x = torch.arange(5.0)
    with SyncFinder() as f:
        bool(x.any())
        _ = x[x > 2]
        _ = torch.tensor([1.0, 2.0])
    return [n for n, _ in f.found] == ["aten._local_scalar_dense.default", "aten.index.Tensor",
                                       "aten.lift_fresh.default"]


# --------------------------------------------------------------------------
# supersteps against K single steps
# --------------------------------------------------------------------------

def _setup(trainer, extra=()):
    cfg = _small(apply_overrides(load_config(os.path.join(REPO, CONFIGS[trainer])),
                                 SMALL + list(extra)))
    pt, state, step = cli.setup(cfg, 8, 0, torch.device("cpu"))
    data = cli.synthetic_dataset(8, pt, 0, rotated=bool(cfg.get("rotated")))
    return cfg, pt, state, step, [cli.to_batch(a, "cpu") for a in data(pt.batch_size)]


def _draws(cfg, pt, state, phase1):
    """One step's draws as the superstep makes them (None for the baselines)."""
    if cfg.get("trainer", "point_teacher") != "point_teacher":
        return None
    dcfg = pt if cfg.get("rotated") else pt.normalized()
    return make_draws(state.generator, dcfg, pt.batch_size, "cpu", phase1)


def _replayed_step(cfg, pt, state, step, batch, phase1):
    """A single step run as a graph replay runs it: the draws made before
    it, the learning rates written before it, under the SyncFinder."""
    draws = _draws(cfg, pt, state, phase1)
    opt = state.optimizer
    copy_from_host(opt.neg_lr, opt.neg_lr_values(opt.count))
    opt.external_lr = True
    try:
        with SyncFinder() as finder:
            m = step(state, batch, phase1=phase1, **({} if draws is None else {"draws": draws}))
    finally:
        opt.external_lr = False
    return m, finder.found


def _state_parts(state):
    parts = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    parts.update({f"teacher.{k}": v for k, v in state.teacher.state_dict().items()})
    parts.update({f"trace.{g}.{i}": t for g in ("base", "bias")
                  for i, t in enumerate(state.optimizer.trace[g])})
    parts.update(origin=state.origin_points, refined=state.refined_points,
                 cached=state.points_cached, generator=state.generator.get_state())
    return parts


# trainer -> [(phase1, K), ...]: each scan against K single steps, in turn;
# the HBB scan is held against JAX in test_torch_train_step.py, so here its
# single steps run alone (K single steps, no scan), under the SyncFinder
PLANS = {
    "rotated": [(True, 1), (False, 2)],
    "hbb": [(True, 1), (False, 1)],
    "fcos": [(False, 2)],
    "rfla_fcos": [(False, 2)],
}
NO_SCAN = {"hbb"}


@pytest.fixture(scope="module", params=list(PLANS))
def scan_runs(request):
    """Two states from one seed: one through the trainer's scan, one through
    the same number of single steps run as a replay runs them."""
    trainer, plan = request.param, PLANS[request.param]
    cfg, pt, state_b, step, batches = _setup(trainer, ["pt.burn_in_step=0"])
    state_a = None if trainer in NO_SCAN else create_train_state(
        copy.deepcopy(state_b.student), pt.optim, 8, pt.max_gt)
    scan = cli.build_step(cfg, pt, scan=True)
    at, scans, singles, found = 0, [], [], []
    for phase1, k in plan:
        group = batches[at:at + k]
        at += k
        if state_a is not None:
            scans.append({key: v.tolist()
                          for key, v in scan(state_a, group, phase1=phase1).items()})
        for b in group:
            m, f = _replayed_step(cfg, pt, state_b, step, b, phase1)
            singles.append({key: float(v) for key, v in m.items()})
            found += f
    return dict(a=state_a, b=state_b, scans=scans, singles=singles, found=found, plan=plan)


def test_scan_equals_single_steps_without_host_syncs(scan_runs):
    """Each scan returns [K] per metric, equal to the single steps' values;
    the states after them are equal (student, teacher, momentum, point
    caches, generator, counters); no op of any step makes the host wait or
    copies host data (the plain versions of the CUDA kernels aside), in
    either phase. On the CPU the scan is the plain loop: a step graph needs
    a card."""
    a, b = scan_runs["a"], scan_runs["b"]
    n = sum(k for _, k in scan_runs["plan"])
    assert (b.step, b.optimizer.count) == (n, n)
    if a is not None:
        flat = []
        for (_, k), ms in zip(scan_runs["plan"], scan_runs["scans"]):
            assert all(len(v) == k for v in ms.values())
            flat += [{key: v[i] for key, v in ms.items()} for i in range(k)]
        assert flat == scan_runs["singles"]
        assert (a.step, a.optimizer.count) == (n, n)
        pa, pb = _state_parts(a), _state_parts(b)
        assert pa.keys() == pb.keys()
        assert [k for k in pa if not torch.equal(pa[k], pb[k])] == []
    assert _finder_sees_syncs()
    assert scan_runs["found"] == []
    with pytest.raises(ValueError, match="CUDA device"):
        check_capturable("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        StepGraph(lambda *args, **kw: {}, b, False, torch.device("cpu"))


# --------------------------------------------------------------------------
# the optimizer's learning rate
# --------------------------------------------------------------------------

@torch.no_grad()
def _old_step(opt):
    """PointTeacherSGD.step as it was: the learning rate a Python float alpha
    (p.add_(trace, alpha=-lr): one fused multiply-add on the CPU)."""
    grads = [p.grad for p in opt.params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < opt.cfg.grad_clip_norm
    denom = torch.where(keep, torch.ones_like(norm), norm)
    mult = torch.where(keep, 1.0, opt.cfg.grad_clip_norm).to(norm.dtype)
    for label, wd, mult_lr in (("base", opt.cfg.weight_decay, 1.0),
                               ("bias", 0.0, opt.cfg.bias_lr_mult)):
        params = opt.groups[label]
        g = [p.grad / denom * mult for p in params]
        if wd:
            torch._foreach_add_(g, params, alpha=wd)
        trace = opt.trace[label]
        torch._foreach_mul_(trace, opt.cfg.momentum)
        torch._foreach_add_(trace, g)
        torch._foreach_add_(params, trace, alpha=-lr_at(opt.cfg, opt.count, mult_lr))
    opt.count += 1


def test_optimizer_tensor_lr_matches_python_float():
    """Three updates across the warmup's end and a decay step, with the
    learning rates from the device tensor (p + (-lr) x trace as one fused
    multiply-add, torch._foreach_addcmul_) against the Python float alpha of
    before: bit for bit, the gradients clipped in the first update."""
    cfg = OptimCfg(warmup_iters=1, iters_per_epoch=1, step_epochs=(2,), frozen_stages=-1)
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Linear(32, 8))
    twin = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Linear(32, 8))
    twin.load_state_dict(model.state_dict())
    new, old = PointTeacherSGD(model, cfg), PointTeacherSGD(twin, cfg)
    norms = []
    for it in range(3):
        g = torch.Generator().manual_seed(it)
        for p, q in zip(model.parameters(), twin.parameters()):
            p.grad = torch.randn(p.shape, generator=g) * (30 if it == 0 else 1)
            q.grad = p.grad.clone()
        norms.append(float(new.step()))
        _old_step(old)
        np.testing.assert_array_equal(
            new.neg_lr.numpy(), -np.float32([lr_at(cfg, it), lr_at(cfg, it, cfg.bias_lr_mult)]))
        for p, q in zip(model.parameters(), twin.parameters()):
            assert torch.equal(p, q)
    assert new.count == old.count == 3
    assert norms[0] > cfg.grad_clip_norm > norms[2]
    assert len({lr_at(cfg, i) for i in range(3)}) == 3


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli_run(k, work_dir):
    """tools.train's flags and loop (main less its device choice, with
    NEG negatives): (per-step records, train_log.jsonl, the checkpoint)."""
    args = cli.parse_args([os.path.join(REPO, CONFIGS["hbb"]), "--cpu", "--synthetic-data", "8",
                           "--max-steps", "4", "--work-dir", work_dir,
                           "--steps-per-dispatch", str(k),
                           "--cfg-options", *SMALL, "pt.burn_in_step=1"])
    cfg = _small(apply_overrides(load_config(args.config), args.cfg_options))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.train(cfg, args.work_dir, args.seed, torch.device("cpu"), args.synthetic_data,
                  args.max_steps, args.resume_from, args.ckpt_interval, args.val_interval,
                  args.steps_per_dispatch)
    records = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        log = f.read()
    ckpt = torch.load(os.path.join(work_dir, "epoch_1.pth"), weights_only=False, mmap=True)
    return records, log, ckpt


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix: tree}


@pytest.fixture(scope="module")
def cli_pair():
    """The CLI at --steps-per-dispatch 1 and 3 over steps 0-3 of 8 images
    (one epoch of 4 steps), burn_in_step 1: K=3 runs the group [0, 1] (cut at
    the phase switch) and [2, 3] (cut at --max-steps)."""
    dirs = [tempfile.mkdtemp() for _ in range(2)]
    try:
        return [_cli_run(k, d) for k, d in zip((1, 3), dirs)]
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def test_cli_steps_per_dispatch_matches_one(cli_pair):
    (rec1, log1, ck1), (rec3, log3, ck3) = cli_pair
    assert [r["step"] for r in rec1] == [r["step"] for r in rec3] == [1, 2, 3, 4]
    drop = lambda rs: [{k: v for k, v in r.items() if k != "step_ms"} for r in rs]
    assert drop(rec1) == drop(rec3)
    # the groups' step_ms is the group's wall over its size: equal in a group
    assert rec3[0]["step_ms"] == rec3[1]["step_ms"] and rec3[2]["step_ms"] == rec3[3]["step_ms"]
    assert log1 == log3 and log1.count("\n") == 1
    f1, f3 = _flat(ck1), _flat(ck3)
    assert f1.keys() == f3.keys()
    for k in f1:
        if isinstance(f1[k], torch.Tensor):
            assert torch.equal(f1[k], f3[k]), k
        else:
            assert f1[k] == f3[k], k
    assert ck1["step"] == 4 and ck1["optimizer"]["count"] == 4
