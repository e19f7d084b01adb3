"""The port's training CLI (point_teacher_torch.tools.train) on the CPU at
64 px over an AI-TOD-v2 COCO train and val set (8 and 4 images) written in
the real on-disk layout (the other trainers: test_torch_cli_baselines.py).

On the AI-TOD set, with burn_in_step 2 (steps 1-3 phase 1, later phase 2):
- 4 steps (one epoch) with --val-interval 1 write the train and val
  records of train_log.jsonl, epoch_1.pth and latest.pth with their meta,
  and best.pth (the first validation always beats -1);
- --resume-from epoch_1.pth into a second work dir prints `resumed from ...
  at step 4` and reaches step 6 (epoch_2.pth);
- the state loaded from epoch_1.pth equals the one the run ended with, bit
  for bit (weights, optimizer trace and count, point caches, generator);
- a step run after a validation equals the same step run without it;
- tools.test evaluates latest.pth on the on-disk val set, and --torch-ckpt
  a reference-format teacher-student file of the same weights (with the
  dead keys) to the same headline, and refuses it for rfla_fcos.
Every port config's dicts equal the JAX config file's. The CLI runs in this
process on one torch thread (beside the other test workers, a thread a core
slows torch many times over)."""
import contextlib
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from point_teacher_tpu.config_io import load_config as jax_load_config
from point_teacher_torch.config_io import load_config
from point_teacher_torch.tools import test as test_cli
from point_teacher_torch.tools import train as cli
from point_teacher_torch.utils import checkpoint as ckpt
from point_teacher_torch.utils.logging import TrainLogger
from test_torch_fcos_baseline import one_thread
from test_torch_train_loader import write_coco, write_sodaa_patches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBB = os.path.join(REPO, "configs/point_teacher/aitodv2_point_teacher_0.py")
SODAA = os.path.join(REPO, "configs/point_teacher/sodaa_point_teacher_1x.py")
FCOS = os.path.join(REPO, "configs/baselines/aitodv2_fcos_r50_1x.py")
RFLA = os.path.join(REPO, "configs/baselines/aitodv2_rfla_fcos_1x.py")
SMALL = ["pt.img_size=64", "pt.max_gt=6", "pt.test.nms_pre=100", "pt.test.max_per_img=100"]


def run_main(main, argv):
    """main(argv) in this process on one torch thread; returns (its result,
    its standard output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = one_thread(lambda: main(argv))
    return result, out.getvalue()


def _records(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def aitod(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("aitod"))
    train = write_coco(os.path.join(root, "train"), 8, seed=3)
    val = write_coco(os.path.join(root, "val"), 4, seed=4)
    return ["dataset.train_ann=" + train[0], "dataset.train_img_prefix=" + train[1],
            "dataset.val_ann=" + val[0], "dataset.val_img_prefix=" + val[1]]


def _states_equal(a, b):
    """Names of the parts of two train states that differ (none: equal)."""
    bad = []
    for name in ("student", "teacher"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        bad += [f"{name}.{k}" for k in sa if not torch.equal(sa[k], sb[k])]
    for label in ("base", "bias"):
        bad += [f"trace.{label}.{i}" for i, (x, y) in enumerate(
            zip(a.optimizer.trace[label], b.optimizer.trace[label])) if not torch.equal(x, y)]
    bad += [n for n in ("origin_points", "refined_points", "points_cached")
            if not torch.equal(getattr(a, n), getattr(b, n))]
    if (a.step, a.optimizer.count) != (b.step, b.optimizer.count):
        bad.append("step/count")
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        bad.append("generator")
    return bad


def _reference_ts_file(state, path):
    """The state's branches as a reference teacher-student checkpoint, with
    keys the reference carries that no loader reads."""
    sd = {f"{b}.{k}": v for b in ("teacher", "student")
          for k, v in getattr(state, b).state_dict().items()}
    sd["teacher.bbox_head.fc_iou.0.weight"] = torch.ones(1, 4)
    sd["teacher.backbone.bn1.num_batches_tracked"] = torch.tensor(1)
    torch.save({"state_dict": sd, "meta": {"epoch": 1}}, path)


def drop_checkpoints(*dirs):
    """Remove the .pth files of test work dirs (each holds the whole train
    state of a ResNet-50 detector, ~0.7 GB), keeping their meta."""
    for d in dirs:
        for path in glob.glob(os.path.join(d, "*.pth")):
            os.remove(path)


@pytest.fixture(scope="module")
def hbb(aitod, tmp_path_factory):
    """The whole AI-TOD chain, in order; each test reads its part. The
    checkpoint files are removed as soon as the chain is done with them."""
    d1, d2 = (str(tmp_path_factory.mktemp(n)) for n in ("run", "resumed"))
    opts = ["--cfg-options", *SMALL, "pt.burn_in_step=2", *aitod]
    state, out1 = run_main(cli.main, [HBB, "--cpu", "--work-dir", d1, "--max-steps", "4",
                                      "--val-interval", "1", *opts])
    files = {n: os.path.getsize(os.path.join(d1, n)) for n in os.listdir(d1)}
    linked = os.path.samefile(os.path.join(d1, "latest.pth"), os.path.join(d1, "epoch_1.pth"))
    _, out2 = run_main(cli.main, [HBB, "--cpu", "--work-dir", d2, "--max-steps", "6",
                                  "--resume-from", os.path.join(d1, "epoch_1.pth"), *opts])
    files2 = sorted(os.listdir(d2))
    drop_checkpoints(d2)
    cfg = cli.apply_overrides(load_config(HBB), opts[1:])

    def reload():
        _, fresh, step_fn = cli.setup(cfg, 8, 0, torch.device("cpu"))
        return ckpt.load_checkpoint(fresh, os.path.join(d1, "epoch_1.pth")), step_fn

    fresh, step_fn = one_thread(reload)
    resumed_diff = _states_equal(state, fresh)
    ts = os.path.join(d1, "reference_ts.pth")
    _reference_ts_file(state, ts)
    test_opts = ["--cpu", "--cfg-options", *SMALL, *aitod]
    aps = {name: run_main(test_cli.main, [HBB, *args, *test_opts]) for name, args in (
        ("latest", [os.path.join(d1, "latest.pth")]), ("torch_ckpt", ["--torch-ckpt", ts]))}
    drop_checkpoints(d1)
    # a step after a validation against the same step without it, from
    # equal states (the run's end and its reloaded checkpoint)
    batch = cli.to_batch(next(cli.train_data(cfg, 5)[1](2)), torch.device("cpu"))
    val = cli.Validator(cfg, cfg["pt"], str(tmp_path_factory.mktemp("val")), 8, 0,
                        TrainLogger(None))
    with contextlib.redirect_stdout(io.StringIO()):
        one_thread(lambda: val(state, 1, state.step))
    m_after_val = one_thread(lambda: step_fn(state, batch, phase1=False))
    m_plain = one_thread(lambda: step_fn(fresh, batch, phase1=False))
    return dict(d1=d1, d2=d2, out1=out1, out2=out2, files=files, linked=linked, files2=files2,
                resumed_diff=resumed_diff, aps=aps, step_diff=_states_equal(state, fresh),
                metrics=({k: float(v) for k, v in m_after_val.items()},
                         {k: float(v) for k, v in m_plain.items()}))


def test_cli_trains_from_disk_with_validation(hbb):
    out, d1 = hbb["out1"], hbb["d1"]
    assert "dataset: 8 images, 8 classes" in out and "training done at step 4" in out
    assert [r["step"] for r in _records(out)] == [1, 2, 3, 4]
    with open(os.path.join(d1, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [(r["mode"], r["epoch"], r["iter"]) for r in log] == [("train", 1, 4), ("val", 1, 4)]
    for r in log:
        assert all(np.isfinite(v) for k, v in r.items() if k != "mode"), r
    assert "epoch 1: val mAP = " in out and f"-> {os.path.join(d1, 'best.pth')}" in out


@pytest.mark.parametrize("name", ["epoch_1.pth", "latest.pth", "best.pth"])
def test_cli_writes_checkpoints_with_meta(hbb, name):
    got = ckpt.load_meta(os.path.join(hbb["d1"], name))
    if name == "best.pth":
        assert np.isfinite(got.pop("val_mAP"))
    assert got == dict(epoch=1, step=4, num_images=8) and hbb["files"][name] > 0
    assert hbb["linked"]   # latest.pth is the epoch's file


def test_cli_resumes_at_the_saved_step(hbb):
    out, d1, d2 = hbb["out2"], hbb["d1"], hbb["d2"]
    assert f"resumed from {os.path.join(d1, 'epoch_1.pth')} at step 4" in out
    assert [(r["step"], r["epoch"]) for r in _records(out)] == [(5, 2), (6, 2)]
    assert "training done at step 6" in out
    assert ckpt.load_meta(os.path.join(d2, "epoch_2.pth")) == dict(epoch=2, step=6, num_images=8)
    assert hbb["files2"] == ["epoch_2.pth", "epoch_2.pth.meta.json", "latest.pth",
                             "latest.pth.meta.json", "train_log.jsonl"]


def test_resumed_state_equals_the_saved_one(hbb):
    assert hbb["resumed_diff"] == []


def test_step_after_validation_equals_the_step_without(hbb):
    assert hbb["step_diff"] == []
    after, plain = hbb["metrics"]
    assert after == plain and np.isfinite(after["total_loss"])


def test_test_cli_evaluates_the_checkpoints(hbb):
    (latest, out_latest), (ts, out_ts) = (hbb["aps"][k] for k in ("latest", "torch_ckpt"))
    assert "AI-TOD COCO-style metrics (IoU 0.25)" in out_latest and np.isfinite(latest)
    assert "loaded reference torch checkpoint" in out_ts and "(teacher branch)" in out_ts
    assert ts == latest   # one set of weights in both


def test_test_cli_refuses_torch_ckpt_and_tta_for_rfla():
    with pytest.raises(SystemExit, match="point_teacher trainer only"):
        test_cli.main([RFLA, "--cpu", "--torch-ckpt", "unused.pth"])
    with pytest.raises(SystemExit, match="HBB path only"):
        test_cli.main([RFLA, "--cpu", "--tta-scales", "64"])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.py"))),
                         ids=os.path.basename)
def test_port_config_equals_the_config_file(path):
    """Every dict of the port's config equals the file's; so do the pt
    fields, but for `remat`, a switch of the JAX compile only."""
    got, want = load_config(path), jax_load_config(path)
    assert set(got) == set(want)
    for k in want:
        if k != "pt":
            assert got[k] == want[k], k

    def flat(x, pre=""):
        if hasattr(x, "_asdict"):
            return {k2: v2 for k, v in x._asdict().items() for k2, v2 in flat(v, f"{pre}{k}.").items()}
        if isinstance(x, tuple) and x and hasattr(x[0], "_asdict"):
            return {k2: v2 for i, v in enumerate(x) for k2, v2 in flat(v, f"{pre}{i}.").items()}
        return {pre[:-1]: x}

    g, w = flat(got["pt"]), flat(want["pt"])
    assert set(w) - set(g) == {"remat"} and set(g) <= set(w)
    assert {k: g[k] for k in g} == {k: w[k] for k in g}
