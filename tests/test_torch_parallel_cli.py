"""The port's CLIs over a world of 2 CPU ranks (--cpu-devices 2, gloo) against
one process, at test_torch_cli_train.py's 64 px options:
- tools.train on 8 fabricated images, --max-steps 4 with burn_in_step 2
  (phase 1 then phase 2) and --val-interval 1, then a resume from
  epoch_1.pth to step 6: one `data parallel over 2 devices` line, one
  train_log.jsonl (rank 0's; as many records as one process writes), the
  checkpoints with their meta, the `resumed from` line; every logged
  metric within 1e-5 of the one-process run's (the resumes both from the
  one-process run's epoch_1.pth);
- tools.test on the world's latest.pth over 8 fabricated images: the same
  AP@0.25 table as one process, exactly, and the `eval sharded over 2
  devices` line; the same with multi-scale + flip TTA (64 and 32 px; one
  image a rank) through the port's dist_test.sh (torchrun, --standalone,
  --cpu); the SODA-A config over a patch set (four 64 px patches of one
  original image, merged there): the same rotated table;
- asked for the card under torchrun without one, the CLI raises.
The one-process runs go in this process on one torch thread, while the
world's run as subprocesses beside them; the ~0.7 GB checkpoints are
removed when done."""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from point_teacher_torch.data import patch as ppatch
from point_teacher_torch.evalx.rgeometry import obb2poly_np
from point_teacher_torch.tools import test as test_cli
from point_teacher_torch.tools import train as cli
from test_torch_cli_train import SMALL, drop_checkpoints, run_main
from torch_port_env import port_test_module  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBB = os.path.join(REPO, "configs/point_teacher/aitodv2_point_teacher_0.py")
SODAA = os.path.join(REPO, "configs/point_teacher/sodaa_point_teacher_1x.py")
TRAIN = ["--synthetic-data", "8", "--val-interval", "1", "--cfg-options", *SMALL,
         "pt.burn_in_step=2"]
# every candidate passes, so the AP tables are made of many detections
TEST = ["--synthetic-data", "8", "--cfg-options", *SMALL, "pt.test.score_thr=0.0"]
ROTATED = ["--cfg-options", "pt.img_size=64", "pt.max_gt=6", "pt.test.nms_pre=16",
           "pt.test.score_thr=0.0"]
TTA = ["--tta-scales", "64,32"]


def world_cli(module, argv, *launcher):
    """`python -m point_teacher_torch.tools.<module> argv --cpu-devices 2`
    (or through `launcher`, a command line that takes the config and its
    flags) in a subprocess; returns its standard output."""
    cmd = (list(launcher) if launcher else
           [sys.executable, "-m", f"point_teacher_torch.tools.{module}"]) + list(argv)
    if not launcher:
        cmd.append("--cpu-devices=2")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def table(out):
    """The metrics table's lines of a tools.test output: from its header to
    the headline, without the eval's seconds."""
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("--- "))
    end = next(i for i, line in enumerate(lines) if line.startswith(("mAP@0.25 ", "AP .5:.95 ")))
    return lines[start:end] + [lines[end].split(";")[0]]


def records(work_dir):
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _write_json(path, polys, labels):
    with open(path, "w") as f:
        json.dump(dict(annotations=[dict(poly=[float(v) for v in p], category_id=int(c))
                                    for p, c in zip(polys, labels)]), f)


def sodaa_patch_set(root):
    """test_torch_rotated_eval.py's SODA-A layout: one 100 x 80 original
    image with 8 rotated GTs, split by data/patch.py into four 64 px patches
    (one without GTs); --cfg-options for it."""
    r = np.random.RandomState(9)
    img = r.randint(0, 255, (80, 100, 3)).astype(np.uint8)
    gts = np.concatenate([r.uniform(6, 94, (8, 1)), r.uniform(6, 74, (8, 1)),
                          r.uniform(8, 16, (8, 2)), r.uniform(-1.5, 1.5, (8, 1))], -1)
    gts[:, 1] = np.where(gts[:, 0] < 64, r.uniform(6, 14, 8), gts[:, 1])
    labels = r.randint(0, 9, 8)
    dirs = {k: os.path.join(root, k) for k in ("ann", "img", "ori")}
    for d in dirs.values():
        os.makedirs(d)
    _write_json(os.path.join(dirs["ori"], "scene.json"), obb2poly_np(gts).reshape(-1, 8), labels)
    for patch, (x0, y0) in ppatch.split_image(img, (64,), (16,)):
        name = ppatch.patch_name("scene.png", 64, x0, y0)
        Image.fromarray(patch).save(os.path.join(dirs["img"], name), format="PNG")
        h, w = patch.shape[:2]
        inside = ((gts[:, 0] >= x0) & (gts[:, 0] < x0 + w) & (gts[:, 1] >= y0)
                  & (gts[:, 1] < y0 + h))
        local = gts[inside] - [x0, y0, 0, 0, 0]
        _write_json(os.path.join(dirs["ann"], name.replace(".jpg", ".json")),
                    obb2poly_np(local).reshape(-1, 8), labels[inside])
    return ["dataset.val_ann=" + dirs["ann"], "dataset.val_img_prefix=" + dirs["img"],
            "dataset.ori_val_ann=" + dirs["ori"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's runs as subprocesses in threads, each as soon as what it
    reads exists: train, then its test and dist_test.sh on its latest.pth;
    the SODA-A patch set; the resume from the one-process run's
    epoch_1.pth (both resumes start from one state). The one-process runs
    meanwhile, in this process."""
    d = {n: str(tmp_path_factory.mktemp(n)) for n in ("one", "one_resumed", "world",
                                                       "world_resumed", "patches")}
    patches = sodaa_patch_set(d["patches"])
    world, errors = {}, []
    one_trained, world_trained = threading.Event(), threading.Event()
    ckpt = os.path.join(d["world"], "latest.pth")

    def job(*steps):
        """Steps (key, event to wait for, event to set after, module, argv,
        *launcher) in a thread, in turn."""
        def target():
            try:
                for key, wait, done, module, argv, *launcher in steps:
                    if wait is not None:
                        wait.wait()
                    world[key] = world_cli(module, argv, *launcher)
                    if done is not None:
                        done.set()
            except BaseException as e:  # noqa: BLE001 - raised in the fixture
                errors.append(e)
                one_trained.set()
                world_trained.set()
        th = threading.Thread(target=target)
        th.start()
        return th

    jobs = [
        job(("train", None, world_trained, "train",
             [HBB, "--work-dir", d["world"], "--max-steps", "4", *TRAIN]),
            ("test", None, None, "test", [HBB, ckpt, *TEST])),
        job(("sodaa", None, None, "test", [SODAA, *ROTATED, *patches]),
            ("dist_test", world_trained, None, "test", [HBB, ckpt, "2", "--cpu", *TTA, *TEST],
             "bash", os.path.join(REPO, "point_teacher_torch/tools/dist_test.sh"))),
        job(("resume", one_trained, None, "train", [
            HBB, "--work-dir", d["world_resumed"], "--max-steps", "6",
            "--resume-from", os.path.join(d["one"], "epoch_1.pth"), *TRAIN])),
    ]
    one = {}
    try:
        _, one["train"] = run_main(cli.main, [HBB, "--cpu", "--work-dir", d["one"],
                                              "--max-steps", "4", *TRAIN])
        one_trained.set()
        _, one["resume"] = run_main(cli.main, [
            HBB, "--cpu", "--work-dir", d["one_resumed"], "--max-steps", "6",
            "--resume-from", os.path.join(d["one"], "epoch_1.pth"), *TRAIN])
        _, one["sodaa"] = run_main(test_cli.main, [SODAA, "--cpu", *ROTATED, *patches])
        world_trained.wait()
        # the one-process tests of the world's own checkpoint
        _, one["test"] = run_main(test_cli.main, [HBB, ckpt, "--cpu", *TEST])
        _, one["tta"] = run_main(test_cli.main, [HBB, ckpt, "--cpu", *TTA, *TEST])
    finally:
        one_trained.set()
        world_trained.set()
        for th in jobs:
            th.join()
        files = {k: sorted(os.listdir(v)) for k, v in d.items()}
        drop_checkpoints(*d.values())
    if errors:
        raise errors[0]
    return dict(d=d, one=one, world=world, files=files)


def test_world_prints_the_data_parallel_line_once(runs):
    for key in ("train", "resume"):
        out = runs["world"][key]
        assert out.count("data parallel over 2 devices") == 1
        assert "data parallel" not in runs["one"][key]
    assert "resumed from" in runs["world"]["resume"] and "at step 4" in runs["world"]["resume"]
    assert "training done at step 6" in runs["world"]["resume"]


def test_world_writes_one_log_and_the_checkpoints(runs):
    files = runs["files"]
    assert files["world"] == files["one"]
    assert files["world_resumed"] == files["one_resumed"]
    assert {"epoch_1.pth", "latest.pth", "best.pth", "train_log.jsonl"} <= set(files["world"])
    for key in ("world", "world_resumed"):
        got, want = records(runs["d"][key]), records(runs["d"][key.replace("world", "one")])
        assert [(r["mode"], r["iter"]) for r in got] == [(r["mode"], r["iter"]) for r in want]
    with open(os.path.join(runs["d"]["world"], "epoch_1.pth.meta.json")) as f:
        assert json.load(f) == dict(epoch=1, step=4, num_images=8)


@pytest.mark.parametrize("key", ["world", "world_resumed"])
def test_world_logged_metrics_equal_one_process(runs, key):
    got, want = records(runs["d"][key]), records(runs["d"][key.replace("world", "one")])
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
            else:
                assert g[k] == v, k


def test_world_step_lines_equal_one_process(runs):
    """Every step's line is there, and each run's first step, from one
    state in both (the init, or the same epoch_1.pth), equals one process's
    within 1e-5. The later steps are held by the log's records above: from
    this unconditioned init the bag loss sits in gfocal's saturation
    (ROADMAP.md queue 3), where the update's other order of summation moves
    a single step's stage0_loss_mil_bags by up to ~1.1e-5."""
    def steps(out):
        return [json.loads(line) for line in out.splitlines() if line.startswith("{")]

    for key in ("train", "resume"):
        got, want = steps(runs["world"][key]), steps(runs["one"][key])
        assert [r["step"] for r in got] == [r["step"] for r in want]
        assert got[0].keys() == want[0].keys()
        for k, v in want[0].items():
            if k != "step_ms":
                np.testing.assert_allclose(got[0][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("key", ["test", "dist_test", "sodaa"])
def test_sharded_eval_prints_the_one_process_table(runs, key):
    out = runs["world"][key]
    assert out.count("eval sharded over 2 devices") == 1
    got, want = table(out), table(runs["one"][{"dist_test": "tta"}.get(key, key)])
    assert got == want
    assert len(got) > 10


def test_the_tables_hold_detections(runs):
    """score_thr 0: the HBB table's AP is made of detections (not the empty
    -1 / 0 of a run that kept none)."""
    aps = [line for line in table(runs["one"]["test"]) if line.strip().startswith("mAP:")]
    assert aps and float(aps[0].split(":")[1]) >= 0


def test_torchrun_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([HBB, "--synthetic-data", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_cli.main([HBB, "--synthetic-data", "2"])

