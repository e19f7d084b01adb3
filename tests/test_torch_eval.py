"""The port's eval path against the JAX package's on the CPU: the copied
COCO-style metrics, the COCO dataset, preprocessing and EvalLoader, the
eval runner (synthetic and dataset branches), the detector API, the
checkpoint round trip, and the train -> checkpoint -> test CLI chain."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from point_teacher_tpu import apis as japis
from point_teacher_tpu.data import coco as jcoco
from point_teacher_tpu.data import loader as jloader
from point_teacher_tpu.evalx import cocoeval as jeval
from point_teacher_tpu.evalx import runner as jrunner
from point_teacher_tpu.inference import build_inference_fn as jbuild
from point_teacher_tpu.train.config import InferenceCfg as JaxCfg
from point_teacher_tpu.train.config import PointTeacherConfig as JaxPT
from point_teacher_torch import apis as papis
from point_teacher_torch.config_io import apply_overrides, load_config
from point_teacher_torch.data import coco as pcoco
from point_teacher_torch.data import loader as ploader
from point_teacher_torch.evalx import cocoeval as peval
from point_teacher_torch.evalx import runner as prunner
from point_teacher_torch.inference import build_inference_fn
from point_teacher_torch.tools import train as cli
from point_teacher_torch.train.config import InferenceCfg, PointTeacherConfig
from point_teacher_torch.utils import checkpoint as ckpt
from test_torch_inference import match_dets, pair  # noqa: F401  (the module's JAX fixture)
from test_torch_models import IMG, NUM_CLASSES
from torch_port_env import port_test_module  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/point_teacher/aitodv2_point_teacher_0.py")
MAP_TOL = 1e-6


def _random_eval_case(seed, n_img=6, n_cls=3):
    r = np.random.RandomState(seed)
    anns, dets = [], []
    for _ in range(n_img):
        g = r.randint(0, 9)
        xy = r.uniform(0, 90, (g, 2))
        wh = r.uniform(2, 40, (g, 2))
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        anns.append(dict(boxes=boxes, labels=r.randint(0, n_cls, g)))
        k = r.randint(0, 15)
        jit = boxes[r.randint(0, max(g, 1), k)] if g else np.zeros((k, 4), np.float32)
        d = (jit + r.uniform(-4, 4, (k, 4))).astype(np.float32)
        dets.append((d, r.uniform(0, 1, k).astype(np.float32), r.randint(0, n_cls, k)))
    gt = dict(img_ids=list(range(n_img)), classes=[f"c{i}" for i in range(n_cls)],
              annotations=anns)
    return gt, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cocoeval_copy_gives_jax_stats_exactly(seed):
    gt, dets = _random_eval_case(seed)
    want_ev = jeval.COCOStyleEval(gt, dets)
    got_ev = peval.COCOStyleEval(gt, dets)
    want, got = want_ev.evaluate(), got_ev.evaluate()
    assert got == want
    assert got_ev.per_class_ap == want_ev.per_class_ap
    assert peval.aitod_evaluate(gt, dets) == want
    assert 0 < want["mAP"] < 1


@pytest.fixture
def coco_dir(tmp_path):
    """A COCO-format val set on disk in the AI-TOD classes: three PNGs, one of
    which (48 x 80) the 64 px canvas resizes, one with no boxes."""
    sizes = [(64, 64), (48, 80), (60, 64)]
    images, anns = [], []
    r = np.random.RandomState(7)
    for i, (h, w) in enumerate(sizes):
        name = f"im{i}.png"
        Image.fromarray(r.randint(0, 255, (h, w, 3), np.uint8)).save(tmp_path / name)
        images.append(dict(id=10 + i, file_name=name, width=w, height=h))
        for j in range(0 if i == 2 else 4):
            x, y = r.uniform(0, w - 20), r.uniform(0, h - 20)
            anns.append(dict(id=len(anns), image_id=10 + i, category_id=[3, 6, 1, 4][j],
                             bbox=[x, y, r.uniform(4, 18), r.uniform(4, 18)], iscrowd=0))
    anns.append(dict(id=len(anns), image_id=10, category_id=6, bbox=[5, 5, 10, 10], iscrowd=1))
    cats = [dict(id=k, name=n) for k, n in
            zip((1, 3, 4, 6), ("airplane", "ship", "vehicle", "storage-tank"))]
    ann = tmp_path / "val.json"
    ann.write_text(json.dumps(dict(images=images, annotations=anns, categories=cats)))
    return dict(val_ann=str(ann), val_img_prefix=str(tmp_path))


def test_dataset_pipeline_and_eval_loader_match_jax(coco_dir):
    pds = pcoco.AITODDataset(coco_dir["val_ann"], coco_dir["val_img_prefix"],
                             filter_empty=False)
    jds = jcoco.AITODDataset(coco_dir["val_ann"], coco_dir["val_img_prefix"],
                             filter_empty=False)
    assert pds.img_infos == jds.img_infos and pds.cat2label == jds.cat2label
    for a, b in zip(pds.annotations, jds.annotations):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert len(pcoco.AITODDataset(coco_dir["val_ann"], coco_dir["val_img_prefix"])) == 2
    pbatches = list(ploader.EvalLoader(pds, 2, IMG))
    jbatches = list(jloader.EvalLoader(jds, 2, IMG))
    assert [b[0] for b in pbatches] == [[0, 1], [2]]
    for pb, jb in zip(pbatches, jbatches):
        assert pb[0] == jb[0]
        for got, want in zip(pb[1:], jb[1:]):
            np.testing.assert_array_equal(got, want)
    # the 48 x 80 image was resized to 38 x 64 (scale 0.8)
    np.testing.assert_array_equal(pbatches[0][3][1], [38, 64])


def _pts():
    common = dict(num_classes=NUM_CLASSES, img_size=IMG, batch_size=2)
    return (PointTeacherConfig(test=InferenceCfg(), **common),
            JaxPT(test=JaxCfg(), **common))


@pytest.fixture(scope="module")
def eval_pair(pair):  # noqa: F811
    """`pair` with its regression conditioned to boxes of ~12 px (bias 0.75,
    kernel x 0.1), the size of the fabricated GT boxes, so that detections
    match GTs at IoU 0.25 and the metrics are not all 0; in this module the
    port's module is changed in place, as the flax tree is."""
    jmodel, params, port = pair
    params = jax.tree_util.tree_map(np.array, params)
    reg = params["params"]["bbox_head"]["conv_reg"]
    reg["bias"][:] = 0.75
    reg["kernel"] *= 0.1
    with torch.no_grad():
        port.bbox_head.conv_reg.bias.fill_(0.75)
        port.bbox_head.conv_reg.weight.mul_(0.1)
    return jmodel, params, port


@pytest.mark.parametrize("branch", ["synthetic", "dataset"])
def test_evaluate_detector_matches_jax(eval_pair, coco_dir, branch):
    """The same weights through both runners: mAP within 1e-6, every stat."""
    jmodel, params, port = eval_pair
    ppt, jpt = _pts()
    cfg = dict(dataset=coco_dir)
    n = 4 if branch == "synthetic" else 0
    want_ap, want = jrunner.evaluate_detector(jbuild(jmodel, jpt.test, IMG), params, jpt, cfg,
                                              synthetic_n=n, quiet=True)
    got_ap, got = prunner.evaluate_detector(prunner.build_infer(ppt), port, ppt, cfg,
                                            synthetic_n=n, quiet=True)
    assert abs(got_ap - want_ap) <= MAP_TOL
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= MAP_TOL, k
    assert want_ap > 0


def test_synthetic_val_set_matches_jax():
    ppt, jpt = _pts()
    (pb, pgt), (jb, jgt) = (prunner.synthetic_val_set(ppt, 5, False),
                            jrunner.synthetic_val_set(jpt, 5, False))
    assert len(pb) == len(jb) == 3
    for a, b in zip(pb, jb):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pgt["annotations"], jgt["annotations"]):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_inference_detector_matches_jax(eval_pair):
    """A 52 x 64 image through each package's Detector: the same per-class
    detections (boxes and scores within the forward's tolerance)."""
    jmodel, params, port = eval_pair
    classes = jcoco.AITODDataset.CLASSES
    jdet = japis.Detector(jmodel, params, jbuild(jmodel, JaxCfg(), IMG), classes, IMG)
    pdet = papis.Detector(port, build_inference_fn(InferenceCfg(), IMG), classes, IMG,
                          InferenceCfg())
    img = np.random.RandomState(8).uniform(0, 255, (52, IMG, 3)).astype(np.float32)
    want = japis.inference_detector(jdet, img)
    got = papis.inference_detector(pdet, img)
    assert len(got) == len(want) == len(classes)
    assert sum(len(g) for g in got) > 10
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if len(w):   # one class's rows, in score order: match_dets on them
            lab = np.zeros(len(w), int)
            match_dets((g, lab, np.ones(len(g), bool)), (w, lab, np.ones(len(w), bool)),
                       rtol=1e-4, tie=1e-4, atol=1e-3)
    # the TTA API with one unflipped view at the canvas size is the simple test
    tta = papis.inference_detector_tta(pdet, img, flip=False)
    for a, b in zip(tta, got):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def one_thread():
    """torch on one thread: beside the other test workers, building the
    full-depth model on every core is slower than on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_checkpoint_round_trip_is_bitwise(tmp_path, one_thread):
    cfg = apply_overrides(load_config(CONFIG), ["pt.img_size=64", "pt.max_gt=6"])
    cpu = torch.device("cpu")
    _, state, _ = cli.setup(cfg, 4, 0, cpu)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        state.teacher.bbox_head.conv_cls.weight.add_(1.0)
        for buf in state.optimizer.trace["base"] + state.optimizer.trace["bias"]:
            buf.copy_(torch.randn(buf.shape, generator=g))
        state.origin_points.copy_(torch.rand(state.origin_points.shape, generator=g))
        state.refined_points.copy_(torch.rand(state.refined_points.shape, generator=g))
        state.points_cached[1:3] = True
    state.step, state.optimizer.count = 7, 5
    torch.rand(3, generator=state.generator)
    path = str(tmp_path / "latest.pth")
    ckpt.save_checkpoint(state, path, meta=dict(num_images=4))
    assert ckpt.load_meta(path) == dict(num_images=4)

    _, fresh, _ = cli.setup(cfg, 4, 1, cpu)
    ckpt.load_checkpoint(fresh, path)
    assert (fresh.step, fresh.optimizer.count) == (7, 5)
    for a, b in ((state.student, fresh.student), (state.teacher, fresh.teacher)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for label in ("base", "bias"):
        for x, y in zip(state.optimizer.trace[label], fresh.optimizer.trace[label]):
            assert torch.equal(x, y)
    for name in ("origin_points", "refined_points", "points_cached"):
        assert torch.equal(getattr(state, name), getattr(fresh, name)), name
    assert torch.equal(state.generator.get_state(), fresh.generator.get_state())
    # the branch loader: the teacher's weights, not the student's
    ckpt.load_weights(fresh.student, path, "teacher")
    assert torch.equal(fresh.student.bbox_head.conv_cls.weight,
                       state.teacher.bbox_head.conv_cls.weight)
    assert not torch.equal(fresh.student.bbox_head.conv_cls.weight,
                           state.student.bbox_head.conv_cls.weight)
    fresh.origin_points = fresh.origin_points[:2]
    with pytest.raises(ValueError, match="num_images"):
        ckpt.load_checkpoint(fresh, path)


def _run(args, timeout=300):
    # one thread: beside the other test workers, torch's default of one
    # thread a core oversubscribes the CPU
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_cli_train_checkpoint_test_chain_on_cpu(tmp_path):
    """tools.train --cpu --work-dir writes latest.pth; tools.test --cpu
    evaluates its teacher on fabricated images and prints the AP@0.25 table."""
    small = ["--cfg-options", "pt.img_size=64", "pt.max_gt=6"]
    out = _run(["point_teacher_torch.tools.train", CONFIG, "--cpu", "--synthetic-data", "4",
                "--max-steps", "1", "--work-dir", str(tmp_path), *small])
    path = tmp_path / "latest.pth"
    assert f"saved checkpoint: {tmp_path / 'epoch_1.pth'}" in out and path.exists()
    assert ckpt.load_meta(str(path)) == dict(epoch=1, step=1, num_images=4)
    npz = tmp_path / "dets.npz"
    out = _run(["point_teacher_torch.tools.test", CONFIG, str(path), "--cpu",
                "--synthetic-data", "4", "--out", str(npz), *small])
    assert f"loaded the teacher of {path}" in out
    assert "AI-TOD COCO-style metrics (IoU 0.25)" in out and "greedy matching:" in out
    for key in ("mAP_vt", "AR@1500", "oLRP"):
        assert any(line.split(":")[0].strip() == key for line in out.splitlines()), key
    assert "mAP@0.25 " in out and "on cpu" in out
    assert len(np.load(npz).files) == 4


def test_test_cli_and_api_ask_for_cuda_without_a_card():
    """Without --cpu (or a device) the test CLI and init_detector run on the
    card, and raise where there is none."""
    from point_teacher_torch.tools import test as test_cli

    if torch.cuda.is_available():
        assert cli.resolve_device(False).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_cli.main([CONFIG, "--synthetic-data", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        papis.init_detector(CONFIG)


def test_rotated_eval_raises_not_implemented():
    """What the eval still refuses: TTA of the rotated detector (as the JAX
    package does: the reference's rotated configs run single-scale), through
    the runner and the API. (show_dir is ported: test_torch_visualize.py.)"""
    ppt, _ = _pts()
    with pytest.raises(ValueError, match="HBB path only"):
        prunner.evaluate_detector(None, torch.nn.Linear(1, 1), ppt, {}, rotated=True,
                                  synthetic_n=2, tta=dict(scales=[IMG]))
    det = papis.Detector(torch.nn.Linear(1, 1), None, ("a",), IMG, InferenceCfg(), rotated=True)
    with pytest.raises(NotImplementedError, match="HBB path"):
        papis.inference_detector_tta(det, np.zeros((8, 8, 3), np.float32))


def test_test_settings_and_overrides_match_jax():
    """The `test` field of both forks' configs as in the JAX package, and
    pt.test.* overrides reach it."""
    from point_teacher_tpu.train.config import config_0pct as j0, config_sodaa as jsodaa

    sodaa = os.path.join(REPO, "configs/point_teacher/sodaa_point_teacher_1x.py")
    assert tuple(load_config(CONFIG)["pt"].test) == tuple(j0().test)
    assert tuple(load_config(sodaa)["pt"].test) == tuple(jsodaa().test)
    cfg = apply_overrides(load_config(CONFIG), ["pt.test.score_thr=0.1", "pt.test.nms_pre=100",
                                                "dataset.val_ann=x.json"])
    assert cfg["pt"].test == InferenceCfg(nms_pre=100, score_thr=0.1)
    assert cfg["dataset"]["val_ann"] == "x.json"
