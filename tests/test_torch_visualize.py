"""The port's drawing (point_teacher_torch/utils/visualize.py) and the eval
runner's show_dir against the JAX package's on the CPU: the canvases of
imshow_det_bboxes and imshow_det_rbboxes bit-equal to JAX's; then
evaluate_detector(show_dir=...) at 64 px on the fabricated HBB and rotated
sets, the on-disk HBB set (also with TTA) and the rotated patch set: the
files it writes carry the JAX runner's names and bytes, where the JAX
runner (or, for TTA, the JAX drawing function) is given the port's own
detections and images. The models are the configs' seeded inits made
dense (every candidate passes score_thr), so that boxes are drawn."""
import os

import numpy as np
import pytest
import torch

from point_teacher_torch.config_io import apply_overrides, load_config
from point_teacher_torch.data.pipeline import load_image
from point_teacher_torch.evalx import runner as prunner
from point_teacher_torch.tools import test as test_cli
from point_teacher_torch.tools import train as cli
from point_teacher_torch.tools.profile_step import make_dense
from point_teacher_torch.utils import visualize as pvis
from point_teacher_tpu.evalx import runner as jrunner
from point_teacher_tpu.utils import visualize as jvis
from test_torch_eval import coco_dir  # noqa: F401  (fixture)
from test_torch_fcos_baseline import one_thread
from test_torch_rotated_eval import sodaa_dir  # noqa: F401  (fixture)
from torch_port_env import port_test_module  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBB = os.path.join(REPO, "configs/point_teacher/aitodv2_point_teacher_0.py")
SODAA = os.path.join(REPO, "configs/point_teacher/sodaa_point_teacher_1x.py")
SMALL = ["pt.img_size=64", "pt.batch_size=2"]
# the rotated class NMS and the SODA-A eval are O(n^2) on the host: few detections
RSMALL = SMALL + ["pt.test.nms_pre=16", "pt.test.max_per_img=16"]


def _drawing_case(seed, rotated, n=12, size=96):
    r = np.random.RandomState(seed)
    img = r.uniform(-20, 275, (size, size, 3)).astype(np.float32)   # clipped by both
    xy = r.uniform(-10, size, (n, 2))
    wh = r.uniform(2, 40, (n, 2))
    if rotated:
        boxes = np.concatenate([xy, wh, r.uniform(-np.pi / 2, np.pi / 2, (n, 1))], -1)
    else:
        boxes = np.concatenate([xy, xy + wh], -1)
    return (img, boxes.astype(np.float32), r.randint(0, 5, n), r.uniform(0, 1, n))


@pytest.mark.parametrize("rotated", [False, True], ids=["hbb", "rotated"])
@pytest.mark.parametrize("variant", ["labels", "scores", "names+thr", "tensors"])
def test_canvases_match_jax(rotated, variant, tmp_path):
    img, boxes, labels, scores = _drawing_case(3 + rotated, rotated)
    kw = {}
    if variant != "labels":
        kw["scores"] = scores
    if variant == "names+thr":
        kw.update(class_names=[f"class-{i}" for i in range(5)], score_thr=0.4)
    pfn = pvis.imshow_det_rbboxes if rotated else pvis.imshow_det_bboxes
    jfn = jvis.imshow_det_rbboxes if rotated else jvis.imshow_det_bboxes
    want = jfn(img, boxes, labels, out_file=str(tmp_path / "jax.jpg"), **kw)
    if variant == "tensors":
        got = pfn(torch.as_tensor(img), torch.as_tensor(boxes), torch.as_tensor(labels),
                  out_file=str(tmp_path / "port.jpg"), scores=torch.as_tensor(scores))
    else:
        got = pfn(img, boxes, labels, out_file=str(tmp_path / "port.jpg"), **kw)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert not np.array_equal(got, np.clip(img, 0, 255).astype(np.uint8))   # something drawn
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()


@pytest.fixture(scope="module")
def dense_models():
    """Each fork's 64 px seeded init, made dense, on the CPU."""
    out = {}
    for fork, config in (("hbb", HBB), ("rotated", SODAA)):
        cfg = apply_overrides(load_config(config), SMALL)
        model = one_thread(lambda: cli.build_model(cfg, 0, torch.device("cpu")))
        make_dense(model)
        out[fork] = model
    return out


def _same_files(got_dir, want_dir, names):
    assert sorted(os.listdir(got_dir)) == sorted(names)
    assert sorted(os.listdir(want_dir)) == sorted(names)
    for name in names:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name


def _port_then_jax(model, cfg, rotated, tmp_path, synthetic_n=0):
    """The port's runner with show_dir, recording its inference outputs; then
    the JAX runner with show_dir, its inference replaced by those outputs."""
    pt = cfg["pt"]
    infer = prunner.build_infer(pt, rotated)
    outs = []

    def recorded(m, *args):
        res = infer(m, *args)
        outs.append([x.numpy() for x in res])
        return res

    one_thread(lambda: prunner.evaluate_detector(
        recorded, model, pt, cfg, rotated=rotated, synthetic_n=synthetic_n,
        show_dir=str(tmp_path / "port"), quiet=True))
    replay = iter(outs)
    jrunner.evaluate_detector(lambda _params, *args: next(replay), None, pt, cfg,
                              rotated=rotated, synthetic_n=synthetic_n,
                              show_dir=str(tmp_path / "jax"), quiet=True)
    assert next(replay, None) is None
    kept = sum(int((o[0][..., -1][o[2]] >= 0.3).sum()) for o in outs)
    assert kept > 0, "no detection above the drawing threshold"


@pytest.mark.parametrize("fork", ["hbb", "rotated"])
def test_show_dir_on_fabricated_sets_matches_jax_runner(dense_models, fork, tmp_path):
    cfg = apply_overrides(*((load_config(HBB), SMALL) if fork == "hbb" else
                            (load_config(SODAA), RSMALL)))
    _port_then_jax(dense_models[fork], cfg, fork == "rotated", tmp_path, synthetic_n=4)
    _same_files(tmp_path / "port", tmp_path / "jax", [f"img{i}.jpg" for i in range(4)])


def test_show_dir_on_the_hbb_disk_set_matches_jax_runner(dense_models, coco_dir, tmp_path):
    cfg = apply_overrides(load_config(HBB), SMALL + [f"dataset.{k}={v}"
                                                     for k, v in coco_dir.items()])
    _port_then_jax(dense_models["hbb"], cfg, False, tmp_path)
    _same_files(tmp_path / "port", tmp_path / "jax", ["im0.png", "im1.png", "im2.png"])


def test_show_dir_on_the_rotated_patch_set_matches_jax_runner(dense_models, sodaa_dir,
                                                              tmp_path):
    cfg = apply_overrides(load_config(SODAA), RSMALL + [f"dataset.{k}={v}" for k, v in
                                                        sodaa_dir.items() if k != "img_norm"])
    assert cfg["dataset"]["img_norm"]   # the patches are de-normalised before drawing
    _port_then_jax(dense_models["rotated"], cfg, True, tmp_path)
    names = sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 3 and all("__64__" in n for n in names)   # the non-empty patches
    _same_files(tmp_path / "port", tmp_path / "jax", names)


def test_show_dir_with_tta_draws_the_raw_image(dense_models, coco_dir, tmp_path):
    """TTA draws each image as read with its merged detections: the JAX
    drawing function on the port's image and detections (the --out npz)."""
    cfg = apply_overrides(load_config(HBB), SMALL + [f"dataset.{k}={v}"
                                                     for k, v in coco_dir.items()])
    out = tmp_path / "dets.npz"
    one_thread(lambda: prunner.evaluate_detector(
        None, dense_models["hbb"], cfg["pt"], cfg, out=str(out), quiet=True,
        show_dir=str(tmp_path / "port"), tta=dict(scales=[64, 48], flip=True)))
    dets = np.load(out)
    for i, name in enumerate(["im0.png", "im1.png", "im2.png"]):
        d = dets[f"img{i}"]
        jvis.imshow_det_bboxes(load_image(os.path.join(coco_dir["val_img_prefix"], name)),
                               d[:, :4], d[:, 5], d[:, 4], score_thr=0.3,
                               out_file=str(tmp_path / "jax" / name))
    _same_files(tmp_path / "port", tmp_path / "jax", ["im0.png", "im1.png", "im2.png"])


def test_test_cli_show_dir(tmp_path):
    show = tmp_path / "show"
    one_thread(lambda: test_cli.main([HBB, "--cpu", "--synthetic-data", "2", "--show-dir",
                                      str(show), "--cfg-options", *SMALL]))
    assert sorted(os.listdir(show)) == ["img0.jpg", "img1.jpg"]
