"""The port's rotated (SODA-A) eval path against the JAX package's on the
CPU: the numpy copies (evalx/rgeometry.py, evalx/sodaa.py, the rotated
entries of evalx/native.py, data/sodaa.py, data/patch.py), the rotated
model's inference (build_rotated_inference_fn), the eval runner's
synthetic and patch-dataset branches, the detector API, the config's
dataset dict, and the train -> checkpoint -> test CLI chain.

The JAX runner's rotated headline is stats.get("mAP", 0.0), a key that
sodaa_evaluate never writes, so it is always 0.0; the port's is
stats["AP"] (AP over IoU .5:.95), and its stats dict equals JAX's within
MAP_TOL (ROADMAP.md queue 3)."""
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from point_teacher_tpu import apis as japis
from point_teacher_tpu import config_io as jconfig_io
from point_teacher_tpu.data import patch as jpatch
from point_teacher_tpu.data import sodaa as jdata
from point_teacher_tpu.evalx import native as jnative
from point_teacher_tpu.evalx import rgeometry as jgeo
from point_teacher_tpu.evalx import runner as jrunner
from point_teacher_tpu.evalx import sodaa as jsodaa
from point_teacher_tpu.inference import build_rotated_inference_fn as jbuild
from point_teacher_tpu.train.config import InferenceCfg as JaxCfg
from point_teacher_tpu.train.config import PointTeacherConfig as JaxPT
from point_teacher_torch import apis as papis
from point_teacher_torch.config_io import load_config
from point_teacher_torch.data import patch as ppatch
from point_teacher_torch.data import sodaa as pdata
from point_teacher_torch.evalx import native as pnative
from point_teacher_torch.evalx import rgeometry as pgeo
from point_teacher_torch.evalx import runner as prunner
from point_teacher_torch.evalx import sodaa as psodaa
from point_teacher_torch.inference import build_rotated_inference_fn
from point_teacher_torch.models.rotated_detector import StudentRotatedFCOS
from point_teacher_torch.train.config import InferenceCfg, PointTeacherConfig
from point_teacher_torch.utils import checkpoint as ckpt
from point_teacher_torch.utils.jax_weights import load_jax_params
from test_torch_eval import _run
from test_torch_inference import match_dets
from test_torch_models import NUM_CLASSES
from test_torch_rotated_infer import SODAA_TEST
from test_torch_rotated_models import IMG, random_rotated_flax_params
from torch_port_env import port_test_module  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/point_teacher/sodaa_point_teacher_1x.py")
MAP_TOL = 1e-6
MODEL_TOL = 1e-4   # forward in f32 by two libraries (test_torch_rotated_models' bound)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: beside the other test workers, a thread a core
    oversubscribes the CPU and slows the rotated class NMS many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
TEST = dict(nms_pre=2000, max_per_img=2000, **SODAA_TEST)   # config_sodaa().test


def _rboxes(r, n, lo=0.0, hi=100.0, side=(4.0, 30.0)):
    return np.concatenate([r.uniform(lo, hi, (n, 2)), r.uniform(*side, (n, 2)),
                           r.uniform(-np.pi / 2, np.pi / 2, (n, 1))], -1).astype(np.float32)


def _quads(r, n):
    """Rotated rectangles' corners with some noise: general quads."""
    poly = jgeo.obb2poly_np(_rboxes(r, n, 10, 90, (4, 40)).astype(np.float64))
    return (poly + r.uniform(-1, 1, poly.shape)).reshape(n, 8).astype(np.float32)


@pytest.mark.parametrize("fn", ["obb2poly", "poly2obb", "rbox_iou", "nms_rotated", "native"])
def test_rgeometry_and_native_copies_match_jax(fn):
    r = np.random.RandomState(["obb2poly", "poly2obb", "rbox_iou", "nms_rotated",
                               "native"].index(fn))
    a, b = _rboxes(r, 40), _rboxes(r, 25)
    scores = r.uniform(0, 1, 40).astype(np.float32)
    if fn == "obb2poly":
        np.testing.assert_array_equal(pgeo.obb2poly_np(a), jgeo.obb2poly_np(a))
    elif fn == "poly2obb":
        for q in list(_quads(r, 30)) + [np.zeros(4, np.float32), np.zeros(8, np.float32)]:
            assert pgeo.poly2obb_np(q) == jgeo.poly2obb_np(q)
    elif fn == "rbox_iou":
        want = jgeo.rbox_iou_np(a, b)
        np.testing.assert_array_equal(pgeo.rbox_iou_np(a, b), want)
        assert 0 < (want > 0).mean() < 1
    elif fn == "nms_rotated":
        want = jgeo.nms_rotated_np(a, scores, 0.1)
        np.testing.assert_array_equal(pgeo.nms_rotated_np(a, scores, 0.1), want)
        assert 0 < len(want) < len(a)
    else:   # native where ccore/libptteval.so is built, else the numpy versions
        assert pnative.available() == jnative.available()
        np.testing.assert_array_equal(pnative.rbox_iou(a, b), jnative.rbox_iou(a, b))
        np.testing.assert_array_equal(pnative.nms_rotated(a, scores, 0.5),
                                      jnative.nms_rotated(a, scores, 0.5))


def test_patch_copy_matches_jax():
    for w, h, sizes, gaps in ((2000, 2000, (1200,), (200,)), (100, 80, (64,), (16,)),
                              (50, 300, (64, 32), (16, 8)), (1200, 1200, (1200,), (200,))):
        assert ppatch.compute_windows(w, h, sizes, gaps) == jpatch.compute_windows(w, h, sizes,
                                                                                  gaps)
    img = np.random.RandomState(0).randint(0, 255, (80, 100, 3)).astype(np.uint8)
    got, want = ppatch.split_image(img, (64,), (16,)), jpatch.split_image(img, (64,), (16,))
    assert [o for _, o in got] == [o for _, o in want] == [(0, 0), (36, 0), (0, 16), (36, 16)]
    for (g, _), (x, _) in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert ppatch.patch_name("P0001.png", 1200, 800, 0) == jpatch.patch_name(
        "P0001.png", 1200, 800, 0) == "P0001__1200__800___0.jpg"


def _patch_dets(r, n_cls):
    out = []
    for _ in range(4):
        k = r.randint(0, 30)
        out.append((_rboxes(r, k, 0, 64, (4, 20)), r.uniform(0, 1, k).astype(np.float32),
                    r.randint(0, n_cls, k)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_sodaa_merge_and_evaluate_match_jax(seed):
    """Four overlapping 64 px patches of two images merged (per-class rotated
    NMS at 0.5 across patches), then scored: the JAX package's values
    exactly, every stat and class."""
    r = np.random.RandomState(seed)
    names = [f"im{i}__64__{x}___{y}.jpg" for i in range(2) for x, y in ((0, 0), (36, 16))]
    dets = _patch_dets(r, 3)
    dets[1] = (np.concatenate([dets[1][0], dets[0][0] - [36, 16, 0, 0, 0]]).astype(np.float32),
               np.concatenate([dets[1][1], dets[0][1] * 0.9]).astype(np.float32),
               np.concatenate([dets[1][2], dets[0][2]]))   # the same objects seen twice
    assert psodaa.parse_patch_name(names[1]) == jsodaa.parse_patch_name(names[1]) == (
        "im0", 36, 16)
    got = psodaa.merge_patch_detections(names, dets, 3)
    want = jsodaa.merge_patch_detections(names, dets, 3)
    assert got.keys() == want.keys() == {"im0", "im1"}
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)
    assert len(got["im0"][0]) < len(dets[0][0]) + len(dets[1][0])   # duplicates merged
    annotations = []
    for k in ("im0", "im1"):   # GTs: some detections jittered, some missed objects
        b, s, l = got[k]
        pick = r.rand(len(b)) < 0.5
        gb = b[pick] + r.uniform(-1, 1, (int(pick.sum()), 5)) * [1, 1, 1, 1, 0.05]
        gb = np.concatenate([gb, _rboxes(r, 3, 0, 100, (4, 40))]).astype(np.float32)
        annotations.append(dict(boxes=gb, labels=np.concatenate([l[pick], r.randint(0, 3, 3)])))
    gt = dict(img_ids=["im0.jpg", "im1.jpg"], classes=["a", "b", "c"], annotations=annotations)
    merged = [got["im0"], got["im1"]]
    want_stats = jsodaa.sodaa_evaluate(gt, merged)
    assert psodaa.sodaa_evaluate(gt, merged) == want_stats
    assert psodaa.SODAA_AREA_RNGS == jsodaa.SODAA_AREA_RNGS
    assert 0 < want_stats["AP"] < 1


def _write_json(path, polys, labels):
    with open(path, "w") as f:
        json.dump(dict(annotations=[dict(poly=[float(v) for v in p], category_id=int(c))
                                    for p, c in zip(polys, labels)]), f)


@pytest.fixture
def sodaa_dir(tmp_path):
    """A SODA-A layout in the divData / rawData form: one 100 x 80 original
    image with 8 rotated GTs of 8-16 px, split by data/patch.py into four
    64 px patches (PNG pixels under the .jpg names the dataset expects),
    each patch's json with the GTs whose centre lies inside it, translated;
    one patch holds none (filter_empty drops it from the eval)."""
    r = np.random.RandomState(9)
    img = r.randint(0, 255, (80, 100, 3)).astype(np.uint8)
    gts = np.concatenate([r.uniform(6, 94, (8, 1)), r.uniform(6, 74, (8, 1)),
                          r.uniform(8, 16, (8, 2)), r.uniform(-1.5, 1.5, (8, 1))], -1)
    # none in the left-bottom patch (x < 64, y >= 16)
    gts[:, 1] = np.where(gts[:, 0] < 64, r.uniform(6, 14, 8), gts[:, 1])
    labels = r.randint(0, NUM_CLASSES, 8)
    dirs = {k: tmp_path / k for k in ("ann", "img", "ori")}
    for d in dirs.values():
        d.mkdir()
    _write_json(dirs["ori"] / "scene.json", jgeo.obb2poly_np(gts).reshape(-1, 8), labels)
    for patch, (x0, y0) in ppatch.split_image(img, (64,), (16,)):
        name = ppatch.patch_name("scene.png", 64, x0, y0)
        Image.fromarray(patch).save(dirs["img"] / name, format="PNG")
        h, w = patch.shape[:2]
        inside = ((gts[:, 0] >= x0) & (gts[:, 0] < x0 + w) & (gts[:, 1] >= y0)
                  & (gts[:, 1] < y0 + h))
        local = gts[inside] - [x0, y0, 0, 0, 0]
        _write_json(dirs["ann"] / name.replace(".jpg", ".json"),
                    jgeo.obb2poly_np(local).reshape(-1, 8), labels[inside])
    (dirs["ann"] / "blank.json").write_text("")
    return dict(val_ann=str(dirs["ann"]), val_img_prefix=str(dirs["img"]),
                ori_val_ann=str(dirs["ori"]),
                img_norm=load_config(CONFIG)["dataset"]["img_norm"])


def test_sodaa_dataset_matches_jax(sodaa_dir, tmp_path):
    extra = tmp_path / "ann" / "zz__64__0___0.json"   # a 5-corner polygon is neglected
    _write_json(extra, [np.arange(10.0)], [1])
    for filter_empty in (True, False):
        got = pdata.SODAADataset(sodaa_dir["val_ann"], sodaa_dir["val_img_prefix"],
                                 ori_ann_folder=sodaa_dir["ori_val_ann"],
                                 filter_empty=filter_empty)
        want = jdata.SODAADataset(sodaa_dir["val_ann"], sodaa_dir["val_img_prefix"],
                                  ori_ann_folder=sodaa_dir["ori_val_ann"],
                                  filter_empty=filter_empty)
        assert len(got) == len(want) == (3 if filter_empty else 5)
        for a, b in zip(got.infos + got.ori_infos, want.infos + want.ori_infos):
            assert a["filename"] == b["filename"]
            np.testing.assert_array_equal(a["boxes"], b["boxes"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
        assert [got.image_path(i) for i in range(len(got))] == [
            want.image_path(i) for i in range(len(want))]
        pg, jg = got.ori_gt(), want.ori_gt()
        assert pg["img_ids"] == jg["img_ids"] == ["scene.jpg"] and pg["classes"] == jg["classes"]
        np.testing.assert_array_equal(pg["annotations"][0]["boxes"], jg["annotations"][0]["boxes"])
    assert pdata.SODAADataset.CLASSES == jdata.SODAADataset.CLASSES
    with pytest.raises(ValueError, match="ori_ann_folder"):
        pdata.SODAADataset(sodaa_dir["val_ann"]).ori_gt()


def _pts():
    common = dict(num_classes=NUM_CLASSES, img_size=IMG, batch_size=2)
    return (PointTeacherConfig(test=InferenceCfg(**TEST), **common),
            JaxPT(test=JaxCfg(**TEST), **common))


@pytest.fixture(scope="module")
def rpair():
    """The small rotated model of test_torch_rotated_models in both packages,
    conditioned so that detections look like the fabricated GTs: the
    classifier bias 0 (most points pass score_thr), the regression bias 0.75
    and kernel x 0.1 (boxes of ~12 px, neighbours 8 px apart overlap by IoU
    ~0.2 and suppress each other at 0.1)."""
    jmodel, params = random_rotated_flax_params()
    params = jax.tree_util.tree_map(np.array, params)
    head = params["params"]["bbox_head"]
    head["conv_cls"]["bias"][:] = 0.0
    head["conv_reg"]["bias"][:] = 0.75
    head["conv_reg"]["kernel"] *= 0.1
    port = StudentRotatedFCOS(num_classes=NUM_CLASSES, dtype=torch.float32)
    load_jax_params(port, params)
    return jmodel, params, port


@pytest.fixture(scope="module")
def jinfer(rpair):
    """JAX's rotated inference of rpair's model with the SODA-A test
    settings: one jit, compiled once a batch shape for the module."""
    return jbuild(rpair[0], JaxCfg(**TEST), IMG)


def test_build_rotated_inference_fn_matches_jax(rpair, jinfer):
    """Two 64 px images, the SODA-A test settings, one rescaled: matched sets
    at the forward's tolerance."""
    jmodel, params, port = rpair
    imgs = np.random.RandomState(8).uniform(0, 255, (2, IMG, IMG, 3)).astype(np.float32)
    sf = np.asarray([[0.8, 0.75, 0.8, 0.75], [1.0, 1.0, 1.0, 1.0]], np.float32)
    want = jinfer(params, imgs, sf)
    got = [x.numpy() for x in build_rotated_inference_fn(InferenceCfg(**TEST), IMG)(
        port, torch.from_numpy(imgs), torch.from_numpy(sf))]
    groups = 0
    for b in range(2):
        assert 10 < int(got[2][b].sum()) < IMG * IMG // 64 * NUM_CLASSES   # some suppressed
        groups += match_dets([x[b] for x in got], [np.asarray(x)[b] for x in want],
                             rtol=MODEL_TOL, tie=MODEL_TOL, atol=1e-3, width=5)
    print(f"score tie groups {groups}")


@pytest.mark.parametrize("branch", ["synthetic", "patches"])
def test_evaluate_detector_rotated_matches_jax(rpair, jinfer, sodaa_dir, branch):
    """The same weights through both runners: every stat within MAP_TOL; the
    port's headline is stats["AP"], where JAX's is 0.0 (its runner reads a
    "mAP" key that sodaa_evaluate never writes)."""
    jmodel, params, port = rpair
    ppt, jpt = _pts()
    cfg = dict(dataset=sodaa_dir)
    n = 4 if branch == "synthetic" else 0
    want_ap, want = jrunner.evaluate_detector(jinfer, params, jpt, cfg, rotated=True,
                                              synthetic_n=n, quiet=True)
    got_ap, got = prunner.evaluate_detector(prunner.build_infer(ppt, rotated=True), port, ppt,
                                            cfg, rotated=True, synthetic_n=n, quiet=True)
    assert want_ap == 0.0 and "mAP" not in want
    assert got_ap == got["AP"]
    assert got.keys() == want.keys()
    for k in want:
        if k == "per_class":
            assert got[k].keys() == want[k].keys()
            for c in want[k]:
                assert abs(got[k][c] - want[k][c]) <= MAP_TOL, c
        else:
            assert abs(got[k] - want[k]) <= MAP_TOL, k
    print(f"{branch}: AP {got['AP']:.6f}, AP_50 {got['AP_50']:.6f}, "
          f"AR@20000 {got['AR@20000']:.6f}")
    assert got["AR@20000"] > 0


def test_inference_detector_rotated_matches_jax(rpair, jinfer):
    """A 52 x 64 image through each package's rotated Detector: per-class
    [K, 6] arrays, the same detections (boxes and scores within the
    forward's tolerance); TTA raises in both."""
    jmodel, params, port = rpair
    classes = jdata.SODAADataset.CLASSES[:NUM_CLASSES]

    def jinfer_one(p, img, sf):
        """jinfer on the image twice (its compiled batch of 2): each image's
        detections do not depend on the other's."""
        return jinfer(p, np.concatenate([img, img]), np.concatenate([sf, sf]))

    jdet = japis.Detector(jmodel, params, jinfer_one, classes, IMG, rotated=True)
    pdet = papis.Detector(port, build_rotated_inference_fn(InferenceCfg(**TEST), IMG), classes,
                          IMG, InferenceCfg(**TEST), rotated=True)
    img = np.random.RandomState(8).uniform(0, 255, (52, IMG, 3)).astype(np.float32)
    want = japis.inference_detector(jdet, img)
    got = papis.inference_detector(pdet, img)
    assert len(got) == len(want) == NUM_CLASSES
    assert sum(len(g) for g in got) > 10
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[1:] == (6,)
        if len(w):
            lab = np.zeros(len(w), int)
            match_dets((g, lab, np.ones(len(g), bool)), (w, lab, np.ones(len(w), bool)),
                       rtol=MODEL_TOL, tie=MODEL_TOL, atol=1e-3, width=5)
    for api, det in ((japis, jdet), (papis, pdet)):
        with pytest.raises(NotImplementedError, match="HBB"):
            api.inference_detector_tta(det, img)


def test_init_detector_and_config_of_sodaa():
    """init_detector builds the rotated detector with the SODA-A classes and
    the rotated inference; the config's dataset dict is the config file's."""
    det = papis.init_detector(CONFIG, device="cpu")
    assert det.rotated and isinstance(det.model, StudentRotatedFCOS)
    assert det.CLASSES == jdata.SODAADataset.CLASSES and det.img_size == 1200
    assert det.test_cfg == InferenceCfg(nms_pre=2000, max_per_img=2000, **SODAA_TEST)
    assert load_config(CONFIG)["dataset"] == jconfig_io.load_config(CONFIG)["dataset"]


def test_cli_train_checkpoint_test_chain_rotated_on_cpu(tmp_path):
    """tools.train --cpu --work-dir on the SODA-A config writes latest.pth;
    tools.test --cpu evaluates its teacher on fabricated images, prints the
    SODA-A table with AP .5:.95 as the last line's headline, and writes
    [K, 7] rows; --tta-scales is refused. One phase-2 step (the phase-1
    step's CLI: test_torch_rotated_cli.py) and nms_pre cut to 16 points (144
    candidates an image): on one thread the rotated class NMS of all 64
    points x 9 classes takes ~25 s."""
    small = ["--cfg-options", "pt.img_size=64", "pt.max_gt=6", "pt.test.nms_pre=16"]
    out = _run(["point_teacher_torch.tools.train", CONFIG, "--cpu", "--synthetic-data", "2",
                "--max-steps", "1", "--work-dir", str(tmp_path), *small, "pt.burn_in_step=-1"])
    path = tmp_path / "latest.pth"
    assert f"saved checkpoint: {tmp_path / 'epoch_1.pth'}" in out and path.exists()
    assert ckpt.load_meta(str(path)) == dict(epoch=1, step=1, num_images=2)
    npz = tmp_path / "dets.npz"
    out = _run(["point_teacher_torch.tools.test", CONFIG, str(path), "--cpu",
                "--synthetic-data", "2", "--out", str(npz), *small])
    assert f"loaded the teacher of {path}" in out
    assert prunner.ROTATED_HEADER in out and "rotated IoU and merge NMS:" in out
    for key in ("AP_50", "AP_eS", "AP_Normal", "AR@20000"):
        assert any(line.split(":")[0].strip() == key for line in out.splitlines()), key
    last = out.strip().splitlines()[-1]
    assert last.startswith("AP .5:.95 ") and last.endswith("on cpu")
    arrays = np.load(npz)
    assert len(arrays.files) == 2 and all(arrays[k].shape[1:] == (7,) for k in arrays.files)
    from point_teacher_torch.tools import test as test_cli

    with pytest.raises(SystemExit, match="HBB path only"):
        test_cli.main([CONFIG, "--cpu", "--tta-scales", "64"])
