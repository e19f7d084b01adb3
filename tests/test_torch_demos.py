"""The port's demos and host tools on the CPU: tools.img_split writes the
files of the root tools/img_split.py byte for byte (run as a subprocess);
demo.image_demo (--out, --out-img) and demo.huge_image_demo (a 900 x 700
image: two 800 px patches) agree with apis.inference_detector and
evalx/sodaa.py merge_patch_detections called directly; get_flops prints
the parameter count of the JAX package's init (utils/jax_weights.py
port_arrays); the FPS tool prints its line. The configs are cut to a 64 px
canvas and their seeded inits made dense (every candidate passes
score_thr), in this process, on one torch thread."""
import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from point_teacher_torch import apis, config_io
from point_teacher_torch.data.patch import patch_name, split_image
from point_teacher_torch.data.pipeline import load_image
from point_teacher_torch.demo import huge_image_demo, image_demo
from point_teacher_torch.evalx.sodaa import merge_patch_detections
from point_teacher_torch.tools import img_split
from point_teacher_torch.tools import train as cli
from point_teacher_torch.tools.analysis_tools import benchmark, get_flops
from point_teacher_torch.tools.profile_step import make_dense
from point_teacher_torch.utils.jax_weights import port_arrays
from point_teacher_torch.utils.visualize import imshow_det_bboxes
from point_teacher_tpu.models.detector import StudentFCOS as JaxStudent
from test_torch_fcos_baseline import one_thread
from torch_port_env import port_test_module  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBB = os.path.join(REPO, "configs/point_teacher/aitodv2_point_teacher_0.py")
SODAA = os.path.join(REPO, "configs/point_teacher/sodaa_point_teacher_1x.py")
SMALL = ["pt.img_size=64", "pt.test.nms_pre=40", "pt.test.max_per_img=40"]


@pytest.fixture
def small_dense(monkeypatch):
    """Every config at a 64 px canvas with few candidates, every model dense."""
    load, build = config_io.load_config, cli.build_model
    monkeypatch.setattr(config_io, "load_config",
                        lambda path: config_io.apply_overrides(load(path), SMALL))

    def dense(*args, **kw):
        model = build(*args, **kw)
        make_dense(model)
        return model

    monkeypatch.setattr(cli, "build_model", dense)


def run(main, argv):
    """main(argv) on one torch thread; returns (its result, its stdout)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = one_thread(lambda: main(argv))
    return result, out.getvalue()


def _write_split_input(root):
    r = np.random.RandomState(4)
    img_dir, ann_dir = root / "img", root / "ann"
    img_dir.mkdir()
    ann_dir.mkdir()
    for stem, (h, w), ext in (("scene_a", (150, 170), ".png"), ("scene_b", (90, 100), ".jpg")):
        Image.fromarray(r.randint(0, 255, (h, w, 3), np.uint8)).save(img_dir / (stem + ext))
        anns = []
        for _ in range(9):
            c = r.uniform([5, 5], [w - 5, h - 5])
            poly = c + r.uniform(-6, 6, (4, 2))
            anns.append(dict(poly=[float(v) for v in poly.reshape(-1)],
                             category_id=int(r.randint(1, 10))))
        (ann_dir / f"{stem}.json").write_text(json.dumps(dict(annotations=anns)))
    (ann_dir / "no_image.json").write_text(json.dumps(dict(annotations=[])))
    return img_dir, ann_dir


def test_img_split_writes_the_root_tools_files(tmp_path):
    img_dir, ann_dir = _write_split_input(tmp_path)
    flags = ["--img-dir", str(img_dir), "--ann-dir", str(ann_dir), "--sizes", "64", "--gaps",
             "16"]
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools/img_split.py"), *flags,
                           "--out-img-dir", str(tmp_path / "jax_img"), "--out-ann-dir",
                           str(tmp_path / "jax_ann")], capture_output=True, text=True,
                          cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, out = run(img_split.main, [*flags, "--out-img-dir", str(tmp_path / "img_out"),
                                  "--out-ann-dir", str(tmp_path / "ann_out")])
    assert out == proc.stdout and n == 16 and "skip no_image: no image" in out
    for mine, theirs in (("img_out", "jax_img"), ("ann_out", "jax_ann")):
        names = sorted(os.listdir(tmp_path / theirs))
        assert sorted(os.listdir(tmp_path / mine)) == names and len(names) == n
        for name in names:
            assert (tmp_path / mine / name).read_bytes() == (tmp_path / theirs / name).read_bytes()


def test_image_demo_agrees_with_inference_detector(small_dense, tmp_path):
    r = np.random.RandomState(5)
    path = tmp_path / "img.png"
    Image.fromarray(r.randint(0, 255, (52, 70, 3), np.uint8)).save(path)
    npz, drawn = tmp_path / "dets.npz", tmp_path / "drawn.jpg"
    results, out = run(image_demo.main, [str(path), HBB, "--cpu", "--out", str(npz),
                                         "--out-img", str(drawn)])
    det = one_thread(lambda: apis.init_detector(HBB, device="cpu"))
    want = one_thread(lambda: apis.inference_detector(det, str(path)))
    assert len(results) == len(want) == 8
    for got, ref in zip(results, want):
        np.testing.assert_array_equal(got, ref)
    saved = np.load(npz)
    assert list(saved) == list(det.CLASSES)
    for c, ref in zip(det.CLASSES, want):
        np.testing.assert_array_equal(saved[c], ref)
    n_shown = sum(int((r_[:, -1] >= 0.3).sum()) for r_ in want)
    assert n_shown > 0 and out.count("score=") == n_shown
    boxes = np.concatenate([r_[:, :-1] for r_ in want])
    labels = np.concatenate([np.full(len(r_), i) for i, r_ in enumerate(want)])
    scores = np.concatenate([r_[:, -1] for r_ in want])
    imshow_det_bboxes(load_image(str(path)), boxes, labels, scores, class_names=det.CLASSES,
                      score_thr=0.3, out_file=str(tmp_path / "want.jpg"))
    assert drawn.read_bytes() == (tmp_path / "want.jpg").read_bytes()


def test_huge_image_demo_agrees_with_patches_merged_directly(small_dense, tmp_path):
    r = np.random.RandomState(6)
    path = tmp_path / "huge.png"
    Image.fromarray(r.randint(0, 255, (700, 900, 3), np.uint8)).save(path)
    (rb, sc, lb), out = run(huge_image_demo.main, [str(path), SODAA, "--cpu"])
    det = one_thread(lambda: apis.init_detector(SODAA, device="cpu"))
    patches = split_image(load_image(str(path)), (800,), (200,))
    assert [xy for _, xy in patches] == [(0, 0), (100, 0)]
    names, dets = [], []
    for patch, (x0, y0) in patches:
        per_class = one_thread(lambda: apis.inference_detector(det, patch))
        dets.append((np.concatenate([p[:, :-1] for p in per_class]),
                     np.concatenate([p[:, -1] for p in per_class]),
                     np.concatenate([np.full(len(p), c) for c, p in enumerate(per_class)])))
        names.append(patch_name("huge.png", 800, x0, y0))
    (want_rb, want_sc, want_lb), = merge_patch_detections(names, dets, 9).values()
    np.testing.assert_array_equal(rb, want_rb)
    np.testing.assert_array_equal(sc, want_sc)
    np.testing.assert_array_equal(lb, want_lb)
    n = int((want_sc >= 0.3).sum())
    assert n > 0 and f"{n} detections above 0.3:" in out and out.count("score=") == n


def test_get_flops_counts_the_jax_init_parameters():
    model = JaxStudent(num_classes=8, num_stages=1, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 7, 7, 256)),
        method=JaxStudent.init_all))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = sum(a.size for a in port_arrays(zeros).values())
    (flops, n_params), out = run(get_flops.main, [HBB, "--cpu", "--shape", "64"])
    assert n_params == want and f"({want})" in out
    assert flops > 0 and "Flops: " in out


def test_benchmark_prints_its_line(small_dense):
    fps, out = run(benchmark.main, [HBB, "--cpu", "--warmup", "0", "--iters", "1"])
    assert fps > 0
    assert "Overall fps: " in out and "batch 1, 64px) on cpu" in out


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((image_demo.main, ["x.png", HBB]), (huge_image_demo.main, ["x.png", SODAA]),
                       (get_flops.main, [HBB]), (benchmark.main, [HBB])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
