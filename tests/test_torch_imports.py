"""The port never imports JAX or the JAX package: an AST scan of every module
of point_teacher_torch and of chip_smoke.py."""
import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "point_teacher_tpu")
FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "point_teacher_torch").rglob("*.py"))
FILES.append("chip_smoke.py")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES)
def test_no_jax_imports(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_package():
    assert len(FILES) > 20
    assert "point_teacher_torch/train/steps.py" in FILES


@pytest.mark.parametrize("module", [
    "inference", "apis", "data/__init__", "data/coco", "data/loader", "data/pipeline",
    "evalx/__init__", "evalx/cocoeval", "evalx/native", "evalx/runner",
    "utils/checkpoint", "tools/test",
    "data/sodaa", "data/patch", "evalx/rgeometry", "evalx/sodaa",
    "utils/logging", "utils/torch_port", "train/fcos_baseline", "train/rfla_baseline",
    "ops/tiny_metrics", "core/rfla", "models/rfla_fcos_head", "tools/train",
    "core/hungarian", "utils/visualize", "demo/image_demo", "demo/huge_image_demo",
    "tools/img_split", "tools/analysis_tools/get_flops", "tools/analysis_tools/benchmark",
    "tools/sanity_train", "parallel/__init__", "parallel/dist", "parallel/launch",
    "train/superstep", "utils/device"])
def test_scan_covers_the_eval_modules(module):
    assert f"point_teacher_torch/{module}.py" in FILES
