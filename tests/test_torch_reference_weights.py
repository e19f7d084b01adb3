"""The port's reference-weight loaders (point_teacher_torch.utils.torch_port)
against the JAX package's (point_teacher_tpu.utils.torch_port followed by
utils/jax_weights.py port_arrays), on fabricated files in the reference
layouts: a teacher-student checkpoint (HBB and rotated; both branches; the
dead keys the reference carries: fc_iou, shared_fcs, shared_fcs_refine, BN
num_batches_tracked) and a bare detector state dict, and a torchvision-layout
ResNet-50. Both sides must give the same arrays bit for bit; a missing key
or a wrong shape raises on both."""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.models.detector import StudentFCOS as JaxStudent
from point_teacher_tpu.models.rotated_detector import StudentRotatedFCOS as JaxRotated
from point_teacher_tpu.utils import torch_port as jport
from point_teacher_torch.models.detector import StudentFCOS
from point_teacher_torch.models.rotated_detector import StudentRotatedFCOS
from point_teacher_torch.utils import torch_port as pport
from point_teacher_torch.utils.jax_weights import port_arrays
from test_torch_models import NUM_CLASSES
from torch_port_env import port_test_module  # noqa: F401 (autouse)

STAGES = {False: 1, True: 2}   # the HBB and the SODA-A configs' MIL stages


def _port_model(rotated, num_stages):
    cls = StudentRotatedFCOS if rotated else StudentFCOS
    return cls(num_classes=NUM_CLASSES, num_stages=num_stages, dtype=torch.float32, seed=1)


def _flax_template(rotated):
    """A zero flax tree of the detector (every leaf of it the loaders fill);
    the structure from jax.eval_shape of its init, which compiles nothing."""
    cls = JaxRotated if rotated else JaxStudent
    model = cls(num_classes=NUM_CLASSES, num_stages=STAGES[rotated], dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((2, 7, 7, 256)),
        method=cls.init_all))
    return jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), shapes)


def _random_sd(model, seed):
    """The model's state dict with every tensor drawn anew: a reference
    detector's weights under the reference's keys."""
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}


def _dead_keys(prefix):
    """Keys a reference checkpoint carries that neither loader reads."""
    return {f"{prefix}bbox_head.fc_iou.0.weight": torch.ones(1, 1024),
            f"{prefix}bbox_head.shared_fcs.0.weight": torch.ones(2, 3),
            f"{prefix}bbox_head.shared_fcs_refine.0.bias": torch.ones(2),
            f"{prefix}backbone.bn1.num_batches_tracked": torch.tensor(5),
            f"{prefix}backbone.layer1.0.bn2.num_batches_tracked": torch.tensor(5)}


@pytest.fixture(scope="module")
def templates():
    return {rotated: _flax_template(rotated) for rotated in (False, True)}


@pytest.fixture(scope="module")
def models():
    """One port detector a fork, which each TS load overwrites whole."""
    return {rotated: _port_model(rotated, STAGES[rotated]) for rotated in (False, True)}


@pytest.fixture(scope="module")
def ts_files(tmp_path_factory, models):
    """Per fork: a teacher-student checkpoint ({"state_dict": ..., "meta":
    ...}) and a bare detector state dict, with their source weights."""
    root = tmp_path_factory.mktemp("ref")
    out = {}
    for rotated, model in models.items():
        stages = STAGES[rotated]
        branches = {b: _random_sd(model, 10 * stages + i)
                    for i, b in enumerate(("teacher", "student"))}
        sd = {f"{b}.{k}": v for b, w in branches.items() for k, v in w.items()}
        sd.update(_dead_keys("teacher."), **_dead_keys("student."))
        ts = root / f"ts_{rotated}.pth"
        torch.save({"state_dict": sd, "meta": {"epoch": 12, "iter": 123}}, ts)
        bare = root / f"bare_{rotated}.pth"
        torch.save({**branches["teacher"], **_dead_keys("")}, bare)
        out[rotated] = dict(ts=str(ts), bare=str(bare), weights=branches, stages=stages)
    yield out
    for f in out.values():   # ~0.3-0.7 GB each
        os.remove(f["ts"])
        os.remove(f["bare"])


def _assert_same(port_model, flax_params, stages):
    want = port_arrays(flax_params, stages)
    got = port_model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("rotated", [False, True], ids=["hbb", "rotated"])
@pytest.mark.parametrize("branch", ["teacher", "student"])
def test_ts_checkpoint_matches_jax(templates, models, ts_files, rotated, branch):
    f = ts_files[rotated]
    jparams = jport.load_reference_ts_checkpoint(templates[rotated], f["ts"], branch=branch,
                                                 rotated=rotated, num_stages=f["stages"])
    model = pport.load_reference_ts_checkpoint(models[rotated], f["ts"], branch,
                                               rotated=rotated, num_stages=f["stages"])
    _assert_same(model, jparams, f["stages"])
    for k, v in f["weights"][branch].items():   # the file's own weights, untransposed
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("rotated", [False, True], ids=["hbb", "rotated"])
def test_bare_state_dict_matches_jax_with_a_warning(templates, models, ts_files, rotated):
    f = ts_files[rotated]
    with pytest.warns(UserWarning, match="bare"):
        jparams = jport.load_reference_ts_checkpoint(templates[rotated], f["bare"],
                                                     rotated=rotated, num_stages=f["stages"])
    with pytest.warns(UserWarning, match="bare"):
        model = pport.load_reference_ts_checkpoint(models[rotated], f["bare"], rotated=rotated,
                                                   num_stages=f["stages"])
    _assert_same(model, jparams, f["stages"])


def _broken(tmp_path, f, how):
    """The teacher branch of the fixture's file, one key removed or cut."""
    sd = {f"teacher.{k}": v for k, v in f["weights"]["teacher"].items()}
    key = "teacher.bbox_head.conv_cls.weight"
    if how == "missing":
        del sd[key]
    else:
        sd[key] = sd[key][:, :-1]
    path = tmp_path / f"{how}.pth"
    torch.save({"state_dict": sd}, path)
    return str(path)


@pytest.mark.parametrize("how", ["missing", "shape"])
def test_broken_checkpoint_raises_on_both(templates, models, ts_files, tmp_path, how):
    f = ts_files[False]
    path = _broken(tmp_path, f, how)
    with pytest.raises((KeyError, AssertionError)):
        jport.load_reference_ts_checkpoint(templates[False], path, num_stages=1)
    with pytest.raises(KeyError if how == "missing" else ValueError, match="conv_cls"):
        pport.load_reference_ts_checkpoint(models[False], path, num_stages=1)
    os.remove(path)


def test_no_branch_and_no_backbone_raises(models, tmp_path):
    path = tmp_path / "other.pth"
    torch.save({"state_dict": {"head.weight": torch.ones(2)}}, path)
    with pytest.raises(KeyError, match="teacher"):
        jport.load_reference_ts_checkpoint({}, str(path))
    with pytest.raises(KeyError, match="teacher"):
        pport.load_reference_ts_checkpoint(models[False], str(path))


def test_pickled_checkpoint_needs_the_opt_in(models, tmp_path):
    """weights_only=True refuses a file that holds a python object; the
    caller opts in with allow_pickle."""
    model = models[False]
    sd = {f"teacher.{k}": v for k, v in _random_sd(model, 7).items()}
    path = tmp_path / "pickled.pth"
    torch.save({"state_dict": sd, "meta": {"hook": warnings.WarningMessage}}, path)
    with pytest.raises(Exception):
        pport.load_reference_ts_checkpoint(model, str(path))
    pport.load_reference_ts_checkpoint(model, str(path), allow_pickle=True)
    assert torch.equal(model.bbox_head.conv_cls.weight, sd["teacher.bbox_head.conv_cls.weight"])
    os.remove(path)


@pytest.mark.parametrize("prefixed", [False, True], ids=["torchvision", "backbone_prefix"])
def test_resnet50_matches_jax(templates, models, tmp_path, prefixed):
    """A torchvision-layout ResNet-50 (with its fc classifier and the BN
    num_batches_tracked) into the backbone; the rest of the model stays."""
    model = models[False]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(4)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in model.backbone.state_dict().items()}
    sd.update({"fc.weight": torch.ones(1000, 2048), "fc.bias": torch.ones(1000),
               "bn1.num_batches_tracked": torch.tensor(3)})
    if prefixed:
        sd = {f"backbone.{k}": v for k, v in sd.items()}
    path = tmp_path / "r50.pth"
    torch.save(sd, path)
    jparams = jport.load_torch_resnet50_into(templates[False], str(path))
    pport.load_torch_resnet50_into(model, str(path))
    want = port_arrays(jparams, 1)
    for k, v in model.state_dict().items():
        if k.startswith("backbone."):
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k], np.float32), err_msg=k)
        else:
            assert torch.equal(v, before[k]), k
    del sd[("backbone." if prefixed else "") + "layer2.1.conv2.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError):
        jport.load_torch_resnet50_into(templates[False], str(path))
    with pytest.raises(KeyError, match="layer2.1.conv2.weight"):
        pport.load_torch_resnet50_into(model, str(path))


def test_loader_checks_fork_and_stages(models):
    with pytest.raises(ValueError, match="rotated"):
        pport.load_reference_ts_checkpoint(models[False], "unused.pth", rotated=True)
    with pytest.raises(ValueError, match="num_stages"):
        pport.load_reference_ts_checkpoint(models[True], "unused.pth", rotated=True,
                                           num_stages=1)
