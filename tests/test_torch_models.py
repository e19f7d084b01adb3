"""The port's detector (point_teacher_torch.models) against the JAX StudentFCOS
at 64 px, f32, from the same random flax params carried over by
load_jax_params; plus the weight round trip through the JAX package's
load_torch_detector_into."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.models.detector import StudentFCOS as JaxStudent
from point_teacher_tpu.utils.torch_port import load_torch_detector_into
from point_teacher_torch.models.detector import StudentFCOS
from point_teacher_torch.utils.jax_weights import load_jax_params
from torch_port_env import port_test_module  # noqa: F401 (autouse)

NUM_CLASSES, IMG = 4, 64


def random_flax_params(seed=0, frozen_stages=-1, num_stages=1):
    """A random flax StudentFCOS tree drawn with numpy the way the flax init
    draws it (lecun-normal kernels truncated at 2 sigma, zero biases, the FCOS
    head's normal(0.01) convs and prior biases, unit scale), with every
    FrozenBN given random (non-identity) statistics. The structure comes from
    jax.eval_shape of the model's init, which compiles nothing."""
    model = JaxStudent(num_classes=NUM_CLASSES, num_stages=num_stages,
                       frozen_stages=frozen_stages, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((2, 7, 7, 256)),
        method=JaxStudent.init_all))
    r = np.random.RandomState(seed)

    def truncated(shape):
        x = r.randn(*shape)
        while (bad := np.abs(x) > 2).any():
            x[bad] = r.randn(int(bad.sum()))
        return x

    def draw(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        shape, leaf_name, module = leaf.shape, names[-1], names[-2]
        head = "bbox_head" in names
        if any("bn" in n for n in names[:-1]):
            x = {"var": lambda: r.uniform(0.5, 2.0, shape),
                 "scale": lambda: r.uniform(0.5, 1.5, shape)}.get(
                     leaf_name, lambda: r.randn(*shape) * 0.1)()
        elif leaf_name == "kernel" and head:
            x = r.randn(*shape) * 0.01
        elif leaf_name == "kernel":
            x = truncated(shape) * np.sqrt(1.0 / np.prod(shape[:-1])) / 0.87962566103423978
        elif leaf_name == "scale":
            x = np.ones(shape)
        else:
            x = np.full(shape, {"conv_cls": -np.log(99.0), "conv_reg": 0.1}.get(
                module, 0.0) if head else 0.0)
        return np.asarray(x, np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    jmodel, params = random_flax_params()
    port = StudentFCOS(num_classes=NUM_CLASSES, dtype=torch.float32)
    load_jax_params(port, params)
    return jmodel, params, port


def _close(got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def test_dense_forward_matches_jax(pair):
    jmodel, params, port = pair
    img = np.random.RandomState(1).uniform(0, 255, (2, IMG, IMG, 3)).astype(np.float32)
    (jc, jb, jct), jf = jmodel.apply(params, jnp.asarray(img))
    with torch.no_grad():
        (c, b, ct), f = port(torch.from_numpy(img))
    for got, want in ((f, jf), (c, jc), (b, jb), (ct, jct)):
        _close(got, want)


@pytest.mark.parametrize("tower", ["regress", "classify"])
def test_mil_towers_match_jax(pair, tower):
    jmodel, params, port = pair
    roi = np.random.RandomState(2).randn(11, 7, 7, 256).astype(np.float32)
    method = JaxStudent.mil_regress if tower == "regress" else JaxStudent.mil_classify
    want = jmodel.apply(params, jnp.asarray(roi), 0, method=method)
    with torch.no_grad():
        got = getattr(port, f"mil_{tower}")(torch.from_numpy(roi), 0)
    if tower == "regress":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _close(g, w)


def test_weight_round_trip(pair):
    """flax -> port (load_jax_params) -> flax (load_torch_detector_into) is exact."""
    _, params, port = pair
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    back = load_torch_detector_into(zeros, port.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))


def test_frozen_stages_and_param_count(pair):
    _, params, _ = pair
    port = StudentFCOS(num_classes=NUM_CLASSES, frozen_stages=1, dtype=torch.float32)
    n_flax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_flax
    for name, p in port.named_parameters():
        frozen = name.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))
        assert p.requires_grad == (not frozen), name


def test_load_rejects_mismatched_tree(pair):
    _, params, port = pair
    bad = jax.tree_util.tree_map(lambda x: x, params)   # new containers, same leaves
    fc = bad["params"]["mil_head"]["fc_cls0"]
    fc["kernel"] = np.zeros((fc["kernel"].shape[0], NUM_CLASSES + 1), np.float32)
    with pytest.raises(ValueError):
        load_jax_params(port, bad)
    load_jax_params(port, params)   # leave the shared port as the fixture made it
