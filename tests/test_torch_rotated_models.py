"""The port's rotated detector (point_teacher_torch.models.rotated_detector,
rotated_head and the pytorch-style ResNet) against the JAX StudentRotatedFCOS
at 64 px, f32, from the same random flax params carried over by
load_jax_params; the weight round trip through the JAX package's
load_torch_rotated_detector_into; and the caffe ResNet of the HBB path,
unchanged by the new style."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.models.rotated_detector import StudentRotatedFCOS as JaxRotated
from point_teacher_tpu.utils.torch_port import load_torch_rotated_detector_into
from point_teacher_torch.models.detector import StudentFCOS
from point_teacher_torch.models.resnet import ResNet
from point_teacher_torch.models.rotated_detector import StudentRotatedFCOS
from point_teacher_torch.utils.jax_weights import load_jax_params
from test_torch_models import NUM_CLASSES

IMG = 64
_TRUNC_STD = 0.87962566103423978


def random_rotated_flax_params(seed=0, frozen_stages=-1, num_stages=1):
    """A random flax StudentRotatedFCOS tree drawn with numpy as the flax init
    draws it (lecun-normal kernels truncated at 2 sigma, zero biases, the
    head's normal(0.01) convs and prior biases, unit scales), with random
    FrozenBN statistics and random GroupNorm affines. The structure comes from
    jax.eval_shape of the model's init, which compiles nothing."""
    model = JaxRotated(num_classes=NUM_CLASSES, num_stages=num_stages,
                       frozen_stages=frozen_stages, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((2, 7, 7, 256)),
        method=JaxRotated.init_all))
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
        elif "_gn" in module:
            x = r.uniform(0.5, 1.5, shape) if leaf_name == "scale" else r.randn(*shape) * 0.1
        elif leaf_name == "kernel" and head:
            x = r.randn(*shape) * 0.01
        elif leaf_name == "kernel":
            x = truncated(shape) * np.sqrt(1.0 / np.prod(shape[:-1])) / _TRUNC_STD
        elif leaf_name in ("scale", "scale_angle"):
            x = np.ones(shape)
        else:
            x = np.full(shape, {"conv_cls": -np.log(99.0), "conv_reg": 0.1}.get(
                module, 0.0) if head else 0.0)
        return np.asarray(x, np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    jmodel, params = random_rotated_flax_params()
    port = StudentRotatedFCOS(num_classes=NUM_CLASSES, dtype=torch.float32)
    load_jax_params(port, params)
    return jmodel, params, port


def _close(got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def test_rotated_forward_matches_jax(pair):
    """Backbone (pytorch style) -> FPN -> PSAGG feature, and the rotated
    head's four maps."""
    jmodel, params, port = pair
    img = np.random.RandomState(1).uniform(0, 255, (2, IMG, IMG, 3)).astype(np.float32)
    outs, jf = jmodel.apply(params, jnp.asarray(img))
    with torch.no_grad():
        touts, f = port(torch.from_numpy(img))
    _close(f, jf)
    assert len(touts) == 4
    for got, want in zip(touts, outs):
        _close(got, want)


def test_rotated_head_matches_jax_on_scaled_feature(pair):
    """The head alone, on a feature of unit scale (GroupNorm statistics and
    the angle branch away from the backbone's large activations)."""
    jmodel, params, port = pair
    feat = np.random.RandomState(3).randn(2, IMG // 8, IMG // 8, 256).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(feat), method=lambda m, x: m.head(x))
    with torch.no_grad():
        got = port.head(torch.from_numpy(feat))
    for g, w in zip(got, want):
        _close(g, w)


def test_group_norm_matches_flax_in_bf16():
    """flax GroupNorm(dtype=bfloat16): f32 statistics by the fast variance,
    output cast to bf16. The port's GroupNorm on a bf16 input agrees to the
    last bf16 bit on all but rounding ties."""
    import flax.linen as nn

    from point_teacher_torch.models.rotated_head import GroupNorm

    r = np.random.RandomState(4)
    x = (r.randn(2, 5, 6, 64) * 3 + 1).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    gn = nn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jnp.bfloat16)
    variables = gn.init(jax.random.PRNGKey(0), xb)
    scale = r.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (r.randn(64) * 0.1).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    want = np.asarray(gn.apply(variables, xb).astype(jnp.float32))
    tgn = GroupNorm(32, 64)
    with torch.no_grad():
        tgn.weight.copy_(torch.from_numpy(scale))
        tgn.bias.copy_(torch.from_numpy(bias))
        got = tgn(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    assert np.mean(got != want) < 0.01


@pytest.mark.parametrize("tower", ["regress", "classify"])
def test_rotated_mil_towers_match_jax(pair, tower):
    jmodel, params, port = pair
    roi = np.random.RandomState(2).randn(11, 7, 7, 256).astype(np.float32)
    method = JaxRotated.mil_regress if tower == "regress" else JaxRotated.mil_classify
    want = jmodel.apply(params, jnp.asarray(roi), 0, method=method)
    with torch.no_grad():
        got = getattr(port, f"mil_{tower}")(torch.from_numpy(roi), 0)
    if tower == "regress":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _close(g, w)


def test_rotated_weight_round_trip(pair):
    """flax -> port (load_jax_params) -> flax (load_torch_rotated_detector_into) is exact."""
    _, params, port = pair
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    back = load_torch_rotated_detector_into(zeros, port.state_dict(), num_stages=1)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))


def test_rotated_param_count_and_frozen_stages(pair):
    _, params, _ = pair
    port = StudentRotatedFCOS(num_classes=NUM_CLASSES, frozen_stages=1, dtype=torch.float32)
    n_flax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_flax
    for name, p in port.named_parameters():
        frozen = name.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))
        assert p.requires_grad == (not frozen), name


def test_resnet_styles_and_unchanged_caffe():
    """The HBB detector's backbone stays caffe style (stride on conv1), drawn
    from the seed exactly as a caffe ResNet; pytorch style moves only the
    stride to conv2, from the same draws. (The pytorch-style ResNet is held
    against flax in test_rotated_forward_matches_jax, the caffe one in
    test_torch_models.py.)"""
    import inspect

    assert inspect.signature(StudentFCOS).parameters["backbone_style"].default == "caffe"
    caffe = ResNet(generator=torch.Generator().manual_seed(3))
    pyt = ResNet(generator=torch.Generator().manual_seed(3), style="pytorch")
    for stage in (2, 3, 4):
        first = getattr(caffe, f"layer{stage}")[0]
        assert (first.conv1.stride, first.conv2.stride) == ((2, 2), (1, 1))
        first = getattr(pyt, f"layer{stage}")[0]
        assert (first.conv1.stride, first.conv2.stride) == ((1, 1), (2, 2))
    for (k, a), (k2, b) in zip(caffe.state_dict().items(), pyt.state_dict().items()):
        assert k == k2
        assert torch.equal(a, b), k
    with pytest.raises(ValueError):
        ResNet(style="torch")


@pytest.mark.parametrize("bn_affine_trainable", [True, False])
def test_optimizer_labels_match_jax(pair, bn_affine_trainable):
    """The port's param_label equals the JAX optax label of every leaf of the
    rotated tree (frozen_stages 1): with bn_affine_trainable the BN scale and
    bias outside the stem and layer1 take 'base', their statistics stay
    frozen."""
    from point_teacher_tpu.train.optim import param_label as jax_label
    from point_teacher_torch.train.optim import param_label
    from point_teacher_torch.utils.jax_weights import port_arrays

    _, params, port = pair
    codes = {"base": 0, "bias": 1, "frozen": 2}
    coded = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), codes[jax_label(path, 1, bn_affine_trainable)]),
        params)
    want = {k: int(np.ravel(v)[0]) for k, v in port_arrays(coded).items()}
    got = {name: codes[param_label(name, 1, bn_affine_trainable)]
           for name, _ in port.named_parameters()}
    assert got == want
    trains = [n for n, c in got.items() if c == 0 and ".bn" in n]
    assert bool(trains) == bn_affine_trainable
