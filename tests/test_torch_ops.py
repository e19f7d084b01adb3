"""Port box ops and losses (point_teacher_torch.ops) against the JAX package:
the same numpy inputs through both, values and gradients, in f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.ops import boxes as jb
from point_teacher_tpu.ops import losses as jl
from point_teacher_torch.ops import boxes as tb
from point_teacher_torch.ops import losses as tl
from torch_port_env import port_test_module  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6


def _boxes(r, n, lo=0.0, hi=60.0, wh=(2.0, 30.0)):
    xy = r.uniform(lo, hi, (n, 2))
    size = r.uniform(*wh, (n, 2))
    return np.concatenate([xy, xy + size], -1).astype(np.float32)


def _inputs(name, r):
    n = 37
    if name in ("cxcywh_to_xyxy", "xyxy_to_cxcywh"):
        return [_boxes(r, n)]
    if name == "distance2bbox":
        return [r.uniform(0, 64, (n, 2)).astype(np.float32),
                r.uniform(0, 20, (n, 4)).astype(np.float32)]
    if name == "bbox2distance":
        return [r.uniform(0, 64, (n, 2)).astype(np.float32), _boxes(r, n)]
    if name.startswith("overlaps_aligned"):
        return [_boxes(r, n), _boxes(r, n)]
    if name.startswith("overlaps_pairwise"):
        return [_boxes(r, n), _boxes(r, 11)]
    if name in ("sigmoid_focal_loss",):
        return [r.randn(n, 5).astype(np.float32) * 3,
                (r.uniform(size=(n, 5)) < 0.3).astype(np.float32)]
    if name == "focal_loss_from_labels":
        return [r.randn(n, 5).astype(np.float32) * 3, r.randint(0, 6, n).astype(np.int32),
                r.uniform(size=n).astype(np.float32)]
    if name == "binary_cross_entropy":
        return [r.randn(n).astype(np.float32) * 3, r.uniform(size=n).astype(np.float32),
                r.uniform(size=n).astype(np.float32)]
    if name in ("diou_loss", "dn_diou_loss", "dn_diou_loss_base_valid"):
        target = _boxes(r, n)
        pred = (target + r.randn(n, 4) * 3).astype(np.float32)
        return [pred, target, r.uniform(size=n).astype(np.float32),
                r.uniform(size=n) < 0.6]
    if name == "gfocal_loss":
        return [r.uniform(0.01, 0.99, (n, 5)).astype(np.float32),
                (r.uniform(size=(n, 5)) < 0.3).astype(np.float32),
                r.uniform(size=(n, 1)).astype(np.float32)]
    if name == "centerness_target":
        return [r.uniform(0.001, 30, (n, 4)).astype(np.float32)]
    raise KeyError(name)


# name -> (jax fn, torch fn, indices of differentiable float inputs)
CASES = {
    "cxcywh_to_xyxy": (jb.cxcywh_to_xyxy, tb.cxcywh_to_xyxy, (0,)),
    "xyxy_to_cxcywh": (jb.xyxy_to_cxcywh, tb.xyxy_to_cxcywh, (0,)),
    "distance2bbox": (jb.distance2bbox, tb.distance2bbox, (0, 1)),
    "bbox2distance": (jb.bbox2distance, tb.bbox2distance, (0, 1)),
    "overlaps_aligned_iou": (lambda a, b: jb.bbox_overlaps(a, b, is_aligned=True),
                             lambda a, b: tb.bbox_overlaps(a, b, is_aligned=True), (0, 1)),
    "overlaps_pairwise_iou": (jb.bbox_overlaps, tb.bbox_overlaps, (0, 1)),
    "overlaps_pairwise_iof": (lambda a, b: jb.bbox_overlaps(a, b, "iof"),
                              lambda a, b: tb.bbox_overlaps(a, b, "iof"), (0, 1)),
    "sigmoid_focal_loss": (jl.sigmoid_focal_loss, tl.sigmoid_focal_loss, (0,)),
    "focal_loss_from_labels": (
        lambda x, y, w: jl.focal_loss_from_labels(x, y, 5, weight=w, avg_factor=7.0),
        lambda x, y, w: tl.focal_loss_from_labels(x, y, 5, weight=w, avg_factor=7.0), (0,)),
    "binary_cross_entropy": (
        lambda x, t, w: jl.binary_cross_entropy(x, t, weight=w, avg_factor=3.0),
        lambda x, t, w: tl.binary_cross_entropy(x, t, weight=w, avg_factor=3.0), (0,)),
    "diou_loss": (lambda p, t, w, v: jl.diou_loss(p, t, weight=w),
                  lambda p, t, w, v: tl.diou_loss(p, t, weight=w), (0,)),
    "dn_diou_loss": (lambda p, t, w, v: jl.dn_diou_loss(p, t, weight=w, avg_factor=5.0),
                     lambda p, t, w, v: tl.dn_diou_loss(p, t, weight=w, avg_factor=5.0), (0,)),
    "dn_diou_loss_base_valid": (
        lambda p, t, w, v: jl.dn_diou_loss(p, t, weight=w, avg_factor=5.0, hyper=0.1,
                                           base_valid=v),
        lambda p, t, w, v: tl.dn_diou_loss(p, t, weight=w, avg_factor=5.0, hyper=0.1,
                                           base_valid=v), (0,)),
    "gfocal_loss": (jl.gfocal_loss, tl.gfocal_loss, (0,)),
    "centerness_target": (jl.centerness_target, tl.centerness_target, ()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    jfn, tfn, diff = CASES[name]
    r = np.random.RandomState(sorted(CASES).index(name))
    xs = _inputs(name, r)
    want = np.asarray(jfn(*[jnp.asarray(x) for x in xs]))
    tx = [torch.tensor(x, requires_grad=(i in diff)) for i, x in enumerate(xs)]
    got = tfn(*tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    if not diff:
        return
    # gradients of a random projection of the output
    proj = np.asarray(r.randn(*want.shape), dtype=np.float32)

    def jloss(*args):
        return (jfn(*args) * proj).sum()

    jgrads = jax.grad(jloss, argnums=diff)(*[jnp.asarray(x) for x in xs])
    (got * torch.from_numpy(proj)).sum().backward()
    for i, jg in zip(diff, jgrads):
        np.testing.assert_allclose(tx[i].grad.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)


def test_grid_points_matches_jax():
    np.testing.assert_array_equal(tb.grid_points(5, 7, 8).numpy(),
                                  np.asarray(jb.grid_points(5, 7, 8)))


def test_weight_reduce_modes():
    r = np.random.RandomState(3)
    x = r.randn(9).astype(np.float32)
    w = r.uniform(size=9).astype(np.float32)
    for kw in (dict(), dict(avg_factor=4.0)):
        want = np.asarray(jl.weight_reduce(jnp.asarray(x), jnp.asarray(w), **kw))
        got = tl.weight_reduce(torch.from_numpy(x), torch.from_numpy(w), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
