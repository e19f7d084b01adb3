"""The port's rotated geometry (point_teacher_torch.ops.rotated) and
rotated_iou_loss against the JAX package, f32 on the CPU: values at rtol
1e-5, gradients against jax.grad at rtol 1e-4, wherever JAX's are finite."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.ops import losses as jl
from point_teacher_tpu.ops import rotated as jr
from point_teacher_torch.ops import losses as tl
from point_teacher_torch.ops import rotated as tr

RTOL, GTOL = 1e-5, 1e-4


def _t(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def _close(got, want, rtol=RTOL, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _random(r, n):
    return np.concatenate([r.uniform(10, 50, (n, 2)), r.uniform(2, 20, (n, 2)),
                           r.uniform(-np.pi / 2, np.pi / 2, (n, 1))], -1).astype(np.float32)


def _axis_aligned(r, n):
    """Boxes at angle 0 on integer centres with even integer sizes: cos and
    sin are exact there, so the corners are bit-equal in both packages and
    touching or degenerate pairs are well defined."""
    return np.concatenate([r.randint(10, 50, (n, 2)), 2 * r.randint(1, 10, (n, 2)),
                           np.zeros((n, 1))], -1).astype(np.float32)


SEEDS = {"random": 11, "identical": 12, "disjoint": 13, "nested": 14, "touching": 15,
         "rotated90": 16, "zero_size": 17}


def _pairs(kind):
    """Aligned pairs [N, 5] x [N, 5] of one geometric kind."""
    r = np.random.RandomState(SEEDS[kind])
    a = _random(r, 12)
    if kind == "random":
        b = a.copy()
        b[:, :2] += r.uniform(-6, 6, (12, 2))
        b[:, 2:4] *= r.uniform(0.6, 1.4, (12, 2))
        b[:, 4] += r.uniform(-0.5, 0.5, 12)
    elif kind == "identical":
        b = a.copy()
    elif kind == "disjoint":
        b = a.copy()
        b[:, 0] += 100.0
    elif kind == "nested":
        b = a.copy()
        b[:, 2:4] *= 0.5
    elif kind == "touching":
        # edge to edge along x (rows 0-5), corner to corner (rows 6-11)
        a = _axis_aligned(r, 12)
        b = a.copy()
        b[:6, 0] += a[:6, 2]
        b[6:, :2] += a[6:, 2:4]
    elif kind == "rotated90":
        b = a.copy()
        b[:, 4] += np.pi / 2
    elif kind == "zero_size":
        # a point (rows 0-3) or a segment (rows 4-7) clipped against a box,
        # and a box clipped against a segment (rows 8-11, axis-aligned)
        b = _random(r, 12)
        b[:8, :2] = a[:8, :2] + r.uniform(-3, 3, (8, 2))
        a[:4, 2:4] = 0.0
        a[4:8, 2] = 0.0
        a[8:] = _axis_aligned(r, 4)
        b[8:] = a[8:]
        b[8:, 2] = 0.0
    return a.astype(np.float32), b.astype(np.float32)


KINDS = ["random", "identical", "disjoint", "nested", "touching", "rotated90", "zero_size"]


@pytest.mark.parametrize("kind", KINDS)
def test_rbox_iou_aligned_and_grad_match_jax(kind):
    a, b = _pairs(kind)
    want = np.asarray(jr.rbox_iou(jnp.asarray(a), jnp.asarray(b), aligned=True))
    ta, tb = _t(a, True), _t(b, True)
    got = tr.rbox_iou(ta, tb, aligned=True)
    _close(got, want, atol=1e-6)
    proj = np.random.RandomState(1).randn(len(a)).astype(np.float32)
    ga, gb = jax.grad(lambda x, y: (jr.rbox_iou(x, y, aligned=True) * proj).sum(),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    (got * _t(proj)).sum().backward()
    for g_, w_ in ((ta.grad, ga), (tb.grad, gb)):
        w_ = np.asarray(w_)
        finite = np.isfinite(w_).all(-1)
        assert finite.any()
        np.testing.assert_allclose(g_.numpy()[finite], w_[finite], rtol=GTOL,
                                   atol=GTOL * max(float(np.abs(w_[finite]).max()), 1e-3))


def test_rbox_iou_pairwise_matches_jax():
    r = np.random.RandomState(2)
    a, b = _random(r, 7), _random(r, 9)
    b[:3] = a[:3]
    want = jr.rbox_iou(jnp.asarray(a), jnp.asarray(b))
    got = tr.rbox_iou(_t(a), _t(b))
    assert tuple(got.shape) == (7, 9)
    _close(got, want, atol=1e-6)
    a2 = np.broadcast_to(a[:, None], (7, 9, 5)).copy()
    b2 = np.broadcast_to(b[None], (7, 9, 5)).copy()
    _close(tr.rbox_intersection_area(_t(a2), _t(b2)),
           jr.rbox_intersection_area(jnp.asarray(a2), jnp.asarray(b2)), atol=1e-4)


def test_obb2poly_obb2xyxy_points_in_rbox_match_jax():
    r = np.random.RandomState(3)
    rb = _random(r, 10)
    _close(tr.obb2poly(_t(rb)), jr.obb2poly(jnp.asarray(rb)), atol=1e-4)
    _close(tr.obb2xyxy(_t(rb)), jr.obb2xyxy(jnp.asarray(rb)), atol=1e-4)
    pts = r.uniform(0, 60, (50, 2)).astype(np.float32)
    pts[:10] = rb[:, :2]        # centres are inside
    np.testing.assert_array_equal(tr.points_in_rbox(_t(pts), _t(rb)).numpy(),
                                  np.asarray(jr.points_in_rbox(jnp.asarray(pts), jnp.asarray(rb))))


def test_norm_angle_le90_matches_jax():
    a = np.array([0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi, 2.0, -2.0, 3 * np.pi / 2, 7.5,
                  -7.5, np.nextafter(np.float32(np.pi / 2), 0)], np.float32)
    got = tr.norm_angle_le90(_t(a)).numpy()
    want = np.asarray(jr.norm_angle_le90(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert (got >= -np.pi / 2 - 1e-6).all() and (got < np.pi / 2 + 1e-6).all()
    # +-pi/2 both land on -pi/2: the floored modulo, not fmod
    np.testing.assert_allclose(got[1:3], [-np.pi / 2, -np.pi / 2], atol=1e-6)


def test_distance_angle_decode_matches_jax():
    r = np.random.RandomState(4)
    pts = r.uniform(0, 64, (30, 2)).astype(np.float32)
    pred = np.concatenate([r.uniform(0, 20, (30, 4)), r.uniform(-3, 3, (30, 1))],
                          -1).astype(np.float32)
    _close(tr.distance_angle_decode(_t(pts), _t(pred)),
           jr.distance_angle_decode(jnp.asarray(pts), jnp.asarray(pred)), atol=1e-4)


def test_rbox_ltrb_targets_matches_jax():
    r = np.random.RandomState(5)
    pts = r.uniform(0, 64, (40, 2)).astype(np.float32)
    rb = _random(r, 6)
    _close(tr.rbox_ltrb_targets(_t(pts), _t(rb)),
           jr.rbox_ltrb_targets(jnp.asarray(pts), jnp.asarray(rb)), atol=1e-4)


@pytest.mark.parametrize("mode", ["log", "linear", "square"])
def test_rotated_iou_loss_and_grad_match_jax(mode):
    a, b = _pairs("random")
    w = np.random.RandomState(6).uniform(0, 1, len(a)).astype(np.float32)
    want, (ga,) = jax.value_and_grad(
        lambda x: jl.rotated_iou_loss(x, jnp.asarray(b), weight=jnp.asarray(w), avg_factor=3.0,
                                      mode=mode), argnums=(0,))(jnp.asarray(a))
    ta = _t(a, True)
    got = tl.rotated_iou_loss(ta, _t(b), weight=_t(w), avg_factor=3.0, mode=mode)
    got.backward()
    _close(got, want)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=GTOL,
                               atol=GTOL * float(np.abs(np.asarray(ga)).max()))



def test_dn_rotated_iou_loss_matches_jax():
    """Random pairs whose prediction lies near its target (IoU 0.3-0.95,
    away from IoU ~0, where -log IoU amplifies the clip's last-bit
    differences: ROADMAP.md queue 3), every box of the 3x3 bank too; the
    three modes, values. JAX's side is one jit of all three (eager JAX
    compiles each of the vmapped bank's primitives on its own, and its
    gradient graph alone takes ~30 s to compile); no training path of
    either package calls this loss."""
    r = np.random.RandomState(16)
    n = 64
    b = np.concatenate([r.uniform(20, 80, (n, 2)), r.uniform(8, 30, (n, 2)),
                        r.uniform(-1.5, 1.5, (n, 1))], -1).astype(np.float32)
    a = b + np.concatenate([r.uniform(-2, 2, (n, 2)), r.uniform(-3, 3, (n, 2)),
                            r.uniform(-0.15, 0.15, (n, 1))], -1).astype(np.float32)
    w = r.uniform(0, 1, n).astype(np.float32)
    modes = ("log", "linear", "square")
    iou, *want = jax.jit(lambda x, y, v: [jr.rbox_iou(x, y, aligned=True)] + [
        jl.dn_rotated_iou_loss(x, y, weight=v, avg_factor=5.0, mode=m) for m in modes])(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    assert 0.3 < float(iou.min()) and float(iou.max()) < 1.0
    for mode, wm in zip(modes, want):
        _close(tl.dn_rotated_iou_loss(_t(a), _t(b), weight=_t(w), avg_factor=5.0, mode=mode), wm)
