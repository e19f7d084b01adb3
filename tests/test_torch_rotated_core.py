"""The port's rotated core (point_teacher_torch.core.rpseudo, rtargets,
raugment) and the rotated dense losses (train.rdense_losses) against the
JAX package, f32 on the CPU, with the JAX random draws injected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.core import raugment as jra
from point_teacher_tpu.core import rpseudo as jrp
from point_teacher_tpu.core import rtargets as jrt
from point_teacher_tpu.core.pseudo import FuseAssignerCfg
from point_teacher_tpu.core.targets import AssignerCfg
from point_teacher_tpu.ops.boxes import grid_points
from point_teacher_tpu.train import rdense_losses as jrd
from point_teacher_torch.core import pseudo as tps
from point_teacher_torch.core import raugment as tra
from point_teacher_torch.core import rpseudo as trp
from point_teacher_torch.core import rtargets as trt
from point_teacher_torch.core import targets as tt
from point_teacher_torch.train import rdense_losses as trd

IMG, STRIDE, G, C, B = 64, 8, 6, 4, 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _rboxes(r, lead, lo=8, hi=IMG - 8, wh=(4, 16)):
    cxy = r.uniform(lo, hi, lead + (2,))
    size = r.uniform(*wh, lead + (2,))
    ang = r.uniform(-np.pi / 2, np.pi / 2, lead + (1,))
    return np.concatenate([cxy, size, ang], -1).astype(np.float32)


def _scene(seed):
    r = np.random.RandomState(seed)
    rb = _rboxes(r, (G,))
    points = np.asarray(grid_points(IMG // STRIDE, IMG // STRIDE, STRIDE))
    p = points.shape[0]
    return dict(
        r=r, rboxes=rb, points=points,
        gt_points=(rb[:, :2] + r.uniform(-2, 2, (G, 2))).astype(np.float32),
        labels=r.randint(0, C, G).astype(np.int32),
        valid=np.array([True] * (G - 2) + [False, True]),
        logits=(r.randn(p, C) * 2).astype(np.float32),
        pred5=np.concatenate([r.uniform(0, 20, (p, 4)), r.uniform(-1.5, 1.5, (p, 1))],
                             -1).astype(np.float32),
    )


def test_generate_pseudo_rboxes_matches_jax():
    s = _scene(2)
    cfg = FuseAssignerCfg(num_pre=5, topk=3)
    args = (s["points"], s["logits"], s["pred5"], s["gt_points"], s["labels"], s["valid"],
            s["rboxes"])
    want = jrp.generate_pseudo_rboxes(*args, 0.0, cfg)
    got = trp.generate_pseudo_rboxes(*[_t(a) for a in args], 0.0, tps.FuseAssignerCfg(*cfg))
    for k in ("pseudo_valid", "matched", "pseudo_labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert not np.asarray(want["matched"]).all() or np.asarray(want["matched"]).any()
    for k in ("pseudo_boxes", "pseudo_points", "mean_iou"):
        _close(got[k], want[k], atol=1e-4)


def test_pseudo_targets_rotated_equal():
    s = _scene(1)
    pv = s["valid"] & (s["r"].uniform(size=G) < 0.8)
    args = (s["points"], s["logits"], s["gt_points"], s["labels"], s["valid"], s["rboxes"], pv)
    cfg_cls = AssignerCfg(num_pre=1, topk=1, cls_weight=1.0)
    cfg_reg = AssignerCfg(num_pre=3, topk=3, cls_weight=0.0)
    want = jrt.pseudo_targets_rotated(*args, C, cfg_cls, cfg_reg)
    got = trt.pseudo_targets_rotated(*[_t(a) for a in args], C, tt.AssignerCfg(*cfg_cls),
                                     tt.AssignerCfg(*cfg_reg))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2], atol=1e-4)
    _close(got[3], want[3])


def _raug_batch(seed):
    r = np.random.RandomState(seed)
    img = r.randint(0, 255, (B, IMG, IMG, 3)).astype(np.float32)
    rb = _rboxes(r, (B, G), lo=4, hi=IMG - 4, wh=(4, 20))
    pts = (rb[..., :2] + r.uniform(-2, 2, (B, G, 2))).astype(np.float32)
    return (img, pts, np.ones((B, G), bool), rb[..., :2].copy(), rb,
            r.uniform(size=(B, G)) < 0.8)


def _raug_draws(key):
    """The draws strong_augment_rotated makes from its key (raugment.py:155-164)."""
    dirs, us, angles = [], [], []
    for k in jax.random.split(key, B):
        k1, k2, k3 = jax.random.split(k, 3)
        dirs.append(int(jax.random.randint(k1, (), 0, 4)))
        us.append(float(jax.random.uniform(k2, (), minval=0.8, maxval=1.2)))
        angles.append(float(jax.random.randint(k3, (), 1, 20)))
    return dirs, us, angles


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_strong_augment_rotated_with_injected_draws(seed):
    """Flip, rotation and rescale with the JAX draws. Coordinates, boxes and
    validity must agree; pixels may differ where XLA's fused multiply-adds
    move a nearest-neighbour or rounding tie (ROADMAP.md queue 3)."""
    arrays = _raug_batch(20 + seed)
    key = jax.random.PRNGKey(seed)
    want = jra.strong_augment_rotated(key, jra.RAugBatch(*[jnp.asarray(x) for x in arrays]))
    dirs, us, angles = _raug_draws(key)
    got = tra.strong_augment_rotated(tra.RAugBatch(*[_t(x) for x in arrays]), torch.tensor(dirs),
                                     torch.tensor(us, dtype=torch.float32),
                                     torch.tensor(angles, dtype=torch.float32))
    assert float(np.mean(got.image.numpy() != np.asarray(want.image))) < 1e-3
    for name in ("gt_points", "pseudo_points", "pseudo_rboxes"):
        _close(getattr(got, name), getattr(want, name), atol=1e-4)
    for name in ("gt_valid", "pseudo_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("angle", [1.0, 7.0, 19.0])
def test_rotate_images_nearest_matches_jax(angle):
    img = np.random.RandomState(5).randint(0, 255, (B, IMG, IMG, 3)).astype(np.float32)
    rad = np.full((B,), np.float32(angle) * np.float32(np.pi / 180.0), np.float32)
    want = np.asarray(jra.rotate_images_nearest(jnp.asarray(img), jnp.asarray(rad)))
    got = tra.rotate_images_nearest(_t(img), _t(rad)).numpy()
    assert float(np.mean(got != want)) < 1e-3


def test_canon_le90_matches_jax():
    r = np.random.RandomState(6)
    rb = _rboxes(r, (40,), wh=(2, 30))
    rb[:5, 4] = [-np.pi / 2, np.pi / 2, 0.0, np.pi, -np.pi]
    rb[5, 2:4] = 10.0   # exact square: no swap
    _close(tra.canon_le90(_t(rb)), jra._canon_le90(jnp.asarray(rb)), atol=1e-6)


@pytest.mark.parametrize("position", [0.0, "center", 0.6, "random"])
def test_random_point_in_rboxes_with_injected_draws(position):
    rb = _raug_batch(3)[4]
    key = jax.random.PRNGKey(5)
    want = jra.random_point_in_rboxes(key, jnp.asarray(rb), position)
    u = np.asarray(jax.random.uniform(key, rb[..., :2].shape))
    _close(tra.random_point_in_rboxes(_t(rb), position, _t(u)), want, atol=1e-5)


def test_pseudo_branch_loss_rotated_matches_jax():
    """Losses and the gradients w.r.t. the four head maps (the IoU loss runs
    on the exact top-k max_pos rows, as in the reference)."""
    r = np.random.RandomState(7)
    points = np.asarray(grid_points(IMG // STRIDE, IMG // STRIDE, STRIDE))
    p = points.shape[0]
    cls = (r.randn(B, p, C) * 2).astype(np.float32)
    ps = _rboxes(r, (B, G), wh=(8, 24))
    # predictions near the targets, so IoUs are far from 0 and the loss well conditioned
    bbox = r.uniform(4, 14, (B, p, 4)).astype(np.float32)
    ang = (r.uniform(-1, 1, (B, p, 1))).astype(np.float32)
    ctr = r.randn(B, p).astype(np.float32)
    gt_points = (ps[..., :2] + r.uniform(-2, 2, (B, G, 2))).astype(np.float32)
    labels = r.randint(0, C, (B, G)).astype(np.int32)
    gv = np.ones((B, G), bool)
    gv[1, -1] = False
    pv = gv & (r.uniform(size=(B, G)) < 0.9)
    jcfg = jrd.RDenseLossCfg(num_classes=C)

    def jloss(cl, bb, an, ce):
        out = jrd.pseudo_branch_loss_rotated(cl, bb, an, ce, jnp.asarray(points),
                                             jnp.asarray(gt_points), jnp.asarray(labels),
                                             jnp.asarray(gv), jnp.asarray(ps), jnp.asarray(pv),
                                             jcfg)
        return out[0] + out[1] + out[2], out

    (_, want), want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(x) for x in (cls, bbox, ang, ctr)])
    ins = [torch.tensor(x, requires_grad=True) for x in (cls, bbox, ang, ctr)]
    got = trd.pseudo_branch_loss_rotated(*ins, _t(points), _t(gt_points), _t(labels), _t(gv),
                                         _t(ps), _t(pv), trd.RDenseLossCfg(num_classes=C))
    sum(got).backward()
    for g_, w_ in zip(got, want):
        _close(g_.detach(), w_, rtol=1e-5, atol=1e-6)
    assert float(want[1]) > 0
    for t_, w_ in zip(ins, want_g):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(t_.grad.numpy(), w_, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w_).max()))
