"""The port's costs, assigners, targets, pseudo boxes, proposals and strong
augmentation (point_teacher_torch.core) against the JAX package, f32 on the
CPU, with the JAX random draws injected. Assignments and labels must be
equal given identical cost inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.core import assigners as ja
from point_teacher_tpu.core import augment as jaug
from point_teacher_tpu.core import costs as jc
from point_teacher_tpu.core import proposals as jp
from point_teacher_tpu.core import pseudo as jps
from point_teacher_tpu.core import targets as jt
from point_teacher_tpu.ops.boxes import grid_points
from point_teacher_torch.core import assigners as ta
from point_teacher_torch.core import augment as taug
from point_teacher_torch.core import costs as tc
from point_teacher_torch.core import proposals as tp
from point_teacher_torch.core import pseudo as tps
from point_teacher_torch.core import targets as tt

IMG, STRIDE, G, C = 64, 8, 6, 4
RTOL, ATOL = 1e-5, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _scene(seed):
    r = np.random.RandomState(seed)
    cxy = r.uniform(8, IMG - 8, (G, 2))
    wh = r.uniform(4, 16, (G, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    points = np.asarray(grid_points(IMG // STRIDE, IMG // STRIDE, STRIDE))
    p = points.shape[0]
    return dict(
        r=r, boxes=boxes, points=points,
        gt_points=(cxy + r.uniform(-2, 2, (G, 2))).astype(np.float32),
        labels=r.randint(0, C, G).astype(np.int32),
        valid=np.array([True] * (G - 2) + [False, True]),
        logits=(r.randn(p, C) * 2).astype(np.float32),
        ltrb=r.uniform(0, 20, (p, 4)).astype(np.float32),
    )


def test_costs_match_jax():
    s = _scene(0)
    ctr = np.concatenate([s["gt_points"], np.full((G, 2), 6.0, np.float32)], -1)
    _close(tc.focal_cost(_t(s["logits"]), _t(s["labels"]), 0.7),
           jc.focal_cost(s["logits"], s["labels"], 0.7))
    for mode in ("L1", "L2"):
        _close(tc.point_cost(_t(s["points"]), _t(ctr), mode=mode),
               jc.point_cost(s["points"], ctr, mode=mode))
    pred = np.concatenate([s["points"], s["ltrb"][:, 2:]], -1)
    np.testing.assert_array_equal(tc.insider_cost(_t(pred), _t(s["gt_points"])).numpy(),
                                  np.asarray(jc.insider_cost(pred, s["gt_points"])))


@pytest.mark.parametrize("num_pre,topk", [(5, 3), (3, 3), (1, 1), (6, 2)])
def test_topk_assign_equal(num_pre, topk):
    """Integer-valued costs make ties common: the tie order must match too."""
    r = np.random.RandomState(num_pre * 10 + topk)
    reg = r.randint(0, 12, (64, G)).astype(np.float32)
    stage2 = r.randint(0, 5, (64, G)).astype(np.float32)
    valid = r.uniform(size=G) < 0.7
    got = ta.topk_assign(_t(reg), _t(stage2), _t(valid), num_pre, topk)
    want = ja.topk_assign(reg, stage2, valid, num_pre, topk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    labels = r.randint(0, C, G).astype(np.int32)
    np.testing.assert_array_equal(ta.labels_from_assignment(got, _t(labels), C).numpy(),
                                  np.asarray(ja.labels_from_assignment(want, labels, C)))


def test_pseudo_targets_equal():
    s = _scene(1)
    args = (s["points"], s["logits"], s["gt_points"], s["labels"], s["valid"], s["boxes"],
            s["labels"], s["valid"] & (s["r"].uniform(size=G) < 0.8))
    cfg_cls = jt.AssignerCfg(num_pre=1, topk=1, cls_weight=1.0)
    cfg_reg = jt.AssignerCfg(num_pre=3, topk=3, cls_weight=0.0)
    want = jt.pseudo_targets(*args, C, cfg_cls, cfg_reg)
    got = tt.pseudo_targets(*[_t(a) for a in args], C, tt.AssignerCfg(*cfg_cls),
                            tt.AssignerCfg(*cfg_reg))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2])


def test_generate_pseudo_boxes_matches_jax():
    s = _scene(2)
    cfg = jps.FuseAssignerCfg(num_pre=5, topk=3)
    args = (s["points"], s["logits"], s["ltrb"], s["gt_points"], s["labels"], s["valid"],
            s["boxes"])
    want = jps.generate_pseudo_boxes(*args, 0.0, cfg)
    got = tps.generate_pseudo_boxes(*[_t(a) for a in args], 0.0, tps.FuseAssignerCfg(*cfg))
    for k in ("pseudo_valid", "matched", "pseudo_labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("pseudo_boxes", "pseudo_points", "mean_iou"):
        _close(got[k], want[k], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shake", [None, (0.1,)])
def test_fine_proposals_match_jax(shake):
    s = _scene(3)
    s["boxes"][0] = [-20.0, -10.0, 10.0, 12.0]   # mostly outside: invalid members
    cfg = jp.FineProposalCfg(base_ratios=(1.0, 1.2, 0.8), shake_ratio=shake, min_scale=4.0)
    want_p, want_v = jp.fine_proposals(s["boxes"], cfg, (IMG, IMG))
    got_p, got_v = tp.fine_proposals(_t(s["boxes"])[None], tp.FineProposalCfg(*cfg), (IMG, IMG))
    _close(got_p[0], want_p)
    np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v))
    assert not np.asarray(want_v).all()


def test_negative_proposals_with_injected_draws():
    s = _scene(4)
    props, valid = jp.fine_proposals(s["boxes"], jp.FineProposalCfg(), (IMG, IMG))
    key = jax.random.PRNGKey(11)
    want_n, want_w = jp.negative_proposals(key, props, valid, 16, (IMG, IMG))
    u = np.stack([np.asarray(jax.random.uniform(k, (16,))) for k in jax.random.split(key, 4)])
    got_n, got_w = tp.negative_proposals(_t(u), _t(props), _t(valid), (IMG, IMG))
    _close(got_n, want_n)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


def test_delta_decode_matches_jax():
    s = _scene(5)
    deltas = (s["r"].randn(G, 4) * 3).astype(np.float32)
    _close(tp.delta_decode(_t(s["boxes"]), _t(deltas), (IMG, IMG)),
           jp.delta_decode(s["boxes"], deltas, (IMG, IMG)), atol=1e-4)


def _aug_batch(seed, b=2):
    r = np.random.RandomState(seed)
    img = r.randint(0, 255, (b, IMG, IMG, 3)).astype(np.float32)
    cxy = r.uniform(4, IMG - 4, (b, G, 2))
    wh = r.uniform(4, 20, (b, G, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    pts = (cxy + r.uniform(-2, 2, (b, G, 2))).astype(np.float32)
    return (img, pts, np.ones((b, G), bool), cxy.astype(np.float32), boxes,
            r.uniform(size=(b, G)) < 0.8)


@pytest.mark.parametrize("direction", [0, 1, 2, 3])
@pytest.mark.parametrize("scale", [0.8, 1.0, 1.2])
def test_flip_and_rescale_match_jax(direction, scale):
    img, pts, _, ps_pts, boxes, _ = _aug_batch(direction)
    s32 = np.float32(scale)
    ji, jpts, jb = jaug._flip(jnp.asarray(img[0]), [jnp.asarray(pts[0]), jnp.asarray(ps_pts[0])],
                              jnp.asarray(boxes[0]), direction, IMG, IMG)
    ji, jpts, jb, jin = jaug._rescale(ji, jpts, jb, jnp.asarray(s32), IMG, IMG)
    ti, tpts, tb = taug._flip(_t(img[0]), [_t(pts[0]), _t(ps_pts[0])], _t(boxes[0]),
                              direction, IMG, IMG)
    ti, tpts, tb, tin = taug._rescale(ti, tpts, tb, torch.tensor(s32), IMG, IMG)
    assert float(np.abs(ti.numpy() - np.asarray(ji)).max()) <= 1.0  # .5 rounding ties
    assert float(np.mean(ti.numpy() != np.asarray(ji))) < 1e-3
    for g_, w_ in zip(tpts + [tb], list(jpts) + [jb]):
        _close(g_, w_)
    for g_, w_ in zip(tin, jin):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.mark.parametrize("seed", [0, 1])
def test_strong_augment_with_injected_draws(seed):
    img, pts, gv, ps_pts, boxes, pv = _aug_batch(10 + seed)
    key = jax.random.PRNGKey(seed)
    want = jaug.strong_augment(key, jaug.AugBatch(*[jnp.asarray(x) for x in
                                                   (img, pts, gv, ps_pts, boxes, pv)]))
    dirs, us = [], []
    for k in jax.random.split(key, img.shape[0]):
        k1, k2 = jax.random.split(k)
        dirs.append(int(jax.random.randint(k1, (), 0, 4)))
        us.append(float(jax.random.uniform(k2, (), minval=0.8, maxval=1.2)))
    got = taug.strong_augment(taug.AugBatch(*[_t(x) for x in (img, pts, gv, ps_pts, boxes, pv)]),
                              torch.tensor(dirs), torch.tensor(us, dtype=torch.float32))
    assert float(np.abs(got.image.numpy() - np.asarray(want.image)).max()) <= 1.0
    for name in ("gt_points", "pseudo_points", "pseudo_boxes"):
        _close(getattr(got, name), getattr(want, name))
    for name in ("gt_valid", "pseudo_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("position", [0.0, 0.6])
def test_random_point_in_boxes_with_injected_draws(position):
    boxes = _aug_batch(3)[4]
    key = jax.random.PRNGKey(5)
    want = jaug.random_point_in_boxes(key, boxes, position)
    u = np.asarray(jax.random.uniform(key, boxes[..., :2].shape))
    _close(taug.random_point_in_boxes(_t(boxes), position, _t(u)), want)
