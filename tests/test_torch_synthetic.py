"""The port's phase-1 synthesis (point_teacher_torch.core.synthetic, with
ops.masks.rasterize_rboxes and ops.nms.nms_rotated) against the JAX package,
f32 on the CPU, with the JAX draws replayed into SynDraws from the same key
path (split(k_syn, B) -> split(., 3) -> split(k_box, 5), split(k_chain, 3)).

At a small size and at each fork's full shapes (800 px, 100 GTs,
DEFAULT_SHAPE_LIST; 1200 px, rotated GTs, SODAA_SHAPE_LIST):
- boxes at rtol 1e-6; keep and valid masks equal;
- raster masks equal outside the pixels that lie within EDGE_PX of a kept
  box's edge, where XLA's fused multiply-add in the local coordinates may
  round across the edge (ROADMAP.md queue 3); those pixels are counted and
  printed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.core import synthetic as js
from point_teacher_tpu.ops.masks import rasterize_rboxes as j_rasterize
from point_teacher_tpu.ops.nms import nms_rotated as j_nms_rotated
from point_teacher_tpu.train.config import DEFAULT_SHAPE_LIST, SODAA_SHAPE_LIST
from point_teacher_torch.core import synthetic as ts
from point_teacher_torch.ops.masks import rasterize_rboxes
from point_teacher_torch.ops.nms import nms_rotated
from point_teacher_torch.train import config as tconfig
from torch_port_env import port_test_module  # noqa: F401 (autouse)

B = 2
EDGE_PX = 1e-4
# the DEFAULT_SHAPE_LIST priors scaled by 1/4 for a 64 px image
SMALL_SHAPE_LIST = ((5, 5, 0.5, 0.5), (2.5, 5, 0.5, 0.5), (7.5, 20, 0.5, 0.5),
                    (5, 12.5, 0.5, 0.5), (7.5, 30, 0.5, 0.5), (7.5, 10, 0.5, 0.5))
# (image px, GT slots, rotated GTs, shape list)
SIZES = {"small": (64, 6, False, SMALL_SHAPE_LIST),
         "hbb_full": (800, 100, False, DEFAULT_SHAPE_LIST),
         "obb_full": (1200, 100, True, SODAA_SHAPE_LIST)}


def replay_syn_draws(k_syn, b, g, n_cls):
    """The random numbers generate_black_paper_batch draws from k_syn
    (core/synthetic.py:52-57, :80-84, :125), as the port's SynDraws. Both
    chain gaps come from one uniform (the reference reuses k2)."""
    fields = {k: [] for k in ts.SynDraws._fields}
    for key in jax.random.split(k_syn, b):
        k_cls, k_box, k_chain = jax.random.split(key, 3)
        k1, k2, k3, k4, k5 = jax.random.split(k_box, 5)
        c1, c2, c3 = jax.random.split(k_chain, 3)
        fields["cls_ids"].append(jax.random.randint(k_cls, (g,), 0, n_cls))
        fields["base_u"].append(jax.random.uniform(k1, (g,)))
        fields["xy_u"].append(jax.random.uniform(k2, (g, 2)))
        fields["w_n"].append(jax.random.normal(k3, (g,)))
        fields["r_n"].append(jax.random.normal(k4, (g,)))
        fields["angle_u"].append(jax.random.uniform(k5, (g,)))
        fields["fire_u"].append(jax.random.uniform(c1, (g,)))
        fields["itv_u"].append(jax.random.uniform(c2, (js.NUM_CHAINS,)))
        fields["dev_u"].append(jax.random.uniform(c3, (js.NUM_CHAINS,)))
    out = {k: torch.from_numpy(np.stack([np.asarray(x) for x in v])) for k, v in fields.items()}
    out["cls_ids"] = out["cls_ids"].long()
    return ts.SynDraws(**out)


def syn_inputs(size: str, seed: int):
    """Images (values 0-254, so a 255 fill marks the mask), GTs and validity:
    dense GTs of 4-16 px, the last quarter of the slots padding."""
    s, g, rotated, _ = SIZES[size]
    r = np.random.RandomState(seed)
    img = r.randint(0, 255, (B, s, s, 3)).astype(np.float32)
    cxy = r.uniform(12, s - 12, (B, g, 2))
    wh = r.uniform(4, 16, (B, g, 2))
    if rotated:
        boxes = np.concatenate([cxy, wh, r.uniform(-np.pi / 2, np.pi / 2, (B, g, 1))], -1)
    else:
        boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    valid = np.ones((B, g), bool)
    valid[:, g - g // 4:] = False
    return img, boxes.astype(np.float32), valid


def edge_pixels(rboxes, keep, h, w, margin=EDGE_PX):
    """Pixels within `margin` px of a kept box's edge (float64): set in the
    mask of the boxes grown by `margin`, not in that of the boxes shrunk by it."""
    inner = np.zeros((h, w), bool)
    outer = np.zeros((h, w), bool)
    for cx, cy, bw, bh, a in np.asarray(rboxes, np.float64)[np.asarray(keep)]:
        # only the pixels within the box's circumscribed square can be set
        r = np.hypot(bw, bh) / 2 + margin + 1
        y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, h)
        x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, w)
        if y0 >= y1 or x0 >= x1:
            continue
        ys, xs = np.mgrid[y0:y1, x0:x1].astype(np.float64)
        c, s = np.cos(a), np.sin(a)
        dx, dy = xs - cx, ys - cy
        lx, ly = np.abs(c * dx + s * dy), np.abs(-s * dx + c * dy)
        inner[y0:y1, x0:x1] |= (lx <= bw / 2 - margin) & (ly <= bh / 2 - margin)
        outer[y0:y1, x0:x1] |= (lx <= bw / 2 + margin) & (ly <= bh / 2 + margin)
    return outer & ~inner


def assert_masks_match(got, want, rboxes, keep, what):
    """Bool masks [B, H, W] equal outside the edge pixels; prints the count."""
    got, want = np.asarray(got), np.asarray(want)
    n_edge = n_diff = 0
    for i in range(got.shape[0]):
        edge = edge_pixels(rboxes[i], keep[i], *got.shape[1:])
        diff = got[i] != want[i]
        assert not (diff & ~edge).any(), (
            f"{what} image {i}: {int((diff & ~edge).sum())} pixels differ away from an edge")
        n_edge += int(edge.sum())
        n_diff += int(diff.sum())
    print(f"{what}: {n_edge} pixels within {EDGE_PX} px of an edge, {n_diff} of them differ")


@pytest.fixture(scope="module", params=list(SIZES))
def synthesis(request):
    """generate_black_paper_batch of both packages on the same inputs and draws."""
    size = request.param
    s, g, _, shape_list = SIZES[size]
    img, boxes, valid = syn_inputs(size, seed=3)
    key = jax.random.PRNGKey(17)
    jout = js.generate_black_paper_batch(key, jnp.asarray(img), jnp.asarray(boxes),
                                         jnp.asarray(valid), js.SynCfg(shape_list, s))
    draws = replay_syn_draws(key, B, g, len(shape_list))
    tout = ts.generate_black_paper_batch(draws, torch.from_numpy(img), torch.from_numpy(boxes),
                                         torch.from_numpy(valid), ts.SynCfg(shape_list, s))
    return size, [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def test_black_paper_boxes_and_valid_match_jax(synthesis):
    size, (_, jxyxy, jrb, jvalid), (_, txyxy, trb, tvalid) = synthesis
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_allclose(trb, jrb, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(txyxy, jxyxy, rtol=1e-6, atol=1e-5)
    assert tvalid.any(-1).all(), f"{size}: an image kept no synthetic box"
    print(f"{size}: kept {tvalid.sum(-1).tolist()} of {tvalid.shape[1]} slots")


def test_black_paper_raster_matches_jax(synthesis):
    size, (jimg, _, jrb, jvalid), (timg, _, _, _) = synthesis
    jmask, tmask = (jimg == 255).all(-1), (timg == 255).all(-1)
    assert jmask.any()
    # pixels that neither package paints keep their values
    untouched = ~tmask & ~jmask
    np.testing.assert_array_equal(timg[untouched], jimg[untouched])
    assert_masks_match(tmask, jmask, jrb, jvalid, f"black paper {size}")


def test_synthesis_fill_zero_matches_jax():
    """generate_synthesis_batch: the same boxes, painted 0."""
    s, g, _, shape_list = SIZES["small"]
    img, boxes, valid = syn_inputs("small", seed=4)
    img = img + 1.0  # values 1-255: a 0 fill marks the mask
    key = jax.random.PRNGKey(23)
    jimg, _, jrb, jvalid = js.generate_synthesis_batch(
        key, jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid), js.SynCfg(shape_list, s))
    timg, _, trb, tvalid = ts.generate_synthesis_batch(
        replay_syn_draws(key, B, g, len(shape_list)), torch.from_numpy(img),
        torch.from_numpy(boxes), torch.from_numpy(valid), ts.SynCfg(shape_list, s))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(trb.numpy(), np.asarray(jrb), rtol=1e-6, atol=1e-6)
    jmask, tmask = (np.asarray(jimg) == 0).all(-1), (timg.numpy() == 0).all(-1)
    assert jmask.any()
    assert_masks_match(tmask, jmask, np.asarray(jrb), np.asarray(jvalid), "fill 0")


def _rboxes(r, n, s, wh):
    return np.concatenate([r.uniform(0, s, (n, 2)), r.uniform(*wh, (n, 2)),
                           r.uniform(-np.pi / 2, np.pi / 2, (n, 1))], -1).astype(np.float32)


@pytest.mark.parametrize("size", list(SIZES))
def test_rasterize_rboxes_matches_jax(size):
    s, g, _, _ = SIZES[size]
    r = np.random.RandomState(5)
    rb = np.stack([_rboxes(r, g + 10, s, (2, s / 8)) for _ in range(B)])
    valid = r.uniform(size=(B, g + 10)) < 0.7
    want = np.stack([np.asarray(j_rasterize(jnp.asarray(rb[i]), jnp.asarray(valid[i]), s, s))
                     for i in range(B)])
    got = rasterize_rboxes(torch.from_numpy(rb), torch.from_numpy(valid), s, s).numpy()
    assert want.any()
    assert_masks_match(got, want, rb, valid, f"rasterize {size}")


def test_rasterize_rboxes_row_blocks():
    """A height that is not a multiple of the row block, any block size."""
    r = np.random.RandomState(6)
    rb = torch.from_numpy(_rboxes(r, 12, 50, (2, 12)))
    valid = torch.ones(12, dtype=torch.bool)
    want = rasterize_rboxes(rb, valid, 50, 70, row_block=50)
    for blk in (1, 7, 64):
        np.testing.assert_array_equal(rasterize_rboxes(rb, valid, 50, 70, row_block=blk).numpy(),
                                      want.numpy())


def _nms_inputs(seed, n, s):
    r = np.random.RandomState(seed)
    rb = np.stack([_rboxes(r, n, s, (4, s / 5)) for _ in range(B)])
    scores = r.uniform(size=(B, n)).astype(np.float32)
    scores[:, : n // 4] = 0.5  # a run of equal scores: ranked by index
    valid = r.uniform(size=(B, n)) < 0.8
    return rb, scores, valid


@pytest.mark.parametrize("case", ["full_210", "deep_chain"])
def test_nms_rotated_matches_jax(case):
    """Keep masks equal, per image, at the synthesis's 210 boxes (a quarter
    of them with equal scores); `deep_chain` runs 2 unrolled rounds on a
    chain of boxes, each suppressing the next, so the exactness loop runs."""
    if case == "deep_chain":
        x = np.arange(12, dtype=np.float32) * 8.0
        rb = np.stack([np.stack([x + 20, np.full(12, 30.0), np.full(12, 10.0), np.full(12, 6.0),
                                 np.zeros(12)], -1)] * B).astype(np.float32)
        scores = np.stack([np.linspace(1, 0.1, 12)] * B).astype(np.float32)
        valid, iters = np.ones((B, 12), bool), 2
    else:
        rb, scores, valid = _nms_inputs(7, 210, 800)
        iters = 32
    want = np.stack([np.asarray(j_nms_rotated(jnp.asarray(rb[i]), jnp.asarray(scores[i]), 0.05,
                                              valid=jnp.asarray(valid[i]), iters=iters))
                     for i in range(B)])
    got = nms_rotated(torch.from_numpy(rb), torch.from_numpy(scores), 0.05,
                      valid=torch.from_numpy(valid), iters=iters).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < valid.sum()
    if case == "deep_chain":
        np.testing.assert_array_equal(want[0], np.arange(12) % 2 == 0)


def test_config_phase1_fields_match_jax():
    """The phase-1 fields of the port's config copies equal the JAX package's."""
    from point_teacher_tpu.train import config as jconfig
    for name in ("config_0pct", "config_sodaa"):
        jc, tc = getattr(jconfig, name)(), getattr(tconfig, name)()
        for field in ("shape_list", "syn_fill_value", "num_training_burninstep1",
                      "num_training_burninstep2", "burn_in_step"):
            assert getattr(tc, field) == getattr(jc, field), (name, field)
        assert tuple(tc.syn_cfg) == tuple(jc.syn_cfg)
    jc, tc = jconfig.config_noisy(0.3), tconfig.config_noisy(0.3)
    assert tc.num_training_burninstep1 == jc.num_training_burninstep1 == 75
