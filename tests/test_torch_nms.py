"""The port's horizontal NMS (point_teacher_torch.ops.nms: nms,
multiclass_nms, stable_topk) against the JAX package's on the CPU, from the
same numpy inputs: keep masks and every output row, the invalid padding
rows included, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.ops import nms as jnms
from point_teacher_torch.ops import nms as pnms

THR, IOU, MAX_OUT = 0.05, 0.5, 3000


def _boxes(r, n, side=200.0):
    """n xyxy boxes of 4-40 px in a side x side image, as f32."""
    c = r.uniform(0, side, (n, 2))
    wh = r.uniform(4, 40, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _case(name):
    """(boxes [N, 4], scores [N, C], score factors [N] or None) of a case."""
    r = np.random.RandomState(sum(map(ord, name)))
    if name == "one_shot":            # 300 x 8 = 2400 candidates: one [M, M] matrix
        return _boxes(r, 300), r.uniform(0, 1, (300, 8)).astype(np.float32), None
    if name == "chunked":             # 700 x 8 = 5600: two chunks of 4096
        return _boxes(r, 700), r.uniform(0, 1, (700, 8)).astype(np.float32), None
    if name == "score_factors":       # the centerness multiply after the threshold
        return (_boxes(r, 300), r.uniform(0, 1, (300, 8)).astype(np.float32),
                r.uniform(0, 1, 300).astype(np.float32))
    if name == "chunked_score_factors":
        return (_boxes(r, 700), r.uniform(0, 1, (700, 8)).astype(np.float32),
                r.uniform(0, 1, 700).astype(np.float32))
    if name == "ties_and_duplicates":  # bf16-quantised scores, every box twice
        b = _boxes(r, 150)
        s = r.uniform(0, 1, (300, 8)).astype(np.float32)
        s = np.asarray(jnp.asarray(s).astype(jnp.bfloat16).astype(jnp.float32))
        return np.concatenate([b, b]), np.round(s * 8) / 8, None
    if name == "all_below_thr":
        return _boxes(r, 300), r.uniform(0, THR, (300, 8)).astype(np.float32), None
    raise KeyError(name)


CASES = ["one_shot", "chunked", "score_factors", "chunked_score_factors",
         "ties_and_duplicates", "all_below_thr"]


def _jax(boxes, scores, factors):
    out = jnms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), THR, IOU, MAX_OUT,
                              score_factors=None if factors is None else jnp.asarray(factors))
    return [np.asarray(x) for x in out]


def _port(boxes, scores, factors):
    out = pnms.multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores), THR, IOU,
                              MAX_OUT, None if factors is None else torch.from_numpy(factors))
    return [x.numpy() for x in out]


def _assert_equal(got, want):
    for name, g, w in zip(("dets", "labels", "valid"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_multiclass_nms_matches_jax_bitwise(case):
    """Every row, the padding rows' boxes (gathered from the top-k's order of
    the -inf scores) included."""
    boxes, scores, factors = _case(case)
    want = _jax(boxes, scores, factors)
    got = _port(boxes, scores, factors)
    _assert_equal(got, want)
    n_valid = int(want[2].sum())
    if case == "all_below_thr":
        assert n_valid == 0 and (got[1] == -1).all()
    else:
        # suppression happened, and the buffer is full only where expected
        assert 0 < n_valid < boxes.shape[0] * scores.shape[1]


def test_multiclass_nms_batched_matches_per_image():
    """A batch of three images (one-shot sizes, one image all below the
    threshold) equals the three single-image calls of the port and of JAX."""
    cases = [_case("one_shot"), _case("all_below_thr"), _case("ties_and_duplicates")]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    factors = np.random.RandomState(3).uniform(0, 1, scores.shape[:2]).astype(np.float32)
    batched = [x.numpy() for x in pnms.multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), THR, IOU, MAX_OUT,
        torch.from_numpy(factors))]
    for i in range(3):
        single = _port(boxes[i], scores[i], factors[i])
        _assert_equal([x[i] for x in batched], single)
        _assert_equal(single, _jax(boxes[i], scores[i], factors[i]))


def test_nms_keep_mask_matches_jax():
    """The one-shot NMS with a valid mask: invalid boxes never kept, never suppress."""
    r = np.random.RandomState(4)
    boxes = _boxes(r, 500, side=120.0)
    scores = r.uniform(0, 1, 500).astype(np.float32)
    valid = r.uniform(size=500) < 0.8
    want = np.asarray(jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), IOU,
                               valid=jnp.asarray(valid)))
    got = pnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), IOU,
                   valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("k", [8, 20])
def test_stable_topk_matches_lax_top_k_on_ties(k):
    """Ties ordered by lower index first, as lax.top_k; torch.topk orders
    them otherwise on these inputs."""
    x = (np.random.RandomState(0).randint(0, 8, 20) / 4).astype(np.float32)
    x[[3, 17]] = -np.inf
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = pnms.stable_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if k == 8:
        assert not np.array_equal(torch.topk(torch.from_numpy(x), k).indices.numpy(),
                                  np.asarray(want_i))
