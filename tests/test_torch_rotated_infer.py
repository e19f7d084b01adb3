"""The port's rotated class NMS and rotated inference against the JAX
package's on the CPU, from the same numpy inputs: multiclass_nms_rotated
(one-shot), _chunked_class_nms with the row-tiled rotated IoU,
rbox_iou_tiled and get_rbboxes_single at full width
(build_rotated_inference_fn: test_torch_rotated_eval.py).

The NMS's keep decisions must agree with JAX's except where a pair's IoU
lies within NEAR of the threshold: XLA contracts the polygon clip's
a * b + c * d into FMAs (ROADMAP.md queue 3), so such a pair may fall on
the other side. Each test prints how many such pairs there were (0 so
far); where there are none, the outputs must be equal bit for bit, every
row, the padding included. A chain from logits is held as matched sets, as
in test_torch_inference.py (its sigmoid differs from XLA's in the last
bit). pytest -rP shows the printed counts.

The port's side runs on one thread (`one_thread`): beside the other test
workers, torch's default of a thread a core oversubscribes the CPU, and
its polygon clip then slows down many times over. The sizes are cut to
what one thread does in seconds."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu import inference as jinf
from point_teacher_tpu.ops import nms as jnms
from point_teacher_tpu.ops import rotated as jrot
from point_teacher_tpu.ops.boxes import grid_points as jgrid
from point_teacher_tpu.train.config import InferenceCfg as JaxCfg
from point_teacher_torch import inference as pinf
from point_teacher_torch.ops import nms as pnms
from point_teacher_torch.ops import rotated as prot
from point_teacher_torch.ops.boxes import grid_points
from point_teacher_torch.ops.nms import stable_topk
from point_teacher_torch.train.config import InferenceCfg
from test_torch_inference import ULP2, match_dets

NEAR = 1e-6        # IoU margin around the threshold where a keep decision may flip


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# the SODA-A test settings (config_sodaa().test): IoU 0.1, score_thr 0.05
SODAA_TEST = dict(score_thr=0.05, nms_iou=0.1)


def _rboxes(r, n, field=200.0, lo=8.0, hi=40.0):
    return np.concatenate([r.uniform(0, field, (n, 2)), r.uniform(lo, hi, (n, 2)),
                           r.uniform(-1.5, 1.5, (n, 1))], -1).astype(np.float32)


def _near_candidates(boxes, scores, score_thr, iou_thr):
    """(class, box) of every candidate with a same-class pair whose IoU, on
    the class-offset boxes multiclass_nms_rotated builds, lies within NEAR
    of iou_thr. boxes [N, 5], scores [N, C]."""
    rb = torch.from_numpy(boxes)
    valid = torch.from_numpy(scores) > score_thr
    max_coord = torch.where(valid.any(1)[:, None], rb[:, :4].abs(), 0.0).amax() * 2 + 1.0
    out = set()
    for c in range(scores.shape[1]):
        rows = torch.nonzero(valid[:, c])[:, 0]
        b = rb[rows].clone()
        b[:, 0] = b[:, 0] + torch.tensor(float(c)) * max_coord
        iou = prot.rbox_iou_tiled(b, b)
        near = ((iou - iou_thr).abs() <= NEAR) & ~torch.eye(len(rows), dtype=torch.bool)
        out |= {(c, tuple(boxes[int(rows[i])].tolist())) for i in torch.nonzero(near)[:, 0]}
    return out


def _assert_keep_agree(got, want, near, keys):
    """Bit for bit, every output array; or, where some pair lies near the
    threshold, the outputs may differ in the rows that only one side kept,
    each of which must be a near candidate. keys(outputs) -> the kept rows
    as (class, box) pairs."""
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    if all(np.array_equal(g, w) for g, w in zip(got, want)):
        return
    assert near, "outputs differ with no pair near the threshold"
    assert keys(got) ^ keys(want) <= near


def _det_keys(out):
    """multiclass_nms_rotated's kept rows: {(label, box)}."""
    d, l, v = out
    return {(int(c), tuple(b[:5].tolist())) for b, c in zip(d[v], l[v])}


def _one_shot_case(name):
    """40 rotated boxes x 9 classes (360 class-expanded candidates, the
    one-shot path) in a 120 px field, neighbours overlapping."""
    r = np.random.RandomState(["plain", "factors", "below", "ties"].index(name))
    boxes = _rboxes(r, 40, field=120.0)
    scores = r.uniform(0, 1, (40, 9)).astype(np.float32)
    factors = None
    if name == "factors":
        factors = r.uniform(0.2, 1, 40).astype(np.float32)
    elif name == "below":
        scores *= 0.29
    elif name == "ties":   # duplicate boxes with tied (bf16-quantised) scores
        boxes[20:] = boxes[:20]
        scores = np.asarray(torch.from_numpy(scores).bfloat16().float())
        scores[20:] = scores[:20]
    return boxes, scores, factors


@pytest.mark.parametrize("case", ["plain", "factors", "below", "ties"])
def test_multiclass_nms_rotated_one_shot_matches_jax(case):
    """max_out 400 > 360 candidates: the output's 40 padding rows too. The
    port runs without score factors where the case has none; JAX always
    with them, ones there (x * 1 is x exactly), so that it compiles once."""
    boxes, scores, factors = _one_shot_case(case)
    args = dict(score_thr=0.3, iou_thr=0.1, max_out=400)
    want = jnms.multiclass_nms_rotated(
        jnp.asarray(boxes), jnp.asarray(scores),
        score_factors=jnp.ones(len(boxes)) if factors is None else jnp.asarray(factors), **args)
    got = pnms.multiclass_nms_rotated(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        score_factors=None if factors is None else torch.from_numpy(factors), **args)
    near = _near_candidates(boxes, scores, 0.3, 0.1)
    n_valid = int(got[2].sum())
    print(f"{case}: {n_valid} kept; candidates in a pair within {NEAR} of IoU 0.1: {len(near)}")
    assert got[0].shape == (400, 6) and (n_valid == 0) == (case == "below")
    _assert_keep_agree(got, want, near, _det_keys)


def test_chunked_class_nms_with_tiled_iou_matches_jax():
    """The port's _chunked_class_nms with rbox_iou_tiled against JAX's
    _chunked_class_nms with its rbox_iou, called directly: 320 crowded
    candidates in 5 chunks of 64, a buffer of 64 that fills within them.
    Chunk and buffer of one size: JAX's IoU then compiles for one shape."""
    r = np.random.RandomState(4)
    boxes = _rboxes(r, 320, field=300.0, lo=10.0)
    scores = r.uniform(0, 1, 320).astype(np.float32)
    valid = scores > 0.2
    args = dict(iou_thr=0.1, max_out=64, chunk=64, iters=32)
    # JAX's IoU jitted, as inside its jitted multiclass_nms_rotated (eager,
    # each of its primitives would compile on its own)
    want = jnms._chunked_class_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                                   jax.jit(jrot.rbox_iou), **args)
    got = pnms._chunked_class_nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                                  torch.from_numpy(valid)[None], prot.rbox_iou_tiled, **args)
    near = _near_candidates(boxes, valid[:, None].astype(np.float32), 0.5, 0.1)
    print(f"candidates in a pair within {NEAR} of IoU 0.1: {len(near)}")
    assert bool(got[2].all())

    def keys(out):   # the kept candidates, by index
        return {(0, tuple(boxes[i].tolist())) for i in np.asarray(out[1]).reshape(-1)}

    _assert_keep_agree([x[0] for x in got], want, near, keys)


def test_chunked_rotated_path_equals_one_shot(monkeypatch):
    """multiclass_nms_rotated of two images (30 boxes x 9 classes each, 270
    candidates): in chunks of 128 (ROTATED_CLASS_NMS_CHUNK patched), the
    last one 14, equal to the one-shot path bit for bit, and each image of
    the batch equal to its own call."""
    r = np.random.RandomState(5)
    boxes = torch.from_numpy(np.stack([_rboxes(r, 30, field=100.0) for _ in range(2)]))
    scores = torch.from_numpy(r.uniform(0, 1, (2, 30, 9)).astype(np.float32))
    args = dict(score_thr=0.2, iou_thr=0.1, max_out=60)
    one_shot = pnms.multiclass_nms_rotated(boxes, scores, **args)
    monkeypatch.setattr(pnms, "ROTATED_CLASS_NMS_CHUNK", 128)
    chunked = pnms.multiclass_nms_rotated(boxes, scores, **args)
    for a, b in zip(chunked, one_shot):
        assert torch.equal(a, b)
    assert int(one_shot[2].sum()) == 120          # both buffers fill
    for i in range(2):
        for a, b in zip(pnms.multiclass_nms_rotated(boxes[i], scores[i], **args), chunked):
            assert torch.equal(a, b[i])


@pytest.mark.parametrize("rows", [None, 7])
def test_rbox_iou_tiled_equals_rbox_iou_bitwise(monkeypatch, rows):
    """[2, 300, 5] x [2, 40, 5]: two tiles of the default 256 rows (the
    second 44), or 43 of 7 rows; pairs nested, overlapping and apart."""
    if rows is not None:
        monkeypatch.setattr(prot, "IOU_TILE_ROWS", rows)
    r = np.random.RandomState(6)
    a = torch.from_numpy(np.stack([_rboxes(r, 300, field=100.0) for _ in range(2)]))
    b = torch.from_numpy(np.stack([_rboxes(r, 40, field=100.0, lo=2.0) for _ in range(2)]))
    want = prot.rbox_iou(a, b)
    got = prot.rbox_iou_tiled(a, b)
    assert torch.equal(got, want)
    assert 0.1 < float((want > 0).float().mean()) < 0.9


# --------------------------------------------------------------------------
# the rotated decode + NMS chain at full width, from random head outputs
# --------------------------------------------------------------------------

# 1200 px: 150 x 150 points at stride 8, 9 classes; nms_pre and max_per_img
# cut from the config's 2000 so that the one-shot NMS (360 candidates)
# stays within seconds on both sides
FULL, FULL_C = 1200, 9
REDUCED = dict(nms_pre=40, max_per_img=100, **SODAA_TEST)


def test_get_rbboxes_single_full_width_matches_jax():
    r = np.random.RandomState(7)
    p = (FULL // 8) ** 2
    cls = (r.randn(p, FULL_C) * 1.5 - 1.0).astype(np.float32)
    pred5 = np.concatenate([r.uniform(10, 60, (p, 4)), r.uniform(-1.2, 1.2, (p, 1))],
                           -1).astype(np.float32)
    ctr = r.randn(p).astype(np.float32)
    sf = np.asarray([0.8, 0.75, 0.8, 0.75], np.float32)
    pts = jgrid(FULL // 8, FULL // 8, 8)
    want = jax.jit(functools.partial(jinf.get_rbboxes_single, points=pts,
                                     cfg=JaxCfg(**REDUCED)))(
        jnp.asarray(cls), jnp.asarray(pred5), jnp.asarray(ctr), scale_factor=jnp.asarray(sf))
    got = [x.numpy() for x in pinf.get_rbboxes_single(
        torch.from_numpy(cls), torch.from_numpy(pred5), torch.from_numpy(ctr),
        grid_points(FULL // 8, FULL // 8, 8), torch.from_numpy(sf), InferenceCfg(**REDUCED))]

    # the nms_pre cut (the raw max class score): equal but for keys that tie
    # the last one kept
    jkey = np.asarray(jax.nn.sigmoid(jnp.asarray(cls)).max(-1))
    _, jtop = jax.lax.top_k(jnp.asarray(jkey), REDUCED["nms_pre"])
    _, ptop = stable_topk(pinf.score_sigmoid(torch.from_numpy(cls)).amax(-1),
                          REDUCED["nms_pre"])
    cut_diff = set(np.asarray(jtop).tolist()) ^ set(ptop.numpy().tolist())
    last = jkey[np.asarray(jtop)[-1]]
    assert all(abs(jkey[i] - last) <= ULP2 * last for i in cut_diff), cut_diff

    n_valid = int(want[2].sum())
    assert n_valid == REDUCED["max_per_img"]         # the output fills
    groups = match_dets(got, want, rtol=1e-6, tie=ULP2, atol=1e-5, width=5)
    ulp_scores = int((got[0][:n_valid, 5] != want[0][:n_valid, 5]).sum())
    print(f"nms_pre cut differences {len(cut_diff)}; score tie groups {groups}; "
          f"scores differing in the last bits {ulp_scores} of {n_valid}")
