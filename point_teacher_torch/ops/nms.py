"""NMS with static shapes (counterpart of point_teacher_tpu/ops/nms.py:
_greedy_suppress in its parallel mode, nms, nms_rotated, _chunked_class_nms,
multiclass_nms and multiclass_nms_rotated).

Greedy NMS as a parallel fixpoint: each round, every undecided box that no
higher-ranked undecided box overlaps is kept, and every box a newly kept,
higher-ranked box overlaps dies. `iters` rounds run unrolled; a loop then
finishes any suppression chain deeper than that, so the result always
equals sequential greedy NMS. Its test is the call's one device-to-host
sync. Batched over any leading dimensions (the class NMS: one leading
image dimension, or none).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from .boxes import bbox_overlaps
from .rotated import rbox_iou, rbox_iou_tiled

Tensor = torch.Tensor

CLASS_NMS_CHUNK = 4096          # class-expanded candidates above this run in chunks
ROTATED_CLASS_NMS_CHUNK = 2048  # the same for multiclass_nms_rotated


def stable_topk(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest values of `x` along its last dim and their indices, in
    descending order, equal values by lower index first: jax.lax.top_k's
    order (torch.topk orders ties otherwise)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _greedy_suppress(iou: Tensor, order_scores: Tensor, iou_thr: float,
                     iters: int = 32) -> Tensor:
    """iou [..., N, N], scores [..., N] -> keep mask [..., N], matching greedy
    NMS in descending score order, equal scores ranked by index."""
    n = iou.shape[-1]
    order = torch.argsort(-order_scores, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    higher = rank[..., None, :] < rank[..., :, None]          # [.., i, j]: j outranks i
    conflict = higher & (iou > iou_thr)                      # j can suppress i

    def round_fn(alive, keep):
        newly = alive & ~(conflict & alive[..., None, :]).any(-1)
        dead = (conflict & newly[..., None, :]).any(-1)
        return alive & ~newly & ~dead, keep | newly

    alive = torch.ones(iou.shape[:-1], dtype=torch.bool, device=iou.device)
    keep = torch.zeros_like(alive)
    for _ in range(iters):
        alive, keep = round_fn(alive, keep)
    # each round decides at least one box while any is alive: zero trips
    # unless a suppression chain is deeper than `iters`
    while bool(alive.any()):
        alive, keep = round_fn(alive, keep)
    return keep


def _masked_nms(iou: Tensor, scores: Tensor, iou_thr: float, valid: Optional[Tensor],
                iters: int) -> Tensor:
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
        iou = torch.where(valid[..., None, :] & valid[..., :, None], iou, 0.0)
    keep = _greedy_suppress(iou, scores, iou_thr, iters=iters)
    if valid is not None:
        keep = keep & valid
    return keep


def nms(boxes: Tensor, scores: Tensor, iou_thr: float, valid: Optional[Tensor] = None,
        iters: int = 64) -> Tensor:
    """Horizontal NMS: boxes [..., N, 4] xyxy, scores [..., N] -> keep mask
    [..., N]; invalid boxes rank last, suppress nothing and are never kept."""
    return _masked_nms(bbox_overlaps(boxes, boxes), scores, iou_thr, valid, iters)


def nms_rotated(rboxes: Tensor, scores: Tensor, iou_thr: float,
                valid: Optional[Tensor] = None, iters: int = 32) -> Tensor:
    """Rotated NMS: rboxes [..., N, 5] (cx, cy, w, h, a), scores [..., N] ->
    keep mask [..., N]; invalid boxes rank last, suppress nothing and are
    never kept."""
    return _masked_nms(rbox_iou(rboxes, rboxes), scores, iou_thr, valid, iters)


def _gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """x [B, M, D] at the rows idx [B, K] -> [B, K, D]."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _chunked_class_nms(boxes_iou: Tensor, scores_f: Tensor, valid: Tensor, iou_fn,
                       iou_thr: float, max_out: int, chunk: int, iters: int):
    """Exact greedy NMS over M candidates per image in score-sorted chunks
    against a buffer of the top `max_out` kept boxes: boxes_iou [B, M, D]
    (what iou_fn reads, batched: [B, K, D] x [B, L, D] -> [B, K, L]), scores
    and valid [B, M].

    Equal to one-shot greedy over all M: while the buffer is not full no
    kept box was dropped, so suppression is exact; once it is full, every
    later candidate scores below all buffered boxes and cannot enter the
    output. The last chunk holds the remainder, unpadded (JAX pads it to
    `chunk` for a static shape; its padding is never alive). Returns
    (kept_scores [B, max_out] descending, -inf where empty, kept_idx
    [B, max_out] into the M candidates, kept_valid [B, max_out]). One host
    sync a chunk (the fixpoint's), for the whole batch."""
    b, m, d = boxes_iou.shape
    nchunks = -(-m // chunk)
    scores_m = torch.where(valid, scores_f, -torch.inf)
    order = torch.argsort(-scores_m, dim=-1, stable=True)
    dev = boxes_iou.device
    kept_scores = torch.full((b, max_out), -torch.inf, dtype=scores_m.dtype, device=dev)
    kept_boxes = torch.zeros((b, max_out, d), dtype=boxes_iou.dtype, device=dev)
    kept_idx = torch.zeros((b, max_out), dtype=torch.long, device=dev)
    for ci in range(nchunks):
        sl = order[:, ci * chunk:(ci + 1) * chunk]
        cb = _gather_rows(boxes_iou, sl)
        cs = scores_m.gather(1, sl)
        dead = ((iou_fn(cb, kept_boxes) > iou_thr)
                & (kept_scores > -torch.inf)[:, None, :]).any(-1)
        alive = (cs > -torch.inf) & ~dead
        iou = torch.where(alive[:, None, :] & alive[:, :, None], iou_fn(cb, cb), 0.0)
        keep_chunk = _greedy_suppress(iou, torch.where(alive, cs, -torch.inf), iou_thr,
                                      iters=iters) & alive
        merged_scores = torch.cat([kept_scores, torch.where(keep_chunk, cs, -torch.inf)], 1)
        merged_boxes = torch.cat([kept_boxes, cb], 1)
        merged_idx = torch.cat([kept_idx, sl], 1)
        kept_scores, sel = stable_topk(merged_scores, max_out)
        kept_boxes = _gather_rows(merged_boxes, sel)
        kept_idx = merged_idx.gather(1, sel)
    return kept_scores, kept_idx, kept_scores > -torch.inf


def _class_nms(boxes_f: Tensor, boxes_off: Tensor, scores_f: Tensor, valid: Tensor,
               labels_f: Tensor, iou_fn, iou_thr: float, max_out: int, chunk: int):
    """The class NMS shared by multiclass_nms and multiclass_nms_rotated, over
    M class-expanded candidates an image: boxes_f [B, M, D] (the output's
    boxes), boxes_off [B, M, D] (the class-offset boxes iou_fn reads),
    scores_f and valid [B, M], labels_f [M]. Up to `chunk` candidates run
    one-shot (64 rounds), more in exact score-sorted chunks (32 rounds).
    Returns dets [B, max_out, D + 1] (box, score), labels [B, max_out] (-1
    where invalid), valid [B, max_out]."""
    m = boxes_f.shape[1]
    if m <= chunk:
        keep = _masked_nms(iou_fn(boxes_off, boxes_off), torch.where(valid, scores_f, -torch.inf),
                           iou_thr, valid, iters=64)
        k = min(max_out, m)
        out_scores, sel_idx = stable_topk(torch.where(keep & valid, scores_f, -torch.inf), k)
    else:
        k = max_out
        out_scores, sel_idx, _ = _chunked_class_nms(boxes_off, scores_f, valid, iou_fn, iou_thr,
                                                    max_out, chunk, iters=32)
    out_valid = out_scores > -torch.inf
    out_scores = torch.where(out_valid, out_scores, 0.0)
    dets = torch.cat([_gather_rows(boxes_f, sel_idx), out_scores[..., None]], -1)
    out_labels = torch.where(out_valid, labels_f[sel_idx], -1)
    if k < max_out:
        pad = max_out - k
        dets = F.pad(dets, (0, 0, 0, pad))
        out_labels = F.pad(out_labels, (0, pad), value=-1)
        out_valid = F.pad(out_valid, (0, pad))
    return dets, out_labels, out_valid


def _expand_classes(boxes: Tensor, scores: Tensor, score_thr: float,
                    score_factors: Optional[Tensor]):
    """boxes [B, N, D], scores [B, N, C] -> class-expanded boxes [B, N*C, D],
    scores [B, N*C] (times score_factors [B, N] where given), labels [N*C]
    and valid [B, N*C]: the raw class score above score_thr, tested BEFORE
    the score_factors multiply (mmdet keeps a box whose raw score passes
    although the product falls below)."""
    b, n, c = scores.shape
    valid = (scores > score_thr).reshape(b, -1)
    if score_factors is not None:
        scores = scores * score_factors[..., None]
    boxes_f = boxes[:, :, None, :].expand(b, n, c, boxes.shape[-1]).reshape(b, n * c, -1)
    labels_f = torch.arange(c, device=boxes.device).expand(n, c).reshape(-1)
    return boxes_f, scores.reshape(b, -1), labels_f, valid


def _batched(fn):
    """Let fn(boxes [B, N, D], scores [B, N, C], ..., score_factors [B, N])
    also take one image ([N, D], [N, C], [N]) and return its outputs
    unbatched."""
    @functools.wraps(fn)
    def wrapper(boxes: Tensor, scores: Tensor, score_thr: float, iou_thr: float,
                max_out: int, score_factors: Optional[Tensor] = None):
        if boxes.dim() == 2:
            out = fn(boxes[None], scores[None], score_thr, iou_thr, max_out,
                     None if score_factors is None else score_factors[None])
            return tuple(x[0] for x in out)
        return fn(boxes, scores, score_thr, iou_thr, max_out, score_factors)

    return wrapper


@_batched
def multiclass_nms(boxes: Tensor, scores: Tensor, score_thr: float, iou_thr: float,
                   max_out: int, score_factors: Optional[Tensor] = None):
    """Class-wise NMS over boxes [B, N, 4] (or [N, 4]) and foreground scores
    [B, N, C] (or [N, C]), each image on its own: mmdet's multiclass_nms with
    fixed-shape output, dets [B, max_out, 5] (x1, y1, x2, y2, score), labels
    [B, max_out] (-1 where invalid), valid [B, max_out].

    The raw class score is thresholded BEFORE the score_factors multiply.
    Classes are kept apart by offsetting each class's boxes by label x (the
    image's largest valid coordinate + 1). Up to CLASS_NMS_CHUNK
    class-expanded candidates run one-shot, more in exact score-sorted
    chunks (_chunked_class_nms)."""
    boxes_f, scores_f, labels_f, valid = _expand_classes(boxes, scores, score_thr,
                                                         score_factors)
    max_coord = torch.where(valid[..., None], boxes_f, 0.0).amax((1, 2)) + 1.0
    offsets = labels_f.to(boxes_f.dtype)[None] * max_coord[:, None]
    return _class_nms(boxes_f, boxes_f + offsets[..., None], scores_f, valid, labels_f,
                      bbox_overlaps, iou_thr, max_out, CLASS_NMS_CHUNK)


@_batched
def multiclass_nms_rotated(rboxes: Tensor, scores: Tensor, score_thr: float, iou_thr: float,
                           max_out: int, score_factors: Optional[Tensor] = None):
    """Class-wise rotated NMS over rboxes [B, N, 5] (cx, cy, w, h, a) (or
    [N, 5]) and scores [B, N, C] (or [N, C]), each image on its own:
    mmrotate's multiclass_nms_rotated with fixed-shape output, dets
    [B, max_out, 6] (cx, cy, w, h, a, score), labels (-1 where invalid),
    valid.

    The raw class score is thresholded BEFORE the score_factors multiply.
    The rotated IoU does not change under translation, so classes are kept
    apart by moving each class's centres along x by label x (2 x the
    image's largest valid |cx|, |cy|, w or h + 1). Up to
    ROTATED_CLASS_NMS_CHUNK class-expanded candidates run one-shot, more in
    exact score-sorted chunks; the IoU blocks go through rbox_iou_tiled."""
    boxes_f, scores_f, labels_f, valid = _expand_classes(rboxes, scores, score_thr,
                                                         score_factors)
    max_coord = torch.where(valid[..., None], boxes_f[..., :4].abs(), 0.0).amax((1, 2)) * 2 + 1.0
    offsets = labels_f.to(boxes_f.dtype)[None] * max_coord[:, None]
    boxes_off = torch.cat([(boxes_f[..., 0] + offsets)[..., None], boxes_f[..., 1:]], -1)
    return _class_nms(boxes_f, boxes_off, scores_f, valid, labels_f, rbox_iou_tiled, iou_thr,
                      max_out, ROTATED_CLASS_NMS_CHUNK)
