"""Test-time inference of the teacher (counterpart of
point_teacher_tpu/inference.py). HBB: forward -> per-image top-k by
max(score x centerness) -> decode -> multiclass NMS, and the multi-scale +
flip test-time augmentation that merges every view's top-k by one NMS.
Rotated (SODA-A): forward -> per-image top-k by the raw max class score ->
DistanceAnglePointCoder decode -> rotated multiclass NMS. The RFLA-FCOS
baseline: its five levels (strides 8-128), each level's own top-k, then one
multiclass NMS over all of them.

The Point-Teacher detectors have a single stride-8 level. Everything is batched over the images: one forward,
one batched NMS (one host sync a chunk of candidates, not one an image).
Returns fixed-shape padded detections: dets [B, max_per_img, 5] (rotated:
6), labels, valid. The functions that build_inference_fn,
build_rotated_inference_fn, build_tta_inference_fn and
build_rfla_inference_fn return take the
module to run (the teacher, or the student) as their first argument and run
it under no_grad, inside the profiler ranges `pt.infer/forward` and
`pt.infer/nms`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.autograd.profiler import record_function

from .models.rfla_fcos_head import STRIDES
from .ops.boxes import distance2bbox, grid_points
from .ops.nms import multiclass_nms, multiclass_nms_rotated, stable_topk
from .ops.rotated import distance_angle_decode
from .train.config import InferenceCfg
from .train.rsteps import _flatten_rhead
from .train.steps import _flatten_head

Tensor = torch.Tensor


def score_sigmoid(logits: Tensor) -> Tensor:
    """sigmoid evaluated in f64 and rounded to f32: the correctly rounded
    value for all but a vanishing share of inputs, so the card and the CPU
    give the same bits, and the ranking and the NMS the same decisions."""
    return torch.sigmoid(logits.double()).float()


def _gather(x: Tensor, idx: Tensor) -> Tensor:
    """x [B, P, ...] at the points idx [B, K] -> [B, K, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _topk_candidates(cls_logits: Tensor, bbox_pred: Tensor, centerness: Tensor,
                     points: Tensor, nms_pre: int):
    """The nms_pre points of each image with the largest max(score x
    centerness): (scores [B, K, C], centerness [B, K], points [B, K, 2],
    distances [B, K, 4])."""
    scores = score_sigmoid(cls_logits)
    ctr = score_sigmoid(centerness)
    k = min(nms_pre, scores.shape[1])
    _, topk = stable_topk((scores * ctr[..., None]).amax(-1), k)
    return _gather(scores, topk), _gather(ctr, topk), points[topk], _gather(bbox_pred, topk)


def _clamp_to_shape(boxes: Tensor, img_shapes: Tensor) -> Tensor:
    """Clamp xyxy boxes [B, K, 4] to each image's [0, w] x [0, h], img_shapes
    [B, 2] (h, w)."""
    h = img_shapes[:, 0, None].to(boxes.dtype)
    w = img_shapes[:, 1, None].to(boxes.dtype)
    return torch.stack([torch.minimum(boxes[..., 0].clamp(min=0), w),
                        torch.minimum(boxes[..., 1].clamp(min=0), h),
                        torch.minimum(boxes[..., 2].clamp(min=0), w),
                        torch.minimum(boxes[..., 3].clamp(min=0), h)], -1)


def get_bboxes(cls_logits: Tensor, bbox_pred: Tensor, centerness: Tensor, points: Tensor,
               img_hw, scale_factors: Tensor, cfg: InferenceCfg, rescale: bool = True,
               img_shapes: Tensor | None = None):
    """Decode + NMS of a batch: cls_logits [B, P, C], bbox_pred [B, P, 4]
    (l, t, r, b px), centerness [B, P], points [P, 2], scale_factors [B, 4]
    (w, h, w, h; boxes are divided by it when `rescale`).

    Boxes are clamped to `img_shapes` [B, 2] (h, w), each image's resized
    extent before padding (the reference's img_shape), or, when it is None,
    to the static canvas `img_hw`. Returns multiclass_nms's (dets, labels,
    valid), batched."""
    scores, ctr, pts, dist = _topk_candidates(cls_logits, bbox_pred, centerness, points,
                                              cfg.nms_pre)
    if img_shapes is None:
        boxes = distance2bbox(pts, dist, max_shape=img_hw)
    else:
        boxes = _clamp_to_shape(distance2bbox(pts, dist), img_shapes)
    if rescale:
        boxes = boxes / scale_factors[:, None, :]
    return multiclass_nms(boxes, scores, cfg.score_thr, cfg.nms_iou, cfg.max_per_img,
                          score_factors=ctr)


def get_bboxes_single(cls_logits: Tensor, bbox_pred: Tensor, centerness: Tensor,
                      points: Tensor, img_hw, scale_factor: Tensor, cfg: InferenceCfg,
                      rescale: bool = True, img_shape: Tensor | None = None):
    """get_bboxes of one image: [P, C], [P, 4], [P], scale_factor [4],
    img_shape [2] or None -> (dets [N, 5], labels [N], valid [N])."""
    out = get_bboxes(cls_logits[None], bbox_pred[None], centerness[None], points, img_hw,
                     scale_factor[None], cfg, rescale,
                     None if img_shape is None else img_shape[None])
    return tuple(x[0] for x in out)


def build_inference_fn(cfg: InferenceCfg, img_size: int, stride: int = 8):
    """infer(model, images [B, S, S, 3], scale_factors [B, 4], img_shapes
    [B, 2] or None) -> (dets [B, N, 5], labels [B, N], valid [B, N]). Run it
    on the teacher for the reference's test behaviour."""
    hw = (img_size, img_size)

    @torch.no_grad()
    def infer(model, images: Tensor, scale_factors: Tensor, img_shapes: Tensor | None = None):
        points = grid_points(img_size // stride, img_size // stride, stride,
                             device=images.device)
        with record_function("pt.infer"):
            with record_function("pt.infer/forward"):
                outs, _ = model(images)
            with record_function("pt.infer/nms"):
                return get_bboxes(*_flatten_head(outs), points, hw, scale_factors, cfg,
                                  img_shapes=img_shapes)

    return infer


def build_rfla_inference_fn(cfg: InferenceCfg, img_size: int):
    """infer(model, images [B, S, S, 3], scale_factors [B, 4], img_shapes
    [B, 2] or None) -> (dets [B, N, 5], labels [B, N], valid [B, N]) of an
    RFLAFCOS: each level's nms_pre points by max(score x centerness)
    (stable_topk), decoded and clamped to the image (img_shapes, or the
    canvas), divided by the scale factor, then one multiclass NMS over the
    levels' candidates with the centerness as score factors."""
    hw = (img_size, img_size)

    @torch.no_grad()
    def infer(model, images: Tensor, scale_factors: Tensor, img_shapes: Tensor | None = None):
        shapes = (img_shapes if img_shapes is not None else
                  torch.tensor([hw], dtype=torch.float32, device=images.device)
                  .expand(images.shape[0], 2))
        with record_function("pt.infer"):
            with record_function("pt.infer/forward"):
                outs = model(images)
            with record_function("pt.infer/nms"):
                boxes_l, scores_l, ctr_l = [], [], []
                for (cl, bb, ct), stride in zip(outs, STRIDES):
                    n = -(-img_size // stride)
                    points = grid_points(n, n, stride, device=images.device)
                    scores, ctr, pts, dist = _topk_candidates(*_flatten_head((cl, bb, ct)),
                                                              points, cfg.nms_pre)
                    boxes = _clamp_to_shape(distance2bbox(pts, dist), shapes)
                    boxes_l.append(boxes / scale_factors[:, None, :])
                    scores_l.append(scores)
                    ctr_l.append(ctr)
                return multiclass_nms(torch.cat(boxes_l, 1), torch.cat(scores_l, 1),
                                      cfg.score_thr, cfg.nms_iou, cfg.max_per_img,
                                      score_factors=torch.cat(ctr_l, 1))

    return infer


def get_rbboxes(cls_logits: Tensor, pred5: Tensor, points: Tensor, scale_factors: Tensor,
                cfg: InferenceCfg):
    """Rotated decode + NMS of a batch: cls_logits [B, P, C], pred5 [B, P, 5]
    (l, t, r, b px, angle), points [P, 2], scale_factors [B, 4] (w, h, w, h).

    The reference's rotated rules: nms_pre ranks by the raw max class score
    (no centerness), the NMS takes no score factors, (cx, cy, w, h) are
    divided by the scale factor and the angle is not, and nothing is clamped
    to the image. Returns multiclass_nms_rotated's (dets [B, N, 6], labels,
    valid)."""
    scores = score_sigmoid(cls_logits)
    k = min(cfg.nms_pre, scores.shape[1])
    _, topk = stable_topk(scores.amax(-1), k)
    rb = distance_angle_decode(points[topk], _gather(pred5, topk))
    rb = torch.cat([rb[..., :4] / scale_factors[:, None, :], rb[..., 4:]], -1)
    return multiclass_nms_rotated(rb, _gather(scores, topk), cfg.score_thr, cfg.nms_iou,
                                  cfg.max_per_img)


def get_rbboxes_single(cls_logits: Tensor, pred5: Tensor, centerness: Tensor, points: Tensor,
                       scale_factor: Tensor, cfg: InferenceCfg):
    """get_rbboxes of one image: [P, C], [P, 5], scale_factor [4] -> (dets
    [N, 6], labels [N], valid [N]). `centerness` [P] is taken, as the
    reference's signature takes it, and not used."""
    del centerness
    out = get_rbboxes(cls_logits[None], pred5[None], points, scale_factor[None], cfg)
    return tuple(x[0] for x in out)


def build_rotated_inference_fn(cfg: InferenceCfg, img_size: int, stride: int = 8):
    """infer(model, images [B, S, S, 3], scale_factors [B, 4]) -> (dets
    [B, N, 6] (cx, cy, w, h, a, score), labels [B, N], valid [B, N]) of the
    rotated detector."""

    @torch.no_grad()
    def infer(model, images: Tensor, scale_factors: Tensor):
        points = grid_points(img_size // stride, img_size // stride, stride,
                             device=images.device)
        with record_function("pt.infer"):
            with record_function("pt.infer/forward"):
                outs, _ = model(images)
            with record_function("pt.infer/nms"):
                cls, bbox, angle, _ = _flatten_rhead(outs)
                return get_rbboxes(cls, torch.cat([bbox, angle], -1), points, scale_factors,
                                   cfg)

    return infer


def map_back_boxes(boxes: Tensor, img_shape: Tensor, scale_factor: Tensor,
                   flipped: Tensor) -> Tensor:
    """bbox_mapping_back, batched: clamp boxes [B, K, 4] to each view's
    resized shape img_shape [B, 2] (h, w), undo the horizontal flip (flipped
    [B] bool; the flip comes before the padding, so its axis is the resized
    width), divide by scale_factor [B, 4] into original-image pixels."""
    h = img_shape[:, 0, None].to(boxes.dtype)
    w = img_shape[:, 1, None].to(boxes.dtype)
    x1 = torch.minimum(boxes[..., 0].clamp(min=0), w)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0), h)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0), w)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0), h)
    flip = flipped[:, None]
    fx1 = torch.where(flip, w - x2, x1)
    fx2 = torch.where(flip, w - x1, x2)
    return torch.stack([fx1, y1, fx2, y2], -1) / scale_factor[:, None, :]


def _build_raw_view_fn(cfg: InferenceCfg, canvas: int, stride: int = 8):
    """One TTA view: forward -> per-image top-k -> decode -> map back to
    original-image pixels, no NMS. Returns raw(model, images, img_shapes,
    scale_factors, flipped) -> (boxes [B, K, 4], scores [B, K, C],
    centerness [B, K])."""

    def raw(model, images: Tensor, img_shapes: Tensor, scale_factors: Tensor,
            flipped: Tensor):
        points = grid_points(canvas // stride, canvas // stride, stride, device=images.device)
        with record_function("pt.infer/forward"):
            outs, _ = model(images)
        scores, ctr, pts, dist = _topk_candidates(*_flatten_head(outs), points, cfg.nms_pre)
        boxes = map_back_boxes(distance2bbox(pts, dist), img_shapes, scale_factors, flipped)
        return boxes, scores, ctr

    return raw


def build_tta_inference_fn(cfg: InferenceCfg, canvases: Sequence[int], stride: int = 8):
    """Multi-scale + flip test-time augmentation: each view's nms_pre top-k,
    mapped back to original-image pixels, merged by one multiclass NMS with
    the views' centerness as score factors. `canvases` lists the views'
    canvas sizes (a flipped view repeats its size). Returns infer(model,
    views), views a sequence of dicts of tensors: image [B, c, c, 3],
    img_shape [B, 2], scale_factor [B, 4], flipped [B] bool."""
    raw_fns = {c: _build_raw_view_fn(cfg, c, stride) for c in sorted({int(c) for c in canvases})}

    @torch.no_grad()
    def infer(model, views: Sequence[Dict[str, Tensor]]):
        with record_function("pt.infer"):
            outs = [raw_fns[int(v["image"].shape[1])](model, v["image"], v["img_shape"],
                                                      v["scale_factor"], v["flipped"])
                    for v in views]
            with record_function("pt.infer/nms"):
                boxes, scores, ctr = (torch.cat([o[i] for o in outs], 1) for i in range(3))
                return multiclass_nms(boxes, scores, cfg.score_thr, cfg.nms_iou,
                                      cfg.max_per_img, score_factors=ctr)

    return infer
