"""Horizontal-box geometry ops (counterpart of point_teacher_tpu/ops/boxes.py)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def cxcywh_to_xyxy(b: Tensor) -> Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], -1)


def xyxy_to_cxcywh(b: Tensor) -> Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def distance2bbox(points: Tensor, distances: Tensor, max_shape=None) -> Tensor:
    """Decode (l, t, r, b) distances at `points` [..., 2] into xyxy boxes,
    clamped to [0, w] x [0, h] when `max_shape` (h, w) is given."""
    x1 = points[..., 0] - distances[..., 0]
    y1 = points[..., 1] - distances[..., 1]
    x2 = points[..., 0] + distances[..., 2]
    y2 = points[..., 1] + distances[..., 3]
    if max_shape is not None:
        h, w = max_shape
        x1, x2 = x1.clamp(0, w), x2.clamp(0, w)
        y1, y2 = y1.clamp(0, h), y2.clamp(0, h)
    return torch.stack([x1, y1, x2, y2], -1)


def bbox2distance(points: Tensor, bbox_xyxy: Tensor) -> Tensor:
    """(l, t, r, b) distances from `points` [..., 2] to xyxy boxes."""
    return torch.stack([points[..., 0] - bbox_xyxy[..., 0], points[..., 1] - bbox_xyxy[..., 1],
                        bbox_xyxy[..., 2] - points[..., 0], bbox_xyxy[..., 3] - points[..., 1]], -1)


def _area(b: Tensor) -> Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)


def bbox_overlaps(bboxes1: Tensor, bboxes2: Tensor, mode: str = "iou",
                  is_aligned: bool = False, eps: float = 1e-6) -> Tensor:
    """IoU / IoF between xyxy boxes.

    Pairwise: [..., M, 4] x [..., N, 4] -> [..., M, N].
    Aligned:  [..., M, 4] x [..., M, 4] -> [..., M].
    """
    if mode not in ("iou", "iof"):
        raise ValueError(f"unknown overlap mode {mode!r}")
    area1 = _area(bboxes1)
    area2 = _area(bboxes2)
    if is_aligned:
        b1, b2 = bboxes1, bboxes2
    else:
        b1 = bboxes1[..., :, None, :]
        b2 = bboxes2[..., None, :, :]
        area1 = area1[..., :, None]
        area2 = area2[..., None, :]

    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1 if mode == "iof" else area1 + area2 - overlap
    union = union.clamp(min=eps)
    return overlap / union


def grid_points(feat_h: int, feat_w: int, stride: int, device=None) -> Tensor:
    """Stride-spaced grid point centres, row-major over (y, x), offset stride // 2."""
    ys = torch.arange(feat_h, device=device, dtype=torch.float32) * stride + stride // 2
    xs = torch.arange(feat_w, device=device, dtype=torch.float32) * stride + stride // 2
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
