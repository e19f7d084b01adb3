"""Teacher pseudo boxes: score-weighted fusion of the teacher predictions
matched to each annotation point (counterpart of point_teacher_tpu/core/pseudo.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.boxes import bbox_overlaps, cxcywh_to_xyxy, distance2bbox, xyxy_to_cxcywh
from .assigners import topk_assign
from .costs import focal_cost, insider_cost, point_cost

Tensor = torch.Tensor


class FuseAssignerCfg(NamedTuple):
    num_pre: int = 5
    topk: int = 3
    cls_weight: float = 1.0
    reg_weight: float = 1.0
    insider_weight: float = 1.0
    reg_mode: str = "L1"


def generate_pseudo_boxes(points, cls_logits, bbox_pred, gt_points, gt_labels, gt_valid,
                          gt_boxes_xyxy, filter_score: float, cfg: FuseAssignerCfg) -> dict:
    """One image. points [P, 2]; cls_logits [P, C]; bbox_pred [P, 4] (l, t, r, b
    px); gt_points [G, 2]; gt_labels [G]; gt_valid [G]; gt_boxes_xyxy [G, 4]
    (diagnostics). Unmatched slots get an 8x8 box on the annotation point."""
    num_points = points.shape[0]
    g = gt_points.shape[0]
    decoded = distance2bbox(points, bbox_pred)
    decoded_cxcywh = xyxy_to_cxcywh(decoded)

    reg = point_cost(points, gt_points, weight=cfg.reg_weight, mode=cfg.reg_mode)
    stage2 = (focal_cost(cls_logits, gt_labels, weight=cfg.cls_weight)
              + insider_cost(decoded_cxcywh, gt_points, weight=cfg.insider_weight))
    assigned = topk_assign(reg, stage2, gt_valid, cfg.num_pre, cfg.topk)

    pos = assigned >= 0
    safe_gt = assigned.clamp(0, g - 1)
    lab = torch.where(pos, gt_labels.long()[safe_gt], 0)
    scores = torch.sigmoid(cls_logits)[torch.arange(num_points, device=points.device), lab]

    onehot = (safe_gt[:, None] == torch.arange(g, device=points.device)).to(decoded.dtype)
    onehot = onehot * pos[:, None]
    w = scores * pos
    box_sum = (onehot * w[:, None]).T @ decoded
    w_sum = onehot.T @ w
    n_assigned = onehot.sum(0)

    matched = n_assigned > 0
    default_box = cxcywh_to_xyxy(torch.cat([gt_points, torch.full_like(gt_points, 8.0)], -1))
    pseudo_boxes = torch.where(matched[:, None], box_sum / w_sum.clamp(min=1e-12)[:, None],
                               default_box)
    pseudo_scores = torch.where(matched, w_sum / n_assigned.clamp(min=1.0), 0.0)
    pseudo_points = torch.where(matched[:, None], xyxy_to_cxcywh(pseudo_boxes)[:, :2], gt_points)

    ious = bbox_overlaps(pseudo_boxes, gt_boxes_xyxy, is_aligned=True)
    ok = matched & gt_valid
    mean_iou = torch.where(ok, ious, 0.0).sum() / ok.sum().clamp(min=1)
    return dict(
        pseudo_boxes=pseudo_boxes,
        pseudo_points=pseudo_points,
        pseudo_labels=gt_labels,
        pseudo_valid=matched & (pseudo_scores >= filter_score) & gt_valid,
        matched=ok,
        mean_iou=mean_iou,
    )
