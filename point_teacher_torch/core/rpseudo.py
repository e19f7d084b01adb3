"""Teacher pseudo rotated boxes (counterpart of point_teacher_tpu/core/rpseudo.py,
generate_pseudo_rboxes): decode (l, t, r, b, theta) with the distance-angle
coder, FUSE top-k assignment (insider cost on the (cx, cy, w, h) part), a
score-weighted average of all five dims (the angle averaged naively, as in
the reference), and the default box (point, 8, 8, 0) for unmatched slots."""
from __future__ import annotations

import torch

from ..ops.rotated import distance_angle_decode, rbox_iou
from .assigners import topk_assign
from .costs import focal_cost, insider_cost, point_cost
from .pseudo import FuseAssignerCfg

Tensor = torch.Tensor


def generate_pseudo_rboxes(points, cls_logits, bbox_angle_pred, gt_points, gt_labels, gt_valid,
                           gt_rboxes, filter_score: float, cfg: FuseAssignerCfg) -> dict:
    """One image. points [P, 2]; cls_logits [P, C]; bbox_angle_pred [P, 5]
    (l, t, r, b px, theta); gt_points [G, 2]; gt_labels, gt_valid [G];
    gt_rboxes [G, 5] (diagnostics)."""
    num_points = points.shape[0]
    g = gt_points.shape[0]
    dev = points.device
    decoded = distance_angle_decode(points, bbox_angle_pred)

    reg = point_cost(points, gt_points, weight=cfg.reg_weight, mode=cfg.reg_mode)
    stage2 = (focal_cost(cls_logits, gt_labels, weight=cfg.cls_weight)
              + insider_cost(decoded[:, :4], gt_points, weight=cfg.insider_weight))
    assigned = topk_assign(reg, stage2, gt_valid, cfg.num_pre, cfg.topk)

    pos = assigned >= 0
    safe_gt = assigned.clamp(0, g - 1)
    lab = torch.where(pos, gt_labels.long()[safe_gt], 0)
    scores = torch.sigmoid(cls_logits)[torch.arange(num_points, device=dev), lab]

    onehot = (safe_gt[:, None] == torch.arange(g, device=dev)).to(decoded.dtype) * pos[:, None]
    w = scores * pos
    box_sum = (onehot * w[:, None]).T @ decoded
    w_sum = onehot.T @ w
    n_assigned = onehot.sum(0)

    matched = n_assigned > 0
    default_box = torch.cat([gt_points, torch.full((g, 2), 8.0, dtype=decoded.dtype, device=dev),
                             torch.zeros((g, 1), dtype=decoded.dtype, device=dev)], -1)
    pseudo = torch.where(matched[:, None], box_sum / w_sum.clamp(min=1e-12)[:, None], default_box)
    pseudo_scores = torch.where(matched, w_sum / n_assigned.clamp(min=1.0), 0.0)
    pseudo_points = torch.where(matched[:, None], pseudo[:, :2], gt_points)

    ious = rbox_iou(pseudo, gt_rboxes, aligned=True)
    ok = matched & gt_valid
    mean_iou = torch.where(ok, ious, 0.0).sum() / ok.sum().clamp(min=1)
    return dict(
        pseudo_boxes=pseudo,
        pseudo_points=pseudo_points,
        pseudo_labels=gt_labels,
        pseudo_valid=matched & (pseudo_scores >= filter_score) & gt_valid,
        matched=ok,
        mean_iou=mean_iou,
    )
