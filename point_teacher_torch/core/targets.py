"""Dense-head targets of the pseudo path (counterpart of
point_teacher_tpu/core/targets.py): one image, padded GTs."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.boxes import bbox2distance, xyxy_to_cxcywh
from .assigners import labels_from_assignment, topk_assign
from .costs import focal_cost, point_cost

Tensor = torch.Tensor


class AssignerCfg(NamedTuple):
    num_pre: int = 3
    topk: int = 3
    cls_weight: float = 0.0
    reg_weight: float = 1.0
    reg_mode: str = "L1"


def assign_points_to_gts(points, cls_logits, gt_cxcywh, gt_labels, gt_valid,
                         cfg: AssignerCfg) -> Tensor:
    """TopkAssigner.assign: assigned [P] (0-based, -1 bg)."""
    reg = point_cost(points, gt_cxcywh, weight=cfg.reg_weight, mode=cfg.reg_mode)
    if cfg.num_pre > cfg.topk:
        stage2 = focal_cost(cls_logits, gt_labels, weight=cfg.cls_weight)
    else:
        stage2 = torch.zeros_like(reg)
    return topk_assign(reg, stage2, gt_valid, cfg.num_pre, cfg.topk)


def box_targets_for_assignment(points: Tensor, gt_xyxy: Tensor, assigned: Tensor) -> Tensor:
    """(l, t, r, b) targets; unassigned points take GT row 0 (reference quirk)."""
    idx = assigned.clamp(0, gt_xyxy.shape[0] - 1)
    return bbox2distance(points, gt_xyxy[idx])


def pseudo_targets(points, cls_logits, gt_points, gt_labels, gt_valid, pseudo_xyxy,
                   pseudo_labels, pseudo_valid, num_classes: int,
                   cls_assigner: AssignerCfg, reg_assigner: AssignerCfg):
    """cls targets from the (refined) annotation points, reg targets from the
    pseudo boxes. Returns (labels [P], labels_reg [P], bbox_targets [P, 4])."""
    gp = torch.cat([gt_points, torch.zeros_like(gt_points)], -1)
    assigned_cls = assign_points_to_gts(points, cls_logits, gp, gt_labels, gt_valid, cls_assigner)
    labels = labels_from_assignment(assigned_cls, gt_labels, num_classes)
    ps_cxcywh = xyxy_to_cxcywh(pseudo_xyxy)
    assigned_reg = assign_points_to_gts(points, cls_logits, ps_cxcywh, pseudo_labels,
                                        pseudo_valid, reg_assigner)
    labels_reg = labels_from_assignment(assigned_reg, pseudo_labels, num_classes)
    bbox_targets = box_targets_for_assignment(points, pseudo_xyxy, assigned_reg)
    return labels, labels_reg, bbox_targets
