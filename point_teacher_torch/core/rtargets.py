"""Rotated FCOS targets of the synthetic and the pseudo path (counterpart of
point_teacher_tpu/core/rtargets.py): one image, padded GTs."""
from __future__ import annotations

import torch

from ..ops.rotated import rbox_ltrb_targets
from .assigners import labels_from_assignment
from .targets import AssignerCfg, assign_points_to_gts

Tensor = torch.Tensor


def _take_targets(points: Tensor, rboxes: Tensor, assigned: Tensor):
    """(l, t, r, b) in the assigned box's frame and its angle; unassigned
    points take GT row 0 (reference quirk)."""
    idx = assigned.clamp(0, rboxes.shape[0] - 1)
    ltrb_all = rbox_ltrb_targets(points, rboxes)                      # [P, G, 4]
    ltrb = ltrb_all[torch.arange(points.shape[0], device=points.device), idx]
    return ltrb, rboxes[idx, 4:5]


def syn_targets_rotated(points, cls_logits, gt_rboxes, gt_valid, num_classes: int,
                        cfg: AssignerCfg):
    """Targets of the synthetic view on its rotated boxes [G, 5], every GT
    labelled 0. Returns (labels [P], ltrb [P, 4], angle [P, 1])."""
    gt_labels = torch.zeros(gt_rboxes.shape[0], dtype=torch.long, device=gt_rboxes.device)
    assigned = assign_points_to_gts(points, cls_logits, gt_rboxes[:, :4], gt_labels, gt_valid,
                                    cfg)
    labels = labels_from_assignment(assigned, gt_labels, num_classes)
    ltrb, angle = _take_targets(points, gt_rboxes, assigned)
    return labels, ltrb, angle


def pseudo_targets_rotated(points, cls_logits, gt_points, gt_labels, gt_valid, pseudo_rboxes,
                           pseudo_valid, num_classes: int, cls_assigner: AssignerCfg,
                           reg_assigner: AssignerCfg):
    """cls targets from the (refined) annotation points, reg and angle
    targets from the pseudo rotated boxes. Returns (labels [P], labels_reg
    [P], ltrb [P, 4], angle [P, 1])."""
    gp = torch.cat([gt_points, torch.zeros_like(gt_points)], -1)
    assigned_cls = assign_points_to_gts(points, cls_logits, gp, gt_labels, gt_valid, cls_assigner)
    labels = labels_from_assignment(assigned_cls, gt_labels, num_classes)
    assigned_reg = assign_points_to_gts(points, cls_logits, pseudo_rboxes[:, :4], gt_labels,
                                        pseudo_valid, reg_assigner)
    labels_reg = labels_from_assignment(assigned_reg, gt_labels, num_classes)
    ltrb, angle = _take_targets(points, pseudo_rboxes, assigned_reg)
    return labels, labels_reg, ltrb, angle
