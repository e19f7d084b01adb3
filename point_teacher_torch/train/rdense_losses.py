"""Rotated dense-head losses of the synthetic and the pseudo branch
(counterpart of point_teacher_tpu/train/rdense_losses.py): RotatedIoULoss on
distance-angle-decoded boxes weighted by the centerness targets, the
centerness BCE and, on the pseudo branch, the focal cls loss. Denominators
are taken over the whole batch."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.rtargets import pseudo_targets_rotated, syn_targets_rotated
from ..core.targets import AssignerCfg
from ..ops.losses import (binary_cross_entropy, centerness_target, focal_loss_from_labels,
                          rotated_iou_loss)
from ..ops.rotated import distance_angle_decode

Tensor = torch.Tensor


class RDenseLossCfg(NamedTuple):
    num_classes: int = 9
    syn_assigner: AssignerCfg = AssignerCfg(num_pre=3, topk=3, cls_weight=0.0, reg_weight=1.0)
    cls_assigner: AssignerCfg = AssignerCfg(num_pre=1, topk=1, cls_weight=1.0, reg_weight=1.0)
    pseudo_assigner: AssignerCfg = AssignerCfg(num_pre=3, topk=3, cls_weight=0.0, reg_weight=1.0)
    iou_mode: str = "log"
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


def _rotated_reg_loss(bbox_pred, angle_pred, centerness, points, labels, ltrb_t, angle_t,
                      num_classes: int, iou_mode: str, max_pos: Optional[int] = None):
    """Rotated IoU loss of the positives, weighted by their centerness
    targets, and the centerness BCE.

    The top-k assigner gives at most num_pre positives per GT, so the
    `max_pos` largest-weight rows per image hold every positive: the IoU runs
    on those rows only, chosen as jax.lax.top_k chooses them (descending,
    ties to the lower index), and every row left out has weight 0."""
    b, p = labels.shape
    pos = labels < num_classes
    num_pos = pos.sum().float().clamp(min=1.0)
    ctr_t = torch.where(pos, centerness_target(ltrb_t), 0.0)
    denorm = ctr_t.sum().detach().clamp(min=1e-6)
    pred5 = torch.cat([bbox_pred, angle_pred], -1)
    tgt5 = torch.cat([ltrb_t, angle_t], -1)
    if max_pos is not None and max_pos < p:
        w_top, idx = torch.sort(ctr_t, dim=1, descending=True, stable=True)
        w_top, idx = w_top[:, :max_pos], idx[:, :max_pos]
        pts = points[idx]
        pred5 = pred5.gather(1, idx[..., None].expand(b, max_pos, 5))
        tgt5 = tgt5.gather(1, idx[..., None].expand(b, max_pos, 5))
        weights = w_top
    else:
        pts = points[None].expand(b, p, 2)
        weights = ctr_t
    dec_pred = distance_angle_decode(pts, pred5)
    dec_tgt = distance_angle_decode(pts, tgt5)
    loss_bbox = rotated_iou_loss(dec_pred.reshape(-1, 5), dec_tgt.reshape(-1, 5),
                                 weight=weights.reshape(-1), avg_factor=denorm, mode=iou_mode)
    loss_ctr = binary_cross_entropy(centerness.reshape(-1), ctr_t.reshape(-1),
                                    weight=pos.reshape(-1).float(), avg_factor=num_pos)
    return loss_bbox, loss_ctr


def syn_branch_loss_rotated(cls_logits, bbox_pred, angle_pred, centerness, points, syn_rboxes,
                            syn_valid, cfg: RDenseLossCfg):
    """Loss of the synthetic view on its rotated boxes -> (loss_bbox,
    loss_centerness). syn_rboxes [B, S, 5]; syn_valid [B, S]; the rest as
    pseudo_branch_loss_rotated."""
    with torch.no_grad():
        targets = [syn_targets_rotated(points, cls_logits[i], syn_rboxes[i], syn_valid[i],
                                       cfg.num_classes, cfg.syn_assigner)
                   for i in range(cls_logits.shape[0])]
    labels, ltrb_t, angle_t = (torch.stack(t) for t in zip(*targets))
    return _rotated_reg_loss(bbox_pred, angle_pred, centerness, points, labels, ltrb_t, angle_t,
                             cfg.num_classes, cfg.iou_mode,
                             max_pos=cfg.syn_assigner.num_pre * syn_rboxes.shape[1])


def pseudo_branch_loss_rotated(cls_logits, bbox_pred, angle_pred, centerness, points,
                               gt_points, gt_labels, gt_valid, pseudo_rboxes, pseudo_valid,
                               cfg: RDenseLossCfg):
    """loss_pseudo of the rotated head -> (loss_cls, loss_bbox, loss_centerness).

    cls_logits [B, P, C]; bbox_pred [B, P, 4] px; angle_pred [B, P, 1];
    centerness [B, P]; points [P, 2]; gt_points [B, G, 2]; gt_labels,
    gt_valid, pseudo_valid [B, G]; pseudo_rboxes [B, G, 5]."""
    with torch.no_grad():
        targets = [pseudo_targets_rotated(points, cls_logits[i], gt_points[i], gt_labels[i],
                                          gt_valid[i], pseudo_rboxes[i], pseudo_valid[i],
                                          cfg.num_classes, cfg.cls_assigner, cfg.pseudo_assigner)
                   for i in range(cls_logits.shape[0])]
    labels, labels_reg, ltrb_t, angle_t = (torch.stack(t) for t in zip(*targets))

    num_pos_cls = (labels < cfg.num_classes).sum().float().clamp(min=1.0)
    loss_cls = focal_loss_from_labels(
        cls_logits.reshape(-1, cfg.num_classes), labels.reshape(-1), cfg.num_classes,
        avg_factor=num_pos_cls, alpha=cfg.focal_alpha, gamma=cfg.focal_gamma)
    loss_bbox, loss_ctr = _rotated_reg_loss(
        bbox_pred, angle_pred, centerness, points, labels_reg, ltrb_t, angle_t,
        cfg.num_classes, cfg.iou_mode, max_pos=cfg.pseudo_assigner.num_pre * pseudo_rboxes.shape[1])
    return loss_cls, loss_bbox, loss_ctr
