"""Dense-head losses of the synthetic and the pseudo branch (counterpart of
point_teacher_tpu/train/dense_losses.py). Denominators are taken over the
whole batch."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.targets import AssignerCfg, pseudo_targets, syn_targets
from ..ops.boxes import distance2bbox
from ..ops.losses import (binary_cross_entropy, centerness_target, diou_loss, dn_diou_loss,
                          focal_loss_from_labels)

Tensor = torch.Tensor


class DenseLossCfg(NamedTuple):
    num_classes: int = 8
    syn_assigner: AssignerCfg = AssignerCfg(num_pre=3, topk=3, cls_weight=0.0, reg_weight=1.0)
    cls_assigner: AssignerCfg = AssignerCfg(num_pre=1, topk=1, cls_weight=1.0, reg_weight=1.0)
    pseudo_assigner: AssignerCfg = AssignerCfg(num_pre=3, topk=3, cls_weight=0.0, reg_weight=1.0)
    dn_hyper_burn2: float = 0.1
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


def _reg_and_centerness_loss(bbox_pred, centerness, points, labels, bbox_targets,
                             num_classes, loss_fn):
    """Positive-sample (DN-)DIoU weighted by centerness targets + centerness BCE."""
    b, p = labels.shape
    pos = labels < num_classes
    num_pos = pos.sum().float().clamp(min=1.0)
    ctr_targets = torch.where(pos, centerness_target(bbox_targets), 0.0)
    denorm = ctr_targets.sum().detach().clamp(min=1e-6)
    pts = points[None].expand(b, p, 2)
    decoded_pred = distance2bbox(pts, bbox_pred)
    decoded_tgt = distance2bbox(pts, bbox_targets)
    loss_bbox = loss_fn(decoded_pred.reshape(-1, 4), decoded_tgt.reshape(-1, 4),
                        weight=ctr_targets.reshape(-1), avg_factor=denorm,
                        base_valid=pos.reshape(-1))
    loss_ctr = binary_cross_entropy(centerness.reshape(-1), ctr_targets.reshape(-1),
                                    weight=pos.reshape(-1).float(), avg_factor=num_pos)
    return loss_bbox, loss_ctr


def syn_branch_loss(cls_logits, bbox_pred, centerness, points, syn_boxes, syn_valid,
                    cfg: DenseLossCfg):
    """Box-supervised loss of the synthetic view -> (loss_bbox, loss_centerness):
    DIoU weighted by the centerness targets, and the centerness BCE.

    cls_logits [B, P, C]; bbox_pred [B, P, 4] px; centerness [B, P];
    points [P, 2]; syn_boxes [B, S, 4] xyxy; syn_valid [B, S]."""
    with torch.no_grad():
        targets = [syn_targets(points, cls_logits[i], syn_boxes[i], syn_valid[i],
                               cfg.num_classes, cfg.syn_assigner)
                   for i in range(cls_logits.shape[0])]
    labels, bbox_targets = (torch.stack(t) for t in zip(*targets))
    return _reg_and_centerness_loss(
        bbox_pred, centerness, points, labels, bbox_targets, cfg.num_classes,
        lambda *a, base_valid=None, **kw: diou_loss(*a, **kw))


def pseudo_branch_loss(cls_logits, bbox_pred, centerness, points, gt_points, gt_labels,
                       gt_valid, pseudo_boxes, pseudo_valid, cfg: DenseLossCfg):
    """loss_pseudo -> (loss_cls, loss_bbox, loss_centerness).

    cls_logits [B, P, C]; bbox_pred [B, P, 4] px; centerness [B, P];
    points [P, 2]; gt_points [B, G, 2]; gt_labels, gt_valid, pseudo_valid [B, G];
    pseudo_boxes [B, G, 4]."""
    with torch.no_grad():
        targets = [pseudo_targets(points, cls_logits[i], gt_points[i], gt_labels[i],
                                  gt_valid[i], pseudo_boxes[i], gt_labels[i],
                                  pseudo_valid[i], cfg.num_classes, cfg.cls_assigner,
                                  cfg.pseudo_assigner)
                   for i in range(cls_logits.shape[0])]
    labels, labels_reg, bbox_targets = (torch.stack(t) for t in zip(*targets))

    num_pos_cls = (labels < cfg.num_classes).sum().float().clamp(min=1.0)
    loss_cls = focal_loss_from_labels(
        cls_logits.reshape(-1, cfg.num_classes), labels.reshape(-1), cfg.num_classes,
        avg_factor=num_pos_cls, alpha=cfg.focal_alpha, gamma=cfg.focal_gamma)

    def dn(pred, tgt, weight=None, avg_factor=None, base_valid=None):
        return dn_diou_loss(pred, tgt, weight=weight, avg_factor=avg_factor,
                            hyper=cfg.dn_hyper_burn2, base_valid=base_valid)

    loss_bbox, loss_ctr = _reg_and_centerness_loss(
        bbox_pred, centerness, points, labels_reg, bbox_targets, cfg.num_classes, dn)
    return loss_cls, loss_bbox, loss_ctr
