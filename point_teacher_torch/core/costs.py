"""Match costs over padded GT sets (counterpart of point_teacher_tpu/core/costs.py,
the members the phase-2 assigners use). All return [P, G] cost matrices."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def focal_cost(cls_logits: Tensor, gt_labels: Tensor, weight: float = 1.0,
               alpha: float = 0.25, gamma: float = 2.0, eps: float = 1e-12) -> Tensor:
    """cls_logits [P, C], gt_labels [G] -> [P, G]."""
    p = torch.sigmoid(cls_logits)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * torch.pow(p, gamma)
    pos = -torch.log(p + eps) * alpha * torch.pow(1 - p, gamma)
    cost = pos - neg
    safe = gt_labels.clamp(0, cls_logits.shape[-1] - 1).long()
    return cost[:, safe] * weight


def point_cost(points: Tensor, gt_cxcywh: Tensor, weight: float = 1.0, mode: str = "L1") -> Tensor:
    """points [P, >=2], gt [G, >=2] -> [P, G] distance of the first two dims."""
    d = points[:, None, :2] - gt_cxcywh[None, :, :2]
    dist = d.abs().sum(-1) if mode == "L1" else torch.sqrt((d * d).sum(-1))
    return dist * weight


def insider_cost(pred_cxcywh: Tensor, gt_points: Tensor, weight: float = 1.0) -> Tensor:
    """0 where the gt point lies inside the predicted box, else 1. [P, G]."""
    x1 = pred_cxcywh[:, 0] - pred_cxcywh[:, 2] / 2
    y1 = pred_cxcywh[:, 1] - pred_cxcywh[:, 3] / 2
    x2 = pred_cxcywh[:, 0] + pred_cxcywh[:, 2] / 2
    y2 = pred_cxcywh[:, 1] + pred_cxcywh[:, 3] / 2
    gx = gt_points[None, :, 0]
    gy = gt_points[None, :, 1]
    inside = (gx >= x1[:, None]) & (gx <= x2[:, None]) & (gy >= y1[:, None]) & (gy <= y2[:, None])
    return torch.where(inside, 0.0, 1.0).to(pred_cxcywh.dtype) * weight
