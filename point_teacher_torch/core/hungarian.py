"""Point-Hungarian assignment, one prediction to one GT (counterpart of
point_teacher_tpu/core/hungarian.py).

Capability target: PHungarianAssigner (p_hungarian_assigner.py:40-100 of the
reference): cost = focal class cost + centerness-vs-1 L1 cost + insider
(point-in-box) cost, solved with scipy's linear_sum_assignment. No shipped
config selects it (they use the FUSE top-k assigner), and no step calls it:
it is here for config parity. The cost is computed on the inputs' device,
with numpy's type promotion of the JAX package's version (the class cost in
the inputs' dtype, the sum in f64); only the GT mask and the cost matrix go to
the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class HungarianCfg(NamedTuple):
    cls_weight: float = 1.0
    center_weight: float = 1.0
    insider_weight: float = 1.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


def hungarian_cost(pred_cxcywh: Tensor, cls_logits: Tensor, centerness: Tensor,
                   gt_points: Tensor, gt_labels: Tensor,
                   cfg: HungarianCfg = HungarianCfg()) -> Tensor:
    """[P, G] f64 cost of each prediction against each GT point.

    pred_cxcywh [P, 4] decoded boxes, cls_logits [P, C], centerness [P]
    logits, gt_points [G, 2], gt_labels [G]."""
    # focal class cost (match_cost.py:54-99)
    prob = 1.0 / (1.0 + torch.exp(-cls_logits))
    eps = 1e-12
    neg = -torch.log(1 - prob + eps) * (1 - cfg.focal_alpha) * prob ** cfg.focal_gamma
    pos = -torch.log(prob + eps) * cfg.focal_alpha * (1 - prob) ** cfg.focal_gamma
    cls_cost = (pos - neg)[:, gt_labels] * cfg.cls_weight
    # centerness L1 cost against target 1 (CenternessCost, match_cost.py:254)
    ctr = 1.0 / (1.0 + torch.exp(-centerness))
    center_cost = ((ctr - 1.0).abs().double()[:, None]
                   * torch.ones((1, gt_points.shape[0]), dtype=torch.float64,
                                device=ctr.device)) * cfg.center_weight
    # insider cost (InsiderCost, match_cost.py:216)
    x1 = pred_cxcywh[:, 0] - pred_cxcywh[:, 2] / 2
    y1 = pred_cxcywh[:, 1] - pred_cxcywh[:, 3] / 2
    x2 = pred_cxcywh[:, 0] + pred_cxcywh[:, 2] / 2
    y2 = pred_cxcywh[:, 1] + pred_cxcywh[:, 3] / 2
    gx, gy = gt_points[None, :, 0], gt_points[None, :, 1]
    inside = ((gx >= x1[:, None]) & (gx <= x2[:, None])
              & (gy >= y1[:, None]) & (gy <= y2[:, None]))
    location_cost = (~inside).double() * cfg.insider_weight
    return cls_cost.double() + center_cost + location_cost


def hungarian_assign(pred_cxcywh: Tensor, cls_logits: Tensor, centerness: Tensor,
                     gt_points: Tensor, gt_labels: Tensor, gt_valid: Tensor,
                     cfg: HungarianCfg = HungarianCfg()) -> Tensor:
    """[P] int64 on the inputs' device: the 0-based GT index of each
    prediction, -1 for background. gt_valid [G] bool; with no valid GT, or
    P = 0, every prediction is background."""
    from scipy.optimize import linear_sum_assignment

    dev = pred_cxcywh.device
    p = pred_cxcywh.shape[0]
    assigned = torch.full((p,), -1, dtype=torch.int64)
    idx = torch.nonzero(gt_valid.cpu()).reshape(-1)
    if len(idx) == 0 or p == 0:
        return assigned.to(dev)
    sel = idx.to(dev)
    cost = hungarian_cost(pred_cxcywh, cls_logits, centerness, gt_points[sel],
                          gt_labels[sel], cfg)
    rows, cols = linear_sum_assignment(cost.cpu().numpy())
    assigned[torch.as_tensor(rows)] = idx[torch.as_tensor(cols)]
    return assigned.to(dev)
