"""Proposal bags for the MIL head (counterpart of point_teacher_tpu/core/proposals.py).

Bag size U = len(base_ratios)^2 * (1 + 4 * len(shake_ratio or ())).
Functions take any leading batch dims.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import math

import torch

from ..ops.boxes import bbox_overlaps, cxcywh_to_xyxy, xyxy_to_cxcywh
from ..utils.device import constant

Tensor = torch.Tensor


class FineProposalCfg(NamedTuple):
    base_ratios: Tuple[float, ...] = (1.0,)
    shake_ratio: Optional[Tuple[float, ...]] = None
    min_scale: float = 0.0
    gen_num_neg: int = 0


def fine_proposals(boxes_xyxy: Tensor, cfg: FineProposalCfg, img_hw) -> Tuple[Tensor, Tensor]:
    """boxes [..., G, 4] -> (proposals [..., G, U, 4], valid [..., G, U]).
    Member order is combo-major ([base, l, r, t, d] per ratio combo)."""
    dev, dt = boxes_xyxy.device, boxes_xyxy.dtype
    c = xyxy_to_cxcywh(boxes_xyxy)
    wh = c[..., 2:4].clamp(cfg.min_scale, 1000.0)
    ratios = constant([(rw, rh) for rw in cfg.base_ratios for rh in cfg.base_ratios],
                      dt, dev)                                               # [R2, 2]
    r2 = ratios.shape[0]
    ctr = c[..., None, :2].expand(*c.shape[:-1], r2, 2)
    base = torch.cat([ctr, wh[..., None, :] * ratios], -1)                   # [..., G, R2, 4]
    variants = [base[..., None, :]]
    for ratio in cfg.shake_ratio or ():
        offs = constant([(-ratio, 0.0), (ratio, 0.0), (0.0, -ratio), (0.0, ratio)],
                        dt, dev)                                             # [4, 2]
        shift = base[..., None, 2:4] * offs
        vctr = base[..., None, :2] + shift
        variants.append(torch.cat([vctr, base[..., None, 2:4].expand_as(vctr)], -1))
    stacked = torch.cat(variants, -2)                                        # [..., G, R2, V, 4]
    props = cxcywh_to_xyxy(stacked.reshape(*boxes_xyxy.shape[:-1], -1, 4))
    h, w = img_hw
    img_box = constant([[0.0, 0.0, w, h]], dt, dev)
    iof = bbox_overlaps(props.reshape(-1, 4), img_box, mode="iof")[:, 0]
    return props, (iof > 0.7).reshape(props.shape[:-1])


def negative_proposals(u: Tensor, pos_proposals: Tensor, pos_valid: Tensor,
                       img_hw) -> Tuple[Tensor, Tensor]:
    """u [..., 4, N] uniforms in [0, 1) (the draws of the reference's four
    keys) -> random background boxes [..., N, 4] and weight [..., N] (True when
    IoU with every valid positive proposal < 0.3). pos_proposals [..., M1, M2, 4]."""
    h, w = img_hw
    x1 = u[..., 0, :] * w * 0.8
    y1 = u[..., 1, :] * h * 0.8
    x2 = x1 + u[..., 2, :] * 100.0
    y2 = y1 + u[..., 3, :] * 100.0
    neg = torch.stack([x1, y1, x2, y2], -1)
    lead = neg.shape[:-2]
    iou = bbox_overlaps(neg, pos_proposals.reshape(*lead, -1, 4))
    iou = torch.where(pos_valid.reshape(*lead, 1, -1), iou, 0.0)
    return neg, (iou < 0.3).all(-1)


def delta_decode(proposals_xyxy: Tensor, deltas: Tensor, img_hw,
                 wh_ratio_clip: float = 16 / 1000) -> Tensor:
    """DeltaXYWHBBoxCoder.decode with means 0 / stds 1, clipped to the image."""
    c = xyxy_to_cxcywh(proposals_xyxy)
    max_ratio = abs(math.log(wh_ratio_clip))
    dwh = deltas[..., 2:4].clamp(-max_ratio, max_ratio)
    ctr = c[..., :2] + deltas[..., :2] * c[..., 2:4]
    wh = c[..., 2:4] * torch.exp(dwh)
    out = cxcywh_to_xyxy(torch.cat([ctr, wh], -1))
    h, w = img_hw
    return torch.stack([out[..., 0].clamp(0, w), out[..., 1].clamp(0, h),
                        out[..., 2].clamp(0, w), out[..., 3].clamp(0, h)], -1)
