"""RFLA-FCOS: the multi-level FCOS detector of the RFLA baseline
(counterpart of point_teacher_tpu/models/rfla_fcos_head.py).

ResNet-50 + FPN (P3-P7, strides 8-128, no PSAGG) + a head whose GN(32)
towers are shared across the levels, with a learnable Scale a level and
exp decode, centerness on the cls feature. Its targets
come from the RFLA hierarchical assigner (core/rfla.py) run on each point's
theoretical-receptive-field box (gen_trf); the assigner gives a point at
most one GT, so the reference's masked area-min reduces to a gather of that
GT.

Images [B, H, W, 3] raw 0-255 pixels in, per-level maps NHWC f32 out;
NCHW inside. Module names follow the reference torch keys (cls_convs.i.conv,
cls_convs.i.gn, conv_cls, conv_reg, conv_centerness, scales.i.scale).
`dtype` is the compute dtype: bfloat16 runs the convs under autocast.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.rfla import HieAssignerCfg, hierarchical_assign
from ..ops.boxes import bbox2distance, grid_points
from .fcos_head import Scale
from .fpn import FPN
from .resnet import ResNet
from .rotated_head import ConvGN, _conv

Tensor = torch.Tensor
STRIDES = (8, 16, 32, 64, 128)


def gen_trf() -> Tuple[int, ...]:
    """Theoretical receptive fields of P2..P7 of ResNet-50-FPN:
    (35, 91, 267, 427, 555, 811)."""
    j = [2 ** i for i in range(8)]
    r1 = 1 + (7 - 1) * j[0]
    r2 = r1 + (3 - 1) * j[1]
    trf_p2 = r2 + (3 - 1) * j[2] * 3
    r3 = trf_p2 + (3 - 1) * j[2]
    trf_p3 = r3 + (3 - 1) * j[3] * 3
    r4 = trf_p3 + (3 - 1) * j[3]
    trf_p4 = r4 + (3 - 1) * j[4] * 5
    r5 = trf_p4 + (3 - 1) * j[4]
    trf_p5 = r5 + (3 - 1) * j[5] * 2
    trf_p6 = trf_p5 + (3 - 1) * j[6]
    trf_p7 = trf_p6 + (3 - 1) * j[7]
    return (trf_p2, trf_p3, trf_p4, trf_p5, trf_p6, trf_p7)


def level_points_and_rfields(img_size: int, device=None):
    """Per-level grid points (STRIDES) and their receptive-field boxes (a
    third of the theoretical receptive field of the level above, FPN from p3),
    concatenated over the levels: (points [P, 2], rfields [P, 4] xyxy, the
    levels' feature sizes, each point's stride [P])."""
    trfs = gen_trf()
    pts, rfs, sizes, strs = [], [], [], []
    for num, stride in enumerate(STRIDES):
        feat = int(math.ceil(img_size / stride))
        p = grid_points(feat, feat, stride, device=device)
        half = trfs[min(num + 1, len(trfs) - 1)] * (1 / 3) / 2.0
        pts.append(p)
        rfs.append(torch.cat([p - half, p + half], -1))
        sizes.append(feat)
        strs.append(torch.full((feat * feat,), float(stride), device=device))
    return torch.cat(pts), torch.cat(rfs), sizes, torch.cat(strs)


def rfla_targets(points: Tensor, rfields: Tensor, gt_boxes: Tensor, gt_labels: Tensor,
                 gt_valid: Tensor, num_classes: int):
    """One image's RFLA targets: labels [P] (num_classes = background) and
    (l, t, r, b) targets [P, 4] to the assigned GT (GT 0 where none)."""
    assigned = hierarchical_assign(rfields, gt_boxes, gt_valid, HieAssignerCfg())
    safe = assigned.clamp(0, gt_boxes.shape[0] - 1)
    labels = torch.where(assigned >= 0, gt_labels.long()[safe], num_classes)
    return labels, bbox2distance(points, gt_boxes[safe])


class RFLAFCOSHead(nn.Module):
    def __init__(self, num_classes: int, feat_channels: int = 256, stacked_convs: int = 4,
                 num_levels: int = 5, generator: torch.Generator | None = None):
        super().__init__()
        g, c = generator, feat_channels
        # flax GroupNorm's default epsilon, which the JAX head keeps
        self.cls_convs = nn.ModuleList(ConvGN(c, g, eps=1e-6) for _ in range(stacked_convs))
        self.reg_convs = nn.ModuleList(ConvGN(c, g, eps=1e-6) for _ in range(stacked_convs))
        self.conv_cls = _conv(c, num_classes, g, bias=-math.log((1 - 0.01) / 0.01))
        self.conv_reg = _conv(c, 4, g)
        self.conv_centerness = _conv(c, 1, g)
        self.scales = nn.ModuleList(Scale(1.0) for _ in range(num_levels))

    def forward(self, feats: Sequence[Tensor]):
        """Per level NCHW feature -> (cls_logits, bbox_pred in px, centerness),
        NCHW f32: exp decode, centerness on the cls feature."""
        outs = []
        for lvl, x in enumerate(feats):
            cls_feat = reg_feat = x
            for conv in self.cls_convs:
                cls_feat = F.relu(conv(cls_feat))
            for conv in self.reg_convs:
                reg_feat = F.relu(conv(reg_feat))
            cls_score = self.conv_cls(cls_feat).float()
            bbox_pred = torch.exp(self.conv_reg(reg_feat).float() * self.scales[lvl].scale)
            centerness = self.conv_centerness(cls_feat).float()
            outs.append((cls_score, bbox_pred, centerness))
        return outs


class RFLAFCOS(nn.Module):
    """ResNet-50 + FPN (P3-P7) + RFLAFCOSHead; weights drawn from `seed`."""

    strides = STRIDES

    def __init__(self, num_classes: int = 8, frozen_stages: int = -1,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 backbone_style: str = "caffe"):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.num_classes = num_classes
        self.backbone = ResNet(frozen_stages=frozen_stages, generator=g, style=backbone_style)
        self.neck = FPN(generator=g)
        self.bbox_head = RFLAFCOSHead(num_classes, num_levels=len(self.strides), generator=g)

    def forward(self, img: Tensor):
        """img [B, H, W, 3] -> per level (cls [B, h, w, K], bbox [B, h, w, 4]
        px, centerness [B, h, w, 1]), NHWC f32."""
        fmt = torch.channels_last if img.is_cuda else torch.contiguous_format
        with torch.autocast(img.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            x = img.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
            outs = self.bbox_head(self.neck(self.backbone(x)))
        return [tuple(o.permute(0, 2, 3, 1) for o in lvl) for lvl in outs]

    def flatten_outs(self, outs):
        """Per-level NHWC maps -> (cls [B, P, K], bbox [B, P, 4], ctr [B, P])
        over all levels, each level row-major."""
        b = outs[0][0].shape[0]
        return (torch.cat([o[0].reshape(b, -1, self.num_classes) for o in outs], 1),
                torch.cat([o[1].reshape(b, -1, 4) for o in outs], 1),
                torch.cat([o[2].reshape(b, -1) for o in outs], 1))
