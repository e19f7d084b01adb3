"""FCOS dense head on the single stride-8 level (counterpart of
point_teacher_tpu/models/fcos_head.py): 4 stacked 3x3 conv + relu towers per
branch, conv_cls / conv_reg / conv_centerness (centerness on the reg
branch), a learnable Scale and norm_on_bbox decode relu(pred * scale) *
stride. NCHW inside; module names follow the reference torch keys
(cls_convs.i.conv, reg_convs.i.conv, conv_cls, scales.0.scale)."""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .fpn import ConvModule


class Scale(nn.Module):
    def __init__(self, value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(value, dtype=torch.float32))


class FCOSHead(nn.Module):
    def __init__(self, num_classes: int, feat_channels: int, stride: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        g, c = generator, feat_channels
        self.cls_convs = nn.ModuleList(ConvModule(c, c, 3, generator=g, std=0.01) for _ in range(4))
        self.reg_convs = nn.ModuleList(ConvModule(c, c, 3, generator=g, std=0.01) for _ in range(4))
        self.conv_cls = ConvModule(c, num_classes, 3, generator=g, std=0.01,
                                   bias=-math.log((1 - 0.01) / 0.01)).conv
        # small positive bias: see the reference head
        self.conv_reg = ConvModule(c, 4, 3, generator=g, std=0.01, bias=0.1).conv
        self.conv_centerness = ConvModule(c, 1, 3, generator=g, std=0.01).conv
        self.scales = nn.ModuleList([Scale(1.0)])

    def forward(self, feat: torch.Tensor):
        """feat [B, C, H, W] -> (cls_logits, bbox_pred in px, centerness), NCHW f32."""
        cls_feat = reg_feat = feat
        for cls_conv, reg_conv in zip(self.cls_convs, self.reg_convs):
            cls_feat = F.relu(cls_conv(cls_feat))
            reg_feat = F.relu(reg_conv(reg_feat))
        cls_score = self.conv_cls(cls_feat)
        bbox_pred = self.conv_reg(reg_feat)
        centerness = self.conv_centerness(reg_feat)
        # the bf16 conv output times the f32 scale is f32, as in the reference
        bbox_pred = (bbox_pred.float() * self.scales[0].scale).clamp(min=0) * self.stride
        return cls_score.float(), bbox_pred, centerness.float()
