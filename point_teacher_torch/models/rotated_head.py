"""Rotated FCOS head (counterpart of point_teacher_tpu/models/rotated_head.py):
the FCOS head with GroupNorm(32) towers of bias-free 3x3 convs, centerness on
the cls feature, and an angle branch `conv_angle` on the reg feature with a
learnable `scale_angle`. bbox_pred is relu(pred * scale) * stride.

NCHW inside; module names follow the reference torch keys (cls_convs.i.conv,
cls_convs.i.gn, conv_angle, scales.0.scale, scale_angle.scale).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .fcos_head import Scale
from .init import init_conv_


class GroupNorm(nn.Module):
    """GroupNorm as flax.linen.GroupNorm computes it: statistics in f32 by
    the fast variance max(0, E[x^2] - E[x]^2), y = (x - mean) *
    (rsqrt(var + eps) * weight) + bias in f32, cast back to x's dtype."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xf = x.float()
        grouped = xf.reshape(b, self.num_groups, -1)
        mean = grouped.mean(-1)
        var = ((grouped * grouped).mean(-1) - mean * mean).clamp(min=0.0)
        size = c // self.num_groups
        mean = mean.repeat_interleave(size, 1)[:, :, None, None]
        var = var.repeat_interleave(size, 1)[:, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return ((xf - mean) * mul + self.bias[:, None, None]).to(x.dtype)


class ConvGN(nn.Module):
    """conv (no bias) + gn, under the `.conv` and `.gn` keys of mmcv's ConvModule."""

    def __init__(self, c: int, generator: torch.Generator | None, eps: float = 1e-5):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1, bias=False)
        init_conv_(self.conv, generator, std=0.01)
        self.gn = GroupNorm(32, c, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(self.conv(x))


def _conv(cin: int, cout: int, generator, bias: float = 0.0) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, 3, padding=1)
    init_conv_(conv, generator, std=0.01, bias=bias)
    return conv


class RotatedFCOSHead(nn.Module):
    def __init__(self, num_classes: int, feat_channels: int, stride: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        g, c = generator, feat_channels
        self.cls_convs = nn.ModuleList(ConvGN(c, g) for _ in range(4))
        self.reg_convs = nn.ModuleList(ConvGN(c, g) for _ in range(4))
        self.conv_cls = _conv(c, num_classes, g, bias=-math.log((1 - 0.01) / 0.01))
        # small positive bias: see the reference head
        self.conv_reg = _conv(c, 4, g, bias=0.1)
        self.conv_centerness = _conv(c, 1, g)
        self.conv_angle = _conv(c, 1, g)
        self.scales = nn.ModuleList([Scale(1.0)])
        self.scale_angle = Scale(1.0)

    def forward(self, feat: torch.Tensor):
        """feat [B, C, H, W] -> (cls_logits, bbox_pred in px, angle_pred,
        centerness), NCHW f32."""
        cls_feat = reg_feat = feat
        for cls_conv, reg_conv in zip(self.cls_convs, self.reg_convs):
            cls_feat = F.relu(cls_conv(cls_feat))
            reg_feat = F.relu(reg_conv(reg_feat))
        cls_score = self.conv_cls(cls_feat)
        bbox_pred = self.conv_reg(reg_feat)
        centerness = self.conv_centerness(cls_feat)
        angle_pred = self.conv_angle(reg_feat)
        # the conv outputs times the f32 scales are f32, as in the reference
        bbox_pred = (bbox_pred.float() * self.scales[0].scale).clamp(min=0) * self.stride
        angle_pred = angle_pred.float() * self.scale_angle.scale
        return cls_score.float(), bbox_pred, angle_pred, centerness.float()
