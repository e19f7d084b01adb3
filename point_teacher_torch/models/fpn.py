"""Feature Pyramid Network (counterpart of point_teacher_tpu/models/fpn.py):
P3-P5 from C3-C5 laterals with a nearest top-down pathway, P6/P7 from
stride-2 convs on the P5 output (relu before the second). NCHW; module
names follow the reference torch keys (lateral_convs.i.conv, fpn_convs.i.conv
with the two extra convs appended)."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ._resize import resize_nearest
from .init import init_conv_


class ConvModule(nn.Module):
    """A bare conv under the `.conv` key, as mmcv's ConvModule without norm/act."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 generator: torch.Generator | None = None, std=None, bias: float = 0.0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)
        init_conv_(self.conv, generator, std=std, bias=bias)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = 256,
                 start_level: int = 1, num_outs: int = 5,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.start_level = start_level
        used = in_channels[start_level:]
        self.n_lat = len(used)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, generator=generator) for c in used)
        convs = [ConvModule(out_channels, out_channels, 3, generator=generator)
                 for _ in used]
        convs += [ConvModule(out_channels, out_channels, 3, stride=2, generator=generator)
                  for _ in range(num_outs - self.n_lat)]
        self.fpn_convs = nn.ModuleList(convs)

    def forward(self, inputs):
        used = list(inputs[self.start_level:])
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(self.n_lat - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [self.fpn_convs[i](laterals[i]) for i in range(self.n_lat)]
        src = outs[-1]
        for i, conv in enumerate(self.fpn_convs[self.n_lat:]):
            if i > 0:
                src = F.relu(src)
            src = conv(src)
            outs.append(src)
        return tuple(outs)
