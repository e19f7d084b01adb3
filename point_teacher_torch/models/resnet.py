"""ResNet backbone (counterpart of point_teacher_tpu/models/resnet.py), NCHW.

Bottlenecks in caffe style (stride on the first 1x1 conv, the HBB configs)
or pytorch style (stride on the 3x3 conv, the SODA-A config), FrozenBN as a
constant affine, and `frozen_stages` as requires_grad=False on the stem
(>= 0) and layers 1..frozen_stages. The FrozenBN affines of the other stages
keep their gradients; whether the optimizer trains them is its label rule
(train/optim.py, `bn_affine_trainable`). Module names follow the reference
torch keys (conv1, bn1, layer1.0.conv1, layer1.0.downsample.0, ...).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .init import init_conv_

STAGE_BLOCKS = (3, 4, 6, 3)  # ResNet-50


class FrozenBN(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias, folded to x * scale +
    shift in x's dtype. All four are parameters, as in the reference's flax
    tree: the optimizer never updates them, but their gradients count in the
    global-norm clip exactly as the JAX step counts them."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.running_mean = nn.Parameter(torch.zeros(c))
        self.running_var = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.sqrt(self.running_var + self.eps)
        scale = (self.weight / inv).to(x.dtype)
        shift = (self.bias - self.running_mean * self.weight / inv).to(x.dtype)
        return x * scale[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, generator: torch.Generator,
                 style: str = "caffe"):
        super().__init__()
        out_c = planes * self.expansion
        # caffe style: the stride sits on conv1; pytorch style: on conv2
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=s1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=s2, padding=1, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = nn.Conv2d(planes, out_c, 1, bias=False)
        self.bn3 = FrozenBN(out_c)
        self.downsample = None
        if inplanes != out_c or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out_c, 1, stride=stride, bias=False), FrozenBN(out_c))
        for conv in (self.conv1, self.conv2, self.conv3):
            init_conv_(conv, generator)
        if self.downsample is not None:
            init_conv_(self.downsample[0], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNet(nn.Module):
    """ResNet-50; returns the four stage outputs (strides 4, 8, 16, 32)."""

    def __init__(self, frozen_stages: int = -1, generator: torch.Generator | None = None,
                 style: str = "caffe"):
        super().__init__()
        if style not in ("caffe", "pytorch"):
            raise ValueError(f"unknown ResNet style {style!r}")
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        init_conv_(self.conv1, generator)
        inplanes, planes = 64, 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(Bottleneck(inplanes, planes, stride, generator, style))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        frozen = []
        if frozen_stages >= 0:
            frozen += [self.conv1, self.bn1]
        frozen += [getattr(self, f"layer{s}") for s in range(1, frozen_stages + 1)]
        for m in frozen:
            m.requires_grad_(False)

    def forward(self, x: torch.Tensor):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        outs = []
        for s in range(1, 5):
            h = getattr(self, f"layer{s}")(h)
            outs.append(h)
        return tuple(outs)
