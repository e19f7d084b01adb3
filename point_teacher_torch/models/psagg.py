"""PSAGG aggregation neck (counterpart of point_teacher_tpu/models/psagg.py):
collapse all FPN levels into the stride-8 map by iterative top-down
upsample-add with a 1x1 conv after each merge. NCHW."""
from __future__ import annotations

import torch
from torch import nn

from ._resize import resize_nearest
from .fpn import ConvModule


class PSAGG(nn.Module):
    def __init__(self, num_aggregation: int = 5, channels: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            ConvModule(channels, channels, 1, generator=generator)
            for _ in range(num_aggregation))

    def forward(self, inputs) -> torch.Tensor:
        feats = list(inputs)
        n = len(self.lateral_convs)
        feats[-1] = self.lateral_convs[0](feats[-1])
        for i in range(n - 1):
            idx = n - 1 - i
            merged = feats[idx - 1] + resize_nearest(feats[idx], feats[idx - 1].shape[-2:])
            feats[idx - 1] = self.lateral_convs[i + 1](merged)
        return feats[0]
