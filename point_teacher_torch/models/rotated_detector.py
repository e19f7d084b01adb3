"""Rotated single-stage detector: ResNet (pytorch style) -> FPN -> PSAGG ->
rotated FCOS head + MIL towers (counterpart of
point_teacher_tpu/models/rotated_detector.py, StudentRotatedFCOS).

The backbone, neck, PSAGG and MIL towers are the HBB detector's; `head`
returns (cls [B,H,W,K], bbox [B,H,W,4] px, angle [B,H,W,1], centerness
[B,H,W,1]), NHWC f32.
"""
from __future__ import annotations

import torch
from torch import nn

from .detector import CHANNELS, STRIDE, StudentFCOS
from .rotated_head import RotatedFCOSHead


class StudentRotatedFCOS(StudentFCOS):
    def __init__(self, num_classes: int = 9, num_stages: int = 1, frozen_stages: int = -1,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 backbone_style: str = "pytorch"):
        super().__init__(num_classes=num_classes, num_stages=num_stages,
                         frozen_stages=frozen_stages, dtype=dtype, seed=seed,
                         backbone_style=backbone_style)

    def _make_head(self, num_classes: int, generator: torch.Generator) -> nn.Module:
        return RotatedFCOSHead(num_classes, CHANNELS, STRIDE, generator=generator)
