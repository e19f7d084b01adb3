"""Single-stage detector: ResNet -> FPN -> PSAGG -> FCOS head + MIL towers
(counterpart of point_teacher_tpu/models/detector.py, StudentFCOS).

Public methods keep the reference layout: images [B, H, W, 3] raw 0-255
pixels (identity normalisation), features and head maps NHWC. `dtype` is the
compute dtype, as the flax module's: bfloat16 runs the convs and tower
matmuls under autocast; float32 runs everything in f32. The teacher is a
second instance holding the EMA weights.
"""
from __future__ import annotations

import torch
from torch import nn

from . import mil_head
from .fcos_head import FCOSHead
from .fpn import FPN
from .psagg import PSAGG
from .resnet import ResNet


CHANNELS, STRIDE = 256, 8


class StudentFCOS(nn.Module):
    """ResNet-50 caffe, 256-channel FPN / PSAGG, stride-8 head; weights drawn
    from `seed` as the flax initialisers draw them."""

    def __init__(self, num_classes: int = 8, num_stages: int = 1, frozen_stages: int = -1,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 backbone_style: str = "caffe"):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.dtype = dtype
        self.backbone = ResNet(frozen_stages=frozen_stages, generator=g, style=backbone_style)
        self.neck = FPN(out_channels=CHANNELS, generator=g)
        self.neck_agg = PSAGG(5, CHANNELS, generator=g)
        self.bbox_head = self._make_head(num_classes, g)
        mil_head.add_mil_towers(self.bbox_head, num_classes, num_stages, CHANNELS, generator=g)

    def _make_head(self, num_classes: int, generator: torch.Generator) -> nn.Module:
        return FCOSHead(num_classes, CHANNELS, STRIDE, generator=generator)

    def _autocast(self, x: torch.Tensor):
        return torch.autocast(x.device.type, dtype=torch.bfloat16,
                              enabled=self.dtype == torch.bfloat16)

    def extract_feat(self, img: torch.Tensor) -> torch.Tensor:
        """img [B, H, W, 3] -> stride-8 feature [B, H/8, W/8, C] (NHWC)."""
        fmt = torch.channels_last if img.is_cuda else torch.contiguous_format
        with self._autocast(img):
            x = img.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
            feat = self.neck_agg(self.neck(self.backbone(x)))
        return feat.permute(0, 2, 3, 1)

    def head(self, feat: torch.Tensor):
        """NHWC feature -> the head's maps, NHWC f32: (cls [B,H,W,K], bbox
        [B,H,W,4] px, centerness [B,H,W,1]) for FCOSHead."""
        with self._autocast(feat):
            outs = self.bbox_head(feat.permute(0, 3, 1, 2))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)

    def forward(self, img: torch.Tensor):
        feat = self.extract_feat(img)
        return self.head(feat), feat

    def mil_regress(self, roi_feats: torch.Tensor, stage: int) -> torch.Tensor:
        with self._autocast(roi_feats):
            return mil_head.mil_regress(self.bbox_head, roi_feats, stage)

    def mil_classify(self, roi_feats: torch.Tensor, stage: int):
        with self._autocast(roi_feats):
            return mil_head.mil_classify(self.bbox_head, roi_feats, stage)
