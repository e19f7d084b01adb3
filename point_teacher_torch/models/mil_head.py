"""MIL towers (counterpart of point_teacher_tpu/models/mil_head.py): per
stage a reg tower and a bag tower, each 2 x (Linear -> relu) from the
flattened 7x7xC roi feature to 1024, then fc_reg (4), fc_cls and fc_ins
(num_classes). fc_reg / fc_cls / fc_ins run in f32 whatever the model dtype.

The reference registers these stacks on the bbox head
(shared_fcs_reg.s.{0,1}, shared_fcs_bag.s.{0,1}, fc_reg.s, fc_cls.s, fc_ins.s),
so `add_mil_towers` adds them to the head module to keep its state_dict keys.
The first Linear keeps the reference's (C, H, W) input order; roi features
arrive as [N, 7, 7, C] and the weight is permuted to (H, W, C) at use.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .init import init_linear_

ROI = 7


def _linear(cin: int, cout: int, generator) -> nn.Linear:
    fc = nn.Linear(cin, cout)
    init_linear_(fc, generator)
    return fc


def add_mil_towers(head: nn.Module, num_classes: int, num_stages: int = 1,
                   in_channels: int = 256, fc_out: int = 1024,
                   generator: torch.Generator | None = None) -> None:
    din = in_channels * ROI * ROI
    g = generator

    def tower():
        return nn.Sequential(_linear(din, fc_out, g), _linear(fc_out, fc_out, g))

    head.shared_fcs_reg = nn.ModuleList(tower() for _ in range(num_stages))
    head.shared_fcs_bag = nn.ModuleList(tower() for _ in range(num_stages))
    head.fc_reg = nn.ModuleList(_linear(fc_out, 4, g) for _ in range(num_stages))
    head.fc_cls = nn.ModuleList(_linear(fc_out, num_classes, g) for _ in range(num_stages))
    head.fc_ins = nn.ModuleList(_linear(fc_out, num_classes, g) for _ in range(num_stages))


def _tower(tower: nn.Sequential, roi_feats: torch.Tensor) -> torch.Tensor:
    """roi_feats [N, 7, 7, C] -> [N, fc_out] in the autocast dtype."""
    fc0, fc1 = tower[0], tower[1]
    n, c = roi_feats.shape[0], roi_feats.shape[-1]
    o = fc0.weight.shape[0]
    w0 = fc0.weight.view(o, c, ROI, ROI).permute(0, 2, 3, 1).reshape(o, -1)
    h = F.relu(F.linear(roi_feats.reshape(n, -1), w0, fc0.bias))
    return F.relu(fc1(h))


def _f32(fc: nn.Linear, h: torch.Tensor) -> torch.Tensor:
    with torch.autocast(h.device.type, enabled=False):
        return fc(h.float())


def mil_regress(head, roi_feats: torch.Tensor, stage: int) -> torch.Tensor:
    """[N, 7, 7, C] -> bbox deltas [N, 4] f32."""
    return _f32(head.fc_reg[stage], _tower(head.shared_fcs_reg[stage], roi_feats))


def mil_classify(head, roi_feats: torch.Tensor, stage: int):
    """[N, 7, 7, C] -> (cls_score, ins_score) [N, num_classes] f32."""
    h = _tower(head.shared_fcs_bag[stage], roi_feats)
    return _f32(head.fc_cls[stage], h), _f32(head.fc_ins[stage], h)
