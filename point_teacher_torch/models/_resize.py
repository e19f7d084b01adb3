"""Nearest-neighbour feature resize shared by FPN / PSAGG (counterpart of
point_teacher_tpu/models/_resize.py): the F.interpolate(mode='nearest')
index mapping src = floor(dst * h / oh), on NCHW tensors."""
from __future__ import annotations

import torch


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, oh, ow]."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[-2:]
    if (oh, ow) == (h, w):
        return x
    iy = torch.arange(oh, device=x.device) * h // oh
    ix = torch.arange(ow, device=x.device) * w // ow
    return x.index_select(2, iy).index_select(3, ix)
