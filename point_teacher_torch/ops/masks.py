"""Rasterisation of rotated rectangles (counterpart of
point_teacher_tpu/ops/masks.py).

A point-in-rotated-rect test on the integer pixel grid, row block by row
block so that the live [rows, W, G] comparisons stay bounded; batched over
any leading dimensions (one call for a batch of images).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def rasterize_rboxes(rboxes: Tensor, valid: Tensor, height: int, width: int,
                     row_block: int = 64) -> Tensor:
    """rboxes [..., G, 5] (cx, cy, w, h, a), valid [..., G] -> bool mask
    [..., H, W]: a pixel (ix, iy) is set when its integer coordinate lies in
    any valid rotated rect (|local x| <= w / 2 and |local y| <= h / 2)."""
    lead = rboxes.shape[:-2]
    g = rboxes.shape[-2]
    rb = rboxes.reshape(-1, 1, 1, g, 5)
    ok = valid.reshape(-1, 1, 1, g)
    cx, cy = rb[..., 0], rb[..., 1]
    hw, hh = rb[..., 2] * 0.5, rb[..., 3] * 0.5
    cos, sin = torch.cos(rb[..., 4]), torch.sin(rb[..., 4])
    xs = torch.arange(width, dtype=rboxes.dtype, device=rboxes.device)
    dx = xs[None, None, :, None] - cx                                  # [N, 1, W, G]
    blocks = []
    for y0 in range(0, height, row_block):
        ys = torch.arange(y0, min(y0 + row_block, height), dtype=rboxes.dtype,
                          device=rboxes.device)
        dy = ys[None, :, None, None] - cy                              # [N, BLK, 1, G]
        lx = cos * dx + sin * dy
        ly = -sin * dx + cos * dy
        inside = (lx.abs() <= hw) & (ly.abs() <= hh) & ok
        blocks.append(inside.any(-1))
    return torch.cat(blocks, 1).reshape(*lead, height, width)
