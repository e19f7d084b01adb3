"""Rotated NMS with static shapes (counterpart of point_teacher_tpu/ops/nms.py:
_greedy_suppress in its parallel mode and nms_rotated).

Greedy NMS as a parallel fixpoint: each round, every undecided box that no
higher-ranked undecided box overlaps is kept, and every box a newly kept,
higher-ranked box overlaps dies. `iters` rounds run unrolled; a loop then
finishes any suppression chain deeper than that, so the result always
equals sequential greedy NMS. Its test is the call's one device-to-host
sync. Batched over any leading dimensions.
"""
from __future__ import annotations

from typing import Optional

import torch

from .rotated import rbox_iou

Tensor = torch.Tensor


def _greedy_suppress(iou: Tensor, order_scores: Tensor, iou_thr: float,
                     iters: int = 32) -> Tensor:
    """iou [..., N, N], scores [..., N] -> keep mask [..., N], matching greedy
    NMS in descending score order, equal scores ranked by index."""
    n = iou.shape[-1]
    order = torch.argsort(-order_scores, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    higher = rank[..., None, :] < rank[..., :, None]          # [.., i, j]: j outranks i
    conflict = higher & (iou > iou_thr)                      # j can suppress i

    def round_fn(alive, keep):
        newly = alive & ~(conflict & alive[..., None, :]).any(-1)
        dead = (conflict & newly[..., None, :]).any(-1)
        return alive & ~newly & ~dead, keep | newly

    alive = torch.ones(iou.shape[:-1], dtype=torch.bool, device=iou.device)
    keep = torch.zeros_like(alive)
    for _ in range(iters):
        alive, keep = round_fn(alive, keep)
    # each round decides at least one box while any is alive: zero trips
    # unless a suppression chain is deeper than `iters`
    while bool(alive.any()):
        alive, keep = round_fn(alive, keep)
    return keep


def nms_rotated(rboxes: Tensor, scores: Tensor, iou_thr: float,
                valid: Optional[Tensor] = None, iters: int = 32) -> Tensor:
    """Rotated NMS: rboxes [..., N, 5] (cx, cy, w, h, a), scores [..., N] ->
    keep mask [..., N]; invalid boxes rank last, suppress nothing and are
    never kept."""
    iou = rbox_iou(rboxes, rboxes)
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
        iou = torch.where(valid[..., None, :] & valid[..., :, None], iou, 0.0)
    keep = _greedy_suppress(iou, scores, iou_thr, iters=iters)
    if valid is not None:
        keep = keep & valid
    return keep
