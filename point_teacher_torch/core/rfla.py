"""RFLA hierarchical label assignment (counterpart of
point_teacher_tpu/core/rfla.py): two ranking passes over a Gaussian
similarity (Wasserstein or KL, ops/tiny_metrics.py) between the points'
receptive-field boxes and the GTs, the second on `ratio`-rescaled boxes;
the first pass's positives stay, the second fills the rest; optionally a
point whose centre lies outside its GT is dropped.

Each GT claims its top-k boxes (stable_topk: jax.lax.top_k's order on
ties), and a box claimed twice goes to the later GT (a scatter max of the
GT index), as the JAX package's vectorised form of the reference's
ascending overwrite loop does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.nms import stable_topk
from ..ops.tiny_metrics import kl_similarity, wasserstein_similarity

Tensor = torch.Tensor


class HieAssignerCfg(NamedTuple):
    assign_metric: str = "kl"
    topk: Tuple[int, int] = (2, 1)
    ratio: float = 1.0
    inside: bool = False


def _metric(gt: Tensor, anchors: Tensor, mode: str) -> Tensor:
    if mode == "wd":
        return wasserstein_similarity(gt, anchors)
    return kl_similarity(gt, anchors, mode=mode if mode.startswith("kl") else "kl")


def _assign_ranking(overlaps: Tensor, gt_valid: Tensor, k: int) -> Tensor:
    """overlaps [G, N] -> assigned [N] (0-based GT, -1 background): each
    valid GT claims its top-k boxes, later GTs overwriting earlier ones."""
    g, n = overlaps.shape
    overlaps = torch.where(gt_valid[:, None], overlaps, -torch.inf)
    _, cand = stable_topk(overlaps, min(k, n))                       # [G, k]
    gt_ids = torch.arange(g, device=overlaps.device)[:, None].expand_as(cand)
    vals = torch.where(gt_valid[:, None], gt_ids, -1)
    assigned = torch.full((n,), -1, dtype=torch.long, device=overlaps.device)
    return assigned.scatter_reduce(0, cand.reshape(-1), vals.reshape(-1), "amax")


def _rescale(anchors: Tensor, ratio: float) -> Tensor:
    c = (anchors[:, :2] + anchors[:, 2:4]) / 2
    wh = (anchors[:, 2:4] - anchors[:, :2]) * ratio / 2
    return torch.cat([c - wh, c + wh], -1)


def hierarchical_assign(anchors: Tensor, gt_bboxes: Tensor, gt_valid: Tensor,
                        cfg: HieAssignerCfg = HieAssignerCfg()) -> Tensor:
    """anchors [N, 4] xyxy (the receptive-field boxes), gt_bboxes [G, 4]
    xyxy, gt_valid [G] -> assigned [N] (0-based GT index, -1 background)."""
    a1 = _assign_ranking(_metric(gt_bboxes, anchors, cfg.assign_metric), gt_valid, cfg.topk[0])
    a2 = _assign_ranking(_metric(gt_bboxes, _rescale(anchors, cfg.ratio), cfg.assign_metric),
                         gt_valid, cfg.topk[1])
    assigned = torch.where(a1 >= 0, a1, a2)
    if cfg.inside:
        cx = (anchors[:, 0] + anchors[:, 2]) / 2
        cy = (anchors[:, 1] + anchors[:, 3]) / 2
        g = gt_bboxes[assigned.clamp(0, gt_bboxes.shape[0] - 1)]
        inside = (cx > g[:, 0]) & (cx < g[:, 2]) & (cy > g[:, 1]) & (cy < g[:, 3])
        assigned = torch.where(inside | (assigned < 0), assigned, -1)
    return assigned
