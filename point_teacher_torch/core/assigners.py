"""Point-based two-stage top-k assignment (counterpart of
point_teacher_tpu/core/assigners.py), with the reference's quirks: stage 1
takes each GT column's `num_pre` lowest-cost points; stage 2 keeps a
candidate that is in the top-k of ANY column; the highest GT index wins a
point claimed twice. Ties rank by position, as jax.lax.top_k does."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def topk_assign(reg_cost: Tensor, stage2_cost: Tensor, gt_valid: Tensor,
                num_pre: int, topk: int) -> Tensor:
    """reg_cost, stage2_cost [P, G]; gt_valid bool [G] -> assigned [P] int64
    (0-based GT index, -1 = background)."""
    p, g = reg_cost.shape
    dev = reg_cost.device
    # stable ascending sort == jax.lax.top_k(-cost): ties keep the lower index
    cand = torch.argsort(reg_cost.T, dim=-1, stable=True)[:, :num_pre]   # [G, J]
    if num_pre <= topk:
        selected = torch.ones((g, num_pre), dtype=torch.bool, device=dev)
    else:
        cc = stage2_cost[cand]                                            # [G, J, G]
        cj = cc[:, :, None, :]
        ck = cc[:, None, :, :]
        jj = torch.arange(num_pre, device=dev)
        tie = jj[None, :] < jj[:, None]                                   # tie[j, k] = k < j
        earlier = (ck < cj) | ((ck == cj) & tie[None, :, :, None])
        rank = earlier.sum(2)                                             # [G, J, G]
        in_topk = (rank < topk) & gt_valid[None, None, :]
        selected = in_topk.any(-1)                                        # [G, J]
    gt_ids = torch.arange(g, device=dev)[:, None].expand(g, num_pre)
    vals = torch.where(selected & gt_valid[:, None], gt_ids, -1)
    assigned = torch.full((p,), -1, dtype=torch.long, device=dev)
    return assigned.scatter_reduce(0, cand.reshape(-1), vals.reshape(-1), "amax")


def labels_from_assignment(assigned: Tensor, gt_labels: Tensor, num_classes: int) -> Tensor:
    """assigned [P] (-1 bg), gt_labels [G] -> labels [P], background = num_classes."""
    safe = assigned.clamp(0, gt_labels.shape[0] - 1)
    return torch.where(assigned >= 0, gt_labels.long()[safe], num_classes)
