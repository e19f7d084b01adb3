"""Tiny-object similarity metrics of the RFLA family (counterpart of
point_teacher_tpu/ops/tiny_metrics.py): IoU substitutes that stay
informative for boxes a few pixels wide. Each xyxy box is a 2-D Gaussian;
the similarity squashes the Wasserstein distance or the KL divergence of
two of them. Pairwise: [..., M, 4] x [..., N, 4] -> [..., M, N], in the
boxes' dtype (f32 on the training path: the KL divides by squared widths
of a few pixels)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _pairwise_parts(b1: Tensor, b2: Tensor, eps: float):
    c1 = (b1[..., :, None, :2] + b1[..., :, None, 2:4]) / 2
    c2 = (b2[..., None, :, :2] + b2[..., None, :, 2:4]) / 2
    d = c1 - c2
    w1 = b1[..., :, None, 2] - b1[..., :, None, 0] + eps
    h1 = b1[..., :, None, 3] - b1[..., :, None, 1] + eps
    w2 = b2[..., None, :, 2] - b2[..., None, :, 0] + eps
    h2 = b2[..., None, :, 3] - b2[..., None, :, 1] + eps
    return d, w1, h1, w2, h2


def center_distance2(b1: Tensor, b2: Tensor, eps: float = 1e-6) -> Tensor:
    d, *_ = _pairwise_parts(b1, b2, 0.0)
    return d[..., 0] ** 2 + d[..., 1] ** 2 + eps


def wasserstein_similarity(b1: Tensor, b2: Tensor, eps: float = 1e-6) -> Tensor:
    """'wd': 1 / (1 + W2^2) of the boxes' Gaussians."""
    d, w1, h1, w2, h2 = _pairwise_parts(b1, b2, eps)
    center = d[..., 0] ** 2 + d[..., 1] ** 2 + eps
    wh = ((w1 - w2) ** 2 + (h1 - h2) ** 2) / 4
    return 1.0 / (1.0 + center + wh)


def _kl_divergence(b1: Tensor, b2: Tensor, eps: float) -> Tensor:
    d, w1, h1, w2, h2 = _pairwise_parts(b1, b2, eps)
    return (
        w2 ** 2 / w1 ** 2 + h2 ** 2 / h1 ** 2
        + 4 * d[..., 0] ** 2 / w1 ** 2 + 4 * d[..., 1] ** 2 / h1 ** 2
        + torch.log(w1 ** 2 / w2 ** 2) + torch.log(h1 ** 2 / h2 ** 2) - 2
    ) / 2


def kl_similarity(b1: Tensor, b2: Tensor, eps: float = 1e-6, mode: str = "kl") -> Tensor:
    """'kl' -> 1 / (1 + KL); 'kl_10' -> 1 / (10 + KL); 'exp_kl' -> exp(-KL / 10)."""
    kl = _kl_divergence(b1, b2, eps)
    if mode == "kl":
        return 1.0 / (1.0 + kl)
    if mode == "kl_10":
        return 1.0 / (10.0 + kl)
    if mode == "exp_kl":
        return torch.exp(-kl / 10.0)
    raise ValueError(mode)
