"""Synthetic "black paper" images of phase 1 (counterpart of
point_teacher_tpu/core/synthetic.py).

Per image: one candidate rotated box per GT slot (centre uniform in
[50, S - 50], log-normal-ish size from its class's prior, angle uniform in
[-pi/2, pi/2), centre clipped so that the box stays inside); "occupied"
markers at the real GT centres (0.7 x the prior width, angle 0, score 1)
join a rotated NMS at IoU 0.05 so that synthetic boxes avoid real objects,
and are then dropped (score < 1); up to two adjacency chains (5 boxes for a
dense class, 3 otherwise) extend the first two GTs whose Bernoulli(0.2)
fired; boxes whose axis-aligned cover leaves [0, S - 1] are dropped; the
kept boxes' pixels are painted with the fill value.

The random numbers come in as `SynDraws`, and the whole batch goes through
one pass (one NMS, one rasterisation), each in its profiler range
(`pt.synthesis/nms`, `pt.synthesis/raster`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.autograd.profiler import record_function

from ..ops.masks import rasterize_rboxes
from ..ops.nms import nms_rotated
from ..ops.rotated import obb2xyxy
from ..utils.device import constant, to_device

Tensor = torch.Tensor

CHAIN_LEN_DENSE = 5
CHAIN_LEN_SPARSE = 3
NUM_CHAINS = 2
CHAIN_SLOTS = NUM_CHAINS * CHAIN_LEN_DENSE


class SynCfg(NamedTuple):
    shape_list: tuple  # ((w, h, dw, dr), ...) per synthetic class
    imgsize: int = 800


class SynDraws(NamedTuple):
    """The random numbers of one batch's synthesis, per image."""
    cls_ids: Tensor   # [B, G] int in [0, n_cls): each slot's synthetic class
    base_u: Tensor    # [B, G] uniforms: the base scale
    xy_u: Tensor      # [B, G, 2] uniforms: the centre
    w_n: Tensor       # [B, G] standard normals: the width's log spread
    r_n: Tensor       # [B, G] standard normals: the aspect's log spread
    angle_u: Tensor   # [B, G] uniforms: the angle
    fire_u: Tensor    # [B, G] uniforms: whether a chain extends the slot
    itv_u: Tensor     # [B, NUM_CHAINS] uniforms: the chain's gap (dense and sparse)
    dev_u: Tensor     # [B, NUM_CHAINS] uniforms: the dense chain's sideways step


def make_syn_draws(generator: torch.Generator, n_cls: int, batch_size: int, max_gt: int,
                   device) -> SynDraws:
    g, b, n = generator, batch_size, max_gt
    draws = SynDraws(
        cls_ids=torch.randint(0, n_cls, (b, n), generator=g),
        base_u=torch.rand((b, n), generator=g),
        xy_u=torch.rand((b, n, 2), generator=g),
        w_n=torch.randn((b, n), generator=g),
        r_n=torch.randn((b, n), generator=g),
        angle_u=torch.rand((b, n), generator=g),
        fire_u=torch.rand((b, n), generator=g),
        itv_u=torch.rand((b, NUM_CHAINS), generator=g),
        dev_u=torch.rand((b, NUM_CHAINS), generator=g),
    )
    return SynDraws(*(to_device(t, device) for t in draws))


def _sample_boxes(d: SynDraws, prior: Tensor, imgsize: int) -> Tensor:
    """One candidate rotated box per GT slot: [B, G, 7] (cx, cy, w, h, a, score, cls)."""
    p = prior[d.cls_ids]                                                  # [B, G, 4]
    base_scale = d.base_u * 2.0 + 0.5
    xy = d.xy_u * (imgsize - 100) + 50.0
    w = (d.w_n * 0.4).clamp(-1, 1) * p[..., 2]
    w = base_scale * torch.exp(w)
    r = (d.r_n * 0.4).clamp(-1, 1) * p[..., 3]
    h = w * torch.exp(r)
    w = w * p[..., 0]
    h = h * p[..., 1]
    a = d.angle_u * math.pi - math.pi / 2
    # jnp.clip order: the upper bound wins where the bounds cross (a box
    # wider than the image)
    x = torch.minimum(torch.maximum(xy[..., 0], 0.71 * w), imgsize - 1 - 0.71 * w)
    y = torch.minimum(torch.maximum(xy[..., 1], 0.71 * h), imgsize - 1 - 0.71 * h)
    # a tensor divisor: CUDA divides by a python scalar through its reciprocal
    score = (w * h) / torch.full((), float(imgsize * imgsize), device=w.device) + 0.1
    return torch.stack([x, y, w, h, a, score, d.cls_ids.to(w.dtype)], -1)


def _adjacency_chains(d: SynDraws, boxes: Tensor, gt_valid: Tensor, dense_cls_max: int):
    """Up to NUM_CHAINS chains extending the first fired boxes: boxes [B, G, 7]
    -> chains [B, CHAIN_SLOTS, 7], chain_valid [B, CHAIN_SLOTS]. The dense and
    the sparse gap come from the same uniform, as in the reference."""
    b = boxes.shape[0]
    fired = (d.fire_u < 0.2) & gt_valid
    order = torch.cumsum(fired.to(torch.int32), -1) - 1                   # fired rank
    itv_dense = d.itv_u * 4 + 2
    dev_dense = d.dev_u * 8 - 4
    itv_sparse = d.itv_u * 40 + 10
    ks = torch.arange(1, CHAIN_LEN_DENSE + 1, dtype=boxes.dtype, device=boxes.device)
    slots, valids = [], []
    rows = torch.arange(b, device=boxes.device)
    for c in range(NUM_CHAINS):
        is_cth = fired & (order == c)
        has = is_cth.any(-1)
        idx = torch.argmax(is_cth.to(torch.int32), -1)      # the first fired, 0 if none
        x, y, w, h, a, s, cls = boxes[rows, idx].unbind(-1)                # [B] each
        dense = cls < dense_cls_max
        itv = torch.where(dense, itv_dense[:, c], itv_sparse[:, c])
        dev = torch.where(dense, dev_dense[:, c], 0.0)
        ofx = (h + itv) * torch.sin(-a) + dev * torch.cos(a)
        ofy = (h + itv) * torch.cos(a) + dev * torch.sin(a)
        chain = torch.stack([x[:, None] + ks * ofx[:, None], y[:, None] + ks * ofy[:, None],
                             w[:, None].expand(b, CHAIN_LEN_DENSE),
                             h[:, None].expand(b, CHAIN_LEN_DENSE),
                             a[:, None].expand(b, CHAIN_LEN_DENSE), s[:, None] - 0.001 * ks,
                             cls[:, None].expand(b, CHAIN_LEN_DENSE)], -1)
        chain_len = CHAIN_LEN_SPARSE + (CHAIN_LEN_DENSE - CHAIN_LEN_SPARSE) * dense.long()
        valids.append(has[:, None] & (ks[None] <= chain_len[:, None]))
        slots.append(chain)
    return torch.cat(slots, 1), torch.cat(valids, 1)


def generate_black_paper_batch(draws: SynDraws, images: Tensor, gt_boxes: Tensor,
                               gt_valid: Tensor, cfg: SynCfg, fill_value: float = 255.0):
    """images [B, H, W, 3]; gt_boxes [B, G, 4] xyxy (HBB) or [B, G, 5]
    rotated (OBB; only the centres are used); gt_valid [B, G].

    Returns (img_syn [B, H, W, 3], syn_boxes_xyxy [B, S, 4], syn_rboxes
    [B, S, 5], syn_valid [B, S]) with S = G + CHAIN_SLOTS slots: the HBB path
    trains on the axis-aligned covers, the OBB path on the rotated boxes."""
    b, h, w, _ = images.shape
    g = gt_boxes.shape[1]
    prior = constant(cfg.shape_list, images.dtype, images.device)
    dense_cls_max = prior.shape[0] // 2  # the first half of the classes are dense
    if gt_boxes.shape[-1] == 5:
        cxy = gt_boxes[..., :2]
    else:
        cxy = (gt_boxes[..., :2] + gt_boxes[..., 2:4]) * 0.5
    occ_size = prior[draws.cls_ids, 0] * 0.7
    zeros = torch.zeros_like(occ_size)
    occupied = torch.stack([cxy[..., 0], cxy[..., 1], occ_size, occ_size, zeros, zeros + 1.0,
                            draws.cls_ids.to(images.dtype)], -1)
    cand = _sample_boxes(draws, prior, cfg.imgsize)
    chains, chain_valid = _adjacency_chains(draws, cand, gt_valid, dense_cls_max)

    allb = torch.cat([occupied, cand, chains], 1)                          # [B, S_all, 7]
    allv = torch.cat([gt_valid, gt_valid, chain_valid], 1)
    with record_function("pt.synthesis/nms"):
        keep = nms_rotated(allb[..., :5], allb[..., 5], 0.05, valid=allv)
    keep = keep & (allb[..., 5] < 1.0)  # drop the occupied markers
    xyxy = obb2xyxy(allb[..., :5])
    inside = (xyxy.amin(-1) >= 0) & (xyxy.amax(-1) <= cfg.imgsize - 1)
    # the occupied slots are never kept: drop them (the raster too)
    rboxes, keep = allb[:, g:, :5], (keep & inside)[:, g:]
    with record_function("pt.synthesis/raster"):
        mask = rasterize_rboxes(rboxes, keep, h, w)
    img_syn = torch.where(mask[..., None], torch.full((), fill_value, dtype=images.dtype,
                                                      device=images.device), images)
    return img_syn, xyxy[:, g:], rboxes, keep


def generate_synthesis_batch(draws: SynDraws, images: Tensor, gt_boxes: Tensor,
                             gt_valid: Tensor, cfg: SynCfg):
    """The textured-synthesis variant: as shipped, the reference multiplies its
    pattern by zero, so it is the black-paper generator with fill 0."""
    return generate_black_paper_batch(draws, images, gt_boxes, gt_valid, cfg, fill_value=0.0)
