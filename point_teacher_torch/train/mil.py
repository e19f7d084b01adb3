"""Dynamic MIL refinement (counterpart of point_teacher_tpu/train/mil.py:
mil_stage through _bags_prep, _reg_finish and _bags_tail for HBB, and
mil_stage_rotated for OBB).

Proposal bags -> RoIAlign -> reg tower -> DeltaXYWH decode + DN-DIoU loss ->
RoIAlign of the refined bags (and the negatives) -> bag tower -> gfocal bag
loss -> top-k weighted selection. Every count that normalises a loss or a
metric is summed over the world before its clamp (parallel/dist.py).

Every pool goes through ops.roi_align. In the grouped mode (the reference
default) each bag member carries the clamp bounds of its group window, so
the one kernel reproduces roi_align_grouped_from_windows; with
grouped=False no bounds are passed, which is roi_align_matmul. The refined
bags and the negatives are pooled in ONE launch (a negative carries
full-map bounds), so a stage launches the forward kernel twice and the
backward kernel twice.

The rotated stage jitters the (cx, cy, w, h) part of each rotated box into
its bags and carries the angle, pools through ops.roi_align_rotated (group
windows of the GT centre when grouped, else a window on each roi's own
centre; the negatives always on their own), refines the HBB part with the
DN-DIoU loss, and merges 5-dim boxes. It too launches each rotated kernel
twice per stage.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.proposals import FineProposalCfg, delta_decode, fine_proposals, negative_proposals
from ..ops.boxes import bbox_overlaps, cxcywh_to_xyxy, xyxy_to_cxcywh
from ..ops.losses import dn_diou_loss, gfocal_loss, one_hot
from ..ops.roi_align import (full_map_clamp, group_window_origins, roi_align,
                             window_clamp)
from ..ops.roi_align_rotated import roi_align_rotated, roi_window_clamp
from ..ops.rotated import rbox_iou
from ..parallel import dist

Tensor = torch.Tensor


class MILStageOut(NamedTuple):
    refined_boxes: Tensor  # [B, G, 4]
    loss_mil_bbox: Tensor
    loss_mil_bags: Tensor
    coarse_bags_iou: Tensor
    refine_bags_iou: Tensor
    # fraction of valid refined members whose sample grid fits the group
    # window (1.0 = the window clamp never bites); 1.0 without the cls pool
    cls_pool_coverage: Tensor


def _masked_mean(x: Tensor, mask: Tensor) -> Tensor:
    return dist.global_ratio(torch.where(mask, x, 0.0).sum(), mask.sum())


def _group_window_coverage(boxes_xyxy, valid, centers, feat_hw, window, scale=1.0 / 8):
    """Fraction of valid members whose bilinear support fits the group window
    (2-cell margin), measured with the configured window as the reference does."""
    h, w = feat_hw
    wy0 = torch.floor(centers[..., 1] * scale - window / 2).clamp(0, max(h - window, 0))
    wx0 = torch.floor(centers[..., 0] * scale - window / 2).clamp(0, max(w - window, 0))
    x1, y1, x2, y2 = (boxes_xyxy * scale).unbind(-1)
    fit = (((y1 - 2).clamp(min=0) >= wy0[..., None])
           & ((y2 + 2).clamp(max=h - 1) <= wy0[..., None] + window - 1)
           & ((x1 - 2).clamp(min=0) >= wx0[..., None])
           & ((x2 + 2).clamp(max=w - 1) <= wx0[..., None] + window - 1))
    return dist.global_ratio((valid & fit).sum(), valid.sum())


def _bag_loss(cls_all, ins_all, ext_valid, labels, boxes_valid, neg_w):
    """Bag scores and the gfocal bag loss of one stage.

    cls_all, ins_all [B * M, C] come from one bag-tower call over per image
    the N = G * U1 * U2 refined members, then its negatives; ext_valid
    [B, G, U1, U2]. Bag score = sum over U2 of sigmoid(cls) * the masked,
    L1-normalised softmax of ins. neg_w [B, M - N] (or None without
    negatives) adds the negatives' gfocal loss against 0.
    Returns (cls_sig, ins_norm, loss_mil_bags)."""
    b, g, u1, u2 = ext_valid.shape
    n = g * u1 * u2
    c = cls_all.shape[-1]
    cls_all = cls_all.reshape(b, -1, c)
    cls_score = cls_all[:, :n].reshape(b, g, u1, u2, c)
    ins_score = ins_all.reshape(b, -1, c)[:, :n].reshape(b, g, u1, u2, c)

    cls_sig = torch.sigmoid(cls_score)
    ins_soft = torch.softmax(ins_score, 3) * ext_valid[..., None]
    ins_norm = ins_soft / ins_soft.abs().sum(3, keepdim=True).clamp(min=1e-12)
    bag_score = (cls_sig * ins_norm).sum(3)                                 # [B, G, U1, C]
    onehot = one_hot(labels, c, bag_score.dtype)[:, :, None, :].expand_as(bag_score)
    bag_w = (ext_valid.sum(3) > 0) & boxes_valid[:, :, None]
    num_sample = dist.global_sum(bag_w.sum().to(bag_score.dtype)).clamp(min=1.0)
    loss = gfocal_loss(bag_score, onehot, bag_w[..., None].to(bag_score.dtype)).sum() / num_sample
    if neg_w is not None:
        neg_sig = torch.sigmoid(cls_all[:, n:])
        loss = loss + gfocal_loss(
            neg_sig, torch.zeros_like(neg_sig), neg_w[..., None].to(neg_sig.dtype)
        ).sum() / num_sample
    return cls_sig, ins_norm, loss


def _top_k_merge(cls_sig, ins_norm, labels, members, top_k: int):
    """Score-weighted merge of each bag's top_k members [B, G, U, D] by the
    score of the bag's label (no gradient)."""
    b, g, u, d = members.shape
    c = cls_sig.shape[-1]
    safe = labels.long().clamp(0, c - 1)[:, :, None, None].expand(b, g, u, 1)
    sel = (cls_sig.reshape(b, g, u, c).gather(-1, safe)[..., 0]
           * ins_norm.reshape(b, g, u, c).gather(-1, safe)[..., 0])
    # stable descending sort: ties keep the lower index, as jax.lax.top_k
    top_scores, top_idx = torch.sort(sel, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :top_k], top_idx[..., :top_k]
    top = members.gather(2, top_idx[..., None].expand(b, g, top_k, d))
    wsel = top_scores / (top_scores.sum(-1, keepdim=True) + 1e-8)
    return (top * wsel[..., None]).sum(2)


class _BagsPrep(NamedTuple):
    props: Tensor
    props_valid: Tensor
    ext: Tensor          # [B, G, U1, U2, 4]
    ext_valid: Tensor    # [B, G, U1, U2]
    ext_real: Tensor
    roi_feats: Tensor    # [B, N, 7, 7, C], N = G*U1*U2
    member_clamp: Optional[Tensor]  # [B, N, 4] group-window bounds (grouped mode)
    ctrs: Tensor
    coarse_bags_iou: Tensor


def _bags_prep(mil_feat, boxes, boxes_valid, real_boxes, fine_cfg, ext_cfg, hw,
               window, grouped) -> _BagsPrep:
    """Proposal bags and the reg-bag pool."""
    b, g = boxes.shape[:2]
    props, props_valid = fine_proposals(boxes, fine_cfg, hw)              # [B, G, U1, 4]
    u1 = props.shape[2]
    ext, ext_valid = fine_proposals(props.reshape(b, g * u1, 4), ext_cfg, hw)
    u2 = ext.shape[2]
    ext = ext.reshape(b, g, u1, u2, 4)
    ext_valid = ext_valid.reshape(b, g, u1, u2) & boxes_valid[:, :, None, None]
    ext_real = real_boxes[:, :, None, None, :].expand_as(ext)
    coarse_bags_iou = _masked_mean(
        bbox_overlaps(ext, ext_real, is_aligned=True),
        boxes_valid[:, :, None, None].expand(ext.shape[:-1]))

    n = g * u1 * u2
    feat_hw = (mil_feat.shape[1], mil_feat.shape[2])
    ctrs = xyxy_to_cxcywh(boxes)[..., :2]
    member_clamp = None
    if grouped:
        wy0, wx0, win = group_window_origins(ctrs, feat_hw, window)
        member_clamp = (window_clamp(wy0, wx0, win, feat_hw)[:, :, None, :]
                        .expand(b, g, u1 * u2, 4).reshape(b, n, 4))
    roi_feats = roi_align(mil_feat, ext.reshape(b, n, 4).detach().contiguous(), member_clamp)
    return _BagsPrep(props, props_valid, ext, ext_valid, ext_real, roi_feats, member_clamp,
                     ctrs, coarse_bags_iou)


def _reg_finish(prep: _BagsPrep, deltas, boxes, boxes_valid, hw, dn_hyper):
    """Decode the tower deltas + the DN denoising loss for the reg bags."""
    b, g, u1, u2 = prep.ext_valid.shape
    ext_ref = boxes[:, :, None, None, :].expand_as(prep.ext)
    pred = delta_decode(prep.ext.reshape(-1, 4), deltas, hw).reshape(b, g, u1, u2, 4)
    w_valid = prep.ext_valid.to(pred.dtype)
    avg = dist.global_sum((boxes_valid.sum() * u1 * u2).to(pred.dtype)).clamp(min=1.0)
    base_valid = boxes_valid[:, :, None, None].expand(prep.ext.shape[:-1])
    loss_mil_bbox = dn_diou_loss(pred.reshape(-1, 4), ext_ref.reshape(-1, 4),
                                 weight=w_valid.reshape(-1), avg_factor=avg, hyper=dn_hyper,
                                 base_valid=base_valid.reshape(-1))
    pred_d = pred.detach()
    refine_bags_iou = _masked_mean(bbox_overlaps(pred_d, prep.ext_real, is_aligned=True),
                                   base_valid)
    return loss_mil_bbox, pred_d, refine_bags_iou


def _bags_tail(model, mil_feat, prep: _BagsPrep, pred_d, loss_mil_bbox, refine_bags_iou,
               labels, boxes, boxes_valid, fine_cfg, stage, hw, top_k, beta, neg_u,
               window, grouped) -> MILStageOut:
    """Refined-bag classification + negative bags + top-k selection."""
    b, g, u1, u2 = prep.ext_valid.shape
    n = g * u1 * u2
    ext_valid = prep.ext_valid
    feat_hw = (mil_feat.shape[1], mil_feat.shape[2])

    if grouped:
        cls_pool_coverage = _group_window_coverage(
            pred_d.reshape(b, g, u1 * u2, 4), ext_valid.reshape(b, g, u1 * u2),
            prep.ctrs, feat_hw, window)
    else:
        cls_pool_coverage = torch.ones((), device=pred_d.device)
    rois = pred_d.reshape(b, n, 4)
    clamp = prep.member_clamp
    use_neg = neg_u is not None and fine_cfg.gen_num_neg > 0
    if use_neg:
        # negatives share the bag tower and fc_cls with the refined bags
        # (fc_ins on their rows is discarded), and their pool shares the launch
        nn_ = fine_cfg.gen_num_neg
        neg, neg_w = negative_proposals(neg_u, prep.props,
                                        prep.props_valid & boxes_valid[:, :, None], hw)
        rois = torch.cat([rois, neg], 1)
        if clamp is not None:
            clamp = torch.cat([clamp, full_map_clamp((b, nn_), feat_hw, clamp.device)], 1)
    pooled = roi_align(mil_feat, rois.detach().contiguous(), clamp)
    cls_all, ins_all = model.mil_classify(pooled.reshape(-1, *pooled.shape[2:]), stage)
    cls_sig, ins_norm, loss_mil_bags = _bag_loss(cls_all, ins_all, ext_valid, labels,
                                                 boxes_valid, neg_w if use_neg else None)

    # selection: top-k weighted merge, beta blend (all stop-gradient)
    with torch.no_grad():
        merged = _top_k_merge(cls_sig, ins_norm, labels, pred_d.reshape(b, g, u1 * u2, 4), top_k)
        h, w = hw
        merged = torch.stack([merged[..., 0].clamp(0, w), merged[..., 1].clamp(0, h),
                              merged[..., 2].clamp(0, w), merged[..., 3].clamp(0, h)], -1)
        refined = (1 - beta) * merged + beta * boxes
        refined = torch.where(boxes_valid[..., None], refined, boxes)

    return MILStageOut(refined, loss_mil_bbox, loss_mil_bags, prep.coarse_bags_iou,
                       refine_bags_iou, cls_pool_coverage)


def mil_stage(model, mil_feat: Tensor, boxes: Tensor, labels: Tensor, boxes_valid: Tensor,
              real_boxes: Tensor, fine_cfg: FineProposalCfg, ext_cfg: FineProposalCfg,
              stage: int, img_hw, top_k: int, beta: float, dn_hyper: float,
              neg_u: Optional[Tensor], with_bags_loss: bool, window: int = 32,
              grouped: bool = True) -> MILStageOut:
    """One MIL refinement stage over a batch.

    model: a StudentFCOS (its mil_regress / mil_classify towers);
    mil_feat [B, Hf, Wf, C] contiguous NHWC; boxes [B, G, 4] xyxy (no grad);
    labels, boxes_valid [B, G]; real_boxes [B, G, 4] (diagnostics only);
    neg_u [B, 4, gen_num_neg] negative-proposal uniforms, or None."""
    hw = img_hw
    prep = _bags_prep(mil_feat, boxes, boxes_valid, real_boxes, fine_cfg, ext_cfg, hw,
                      window, grouped)
    b, n = prep.roi_feats.shape[:2]
    deltas = model.mil_regress(prep.roi_feats.reshape(b * n, *prep.roi_feats.shape[2:]), stage)
    loss_mil_bbox, pred_d, refine_bags_iou = _reg_finish(prep, deltas, boxes, boxes_valid,
                                                         hw, dn_hyper)
    if not with_bags_loss:
        zero = torch.zeros((), device=boxes.device)
        return MILStageOut(boxes, loss_mil_bbox, zero, prep.coarse_bags_iou, refine_bags_iou,
                           torch.ones((), device=boxes.device))
    return _bags_tail(model, mil_feat, prep, pred_d, loss_mil_bbox, refine_bags_iou, labels,
                      boxes, boxes_valid, fine_cfg, stage, hw, top_k, beta, neg_u, window,
                      grouped)


def mil_stage_rotated(model, mil_feat: Tensor, rboxes: Tensor, labels: Tensor,
                      boxes_valid: Tensor, real_rboxes: Tensor, fine_cfg: FineProposalCfg,
                      ext_cfg: FineProposalCfg, stage: int, img_hw, top_k: int, beta: float,
                      dn_hyper: float, neg_u: Optional[Tensor], with_bags_loss: bool,
                      window: int = 16, grouped: bool = True) -> MILStageOut:
    """One rotated MIL refinement stage over a batch.

    model: a StudentRotatedFCOS; mil_feat [B, Hf, Wf, C] contiguous NHWC;
    rboxes [B, G, 5] (cx, cy, w, h, a), no grad; labels, boxes_valid [B, G];
    real_rboxes [B, G, 5] (diagnostics only); neg_u [B, 4, gen_num_neg]
    negative-proposal uniforms, or None."""
    hw = img_hw
    b, g = rboxes.shape[:2]
    feat_hw = (mil_feat.shape[1], mil_feat.shape[2])
    props, props_valid = fine_proposals(cxcywh_to_xyxy(rboxes[..., :4]), fine_cfg, hw)
    u1 = props.shape[2]
    ext, ext_valid = fine_proposals(props.reshape(b, g * u1, 4), ext_cfg, hw)
    u2 = ext.shape[2]
    n = g * u1 * u2
    ext = ext.reshape(b, g, u1, u2, 4)
    ext_valid = ext_valid.reshape(b, g, u1, u2) & boxes_valid[:, :, None, None]
    ext_angle = rboxes[:, :, None, None, 4].expand(b, g, u1, u2)
    ext_rb = torch.cat([xyxy_to_cxcywh(ext), ext_angle[..., None]], -1)     # [B, G, U1, U2, 5]
    ext_ref = rboxes[:, :, None, None, :].expand_as(ext_rb)
    ext_real = real_rboxes[:, :, None, None, :].expand_as(ext_rb).reshape(-1, 5)
    vmask4 = boxes_valid[:, :, None, None].expand(ext_rb.shape[:-1]).reshape(-1)
    coarse_bags_iou = _masked_mean(rbox_iou(ext_rb.reshape(-1, 5), ext_real, aligned=True),
                                   vmask4)

    gctr = rboxes[..., :2]
    if grouped:
        # one window per GT, on its centre: every member of the bag, and its
        # refined box, pools from it
        wy0, wx0, win = group_window_origins(gctr, feat_hw, window)
        member_clamp = (window_clamp(wy0, wx0, win, feat_hw)[:, :, None, :]
                        .expand(b, g, u1 * u2, 4).reshape(b, n, 4))
    else:
        member_clamp = roi_window_clamp(ext_rb.reshape(b, n, 5), feat_hw, window)
    roi_feats = roi_align_rotated(mil_feat, ext_rb.reshape(b, n, 5).detach().contiguous(),
                                  member_clamp.contiguous())
    deltas = model.mil_regress(roi_feats.reshape(b * n, *roi_feats.shape[2:]), stage)
    pred_hbb = delta_decode(ext.reshape(b * n, 4), deltas, hw)
    ref_hbb = cxcywh_to_xyxy(ext_ref[..., :4]).reshape(-1, 4)
    avg = dist.global_sum((boxes_valid.sum() * u1 * u2).to(pred_hbb.dtype)).clamp(min=1.0)
    # base_valid: only real-GT bag rows enter the DN loss's scalar-mean base
    loss_mil_bbox = dn_diou_loss(pred_hbb, ref_hbb, weight=ext_valid.reshape(-1).to(pred_hbb.dtype),
                                 avg_factor=avg, hyper=dn_hyper, base_valid=vmask4)
    pred_d = pred_hbb.detach()
    refined_rb = torch.cat([xyxy_to_cxcywh(pred_d).reshape(b, g, u1, u2, 4),
                            ext_angle[..., None]], -1)
    refine_bags_iou = _masked_mean(rbox_iou(refined_rb.reshape(-1, 5), ext_real, aligned=True),
                                   vmask4)
    if not with_bags_loss:
        zero = torch.zeros((), device=rboxes.device)
        return MILStageOut(rboxes, loss_mil_bbox, zero, coarse_bags_iou, refine_bags_iou,
                           torch.ones((), device=rboxes.device))

    rb5 = refined_rb.reshape(b, g, u1 * u2, 5)
    if grouped:
        # the members' rotated extent, for the window-coverage diagnostic
        cos, sin = torch.cos(rb5[..., 4]), torch.sin(rb5[..., 4])
        hw_x = ((rb5[..., 2] * cos).abs() + (rb5[..., 3] * sin).abs()) / 2
        hw_y = ((rb5[..., 2] * sin).abs() + (rb5[..., 3] * cos).abs()) / 2
        aabb = torch.stack([rb5[..., 0] - hw_x, rb5[..., 1] - hw_y,
                            rb5[..., 0] + hw_x, rb5[..., 1] + hw_y], -1)
        cls_pool_coverage = _group_window_coverage(aabb, ext_valid.reshape(b, g, u1 * u2),
                                                   gctr, feat_hw, window)
        clamp = member_clamp
    else:
        cls_pool_coverage = torch.ones((), device=rboxes.device)
        clamp = roi_window_clamp(rb5.reshape(b, n, 5), feat_hw, window)
    rois = rb5.reshape(b, n, 5)
    use_neg = neg_u is not None and fine_cfg.gen_num_neg > 0
    neg_w = None
    if use_neg:
        # negatives (angle 0, each in a window on its own centre) share the
        # bag tower with the refined bags, and their pool shares the launch
        neg, neg_w = negative_proposals(neg_u, props, props_valid & boxes_valid[:, :, None], hw)
        neg_rb = torch.cat([xyxy_to_cxcywh(neg), torch.zeros_like(neg[..., :1])], -1)
        rois = torch.cat([rois, neg_rb], 1)
        clamp = torch.cat([clamp, roi_window_clamp(neg_rb, feat_hw, window)], 1)
    pooled = roi_align_rotated(mil_feat, rois.detach().contiguous(), clamp.contiguous())
    cls_all, ins_all = model.mil_classify(pooled.reshape(-1, *pooled.shape[2:]), stage)
    cls_sig, ins_norm, loss_mil_bags = _bag_loss(cls_all, ins_all, ext_valid, labels,
                                                 boxes_valid, neg_w)

    with torch.no_grad():
        merged = _top_k_merge(cls_sig, ins_norm, labels, rb5, top_k)
        h, w = hw
        # reference quirk: only the centre is clamped, first to [0, w] then [0, h]
        ctr = merged[..., :2].clamp(0, w).clamp(0, h)
        merged = torch.cat([ctr, merged[..., 2:]], -1)
        refined = (1 - beta) * merged + beta * rboxes
        refined = torch.where(boxes_valid[..., None], refined, rboxes)
    return MILStageOut(refined, loss_mil_bbox, loss_mil_bags, coarse_bags_iou,
                       refine_bags_iou, cls_pool_coverage)
