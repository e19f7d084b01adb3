"""The rotated (OBB, SODA-A) Point-Teacher train step (counterpart of
point_teacher_tpu/train/rsteps.py, the phase-2 branch of
_make_rotated_step_fn).

Phase 2 is ported: EMA first, then the annotation points (cached, else the
box centres or a sample in the rotated box), the teacher's pseudo rotated
boxes, the student's rotated MIL refinement on the real view, the refreshed
points, the rotated strong augmentation of the refined boxes, the student's
pseudo branch on the augmented view, one optimizer update and the
point-cache update. Phase 1 comes with a later slice.

Randomness is an input (steps.Draws, with the per-image rotation angle);
the step's parts run inside the `pt.*` profiler ranges of the HBB step.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.autograd.profiler import record_function

from ..core.raugment import RAugBatch, random_point_in_rboxes, strong_augment_rotated
from ..core.rpseudo import generate_pseudo_rboxes
from ..ops.boxes import grid_points
from ..ops.rotated import rbox_iou
from .config import PointTeacherConfig
from .mil import mil_stage_rotated
from .rdense_losses import RDenseLossCfg, pseudo_branch_loss_rotated
from .state import Batch, TrainState, ema_update
from .steps import Draws, make_draws

Tensor = torch.Tensor


def _flatten_rhead(outs):
    """NHWC (cls, bbox, angle, ctr) maps -> per-point [B, P, *]."""
    cls_score, bbox_pred, angle_pred, centerness = outs
    b = cls_score.shape[0]
    return (cls_score.reshape(b, -1, cls_score.shape[-1]), bbox_pred.reshape(b, -1, 4),
            angle_pred.reshape(b, -1, 1), centerness.reshape(b, -1))


def _masked_iou(rb1: Tensor, rb2: Tensor, valid: Tensor) -> Tensor:
    """Mean aligned rotated IoU over the valid slots."""
    ious = rbox_iou(rb1.reshape(-1, 5), rb2.reshape(-1, 5), aligned=True)
    v = valid.reshape(-1)
    return torch.where(v, ious, 0.0).sum() / v.sum().clamp(min=1)


def _teacher_pseudo(teacher, batch: Batch, gt_points, points, cfg: PointTeacherConfig):
    """Teacher forward + pseudo rotated boxes per image, stacked over the batch."""
    cls_t, bbox_t, ang_t, _ = _flatten_rhead(teacher(batch.image)[0])
    pred5 = torch.cat([bbox_t, ang_t], -1)
    per_image = [generate_pseudo_rboxes(points, cls_t[i], pred5[i], gt_points[i],
                                        batch.gt_labels[i], batch.gt_valid[i],
                                        batch.gt_boxes[i], cfg.filter_score, cfg.fuse_assigner)
                 for i in range(batch.image.shape[0])]
    return {k: torch.stack([r[k] for r in per_image]) for k in per_image[0]}


def _run_rmil_stages(model, mil_feat, rboxes, labels, valid, real_rboxes,
                     cfg: PointTeacherConfig, neg_u, hw, metrics: Dict[str, Tensor]):
    """Unrolled rotated MIL stages with the bag loss; returns (refined rotated
    boxes, weighted loss)."""
    total = torch.zeros((), device=rboxes.device)
    cur = rboxes
    for stage in range(cfg.num_stages):
        out = mil_stage_rotated(model, mil_feat, cur, labels, valid, real_rboxes,
                                cfg.fine_proposal_cfg[stage],
                                cfg.fine_proposal_extensive_cfg[stage], stage, hw, cfg.top_k,
                                cfg.beta, cfg.dn_hyper_denoising, neg_u[stage], True,
                                window=cfg.mil_pool_window_rotated, grouped=cfg.mil_pool_grouped)
        metrics[f"stage{stage}_loss_mil_bbox"] = out.loss_mil_bbox * cfg.alpha[0]
        metrics[f"stage{stage}_coarse_bags_iou"] = out.coarse_bags_iou
        metrics[f"stage{stage}_refine_bags_iou"] = out.refine_bags_iou
        metrics[f"stage{stage}_cls_pool_coverage"] = out.cls_pool_coverage
        metrics[f"stage{stage}_loss_mil_bags"] = out.loss_mil_bags * cfg.alpha[1]
        total = total + out.loss_mil_bbox * cfg.alpha[0] + out.loss_mil_bags * cfg.alpha[1]
        metrics[f"stage{stage}_refine_bboxes_iou"] = _masked_iou(out.refined_boxes, real_rboxes,
                                                                 valid)
        cur = out.refined_boxes
    return cur, total


@torch.no_grad()
def _point_update(state: TrainState, batch: Batch, origin, refined_rboxes,
                  cfg: PointTeacherConfig, metrics: Dict[str, Tensor]) -> None:
    """refined = (1 - lamda) * pseudo centre + lamda * origin, cached."""
    new_refined = (1 - cfg.lamda) * refined_rboxes[..., :2] + cfg.lamda * origin
    gt = batch.gt_boxes
    dist = torch.sqrt((new_refined - gt[..., :2]) ** 2) / torch.sqrt(
        ((gt[..., 2:4] / 2) ** 2).clamp(min=1e-12))
    mask = batch.gt_valid[..., None]
    metrics["refined_points_distance"] = (
        torch.where(mask, dist, 0.0).sum() / (mask.sum() * 1.0).clamp(min=1.0))
    ids = batch.image_ids
    state.refined_points[ids] = new_refined
    state.origin_points[ids] = origin
    state.points_cached[ids] = True


def build_rotated_train_step(cfg: PointTeacherConfig, rdense: Optional[RDenseLossCfg] = None):
    """Returns step(state, batch, phase1=False, draws=None) -> metrics for
    batches whose gt_boxes are rotated [B, G, 5]; it updates `state` in place
    (student, teacher, optimizer, point caches)."""
    if rdense is None:
        rdense = RDenseLossCfg(num_classes=cfg.num_classes)
    hw = (cfg.img_size, cfg.img_size)

    def step(state: TrainState, batch: Batch, phase1: bool = False,
             draws: Optional[Draws] = None) -> Dict[str, Tensor]:
        if phase1:
            raise NotImplementedError(
                "phase 1 (burn-in step 1, black-paper synthesis) is not ported yet: "
                "it is the next slice of the port; run with burn_in_step=-1")
        dev = batch.image.device
        b = batch.image.shape[0]
        if draws is None:
            draws = make_draws(state.generator, cfg, b, dev)
        points = grid_points(cfg.feat_size, cfg.feat_size, cfg.stride, device=dev)
        student, teacher = state.student, state.teacher
        with record_function("pt.ema"):
            ema_update(teacher, student, cfg.ema_alpha)

        sampled = random_point_in_rboxes(batch.gt_boxes, cfg.position, draws.point_u)
        cached = state.points_cached[batch.image_ids][:, None, None]
        origin = torch.where(cached, state.origin_points[batch.image_ids], sampled)
        gt_points = torch.where(cached, state.refined_points[batch.image_ids], sampled)
        sl = slice(0, cfg.num_training_burninstep2)
        metrics: Dict[str, Tensor] = {}
        with torch.no_grad(), record_function("pt.teacher"):
            ps = _teacher_pseudo(teacher, batch, gt_points, points, cfg)
            vmask = batch.gt_valid[:, sl]
            metrics["coarse_bboxes_iou"] = _masked_iou(ps["pseudo_boxes"][:, sl],
                                                       batch.gt_boxes[:, sl], vmask)
            metrics["pseudo_mean_iou"] = ps["mean_iou"].mean()
            pwh = torch.where(vmask[..., None], ps["pseudo_boxes"][:, sl, 2:4], 0.0)
            metrics["pseudo_mean_wh"] = pwh.sum() / (2 * vmask.sum()).clamp(min=1)
            metrics["pseudo_max_wh"] = pwh.max()

        # student: rotated MIL refinement on the real view
        with record_function("pt.student_feat"):
            feat = student.extract_feat(batch.image).contiguous()
        with record_function("pt.mil"):
            refined_nt, mil_loss = _run_rmil_stages(
                student, feat, ps["pseudo_boxes"][:, sl], ps["pseudo_labels"][:, sl],
                batch.gt_valid[:, sl], batch.gt_boxes[:, sl], cfg, draws.neg_u, hw, metrics)
        refined_full = ps["pseudo_boxes"].clone()
        refined_full[:, sl] = refined_nt

        with torch.no_grad(), record_function("pt.augment"):
            # update_points runs before strong augmentation in the reference
            new_pts = (1 - cfg.lamda) * refined_full[..., :2] + cfg.lamda * origin
            aug = strong_augment_rotated(
                RAugBatch(image=batch.image, gt_points=new_pts, gt_valid=batch.gt_valid,
                          pseudo_points=refined_full[..., :2], pseudo_rboxes=refined_full,
                          pseudo_valid=batch.gt_valid),
                draws.aug_direction, draws.aug_u, draws.aug_angle)

        with record_function("pt.student_aug"):
            cls_a, bbox_a, ang_a, ctr_a = _flatten_rhead(
                student.head(student.extract_feat(aug.image)))
        with record_function("pt.dense_loss"):
            loss_cls, loss_bbox, loss_ctr = pseudo_branch_loss_rotated(
                cls_a, bbox_a, ang_a, ctr_a, points, aug.gt_points, batch.gt_labels,
                aug.gt_valid, aug.pseudo_rboxes, aug.pseudo_valid & batch.gt_valid, rdense)
        metrics["loss_cls"] = loss_cls
        metrics["loss_bbox"] = loss_bbox
        metrics["loss_centerness"] = loss_ctr
        total = loss_cls + loss_bbox + loss_ctr + mil_loss
        metrics["total_loss"] = total

        student.zero_grad(set_to_none=True)
        with record_function("pt.backward"):
            total.backward()
        with record_function("pt.optimizer"):
            state.optimizer.step()
        _point_update(state, batch, origin, refined_full, cfg, metrics)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step
