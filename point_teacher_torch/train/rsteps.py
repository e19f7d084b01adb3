"""The rotated (OBB, SODA-A) Point-Teacher train step (counterpart of
point_teacher_tpu/train/rsteps.py, _make_rotated_step_fn).

Both burn-in phases, as in the HBB step (train/steps.py) with the rotated
deltas: the annotation points are cached, else the box centres or a sample
in the rotated box; the teacher's pseudo boxes, the MIL bags and the strong
augmentation are rotated; phase 1 trains the synthetic branch on the
synthetic rotated boxes themselves (not their covers), and its regression
loss decodes through the distance-angle coder.

Randomness is an input (steps.Draws, with the per-image rotation angle);
the step's parts run inside the `pt.*` profiler ranges of the HBB step. In a
world of ranks it runs as the HBB step does: its rows of the global batch
and of the draws, every reduction global (parallel/dist.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.autograd.profiler import record_function

from ..core.raugment import RAugBatch, random_point_in_rboxes, strong_augment_rotated
from ..core.rpseudo import generate_pseudo_rboxes
from ..ops.boxes import grid_points
from ..ops.rotated import rbox_iou
from ..parallel import dist
from .config import PointTeacherConfig
from .mil import mil_stage_rotated
from .rdense_losses import RDenseLossCfg, pseudo_branch_loss_rotated, syn_branch_loss_rotated
from .state import Batch, TrainState, ema_update
from .steps import Draws, make_draws, synthesize, write_cache

Tensor = torch.Tensor


def _flatten_rhead(outs):
    """NHWC (cls, bbox, angle, ctr) maps -> per-point [B, P, *]."""
    cls_score, bbox_pred, angle_pred, centerness = outs
    b = cls_score.shape[0]
    return (cls_score.reshape(b, -1, cls_score.shape[-1]), bbox_pred.reshape(b, -1, 4),
            angle_pred.reshape(b, -1, 1), centerness.reshape(b, -1))


def _masked_iou(rb1: Tensor, rb2: Tensor, valid: Tensor) -> Tensor:
    """Mean aligned rotated IoU over the valid slots (of the global batch)."""
    ious = rbox_iou(rb1.reshape(-1, 5), rb2.reshape(-1, 5), aligned=True)
    v = valid.reshape(-1)
    return dist.global_ratio(torch.where(v, ious, 0.0).sum(), v.sum())


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
                     cfg: PointTeacherConfig, neg_u, hw, metrics: Dict[str, Tensor],
                     with_bags: bool = True):
    """Unrolled rotated MIL stages; returns (refined rotated boxes, weighted
    loss). Without bags (the synthetic branch) as steps._run_mil_stages."""
    total = torch.zeros((), device=rboxes.device)
    cur = rboxes
    for stage in range(cfg.num_stages):
        out = mil_stage_rotated(model, mil_feat, cur, labels, valid, real_rboxes,
                                cfg.fine_proposal_cfg[stage],
                                cfg.fine_proposal_extensive_cfg[stage], stage, hw, cfg.top_k,
                                cfg.beta, cfg.dn_hyper_denoising,
                                neg_u[stage] if with_bags else None, with_bags,
                                window=cfg.mil_pool_window_rotated, grouped=cfg.mil_pool_grouped)
        metrics[f"stage{stage}_loss_mil_bbox"] = out.loss_mil_bbox * cfg.alpha[0]
        metrics[f"stage{stage}_coarse_bags_iou"] = out.coarse_bags_iou
        metrics[f"stage{stage}_refine_bags_iou"] = out.refine_bags_iou
        metrics[f"stage{stage}_cls_pool_coverage"] = out.cls_pool_coverage
        if not with_bags:
            total = total + out.loss_mil_bbox * cfg.alpha[0]
            continue
        metrics[f"stage{stage}_loss_mil_bags"] = out.loss_mil_bags * cfg.alpha[1]
        total = total + out.loss_mil_bbox * cfg.alpha[0] + out.loss_mil_bags * cfg.alpha[1]
        metrics[f"stage{stage}_refine_bboxes_iou"] = _masked_iou(out.refined_boxes, real_rboxes,
                                                                 valid)
        cur = out.refined_boxes
    return cur, total


@torch.no_grad()
def _point_update(state: TrainState, batch: Batch, origin, refined_rboxes,
                  cfg: PointTeacherConfig, metrics: Dict[str, Tensor],
                  gate: Optional[Tensor] = None) -> None:
    """refined = (1 - lamda) * pseudo centre + lamda * origin, written where
    `gate` (phase 1) is open; origin and cached always."""
    new_refined = (1 - cfg.lamda) * refined_rboxes[..., :2] + cfg.lamda * origin
    gt = batch.gt_boxes
    distance = torch.sqrt((new_refined - gt[..., :2]) ** 2) / torch.sqrt(
        ((gt[..., 2:4] / 2) ** 2).clamp(min=1e-12))
    mask = batch.gt_valid[..., None]
    metrics["refined_points_distance"] = dist.global_ratio(
        torch.where(mask, distance, 0.0).sum(), mask.sum() * 1.0, least=1.0)
    write_cache(state, batch.image_ids, origin, new_refined, gate)


def build_rotated_train_step(cfg: PointTeacherConfig, rdense: Optional[RDenseLossCfg] = None):
    """Returns step(state, batch, phase1=False, draws=None) -> metrics for
    batches whose gt_boxes are rotated [B, G, 5]; it updates `state` in place
    (student, teacher, optimizer, point caches)."""
    if rdense is None:
        rdense = RDenseLossCfg(num_classes=cfg.num_classes)
    hw = (cfg.img_size, cfg.img_size)

    def step(state: TrainState, batch: Batch, phase1: bool = False,
             draws: Optional[Draws] = None) -> Dict[str, Tensor]:
        dev = batch.image.device
        b = batch.image.shape[0]
        if draws is None:
            draws = make_draws(state.generator, cfg, b * dist.world(), dev, phase1)
        draws = dist.take_rows(draws)
        points = grid_points(cfg.feat_size, cfg.feat_size, cfg.stride, device=dev)
        student, teacher = state.student, state.teacher
        with record_function("pt.ema"):
            ema_update(teacher, student, cfg.ema_alpha)

        sampled = random_point_in_rboxes(batch.gt_boxes, cfg.position, draws.point_u)
        cached = state.points_cached[batch.image_ids][:, None, None]
        origin = torch.where(cached, state.origin_points[batch.image_ids], sampled)
        gt_points = torch.where(cached, state.refined_points[batch.image_ids], sampled)
        nt = cfg.num_training_burninstep1 if phase1 else cfg.num_training_burninstep2
        sl = slice(0, nt)
        metrics: Dict[str, Tensor] = {}
        with torch.no_grad(), record_function("pt.teacher"):
            ps = _teacher_pseudo(teacher, batch, gt_points, points, cfg)
            vmask = batch.gt_valid[:, sl]
            metrics["coarse_bboxes_iou"] = _masked_iou(ps["pseudo_boxes"][:, sl],
                                                       batch.gt_boxes[:, sl], vmask)
            metrics["pseudo_mean_iou"] = dist.global_mean(ps["mean_iou"])
            pwh = torch.where(vmask[..., None], ps["pseudo_boxes"][:, sl, 2:4], 0.0)
            metrics["pseudo_mean_wh"] = dist.global_ratio(pwh.sum(), 2 * vmask.sum())
            metrics["pseudo_max_wh"] = dist.global_max(pwh)

        def augment(refined_full, gate=None):
            # update_points runs before strong augmentation in the reference
            with torch.no_grad(), record_function("pt.augment"):
                new_pts = (1 - cfg.lamda) * refined_full[..., :2] + cfg.lamda * origin
                if gate is not None:
                    new_pts = torch.where(gate, new_pts, gt_points)
                return strong_augment_rotated(
                    RAugBatch(image=batch.image, gt_points=new_pts, gt_valid=batch.gt_valid,
                              pseudo_points=refined_full[..., :2], pseudo_rboxes=refined_full,
                              pseudo_valid=batch.gt_valid),
                    draws.aug_direction, draws.aug_u, draws.aug_angle)

        gate = None
        if phase1:
            with torch.no_grad(), record_function("pt.synthesis"):
                img_syn, syn_rboxes, syn_valid, gate = synthesize(draws.syn, batch, cfg, True)
            # refinement discarded: the augmented view comes from the coarse
            # pseudo boxes, and the three views run as one batch (steps.py)
            refined_full = ps["pseudo_boxes"]
            aug = augment(refined_full, gate)
            with record_function("pt.student_feat"):
                feat_all = student.extract_feat(torch.cat([img_syn, batch.image, aug.image]))
                cls_all, bbox_all, ang_all, ctr_all = _flatten_rhead(
                    student.head(torch.cat([feat_all[:b], feat_all[2 * b:]])))
            with record_function("pt.dense_loss"):
                loss_bbox, loss_ctr = syn_branch_loss_rotated(
                    cls_all[:b], bbox_all[:b], ang_all[:b], ctr_all[:b], points, syn_rboxes,
                    syn_valid, rdense)
            with record_function("pt.mil"):
                _, mil_syn = _run_rmil_stages(
                    student, feat_all[:b].contiguous(), syn_rboxes[:, :nt],
                    torch.zeros_like(batch.gt_labels[:, sl]), syn_valid[:, :nt],
                    syn_rboxes[:, :nt], cfg, draws.neg_u, hw, metrics, with_bags=False)
                _, mil_ori = _run_rmil_stages(
                    student, feat_all[b:2 * b].contiguous(), ps["pseudo_boxes"][:, sl],
                    ps["pseudo_labels"][:, sl], batch.gt_valid[:, sl], batch.gt_boxes[:, sl],
                    cfg, draws.neg_u, hw, metrics)
                mil_loss = (mil_syn + mil_ori) * gate
            cls_a, bbox_a, ang_a, ctr_a = cls_all[b:], bbox_all[b:], ang_all[b:], ctr_all[b:]
        else:
            # student: rotated MIL refinement on the real view
            with record_function("pt.student_feat"):
                feat = student.extract_feat(batch.image).contiguous()
            with record_function("pt.mil"):
                refined_nt, mil_loss = _run_rmil_stages(
                    student, feat, ps["pseudo_boxes"][:, sl], ps["pseudo_labels"][:, sl],
                    batch.gt_valid[:, sl], batch.gt_boxes[:, sl], cfg, draws.neg_u, hw, metrics)
            refined_full = ps["pseudo_boxes"].clone()
            refined_full[:, sl] = refined_nt
            aug = augment(refined_full)
            with record_function("pt.student_aug"):
                cls_a, bbox_a, ang_a, ctr_a = _flatten_rhead(
                    student.head(student.extract_feat(aug.image)))

        with record_function("pt.dense_loss"):
            loss_cls, loss_bbox_ps, loss_ctr_ps = pseudo_branch_loss_rotated(
                cls_a, bbox_a, ang_a, ctr_a, points, aug.gt_points, batch.gt_labels,
                aug.gt_valid, aug.pseudo_rboxes, aug.pseudo_valid & batch.gt_valid, rdense)
        if not phase1:
            loss_bbox, loss_ctr = loss_bbox_ps, loss_ctr_ps
        metrics["loss_cls"] = loss_cls
        metrics["loss_bbox"] = loss_bbox
        metrics["loss_centerness"] = loss_ctr
        total = loss_cls + loss_bbox + loss_ctr + mil_loss
        metrics["total_loss"] = total

        student.zero_grad(set_to_none=True)
        with record_function("pt.backward"):
            total.backward()
            dist.reduce_grads(student)
        with record_function("pt.optimizer"):
            state.optimizer.step()
        _point_update(state, batch, origin, refined_full, cfg, metrics, gate)
        state.step += 1
        return dist.sum_losses({k: v.detach() for k, v in metrics.items()})

    return step
