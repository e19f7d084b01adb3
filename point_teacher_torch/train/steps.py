"""The Point-Teacher train step (counterpart of point_teacher_tpu/train/steps.py).

Phase 2 (burn-in step 2, the training majority) is ported: EMA first, then
the annotation points, the teacher's pseudo boxes, the student's MIL
refinement, strong augmentation of the refined boxes, the student's pseudo
branch on the augmented view, one optimizer update and the point-cache
update. Phase 1 (black-paper synthesis) comes with the next slice.

Randomness is an input: `Draws` holds every random number a step consumes,
and `make_draws` makes them from the state's torch.Generator.

The step's parts run inside `record_function("pt.<part>")` ranges, which
tools/profile_step.py reads to split the step's device time.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

from ..core.augment import AugBatch, random_point_in_boxes, strong_augment
from ..core.pseudo import generate_pseudo_boxes
from ..ops.boxes import bbox_overlaps, grid_points, xyxy_to_cxcywh
from .config import PointTeacherConfig
from .dense_losses import pseudo_branch_loss
from .mil import mil_stage
from .state import Batch, TrainState, ema_update

Tensor = torch.Tensor


class Draws(NamedTuple):
    point_u: Tensor                  # [B, G, 2] uniforms for random_point_in_boxes
    aug_direction: Tensor            # [B] flip direction in {0, 1, 2, 3}
    aug_u: Tensor                    # [B] uniforms in [0.8, 1.2) for the rescale
    neg_u: Tuple[Optional[Tensor], ...]  # per MIL stage [B, 4, gen_num_neg] or None
    aug_angle: Optional[Tensor] = None   # [B] rotation in whole degrees 1-19 (rotated step)


def make_draws(generator: torch.Generator, cfg: PointTeacherConfig, batch_size: int,
               device) -> Draws:
    g, b = generator, batch_size
    neg = []
    for stage in range(cfg.num_stages):
        nn_ = cfg.fine_proposal_cfg[stage].gen_num_neg
        neg.append(torch.rand((b, 4, nn_), generator=g) if nn_ > 0 else None)
    return Draws(
        point_u=torch.rand((b, cfg.max_gt, 2), generator=g).to(device),
        aug_direction=torch.randint(0, 4, (b,), generator=g).to(device),
        aug_u=(0.8 + 0.4 * torch.rand((b,), generator=g)).to(device),
        neg_u=tuple(None if u is None else u.to(device) for u in neg),
        aug_angle=torch.randint(1, 20, (b,), generator=g).float().to(device),
    )


def _flatten_head(outs):
    """NHWC (cls, bbox, ctr) maps -> per-point [B, P, *]."""
    cls_score, bbox_pred, centerness = outs
    b = cls_score.shape[0]
    return (cls_score.reshape(b, -1, cls_score.shape[-1]), bbox_pred.reshape(b, -1, 4),
            centerness.reshape(b, -1))


def _teacher_pseudo(teacher, batch: Batch, gt_points, points, cfg: PointTeacherConfig):
    """Teacher forward + pseudo boxes per image, stacked over the batch."""
    cls_t, bbox_t, _ = _flatten_head(teacher(batch.image)[0])
    per_image = [generate_pseudo_boxes(points, cls_t[i], bbox_t[i], gt_points[i],
                                       batch.gt_labels[i], batch.gt_valid[i],
                                       batch.gt_boxes[i], cfg.filter_score, cfg.fuse_assigner)
                 for i in range(batch.image.shape[0])]
    return {k: torch.stack([r[k] for r in per_image]) for k in per_image[0]}


def _gather_points(state: TrainState, batch: Batch, point_u, cfg: PointTeacherConfig):
    """Cached points of images seen before, else a fresh sample."""
    sampled = random_point_in_boxes(batch.gt_boxes, cfg.position, point_u)
    cached = state.points_cached[batch.image_ids][:, None, None]
    origin = torch.where(cached, state.origin_points[batch.image_ids], sampled)
    refined = torch.where(cached, state.refined_points[batch.image_ids], sampled)
    return origin, refined


def _run_mil_stages(model, mil_feat, boxes, labels, valid, real_boxes,
                    cfg: PointTeacherConfig, neg_u, hw, metrics: Dict[str, Tensor]):
    """Unrolled MIL stages with the bag loss; returns (refined boxes, weighted loss)."""
    total = torch.zeros((), device=boxes.device)
    cur = boxes
    for stage in range(cfg.num_stages):
        out = mil_stage(model, mil_feat, cur, labels, valid, real_boxes,
                        cfg.fine_proposal_cfg[stage], cfg.fine_proposal_extensive_cfg[stage],
                        stage, hw, cfg.top_k, cfg.beta, cfg.dn_hyper_denoising,
                        neg_u[stage], True, window=cfg.mil_pool_window,
                        grouped=cfg.mil_pool_grouped)
        metrics[f"stage{stage}_loss_mil_bbox"] = out.loss_mil_bbox * cfg.alpha[0]
        metrics[f"stage{stage}_coarse_bags_iou"] = out.coarse_bags_iou
        metrics[f"stage{stage}_refine_bags_iou"] = out.refine_bags_iou
        metrics[f"stage{stage}_cls_pool_coverage"] = out.cls_pool_coverage
        metrics[f"stage{stage}_loss_mil_bags"] = out.loss_mil_bags * cfg.alpha[1]
        total = total + out.loss_mil_bbox * cfg.alpha[0] + out.loss_mil_bags * cfg.alpha[1]
        ious = bbox_overlaps(out.refined_boxes, real_boxes, is_aligned=True)
        metrics[f"stage{stage}_refine_bboxes_iou"] = (
            torch.where(valid, ious, 0.0).sum() / valid.sum().clamp(min=1))
        cur = out.refined_boxes
    return cur, total


@torch.no_grad()
def _point_update(state: TrainState, batch: Batch, origin, refined_boxes,
                  cfg: PointTeacherConfig, metrics: Dict[str, Tensor]) -> None:
    """update_points: refined = (1 - lamda) * pseudo centre + lamda * origin, cached."""
    pseudo_centre = xyxy_to_cxcywh(refined_boxes)[..., :2]
    new_refined = (1 - cfg.lamda) * pseudo_centre + cfg.lamda * origin
    gt_c = xyxy_to_cxcywh(batch.gt_boxes)
    dist = torch.sqrt((new_refined - gt_c[..., :2]) ** 2) / torch.sqrt(
        ((gt_c[..., 2:4] / 2) ** 2).clamp(min=1e-12))
    mask = batch.gt_valid[..., None]
    metrics["refined_points_distance"] = (
        torch.where(mask, dist, 0.0).sum() / mask.sum().clamp(min=1))
    ids = batch.image_ids
    state.refined_points[ids] = new_refined
    state.origin_points[ids] = origin
    state.points_cached[ids] = True


def build_train_step(cfg: PointTeacherConfig):
    """Returns step(state, batch, phase1=False, draws=None) -> metrics, which
    updates `state` in place (student, teacher, optimizer, point caches)."""
    cfg = cfg.normalized()
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

        origin, gt_points = _gather_points(state, batch, draws.point_u, cfg)
        sl = slice(0, cfg.num_training_burninstep2)
        metrics: Dict[str, Tensor] = {}
        with torch.no_grad(), record_function("pt.teacher"):
            ps = _teacher_pseudo(teacher, batch, gt_points, points, cfg)
            vmask = batch.gt_valid[:, sl]
            ious = bbox_overlaps(ps["pseudo_boxes"][:, sl], batch.gt_boxes[:, sl],
                                 is_aligned=True)
            metrics["coarse_bboxes_iou"] = (torch.where(vmask, ious, 0.0).sum()
                                            / vmask.sum().clamp(min=1))
            metrics["pseudo_mean_iou"] = ps["mean_iou"].mean()
            pwh = ps["pseudo_boxes"][:, sl, 2:4] - ps["pseudo_boxes"][:, sl, :2]
            pwh = torch.where(vmask[..., None], pwh, 0.0)
            metrics["pseudo_mean_wh"] = pwh.sum() / (2 * vmask.sum()).clamp(min=1)
            metrics["pseudo_max_wh"] = pwh.max()

        # student: MIL refinement on the real view
        with record_function("pt.student_feat"):
            feat = student.extract_feat(batch.image).contiguous()
        with record_function("pt.mil"):
            refined_nt, mil_loss = _run_mil_stages(
                student, feat, ps["pseudo_boxes"][:, sl], ps["pseudo_labels"][:, sl],
                batch.gt_valid[:, sl], batch.gt_boxes[:, sl], cfg, draws.neg_u, hw, metrics)
        refined_full = ps["pseudo_boxes"].clone()
        refined_full[:, sl] = refined_nt

        with torch.no_grad(), record_function("pt.augment"):
            # update_points runs before strong augmentation in the reference
            pseudo_centre = xyxy_to_cxcywh(refined_full)[..., :2]
            new_pts = (1 - cfg.lamda) * pseudo_centre + cfg.lamda * origin
            aug = strong_augment(
                AugBatch(image=batch.image, gt_points=new_pts, gt_valid=batch.gt_valid,
                         pseudo_points=pseudo_centre, pseudo_boxes=refined_full,
                         pseudo_valid=batch.gt_valid),
                draws.aug_direction, draws.aug_u)

        with record_function("pt.student_aug"):
            cls_a, bbox_a, ctr_a = _flatten_head(student.head(student.extract_feat(aug.image)))
        with record_function("pt.dense_loss"):
            loss_cls, loss_bbox, loss_ctr = pseudo_branch_loss(
                cls_a, bbox_a, ctr_a, points, aug.gt_points, batch.gt_labels, aug.gt_valid,
                aug.pseudo_boxes, aug.pseudo_valid & batch.gt_valid, cfg.dense)
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
