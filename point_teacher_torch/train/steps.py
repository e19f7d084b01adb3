"""The Point-Teacher train step (counterpart of point_teacher_tpu/train/steps.py).

Both burn-in phases. Each step: EMA first, then the annotation points, the
teacher's pseudo boxes, and then
- phase 2 (burn-in step 2, the training majority): the student's MIL
  refinement on the real view, strong augmentation of the refined boxes,
  the student's pseudo branch on the augmented view;
- phase 1 (burn-in step 1): black-paper synthetic images with their boxes
  (compacted to the front), the gate (every image kept a synthetic box),
  strong augmentation of the COARSE pseudo boxes (the refinement is
  discarded), one student feature pass over [synthetic, real, augmented]
  with the head on the synthetic and augmented rows, the synthetic branch's
  box and centerness losses, MIL on the synthetic bags (regression only)
  and on the real bags, both gated, and the pseudo branch's cls loss;
then one optimizer update and the point-cache update (phase 1 writes the
refined points only where the gate is open).

Randomness is an input: `Draws` holds every random number a step consumes,
and `make_draws` makes them from the state's torch.Generator. In a world of
ranks each rank draws the global batch's numbers and takes its rows, and
every batch-wide reduction is global (parallel/dist.py).

The step's parts run inside `record_function("pt.<part>")` ranges, which
tools/profile_step.py reads to split the step's device time.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

from ..core.augment import AugBatch, random_point_in_boxes, strong_augment
from ..core.pseudo import generate_pseudo_boxes
from ..core.synthetic import SynDraws, generate_black_paper_batch, make_syn_draws
from ..ops.boxes import bbox_overlaps, grid_points, xyxy_to_cxcywh
from ..parallel import dist
from ..utils.device import to_device
from .config import PointTeacherConfig
from .dense_losses import pseudo_branch_loss, syn_branch_loss
from .mil import mil_stage
from .state import Batch, TrainState, ema_update
from .superstep import build_scan

Tensor = torch.Tensor


class Draws(NamedTuple):
    point_u: Tensor                  # [B, G, 2] uniforms for random_point_in_boxes
    aug_direction: Tensor            # [B] flip direction in {0, 1, 2, 3}
    aug_u: Tensor                    # [B] uniforms in [0.8, 1.2) for the rescale
    neg_u: Tuple[Optional[Tensor], ...]  # per MIL stage [B, 4, gen_num_neg] or None
    aug_angle: Optional[Tensor] = None   # [B] rotation in whole degrees 1-19 (rotated step)
    syn: Optional[SynDraws] = None       # the synthesis's draws (phase 1)


def make_draws(generator: torch.Generator, cfg: PointTeacherConfig, batch_size: int,
               device, phase1: bool = False) -> Draws:
    """One step's draws from the CPU `generator`, on `device` (on a card
    copied from pinned memory, without a host sync)."""
    g, b = generator, batch_size
    neg = []
    for stage in range(cfg.num_stages):
        nn_ = cfg.fine_proposal_cfg[stage].gen_num_neg
        neg.append(torch.rand((b, 4, nn_), generator=g) if nn_ > 0 else None)
    return Draws(
        point_u=to_device(torch.rand((b, cfg.max_gt, 2), generator=g), device),
        aug_direction=to_device(torch.randint(0, 4, (b,), generator=g), device),
        aug_u=to_device(0.8 + 0.4 * torch.rand((b,), generator=g), device),
        neg_u=tuple(None if u is None else to_device(u, device) for u in neg),
        aug_angle=to_device(torch.randint(1, 20, (b,), generator=g).float(), device),
        syn=(make_syn_draws(g, len(cfg.shape_list), b, cfg.max_gt, device) if phase1
             else None),
    )


def synthesize(syn_draws: SynDraws, batch: Batch, cfg: PointTeacherConfig, rotated: bool):
    """The phase-1 synthetic view: (img_syn [B, H, W, 3], boxes [B, S, 4]
    xyxy covers, or [B, S, 5] rotated when `rotated`, valid [B, S], gate).
    The valid boxes are compacted to the front (a stable sort), so that the
    first num_training slots hold them; the gate, a 0-d bool tensor, is open
    when every image of the global batch kept at least one."""
    img_syn, syn_xyxy, syn_rboxes, syn_valid = generate_black_paper_batch(
        syn_draws, batch.image, batch.gt_boxes, batch.gt_valid, cfg.syn_cfg,
        fill_value=cfg.syn_fill_value)
    boxes = syn_rboxes if rotated else syn_xyxy
    order = torch.argsort((~syn_valid).to(torch.uint8), dim=-1, stable=True)
    boxes = boxes.gather(1, order[..., None].expand_as(boxes))
    syn_valid = syn_valid.gather(1, order)
    return img_syn, boxes, syn_valid, dist.global_all(syn_valid.any(-1).all())


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
                    cfg: PointTeacherConfig, neg_u, hw, metrics: Dict[str, Tensor],
                    with_bags: bool = True):
    """Unrolled MIL stages; returns (refined boxes, weighted loss). Without
    bags (the synthetic branch) a stage trains the regression only and the
    boxes stay as they are; its metrics go under the same keys, which the
    real branch's stages then overwrite."""
    total = torch.zeros((), device=boxes.device)
    cur = boxes
    for stage in range(cfg.num_stages):
        out = mil_stage(model, mil_feat, cur, labels, valid, real_boxes,
                        cfg.fine_proposal_cfg[stage], cfg.fine_proposal_extensive_cfg[stage],
                        stage, hw, cfg.top_k, cfg.beta, cfg.dn_hyper_denoising,
                        neg_u[stage] if with_bags else None, with_bags,
                        window=cfg.mil_pool_window, grouped=cfg.mil_pool_grouped)
        metrics[f"stage{stage}_loss_mil_bbox"] = out.loss_mil_bbox * cfg.alpha[0]
        metrics[f"stage{stage}_coarse_bags_iou"] = out.coarse_bags_iou
        metrics[f"stage{stage}_refine_bags_iou"] = out.refine_bags_iou
        metrics[f"stage{stage}_cls_pool_coverage"] = out.cls_pool_coverage
        if not with_bags:
            total = total + out.loss_mil_bbox * cfg.alpha[0]
            continue
        metrics[f"stage{stage}_loss_mil_bags"] = out.loss_mil_bags * cfg.alpha[1]
        total = total + out.loss_mil_bbox * cfg.alpha[0] + out.loss_mil_bags * cfg.alpha[1]
        ious = bbox_overlaps(out.refined_boxes, real_boxes, is_aligned=True)
        metrics[f"stage{stage}_refine_bboxes_iou"] = dist.global_ratio(
            torch.where(valid, ious, 0.0).sum(), valid.sum())
        cur = out.refined_boxes
    return cur, total


@torch.no_grad()
def _point_update(state: TrainState, batch: Batch, origin, refined_boxes,
                  cfg: PointTeacherConfig, metrics: Dict[str, Tensor],
                  gate: Optional[Tensor] = None) -> None:
    """update_points: refined = (1 - lamda) * pseudo centre + lamda * origin,
    written where `gate` (phase 1) is open; origin and cached always."""
    pseudo_centre = xyxy_to_cxcywh(refined_boxes)[..., :2]
    new_refined = (1 - cfg.lamda) * pseudo_centre + cfg.lamda * origin
    gt_c = xyxy_to_cxcywh(batch.gt_boxes)
    distance = torch.sqrt((new_refined - gt_c[..., :2]) ** 2) / torch.sqrt(
        ((gt_c[..., 2:4] / 2) ** 2).clamp(min=1e-12))
    mask = batch.gt_valid[..., None]
    metrics["refined_points_distance"] = dist.global_ratio(
        torch.where(mask, distance, 0.0).sum(), mask.sum())
    write_cache(state, batch.image_ids, origin, new_refined, gate)


def write_cache(state: TrainState, ids, origin, new_refined, gate: Optional[Tensor]) -> None:
    """The point caches of images `ids`: the refined points where `gate` is
    open (always without one), the original points and the cached flag always.
    In a world of ranks every rank writes every rank's images."""
    if gate is not None:
        new_refined = torch.where(gate, new_refined, state.refined_points[ids])
    ids, origin, new_refined = dist.gather_rows(ids, origin, new_refined)
    state.refined_points[ids] = new_refined
    state.origin_points[ids] = origin
    state.points_cached[ids] = torch.ones_like(ids, dtype=torch.bool)


def build_train_step(cfg: PointTeacherConfig):
    """Returns step(state, batch, phase1=False, draws=None) -> metrics, which
    updates `state` in place (student, teacher, optimizer, point caches).

    In a world of ranks (parallel/dist.py) `batch` holds this rank's rows of
    the global batch, `draws` (drawn from the state's generator when not
    given) the global batch's, of which the step takes its rows; the
    metrics are those of the global batch, the same on every rank."""
    cfg = cfg.normalized()
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

        origin, gt_points = _gather_points(state, batch, draws.point_u, cfg)
        nt = cfg.num_training_burninstep1 if phase1 else cfg.num_training_burninstep2
        sl = slice(0, nt)
        metrics: Dict[str, Tensor] = {}
        with torch.no_grad(), record_function("pt.teacher"):
            ps = _teacher_pseudo(teacher, batch, gt_points, points, cfg)
            vmask = batch.gt_valid[:, sl]
            ious = bbox_overlaps(ps["pseudo_boxes"][:, sl], batch.gt_boxes[:, sl],
                                 is_aligned=True)
            metrics["coarse_bboxes_iou"] = dist.global_ratio(torch.where(vmask, ious, 0.0).sum(),
                                                             vmask.sum())
            metrics["pseudo_mean_iou"] = dist.global_mean(ps["mean_iou"])
            pwh = ps["pseudo_boxes"][:, sl, 2:4] - ps["pseudo_boxes"][:, sl, :2]
            pwh = torch.where(vmask[..., None], pwh, 0.0)
            metrics["pseudo_mean_wh"] = dist.global_ratio(pwh.sum(), 2 * vmask.sum())
            metrics["pseudo_max_wh"] = dist.global_max(pwh)

        def augment(refined_full, gate=None):
            # update_points runs before strong augmentation in the reference
            with torch.no_grad(), record_function("pt.augment"):
                pseudo_centre = xyxy_to_cxcywh(refined_full)[..., :2]
                new_pts = (1 - cfg.lamda) * pseudo_centre + cfg.lamda * origin
                if gate is not None:
                    new_pts = torch.where(gate, new_pts, gt_points)
                return strong_augment(
                    AugBatch(image=batch.image, gt_points=new_pts, gt_valid=batch.gt_valid,
                             pseudo_points=pseudo_centre, pseudo_boxes=refined_full,
                             pseudo_valid=batch.gt_valid),
                    draws.aug_direction, draws.aug_u)

        gate = None
        if phase1:
            with torch.no_grad(), record_function("pt.synthesis"):
                img_syn, syn_boxes, syn_valid, gate = synthesize(draws.syn, batch, cfg, False)
            # the phase-1 refinement is discarded, so the augmented view comes
            # from the coarse pseudo boxes, and the student's three views run
            # as one batch; the head runs on the synthetic and augmented rows
            # only (FrozenBN: every row is independent of the others)
            refined_full = ps["pseudo_boxes"]
            aug = augment(refined_full, gate)
            with record_function("pt.student_feat"):
                feat_all = student.extract_feat(torch.cat([img_syn, batch.image, aug.image]))
                cls_all, bbox_all, ctr_all = _flatten_head(
                    student.head(torch.cat([feat_all[:b], feat_all[2 * b:]])))
            with record_function("pt.dense_loss"):
                loss_bbox, loss_ctr = syn_branch_loss(cls_all[:b], bbox_all[:b], ctr_all[:b],
                                                      points, syn_boxes, syn_valid, cfg.dense)
            with record_function("pt.mil"):
                # regression on the synthetic bags (exact boxes, labels 0), then
                # bag selection and classification on the real view
                _, mil_syn = _run_mil_stages(
                    student, feat_all[:b].contiguous(), syn_boxes[:, :nt],
                    torch.zeros_like(batch.gt_labels[:, sl]), syn_valid[:, :nt],
                    syn_boxes[:, :nt], cfg, draws.neg_u, hw, metrics, with_bags=False)
                _, mil_ori = _run_mil_stages(
                    student, feat_all[b:2 * b].contiguous(), ps["pseudo_boxes"][:, sl],
                    ps["pseudo_labels"][:, sl], batch.gt_valid[:, sl], batch.gt_boxes[:, sl],
                    cfg, draws.neg_u, hw, metrics)
                mil_loss = (mil_syn + mil_ori) * gate
            cls_a, bbox_a, ctr_a = cls_all[b:], bbox_all[b:], ctr_all[b:]
        else:
            # student: MIL refinement on the real view
            with record_function("pt.student_feat"):
                feat = student.extract_feat(batch.image).contiguous()
            with record_function("pt.mil"):
                refined_nt, mil_loss = _run_mil_stages(
                    student, feat, ps["pseudo_boxes"][:, sl], ps["pseudo_labels"][:, sl],
                    batch.gt_valid[:, sl], batch.gt_boxes[:, sl], cfg, draws.neg_u, hw, metrics)
            refined_full = ps["pseudo_boxes"].clone()
            refined_full[:, sl] = refined_nt
            aug = augment(refined_full)
            with record_function("pt.student_aug"):
                cls_a, bbox_a, ctr_a = _flatten_head(
                    student.head(student.extract_feat(aug.image)))

        with record_function("pt.dense_loss"):
            loss_cls, loss_bbox_ps, loss_ctr_ps = pseudo_branch_loss(
                cls_a, bbox_a, ctr_a, points, aug.gt_points, batch.gt_labels, aug.gt_valid,
                aug.pseudo_boxes, aug.pseudo_valid & batch.gt_valid, cfg.dense)
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


def build_train_step_scan(cfg: PointTeacherConfig):
    """Returns scan(state, batches, phase1=False) -> {metric: Tensor [K]}:
    K sequential steps of build_train_step's step over the K batches, their
    draws from the state's generator in the order of K calls; on a card K
    replays of one captured CUDA graph of the step (train/superstep.py)."""
    cfg = cfg.normalized()
    return build_scan(build_train_step(cfg),
                      lambda g, n, phase1: make_draws(g, cfg, n, "cpu", phase1))
