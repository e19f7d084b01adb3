"""Box-supervised FCOS baseline step (counterpart of
point_teacher_tpu/train/fcos_baseline.py): the paper's upper bound, plain
FCOS trained on the real GT boxes, on the Point-Teacher detector
(ResNet-50 + FPN + PSAGG, one stride-8 level).

Each step: the EMA teacher first (kept for evaluation, as in the
teacher-student runs), then the student's forward on the batch, the
synthetic branch's Topk point assignment to the GTs with their labels,
focal classification over the positives, DIoU on the decoded boxes
weighted by the centerness target, BCE centerness, one optimizer update.
No random draw; no RoIAlign. Runs inside `record_function("pt.fcos")`.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.autograd.profiler import record_function

from ..core.assigners import labels_from_assignment
from ..core.targets import assign_points_to_gts, box_targets_for_assignment
from ..ops.boxes import distance2bbox, grid_points, xyxy_to_cxcywh
from ..ops.losses import binary_cross_entropy, centerness_target, diou_loss, focal_loss_from_labels
from ..parallel import dist
from .config import PointTeacherConfig
from .state import Batch, TrainState, ema_update
from .steps import _flatten_head
from .superstep import build_scan

Tensor = torch.Tensor


def dense_box_losses(cls_f: Tensor, bbox_f: Tensor, ctr_f: Tensor, points: Tensor,
                     labels: Tensor, tgts: Tensor, num_classes: int, box_loss):
    """The box-supervised FCOS losses of per-point predictions cls [B, P, K],
    bbox [B, P, 4] (l, t, r, b px), ctr [B, P] and targets labels [B, P]
    (num_classes = background), tgts [B, P, 4]: focal over the positive
    count, `box_loss` of the decoded boxes weighted by the centerness target
    over its sum, BCE centerness over the positive count. Returns
    (loss_cls, loss_bbox, loss_centerness, num_pos)."""
    pos = labels < num_classes
    ctr_t = torch.where(pos, centerness_target(tgts), 0.0)
    num_pos, denorm = dist.global_sum(pos.sum().float(), ctr_t.sum().detach())
    num_pos, denorm = num_pos.clamp(min=1.0), denorm.clamp(min=1e-6)
    loss_cls = focal_loss_from_labels(cls_f.reshape(-1, num_classes), labels.reshape(-1),
                                      num_classes, avg_factor=num_pos)
    pts = points[None].expand(cls_f.shape[0], -1, -1)
    loss_bbox = box_loss(distance2bbox(pts, bbox_f).reshape(-1, 4),
                         distance2bbox(pts, tgts).reshape(-1, 4),
                         weight=ctr_t.reshape(-1), avg_factor=denorm)
    loss_ctr = binary_cross_entropy(ctr_f.reshape(-1), ctr_t.reshape(-1),
                                    weight=pos.reshape(-1).float(), avg_factor=num_pos)
    return loss_cls, loss_bbox, loss_ctr, num_pos


def update(state: TrainState, total: Tensor) -> None:
    """Backward of `total`, the gradients summed over the world, one
    optimizer update, the step count."""
    state.student.zero_grad(set_to_none=True)
    with record_function("pt.backward"):
        total.backward()
        dist.reduce_grads(state.student)
    with record_function("pt.optimizer"):
        state.optimizer.step()
    state.step += 1


def build_fcos_train_step(cfg: PointTeacherConfig):
    """Returns step(state, batch, phase1=False) -> metrics (loss_cls,
    loss_bbox, loss_centerness, total_loss), which updates `state` in
    place; `phase1` is taken, as the CLI passes it, and not used."""
    cfg = cfg.normalized()
    assigner = cfg.dense.syn_assigner

    def step(state: TrainState, batch: Batch, phase1: bool = False) -> Dict[str, Tensor]:
        del phase1
        with record_function("pt.fcos"):
            points = grid_points(cfg.feat_size, cfg.feat_size, cfg.stride,
                                 device=batch.image.device)
            with record_function("pt.ema"):
                ema_update(state.teacher, state.student, cfg.ema_alpha)
            with record_function("pt.student_feat"):
                cls_f, bbox_f, ctr_f = _flatten_head(state.student(batch.image)[0])
            with torch.no_grad(), record_function("pt.targets"):
                labels, tgts = [], []
                for i in range(cls_f.shape[0]):
                    gb, gl = batch.gt_boxes[i], batch.gt_labels[i]
                    assigned = assign_points_to_gts(points, cls_f[i], xyxy_to_cxcywh(gb), gl,
                                                    batch.gt_valid[i], assigner)
                    labels.append(labels_from_assignment(assigned, gl, cfg.num_classes))
                    tgts.append(box_targets_for_assignment(points, gb, assigned))
            with record_function("pt.dense_loss"):
                loss_cls, loss_bbox, loss_ctr, _ = dense_box_losses(
                    cls_f, bbox_f, ctr_f, points, torch.stack(labels), torch.stack(tgts),
                    cfg.num_classes, diou_loss)
                total = loss_cls + loss_bbox + loss_ctr
            update(state, total)
        return dist.sum_losses({k: v.detach() for k, v in dict(
            loss_cls=loss_cls, loss_bbox=loss_bbox, loss_centerness=loss_ctr,
            total_loss=total).items()})

    return step


def build_fcos_train_step_scan(cfg: PointTeacherConfig):
    """Returns scan(state, batches, phase1=False) -> {metric: Tensor [K]}:
    K sequential steps of build_fcos_train_step's step (no draws); on a card
    K replays of one captured CUDA graph of the step (train/superstep.py)."""
    return build_scan(build_fcos_train_step(cfg))
