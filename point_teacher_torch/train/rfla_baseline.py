"""Box-supervised RFLA-FCOS baseline step (counterpart of
point_teacher_tpu/train/rfla_baseline.py): the RFLA_FCOSHead loss on the
multi-level RFLAFCOS, with targets from the RFLA hierarchical assigner in
place of regress ranges: focal classification over the global positive
count, IoU (-log) on the decoded boxes weighted by the centerness target
over its sum, BCE centerness.

Each step: the EMA teacher first, then the forward, the targets, the
losses and one optimizer update. No random draw; no RoIAlign. Runs inside
`record_function("pt.rfla")`.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.autograd.profiler import record_function

from ..models.rfla_fcos_head import level_points_and_rfields, rfla_targets
from ..ops.losses import iou_loss
from ..parallel import dist
from .config import PointTeacherConfig
from .fcos_baseline import dense_box_losses, update
from .state import Batch, TrainState, ema_update
from .superstep import build_scan

Tensor = torch.Tensor


def build_rfla_train_step(cfg: PointTeacherConfig):
    """Returns step(state, batch, phase1=False) -> metrics (loss_cls,
    loss_bbox, loss_centerness, total_loss, num_pos) for a state whose
    student is an RFLAFCOS; it updates `state` in place."""
    cache = {}

    def step(state: TrainState, batch: Batch, phase1: bool = False) -> Dict[str, Tensor]:
        del phase1
        dev = batch.image.device
        if dev not in cache:
            cache[dev] = level_points_and_rfields(cfg.img_size, device=dev)[:2]
        points, rfields = cache[dev]
        model = state.student
        with record_function("pt.rfla"):
            with record_function("pt.ema"):
                ema_update(state.teacher, model, cfg.ema_alpha)
            with record_function("pt.student_feat"):
                cls_f, bbox_f, ctr_f = model.flatten_outs(model(batch.image))
            with torch.no_grad(), record_function("pt.targets"):
                targets = [rfla_targets(points, rfields, batch.gt_boxes[i], batch.gt_labels[i],
                                        batch.gt_valid[i], cfg.num_classes)
                           for i in range(cls_f.shape[0])]
            with record_function("pt.dense_loss"):
                loss_cls, loss_bbox, loss_ctr, num_pos = dense_box_losses(
                    cls_f, bbox_f, ctr_f, points, torch.stack([t[0] for t in targets]),
                    torch.stack([t[1] for t in targets]), cfg.num_classes, iou_loss)
                total = loss_cls + loss_bbox + loss_ctr
            update(state, total)
        return dist.sum_losses({k: v.detach() for k, v in dict(
            loss_cls=loss_cls, loss_bbox=loss_bbox, loss_centerness=loss_ctr, total_loss=total,
            num_pos=num_pos).items()})

    return step


def build_rfla_train_step_scan(cfg: PointTeacherConfig):
    """Returns scan(state, batches, phase1=False) -> {metric: Tensor [K]}:
    K sequential steps of build_rfla_train_step's step (no draws); on a card
    K replays of one captured CUDA graph of the step (train/superstep.py)."""
    return build_scan(build_rfla_train_step(cfg))
