"""Train state of the teacher-student pair (counterpart of
point_teacher_tpu/train/state.py).

The teacher is a second detector holding the EMA weights; the per-image
point caches are dense [num_images, G, 2] tensors on the device, indexed by
an integer image id and sized by the dataset's image count (the baselines
carry them too, unused, as the JAX state does). The step updates the
modules, the optimizer and the caches in place. In a world of ranks every
rank holds the whole state (the caches of every image), the same on all.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from ..parallel import dist
from .config import OptimCfg
from .optim import PointTeacherSGD

Tensor = torch.Tensor


class Batch(NamedTuple):
    image: Tensor       # [B, H, W, 3] float32, raw 0-255 pixels
    gt_boxes: Tensor    # [B, G, 4] xyxy
    gt_labels: Tensor   # [B, G] int
    gt_valid: Tensor    # [B, G] bool
    image_ids: Tensor   # [B] int, index into the point caches


@dataclass
class TrainState:
    step: int
    student: nn.Module
    teacher: nn.Module
    optimizer: PointTeacherSGD
    origin_points: Tensor    # [N_images, G, 2]
    refined_points: Tensor   # [N_images, G, 2]
    points_cached: Tensor    # [N_images] bool
    generator: torch.Generator  # source of the step's random draws


def create_train_state(student: nn.Module, optim_cfg: OptimCfg, num_images: int,
                       max_gt: int, seed: int = 0) -> TrainState:
    """The teacher starts as a copy of the student; caches on the student's
    device. In a world of ranks the student comes from rank 0 first."""
    dev = next(student.parameters()).device
    dist.broadcast_module(student)
    teacher = copy.deepcopy(student).requires_grad_(False)
    return TrainState(
        step=0,
        student=student,
        teacher=teacher,
        optimizer=PointTeacherSGD(student, optim_cfg),
        origin_points=torch.zeros((num_images, max_gt, 2), device=dev),
        refined_points=torch.zeros((num_images, max_gt, 2), device=dev),
        points_cached=torch.zeros((num_images,), dtype=torch.bool, device=dev),
        generator=torch.Generator().manual_seed(seed),
    )


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, alpha: float) -> None:
    """t <- alpha * t + (1 - alpha) * s over every parameter, in place."""
    t = list(teacher.parameters())
    s = list(student.parameters())
    torch._foreach_mul_(t, alpha)
    torch._foreach_add_(t, s, alpha=1 - alpha)
