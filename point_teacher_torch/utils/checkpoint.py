"""Checkpoint save / load of the whole train state (counterpart of
point_teacher_tpu/utils/checkpoint.py, in the port's own format).

One `torch.save` file holds the TrainState: the step, student and teacher
weights, the optimizer's update count and momentum, the three point caches
and the generator's state. Beside it, `<path>.meta.json` holds what a
loader must know before it can build the state to load into: num_images
(the point caches' length), and, from the training CLI, the epoch and step
(and val_mAP for best.pth).

In a world of ranks (parallel/dist.py) the state is the same on every rank:
rank 0 writes, and every rank waits at a barrier until it has; every rank
loads, onto its own device.
"""
from __future__ import annotations

import json
import os
import shutil

import torch

from ..parallel import dist
from ..train.state import TrainState


def save_checkpoint(state: TrainState, path: str, meta: dict | None = None) -> None:
    if dist.rank() == 0:
        _save(state, path, meta)
    dist.barrier()


def _save(state: TrainState, path: str, meta: dict | None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    opt = state.optimizer
    # written aside and renamed: a checkpoint that another name links to
    # (link_checkpoint) is replaced, never rewritten in place
    tmp = path + ".tmp"
    torch.save({
        "step": state.step,
        "student": state.student.state_dict(),
        "teacher": state.teacher.state_dict(),
        "optimizer": {"count": opt.count, "trace": opt.trace},
        "origin_points": state.origin_points,
        "refined_points": state.refined_points,
        "points_cached": state.points_cached,
        "generator": state.generator.get_state(),
    }, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def link_checkpoint(src: str, dst: str) -> None:
    """`dst` (and its meta) become the checkpoint `src`, as a hard link where
    the file system allows it, else a copy. The old `dst` is replaced by a
    rename, so a file that another name links to is never rewritten. In a
    world of ranks rank 0 links, the others wait."""
    if dist.rank() == 0:
        _link(src, dst)
    dist.barrier()


def _link(src: str, dst: str) -> None:
    for a, b in ((src, dst), (src + ".meta.json", dst + ".meta.json")):
        if not os.path.exists(a):
            continue
        tmp = b + ".tmp"
        if os.path.lexists(tmp):
            os.remove(tmp)
        try:
            os.link(a, tmp)
        except OSError:
            shutil.copyfile(a, tmp)
        os.replace(tmp, b)


@torch.no_grad()
def load_checkpoint(state: TrainState, path: str) -> TrainState:
    """Load `path` into `state` (built for the same config and num_images),
    in place, onto the state's devices; returns the state."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.step = int(ckpt["step"])
    state.student.load_state_dict(ckpt["student"])
    state.teacher.load_state_dict(ckpt["teacher"])
    opt = state.optimizer
    opt.count = int(ckpt["optimizer"]["count"])
    for label, saved in ckpt["optimizer"]["trace"].items():
        if len(saved) != len(opt.trace[label]):
            raise ValueError(f"checkpoint {path}: {len(saved)} {label!r} momentum buffers, "
                             f"the optimizer has {len(opt.trace[label])}")
        for dst, src in zip(opt.trace[label], saved):
            dst.copy_(src)
    for name in ("origin_points", "refined_points", "points_cached"):
        dst, src = getattr(state, name), ckpt[name]
        if dst.shape != src.shape:
            raise ValueError(f"checkpoint {path}: {name} {tuple(src.shape)}, the state "
                             f"{tuple(dst.shape)} (num_images differs)")
        dst.copy_(src)
    state.generator.set_state(ckpt["generator"])
    return state


@torch.no_grad()
def load_weights(model: torch.nn.Module, path: str, branch: str = "teacher") -> torch.nn.Module:
    """Load one branch of a checkpoint, "teacher" (the EMA weights, what the
    reference evaluates) or "student", into `model`, in place; returns it."""
    if branch not in ("teacher", "student"):
        raise ValueError(f"branch must be 'teacher' or 'student', got {branch!r}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt[branch])
    return model


def load_meta(path: str) -> dict:
    mp = path + ".meta.json"
    if os.path.exists(mp):
        with open(mp) as f:
            return json.load(f)
    return {}
