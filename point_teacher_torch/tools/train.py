"""Training entry point of the port (counterpart of tools/train.py).

  python -m point_teacher_torch.tools.train <config.py> --synthetic-data N
      --max-steps K [--seed S] [--cpu] [--cfg-options pt.burn_in_step=100 ...]

Runs on the CUDA card unless --cpu is given; asked for CUDA without a card it
raises. A config with `rotated` (sodaa_point_teacher_1x) trains the rotated
detector with the rotated step on rotated boxes. Steps 0..burn_in_step run
phase 1 (black-paper synthesis), later steps phase 2 (`is_phase1`). Data
comes from fabricated batches (--synthetic-data); checkpoints, validation
and the dataset loader are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config_io import apply_overrides, load_config
from ..models.detector import StudentFCOS
from ..models.rotated_detector import StudentRotatedFCOS
from ..train.rsteps import build_rotated_train_step
from ..train.state import Batch, create_train_state
from ..train.steps import build_train_step


def resolve_device(cpu: bool) -> torch.device:
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --cpu to run on the CPU")
    return torch.device("cuda")


def is_phase1(step: int, burn_in_step: int) -> bool:
    """The reference's phase switch (tools/train.py): burn-in step 1 while
    step <= burn_in_step."""
    return step <= burn_in_step


def synthetic_dataset(n_images, cfg_pt, seed=0, rotated=False):
    """Fabricated fixed batches (a copy of tools/train.py synthetic_dataset):
    xyxy boxes, or (cx, cy, w, h, a) boxes with a in [-pi/2, pi/2) when rotated."""
    s, g = cfg_pt.img_size, cfg_pt.max_gt

    def batches(batch_size):
        ids = np.arange(n_images)
        for start in range(0, n_images - batch_size + 1, batch_size):
            idx = ids[start:start + batch_size]
            rr = np.random.RandomState(seed * 1000 + start)
            img = rr.randint(0, 255, (batch_size, s, s, 3)).astype(np.float32)
            ng = rr.randint(1, g + 1, batch_size)
            cxy = rr.uniform(12, s - 12, (batch_size, g, 2))
            wh = rr.uniform(4, 16, (batch_size, g, 2))
            if rotated:
                ang = rr.uniform(-np.pi / 2, np.pi / 2, (batch_size, g, 1))
                boxes = np.concatenate([cxy, wh, ang], -1).astype(np.float32)
            else:
                boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
            valid = np.arange(g)[None] < ng[:, None]
            yield dict(image=img, gt_boxes=boxes,
                       gt_labels=rr.randint(0, cfg_pt.num_classes, (batch_size, g)),
                       gt_valid=valid, image_ids=idx)

    return batches


def to_batch(arrays: dict, device) -> Batch:
    return Batch(
        image=torch.as_tensor(arrays["image"], dtype=torch.float32, device=device),
        gt_boxes=torch.as_tensor(arrays["gt_boxes"], dtype=torch.float32, device=device),
        gt_labels=torch.as_tensor(arrays["gt_labels"], dtype=torch.long, device=device),
        gt_valid=torch.as_tensor(arrays["gt_valid"], dtype=torch.bool, device=device),
        image_ids=torch.as_tensor(arrays["image_ids"], dtype=torch.long, device=device),
    )


def setup(cfg: dict, n_images: int, seed: int, device, dtype=None):
    """Model, train state and step function of a run of a config dict of
    config_io.load_config: StudentFCOS and the HBB step, or, when the
    config says `rotated`, StudentRotatedFCOS and the rotated step."""
    pt = cfg["pt"]
    rotated = bool(cfg.get("rotated"))
    iters_per_epoch = max(n_images // pt.batch_size, 1)
    pt = pt._replace(optim=pt.optim._replace(iters_per_epoch=iters_per_epoch))
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model_cls = StudentRotatedFCOS if rotated else StudentFCOS
    style = {k: v for k, v in cfg.get("model", {}).items() if k == "backbone_style"}
    model = model_cls(num_classes=pt.num_classes, num_stages=pt.num_stages,
                      frozen_stages=pt.optim.frozen_stages, dtype=dtype, seed=seed,
                      **style).to(device)
    state = create_train_state(model, pt.optim, num_images=n_images, max_gt=pt.max_gt,
                               seed=seed)
    step_fn = build_rotated_train_step(pt) if rotated else build_train_step(pt)
    return pt, state, step_fn


def train(cfg: dict, n_images: int, max_steps: int, seed: int, device):
    """Run up to max_steps steps over the fabricated batches, printing one JSON
    line of metrics per step; returns the train state."""
    pt, state, step_fn = setup(cfg, n_images, seed, device)
    batches = synthetic_dataset(n_images, pt, seed, rotated=bool(cfg.get("rotated")))
    for epoch in range(pt.optim.max_epochs):
        for arrays in batches(pt.batch_size):
            phase1 = is_phase1(state.step, pt.burn_in_step)
            t0 = time.perf_counter()
            metrics = step_fn(state, to_batch(arrays, device), phase1=phase1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            record = {k: float(v) for k, v in metrics.items()}
            record.update(step=state.step, epoch=epoch + 1,
                          step_ms=(time.perf_counter() - t0) * 1e3)
            print(json.dumps(record))
            if max_steps and state.step >= max_steps:
                return state
    return state


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train Point-Teacher (PyTorch port)")
    ap.add_argument("config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg-options", nargs="*", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--synthetic-data", type=int, required=True, metavar="N_IMAGES",
                    help="train on N fabricated images (the dataset loader is not ported)")
    ap.add_argument("--max-steps", type=int, default=0, help="stop after N steps (0 = all)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    device = resolve_device(args.cpu)
    state = train(cfg, args.synthetic_data, args.max_steps, args.seed, device)
    print(f"training done at step {state.step}")


if __name__ == "__main__":
    main()
