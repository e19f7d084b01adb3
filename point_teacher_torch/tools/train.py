"""Training entry point of the port (counterpart of tools/train.py).

  python -m point_teacher_torch.tools.train <config.py> [--work-dir D]
      [--resume-from D/epoch_1.pth] [--seed S] [--cpu] [--cpu-devices N]
      [--synthetic-data N] [--max-steps K] [--ckpt-interval E] [--val-interval E]
      [--cfg-options pt.burn_in_step=100 model.pretrained=R50.pth ...]
  torchrun --nproc_per_node=GPUS -m point_teacher_torch.tools.train <config.py> ...

Runs on the CUDA card unless --cpu is given; asked for CUDA without a card it
raises. Data parallel (parallel/dist.py): under torchrun each rank runs on
cuda:LOCAL_RANK over NCCL (gloo with --cpu); --cpu-devices N spawns N CPU
ranks over gloo. Each rank trains on its rows of every global batch of
pt.batch_size (which the world must divide, else ValueError), the metrics,
the gradient and the point caches are the global batch's, and rank 0
prints, logs and writes the checkpoints.

The config's `trainer` picks the model and the step: `point_teacher`
(StudentFCOS, or StudentRotatedFCOS when the config says `rotated`; steps
0..burn_in_step run phase 1, black-paper synthesis, later steps phase 2,
`is_phase1`), `fcos` (the box-supervised FCOS on StudentFCOS) or
`rfla_fcos` (the multi-level RFLAFCOS). `model.pretrained` loads a
torchvision-layout ResNet-50 .pth into the backbone.

Data: the config's train set through TrainLoader (AI-TOD-v2: a COCO json and
its image folder; SODA-A: the divData per-patch json and image folders),
or N fabricated images with --synthetic-data N. An epoch is
max(n_images // batch_size, 1) steps; --max-steps is an absolute step.

Every step prints one JSON line of its metrics (with step, epoch, step_ms);
D/train_log.jsonl gets the metrics averaged every 50 steps and at each
epoch's end (`mode: "train"`) and each validation (`mode: "val"`). Every
--ckpt-interval epochs and when the run stops the whole train state goes to
D/epoch_{e}.pth and D/latest.pth, each with a .meta.json of epoch, step and
num_images. With --val-interval E the teacher is evaluated on the config's
val set (or on N fabricated images) every E epochs and when the run stops,
and D/best.pth is written whenever the headline beats the best so far
(meta val_mAP). The rotated headline is AP .5:.95; the JAX package's is 0.0
always (ROADMAP.md queue 3), so its SODA-A best.pth and val records differ
from the port's by design.

--resume-from loads a checkpoint whole (weights, optimizer, point caches,
generator) and goes on as the JAX CLI does: a fresh loader from --seed, the
start epoch step // iters_per_epoch, the schedule read at the restored step;
so a resumed run does not see the batches the run without the stop would
have seen.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config_io import apply_overrides, load_config
from ..models.detector import StudentFCOS
from ..models.rfla_fcos_head import RFLAFCOS
from ..models.rotated_detector import StudentRotatedFCOS
from ..parallel import dist, launch
from ..train.fcos_baseline import build_fcos_train_step
from ..train.optim import lr_at
from ..train.rfla_baseline import build_rfla_train_step
from ..train.rsteps import build_rotated_train_step
from ..train.state import Batch, create_train_state
from ..train.steps import build_train_step


def resolve_device(cpu: bool) -> torch.device:
    """The CPU, or the card: under torchrun the rank's, cuda:LOCAL_RANK."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --cpu to run on the CPU")
    return dist.local_device() if dist.env_world() is not None else torch.device("cuda")


def run_distributed(fn, args, device) -> None:
    """fn(args, device) in the world torchrun describes, joined before and
    left after."""
    dist.init_from_env(device)
    try:
        fn(args, device)
    finally:
        dist.shutdown()


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


def build_model(cfg: dict, seed: int, device, dtype=None):
    """The detector of a config dict of config_io.load_config on `device`:
    RFLAFCOS for the `rfla_fcos` trainer, else StudentFCOS, or
    StudentRotatedFCOS when the config says `rotated`; weights drawn from
    `seed`; bf16 autocast on the card, f32 on the CPU unless `dtype` is given."""
    pt = cfg["pt"]
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    mcfg = cfg.get("model", {})
    if mcfg.get("depth", 50) != 50:
        raise ValueError(f"the port's ResNet is ResNet-50, the config asks for depth "
                         f"{mcfg['depth']}")
    style = {k: v for k, v in mcfg.items() if k == "backbone_style"}
    common = dict(num_classes=pt.num_classes, frozen_stages=pt.optim.frozen_stages,
                  dtype=dtype, seed=seed, **style)
    if cfg.get("trainer", "point_teacher") == "rfla_fcos":
        return RFLAFCOS(**common).to(device)
    model_cls = StudentRotatedFCOS if cfg.get("rotated") else StudentFCOS
    return model_cls(num_stages=pt.num_stages, **common).to(device)


def build_step(cfg: dict, pt):
    """The step function of the config's trainer."""
    trainer = cfg.get("trainer", "point_teacher")
    if trainer == "fcos":
        return build_fcos_train_step(pt)
    if trainer == "rfla_fcos":
        return build_rfla_train_step(pt)
    if trainer != "point_teacher":
        raise ValueError(f"unknown trainer {trainer!r}")
    return build_rotated_train_step(pt) if cfg.get("rotated") else build_train_step(pt)


def setup(cfg: dict, n_images: int, seed: int, device, dtype=None):
    """Model, train state and step function of a run of a config dict of
    config_io.load_config over `n_images` images: the config's trainer
    (build_model, build_step), the backbone from `model.pretrained` where
    the config names one, the point caches sized by n_images."""
    pt = cfg["pt"]
    iters_per_epoch = max(n_images // pt.batch_size, 1)
    pt = pt._replace(optim=pt.optim._replace(iters_per_epoch=iters_per_epoch))
    model = build_model(cfg, seed, device, dtype)
    pretrained = cfg.get("model", {}).get("pretrained")
    if pretrained:
        from ..utils.torch_port import load_torch_resnet50_into

        load_torch_resnet50_into(model, pretrained)
        say(f"loaded pretrained backbone from {pretrained}")
    state = create_train_state(model, pt.optim, num_images=n_images, max_gt=pt.max_gt,
                               seed=seed)
    return pt, state, build_step(cfg, pt)


def train_data(cfg: dict, seed: int, synthetic_n: int = 0):
    """(n_images, batches(batch_size) -> an epoch's numpy batches): the
    config's train set through TrainLoader, or `synthetic_n` fabricated
    images; in a world of ranks this rank's rows of each batch."""
    pt, rotated = cfg["pt"], bool(cfg.get("rotated"))
    if synthetic_n:
        fabricated = synthetic_dataset(synthetic_n, pt, seed, rotated=rotated)
        rows = dist.rank_rows(pt.batch_size)
        return synthetic_n, lambda bs: ({k: v[rows] for k, v in a.items()}
                                        for a in fabricated(bs))
    from ..data import AITODDataset, SODAADataset, TrainLoader

    dcfg = cfg["dataset"]
    ds = (SODAADataset if rotated else AITODDataset)(dcfg["train_ann"], dcfg["train_img_prefix"])
    loader = TrainLoader(ds, pt.batch_size, pt.max_gt, pt.img_size, seed=seed,
                         img_norm=dcfg.get("img_norm"))
    say(f"dataset: {len(ds)} images, {len(ds.CLASSES)} classes")
    return len(ds), lambda bs: loader.epoch()


class Validator:
    """The EvalHook counterpart: evaluate the teacher of a state as it
    stands (its modules' modes, gradients and autocast untouched), log the
    headline as val_mAP, and write best.pth when it beats the best so far
    (which starts at -1, so the first evaluation writes it). In a world of
    ranks every rank calls it: the eval is sharded, and every rank gets the
    same headline."""

    def __init__(self, cfg: dict, pt, work_dir: str, n_images: int, synthetic_n: int, logger):
        self.cfg, self.pt, self.work_dir = cfg, pt, work_dir
        self.n_images, self.synthetic_n, self.logger = n_images, synthetic_n, logger
        self.infer = None
        self.best = -1.0

    def __call__(self, state, epoch: int, step: int) -> float:
        from ..evalx.runner import build_infer, evaluate_detector
        from ..utils.checkpoint import save_checkpoint

        rotated = bool(self.cfg.get("rotated"))
        if self.infer is None:
            self.infer = build_infer(self.pt, rotated, self.cfg.get("trainer", "point_teacher"))
        t0 = time.perf_counter()
        ap, _ = evaluate_detector(self.infer, state.teacher, self.pt, self.cfg, rotated=rotated,
                                  synthetic_n=self.synthetic_n, quiet=True)
        secs = time.perf_counter() - t0
        self.logger.val(step, epoch, {"val_mAP": ap}, lr=lr_at(self.pt.optim, step))
        best = f" (best {self.best:.4f})" if self.best >= 0 else ""
        say(f"epoch {epoch}: val mAP = {ap:.4f}{best}; {secs:.2f} s")
        if ap > self.best:
            self.best = ap
            path = os.path.join(self.work_dir, "best.pth")
            save_checkpoint(state, path, meta=dict(epoch=epoch, step=step,
                                                   num_images=self.n_images, val_mAP=ap))
            say(f"new best mAP {ap:.4f} -> {path}")
        return ap


def say(text: str) -> None:
    """Print on rank 0 (every line without a world)."""
    if dist.rank() == 0:
        print(text, flush=True)


def train(cfg: dict, work_dir: str, seed: int = 0, device=None, synthetic_n: int = 0,
          max_steps: int = 0, resume_from: str | None = None, ckpt_interval: int = 1,
          val_interval: int = 0):
    """The training loop of tools/train.py on `device`, this rank's part of
    it in a world of ranks; returns the train state."""
    from ..utils.checkpoint import link_checkpoint, load_checkpoint, save_checkpoint
    from ..utils.logging import TrainLogger

    os.makedirs(work_dir, exist_ok=True)
    n_images, batches = train_data(cfg, seed, synthetic_n)
    if dist.world() > 1:
        say(f"data parallel over {dist.world()} devices")
    pt, state, step_fn = setup(cfg, n_images, seed, device)
    if resume_from:
        load_checkpoint(state, resume_from)
        dist.broadcast_module(state.student)
        dist.broadcast_module(state.teacher)
        say(f"resumed from {resume_from} at step {state.step}")
    logger = TrainLogger(work_dir, interval=50)
    validate = Validator(cfg, pt, work_dir, n_images, synthetic_n, logger)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda _d=None: None)
    stop = False
    try:
        for epoch in range(state.step // pt.optim.iters_per_epoch, pt.optim.max_epochs):
            for arrays in batches(pt.batch_size):
                phase1 = is_phase1(state.step, pt.burn_in_step)
                t0 = time.perf_counter()
                metrics = step_fn(state, to_batch(arrays, device), phase1=phase1)
                sync(device)
                record = {k: float(v) for k, v in metrics.items()}
                logger.step(state.step, epoch + 1, record, lr=lr_at(pt.optim, state.step))
                record.update(step=state.step, epoch=epoch + 1,
                              step_ms=(time.perf_counter() - t0) * 1e3)
                say(json.dumps(record))
                if max_steps and state.step >= max_steps:
                    stop = True
                    break
            logger.emit(state.step, epoch + 1, lr=lr_at(pt.optim, state.step))
            if val_interval and ((epoch + 1) % val_interval == 0 or stop):
                validate(state, epoch + 1, state.step)
            if (epoch + 1) % ckpt_interval == 0 or stop:
                path = os.path.join(work_dir, f"epoch_{epoch + 1}.pth")
                save_checkpoint(state, path, meta=dict(epoch=epoch + 1, step=state.step,
                                                       num_images=n_images))
                link_checkpoint(path, os.path.join(work_dir, "latest.pth"))
                say(f"saved checkpoint: {path}")
            if stop:
                break
    finally:
        logger.close()
    say(f"training done at step {state.step}")
    return state


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train Point-Teacher (PyTorch port)")
    ap.add_argument("config")
    ap.add_argument("--work-dir", help="checkpoints and train_log.jsonl (default: the "
                                       "config's work_dir)")
    ap.add_argument("--resume-from", help="a checkpoint of this CLI to go on from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg-options", nargs="*", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--cpu-devices", type=int, default=0, metavar="N",
                    help="data parallel over N CPU processes (gloo); implies --cpu")
    ap.add_argument("--synthetic-data", type=int, default=0, metavar="N_IMAGES",
                    help="train on N fabricated images instead of the dataset")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop at this step (absolute; 0 = the config's epochs)")
    ap.add_argument("--ckpt-interval", type=int, default=1, help="epochs between checkpoints")
    ap.add_argument("--val-interval", type=int, default=0, metavar="EPOCHS",
                    help="evaluate the teacher every N epochs and keep best.pth (0 = off)")
    return ap.parse_args(argv)


def _run(args, device):
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    work_dir = args.work_dir or cfg.get("work_dir", "work_dirs/default")
    return train(cfg, work_dir, args.seed, device, args.synthetic_data, args.max_steps,
                 args.resume_from, args.ckpt_interval, args.val_interval)


def main(argv=None):
    """Train as the flags say; returns the train state, except with
    --cpu-devices (the ranks hold it) and under torchrun."""
    args = parse_args(argv)
    if args.cpu_devices:
        launch.spawn(_run, args.cpu_devices, args, torch.device("cpu"))
        return None
    device = resolve_device(args.cpu)
    if dist.env_world() is not None:
        run_distributed(_run, args, device)
        return None
    return _run(args, device)


if __name__ == "__main__":
    main()
