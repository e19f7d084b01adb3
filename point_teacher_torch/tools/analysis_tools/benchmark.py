"""Teacher-inference FPS of the port (counterpart of
tools/analysis_tools/benchmark.py).

  python -m point_teacher_torch.tools.analysis_tools.benchmark CONFIG [CHECKPOINT]
      [--warmup 5] [--iters 50] [--batch 1] [--cpu]

The config's inference (forward, decode and class NMS with its test
settings; apis.init_detector: the teacher of CHECKPOINT, or the seeded
init) on a batch of fabricated 0-255 images at the canvas size, --warmup
runs, then --iters runs timed with the host clock, the card synchronised
before the loop and after every run. Prints imgs/s, ms a run, and the
card's name and power limit (nvidia-smi) on the same line. A parity tool
for the reference's FPS script: the port's benchmark may reuse it or set
its own method. Runs on the CUDA card unless --cpu is given; asked for CUDA
without a card it raises.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Teacher-inference FPS (PyTorch port)")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={device.index or 0}"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip() if out.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> float:
    """Returns imgs/s."""
    args = parse_args(argv)
    import torch

    from ...apis import init_detector

    det = init_detector(args.config, args.checkpoint, device="cpu" if args.cpu else None)
    dev = det.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    r = np.random.RandomState(0)
    imgs = torch.as_tensor(
        r.randint(0, 255, (args.batch, det.img_size, det.img_size, 3)).astype(np.float32),
        device=dev)
    scales = torch.ones((args.batch, 4), device=dev)
    for _ in range(args.warmup):
        det.infer_fn(det.model, imgs, scales)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        det.infer_fn(det.model, imgs, scales)
        sync()
    dt = time.perf_counter() - t0
    fps = args.iters * args.batch / dt
    print(f"Overall fps: {fps:.1f} img / s  ({dt / args.iters * 1e3:.1f} ms/iter, "
          f"batch {args.batch}, {det.img_size}px) on {device_line(dev)}")
    return fps


if __name__ == "__main__":
    main()
