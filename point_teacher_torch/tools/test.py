"""Evaluation entry point of the port (counterpart of tools/test.py).

  python -m point_teacher_torch.tools.test <config.py> [checkpoint]
      [--synthetic-data N] [--student] [--out F.npz] [--tta-scales S1,S2]
      [--tta-no-flip] [--cpu] [--cfg-options dataset.val_ann=... ...]

Runs the TEACHER of a checkpoint written by `point_teacher_torch.tools.train
--work-dir` (the student with --student; the seeded random init without a
checkpoint) over the config's val set, or over N fabricated images with
--synthetic-data N, and prints the metrics table of the config's fork:
- HBB (AI-TOD configs): the COCO-format val set; AI-TOD COCO-style metrics
  (AP at IoU 0.25, vt/t/s/m buckets, oLRP); --tta-scales runs multi-scale +
  flip test-time augmentation;
- rotated (sodaa_point_teacher_1x): the SODA-A patch set, each patch's
  detections merged into its original image by a rotated NMS; SODA-A
  rotated metrics (AP over IoU .5:.95, eS/rS/gS/Normal buckets, AR@20000);
  no TTA, as in the reference.
The last line names the fork's headline: AP@0.25, or AP .5:.95. Runs on the
CUDA card unless --cpu is given; asked for CUDA without a card it raises.
Loading a reference PyTorch checkpoint (--torch-ckpt of tools/test.py) is
not ported.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..config_io import apply_overrides, load_config
from ..evalx.runner import build_infer, evaluate_detector
from ..utils.checkpoint import load_weights
from .train import build_model, resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate a Point-Teacher detector (PyTorch port)")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?")
    ap.add_argument("--cfg-options", nargs="*", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--synthetic-data", type=int, default=0, metavar="N_IMAGES",
                    help="evaluate on N fabricated images instead of the config's val set")
    ap.add_argument("--student", action="store_true",
                    help="evaluate the student instead of the teacher")
    ap.add_argument("--out", help="write the detections (npz)")
    ap.add_argument("--tta-scales", default=None, metavar="S1,S2",
                    help="comma-separated square canvas sizes for multi-scale TTA")
    ap.add_argument("--tta-no-flip", action="store_true",
                    help="no horizontal-flip views in TTA")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    pt, rotated = cfg["pt"], bool(cfg.get("rotated"))
    if rotated and args.tta_scales:
        raise SystemExit("--tta-scales covers the HBB path only")
    device = resolve_device(args.cpu)
    infer = build_infer(pt, rotated)
    model = build_model(cfg, 0, device)
    if args.checkpoint:
        branch = "student" if args.student else "teacher"
        load_weights(model, args.checkpoint, branch)
        print(f"loaded the {branch} of {args.checkpoint}")
    else:
        print("WARNING: no checkpoint given, evaluating the random init")
    tta = None
    if args.tta_scales:
        tta = dict(scales=[int(s) for s in args.tta_scales.split(",")],
                   flip=not args.tta_no_flip)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    ap, _ = evaluate_detector(infer, model, pt, cfg, rotated=rotated,
                              synthetic_n=args.synthetic_data, out=args.out, tta=tta)
    headline = "AP .5:.95" if rotated else "mAP@0.25"
    print(f"\n{headline} {ap:.4f}; eval {time.perf_counter() - t0:.2f} s on {name}")
    return ap


if __name__ == "__main__":
    main()
