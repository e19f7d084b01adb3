"""Evaluation entry point of the port (counterpart of tools/test.py).

  python -m point_teacher_torch.tools.test <config.py> [checkpoint]
      [--torch-ckpt REF.pth] [--synthetic-data N] [--student] [--out F.npz]
      [--tta-scales S1,S2] [--tta-no-flip] [--show-dir DIR] [--cpu]
      [--cfg-options dataset.val_ann=... ...]

Runs the TEACHER of a checkpoint written by `point_teacher_torch.tools.train`
(the student with --student; the seeded random init without a checkpoint),
or one branch of a reference PyTorch teacher-student checkpoint with
--torch-ckpt (utils/torch_port.py; not for the rfla_fcos trainer, as in the
JAX CLI), over the config's val set, or over N fabricated images with
--synthetic-data N, and prints the metrics table of the config's fork:
- HBB (AI-TOD configs, the point_teacher, fcos and rfla_fcos trainers):
  the COCO-format val set; AI-TOD COCO-style metrics (AP at IoU 0.25,
  vt/t/s/m buckets, oLRP); --tta-scales runs multi-scale + flip test-time
  augmentation (single-level detectors only);
- rotated (sodaa_point_teacher_1x): the SODA-A patch set, each patch's
  detections merged into its original image by a rotated NMS; SODA-A
  rotated metrics (AP over IoU .5:.95, eS/rS/gS/Normal buckets, AR@20000);
  no TTA, as in the reference.
--show-dir DIR writes each evaluated image (each patch of the SODA-A patch
set) with its detections of score >= 0.3 drawn (utils/visualize.py).
The last line names the fork's headline: AP@0.25, or AP .5:.95. Runs on the
CUDA card unless --cpu is given; asked for CUDA without a card it raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..config_io import apply_overrides, load_config
from ..evalx.runner import build_infer, evaluate_detector
from ..utils.checkpoint import load_weights
from ..utils.torch_port import load_reference_ts_checkpoint
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
    ap.add_argument("--torch-ckpt", default=None,
                    help="load a reference PyTorch teacher-student checkpoint (.pth) "
                         "instead of a checkpoint of this port (the teacher branch, or the "
                         "student with --student)")
    ap.add_argument("--out", help="write the detections (npz)")
    ap.add_argument("--show-dir", help="write annotated detection images to DIR")
    ap.add_argument("--tta-scales", default=None, metavar="S1,S2",
                    help="comma-separated square canvas sizes for multi-scale TTA")
    ap.add_argument("--tta-no-flip", action="store_true",
                    help="no horizontal-flip views in TTA")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    pt, rotated = cfg["pt"], bool(cfg.get("rotated"))
    trainer = cfg.get("trainer", "point_teacher")
    if args.torch_ckpt and trainer == "rfla_fcos":
        raise SystemExit("--torch-ckpt supports the point_teacher trainer only (the loader "
                         "fills StudentFCOS / StudentRotatedFCOS, not RFLAFCOS)")
    if args.tta_scales and (rotated or trainer == "rfla_fcos"):
        raise SystemExit("--tta-scales covers the HBB path only (single-level detectors)")
    device = resolve_device(args.cpu)
    infer = build_infer(pt, rotated, trainer)
    model = build_model(cfg, 0, device)
    branch = "student" if args.student else "teacher"
    if args.torch_ckpt:
        load_reference_ts_checkpoint(model, args.torch_ckpt, branch, rotated=rotated,
                                     num_stages=pt.num_stages)
        print(f"loaded reference torch checkpoint {args.torch_ckpt} ({branch} branch)")
    elif args.checkpoint:
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
                              synthetic_n=args.synthetic_data, out=args.out,
                              show_dir=args.show_dir, tta=tta)
    headline = "AP .5:.95" if rotated else "mAP@0.25"
    print(f"\n{headline} {ap:.4f}; eval {time.perf_counter() - t0:.2f} s on {name}")
    return ap


if __name__ == "__main__":
    main()
