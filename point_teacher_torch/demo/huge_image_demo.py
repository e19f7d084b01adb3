"""Huge-image inference demo of the port (counterpart of demo/huge_image_demo.py):
tile the image, run inference on each patch, merge the patches' detections
by the per-class rotated NMS of the SODA-A eval.

  python -m point_teacher_torch.demo.huge_image_demo IMG CONFIG [CHECKPOINT]
      [--patch-size 800] [--gap 200] [--score-thr 0.3] [--cpu]

data/patch.py split_image gives the overlapping patches (named by
patch_name as the SODA-A split names them), apis.inference_detector runs
each one, and evalx/sodaa.py merge_patch_detections translates every
patch's detections into the image and merges them. Prints the merged
detections at or above --score-thr. Runs on the CUDA card unless --cpu is
given; asked for CUDA without a card it raises.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Huge-image inference by patches (PyTorch port)")
    ap.add_argument("img")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?")
    ap.add_argument("--patch-size", type=int, default=800)
    ap.add_argument("--gap", type=int, default=200)
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the merged (boxes, scores, labels) of the image."""
    args = parse_args(argv)
    from ..apis import inference_detector, init_detector
    from ..data.patch import patch_name, split_image
    from ..data.pipeline import load_image
    from ..evalx.sodaa import merge_patch_detections

    det = init_detector(args.config, args.checkpoint, device="cpu" if args.cpu else None)
    img = load_image(args.img)
    names, dets_list = [], []
    for patch, (x0, y0) in split_image(img, (args.patch_size,), (args.gap,)):
        per_class = inference_detector(det, patch)
        boxes = np.concatenate([r[:, :-1] for r in per_class])
        scores = np.concatenate([r[:, -1] for r in per_class])
        labels = np.concatenate([np.full(len(r), c) for c, r in enumerate(per_class)])
        names.append(patch_name(os.path.basename(args.img), args.patch_size, x0, y0))
        dets_list.append((boxes, scores, labels))
    merged = merge_patch_detections(names, dets_list, len(det.CLASSES))
    rb, sc, lb = next(iter(merged.values()))
    keep = sc >= args.score_thr
    print(f"{int(keep.sum())} detections above {args.score_thr}:")
    for b, s, l in zip(rb[keep], sc[keep], lb[keep]):
        print(f"  {det.CLASSES[int(l)]}: {np.round(b, 1).tolist()} score={s:.3f}")
    return rb, sc, lb


if __name__ == "__main__":
    main()
