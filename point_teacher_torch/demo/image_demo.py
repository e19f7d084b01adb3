"""Single-image inference demo of the port (counterpart of demo/image_demo.py).

  python -m point_teacher_torch.demo.image_demo IMG CONFIG [CHECKPOINT]
      [--score-thr 0.3] [--out DETS.npz] [--out-img ANNOTATED.jpg] [--cpu]

apis.init_detector (the teacher of a checkpoint written by
point_teacher_torch.tools.train, or the seeded random init without one)
and apis.inference_detector on one image; prints every detection at or
above --score-thr, and saves the per-class arrays (--out) and the image with
them drawn by utils/visualize.py (--out-img). Runs on the CUDA card unless
--cpu is given; asked for CUDA without a card it raises.
"""
from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Single-image inference (PyTorch port)")
    ap.add_argument("img")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--out", help="save detections as .npz")
    ap.add_argument("--out-img", help="save an annotated image (model.show_result analog)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns inference_detector's per-class arrays."""
    args = parse_args(argv)
    from ..apis import inference_detector, init_detector

    det = init_detector(args.config, args.checkpoint, device="cpu" if args.cpu else None)
    results = inference_detector(det, args.img)
    for cls_name, res in zip(det.CLASSES, results):
        keep = res[:, -1] >= args.score_thr
        for row in res[keep]:
            print(f"{cls_name}: box={np.round(row[:-1], 1).tolist()} score={row[-1]:.3f}")
    if args.out:
        np.savez(args.out, **{c: r for c, r in zip(det.CLASSES, results)})
        print(f"saved: {args.out}")
    if args.out_img:
        from ..data.pipeline import load_image
        from ..utils.visualize import imshow_det_bboxes, imshow_det_rbboxes

        boxes = np.concatenate([r[:, :-1] for r in results], 0)
        scores = np.concatenate([r[:, -1] for r in results], 0)
        labels = np.concatenate([np.full(len(r), i) for i, r in enumerate(results)], 0)
        drawer = imshow_det_rbboxes if det.rotated else imshow_det_bboxes
        drawer(load_image(args.img), boxes, labels, scores, class_names=det.CLASSES,
               score_thr=args.score_thr, out_file=args.out_img)
        print(f"saved annotated image: {args.out_img}")
    return results


if __name__ == "__main__":
    main()
