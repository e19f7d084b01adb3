"""Offline splitting of huge images into patches with per-patch annotation
jsons (counterpart of tools/img_split.py).

  python -m point_teacher_torch.tools.img_split --img-dir I --ann-dir A
      --out-img-dir OI --out-ann-dir OA [--sizes 800] [--gaps 200]

For every per-image json of --ann-dir (its `annotations`: `poly`, 8
numbers, and `category_id`) and the image of the same stem (.jpg, .png or
.jpeg) in --img-dir, the sliding windows of data/patch.py compute_windows
give patches named name__SIZE__X___Y.jpg (patch_name; the size is the first
of --sizes); each patch gets the polygons whose centre lies inside it,
translated into it. Host only: no device is used.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
from PIL import Image

from ..data.patch import compute_windows, patch_name


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Split huge images into patches (PyTorch port)")
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--ann-dir", required=True, help="per-image jsons with 'annotations'")
    ap.add_argument("--out-img-dir", required=True)
    ap.add_argument("--out-ann-dir", required=True)
    ap.add_argument("--sizes", type=int, nargs="+", default=[800])
    ap.add_argument("--gaps", type=int, nargs="+", default=[200])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of patches written."""
    args = parse_args(argv)
    os.makedirs(args.out_img_dir, exist_ok=True)
    os.makedirs(args.out_ann_dir, exist_ok=True)

    n_patches = 0
    for ann_file in sorted(glob.glob(os.path.join(args.ann_dir, "*.json"))):
        stem = os.path.splitext(os.path.basename(ann_file))[0]
        img_path = None
        for ext in (".jpg", ".png", ".jpeg"):
            cand = os.path.join(args.img_dir, stem + ext)
            if os.path.exists(cand):
                img_path = cand
                break
        if img_path is None:
            print(f"skip {stem}: no image")
            continue
        with open(ann_file) as f:
            anns = json.load(f).get("annotations", [])
        img = np.asarray(Image.open(img_path).convert("RGB"))
        h, w = img.shape[:2]
        polys = [np.asarray(a["poly"], np.float32).reshape(-1, 2) for a in anns]
        centres = np.asarray([p.mean(0) for p in polys]) if polys else np.zeros((0, 2))

        for (x0, y0, x1, y1) in compute_windows(w, h, args.sizes, args.gaps):
            inside = [i for i in range(len(polys))
                      if x0 <= centres[i, 0] < x1 and y0 <= centres[i, 1] < y1]
            pn = patch_name(os.path.basename(img_path), args.sizes[0], x0, y0)
            Image.fromarray(img[y0:y1, x0:x1]).save(os.path.join(args.out_img_dir, pn))
            patch_anns = []
            for i in inside:
                p = polys[i] - [x0, y0]
                patch_anns.append(dict(poly=p.reshape(-1).tolist(),
                                       category_id=anns[i]["category_id"]))
            with open(os.path.join(args.out_ann_dir, pn.replace(".jpg", ".json")), "w") as f:
                json.dump(dict(annotations=patch_anns), f)
            n_patches += 1
    print(f"wrote {n_patches} patches")
    return n_patches


if __name__ == "__main__":
    main()
