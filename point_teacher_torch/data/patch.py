"""Huge-image tiling: split large images into overlapping patches and merge
detections back (the port's own copy of point_teacher_tpu/data/patch.py).

Capability targets:
- OBB_TOD/mmrotate/core/patch/split.py (get_multiscale_patch, slide windows)
- merge side lives in evalx.sodaa.merge_patch_detections
  (mmrotate/core/patch/merge_results.py + sodaa.py:260-318).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def compute_windows(
    width: int,
    height: int,
    sizes: Sequence[int] = (800,),
    gaps: Sequence[int] = (200,),
) -> List[Tuple[int, int, int, int]]:
    """Sliding windows (x0, y0, x1, y1) covering the image; last window of each
    row/column is clamped to the border (the standard DOTA/SODA tiling)."""
    wins = []
    for size, gap in zip(sizes, gaps):
        step = size - gap
        xs = list(range(0, max(width - size, 0) + 1, step))
        if not xs or xs[-1] + size < width:
            xs.append(max(width - size, 0))
        ys = list(range(0, max(height - size, 0) + 1, step))
        if not ys or ys[-1] + size < height:
            ys.append(max(height - size, 0))
        for y in ys:
            for x in xs:
                wins.append((x, y, min(x + size, width), min(y + size, height)))
    return wins


def split_image(
    img: np.ndarray,
    sizes: Sequence[int] = (800,),
    gaps: Sequence[int] = (200,),
):
    """-> list of (patch_array, (x0, y0)). Patches at the border keep their
    native (possibly smaller) size; callers pad to the model canvas."""
    h, w = img.shape[:2]
    out = []
    for (x0, y0, x1, y1) in compute_windows(w, h, sizes, gaps):
        out.append((img[y0:y1, x0:x1], (x0, y0)))
    return out


def patch_name(ori_name: str, size: int, x0: int, y0: int, ext: str = "jpg") -> str:
    """SODA-A patch naming: name__SIZE__X___Y.ext."""
    stem = ori_name.rsplit(".", 1)[0]
    return f"{stem}__{size}__{x0}___{y0}.{ext}"
