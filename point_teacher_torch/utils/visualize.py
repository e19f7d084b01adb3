"""Detection drawing with cv2 (counterpart of point_teacher_tpu/utils/visualize.py):
imshow_det_bboxes for xyxy boxes and imshow_det_rbboxes for rotated
(cx, cy, w, h, angle-rad) boxes, as mmdet's imshow_det_bboxes and mmrotate's
imshow_det_rbboxes draw them behind `tools/test.py --show-dir`. They write
annotated images instead of opening windows. Inputs are numpy arrays or
tensors on any device; the canvas is a uint8 numpy copy of the image.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# mmdet's default palette seed: deterministic per-class BGR colours
_rng = np.random.RandomState(42)
_PALETTE = _rng.randint(0, 256, (256, 3)).astype(np.int32)


def _np(x):
    if x is None or isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _color(label: int):
    c = _PALETTE[int(label) % len(_PALETTE)]
    return int(c[0]), int(c[1]), int(c[2])


def _prepare(img, boxes, width: int, labels, scores, score_thr: float):
    """The uint8 canvas and the boxes, labels and scores at or above
    score_thr (all of them without scores)."""
    canvas = np.ascontiguousarray(np.clip(_np(img), 0, 255).astype(np.uint8))
    boxes = np.asarray(_np(boxes)).reshape(-1, width)
    labels = np.asarray(_np(labels)).reshape(-1)
    if scores is not None:
        scores = np.asarray(_np(scores)).reshape(-1)
        keep = scores >= score_thr
        boxes, labels, scores = boxes[keep], labels[keep], scores[keep]
    return canvas, boxes, labels, scores


def _label(canvas, i, labels, scores, class_names, org, col, font_scale: float) -> None:
    import cv2

    name = (class_names[int(labels[i])] if class_names is not None
            else f"cls{int(labels[i])}")
    text = f"{name}|{scores[i]:.2f}" if scores is not None else name
    cv2.putText(canvas, text, org, cv2.FONT_HERSHEY_SIMPLEX, font_scale, col, 1, cv2.LINE_AA)


def _write(canvas, out_file: Optional[str]) -> None:
    import cv2

    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        cv2.imwrite(out_file, canvas)


def imshow_det_bboxes(
    img,
    bboxes,
    labels,
    scores=None,
    class_names: Optional[Sequence[str]] = None,
    score_thr: float = 0.0,
    thickness: int = 1,
    font_scale: float = 0.35,
    out_file: Optional[str] = None,
) -> np.ndarray:
    """Draw horizontal xyxy boxes with their labels (and scores) on a copy
    of the image.

    img: [H, W, 3] uint8 or float (BGR, as cv2 reads it); bboxes [N, 4];
    labels [N]; scores [N] or None. Returns the annotated uint8 image and
    writes it to out_file when given."""
    import cv2

    canvas, bboxes, labels, scores = _prepare(img, bboxes, 4, labels, scores, score_thr)
    for i, (x1, y1, x2, y2) in enumerate(bboxes):
        col = _color(labels[i])
        cv2.rectangle(canvas, (int(x1), int(y1)), (int(x2), int(y2)), col, thickness)
        _label(canvas, i, labels, scores, class_names, (int(x1), max(int(y1) - 2, 8)), col,
               font_scale)
    _write(canvas, out_file)
    return canvas


def imshow_det_rbboxes(
    img,
    rbboxes,
    labels,
    scores=None,
    class_names: Optional[Sequence[str]] = None,
    score_thr: float = 0.0,
    thickness: int = 1,
    font_scale: float = 0.35,
    out_file: Optional[str] = None,
) -> np.ndarray:
    """Draw rotated (cx, cy, w, h, angle-rad) boxes as polygons, as
    imshow_det_bboxes draws horizontal ones."""
    import cv2

    canvas, rbboxes, labels, scores = _prepare(img, rbboxes, 5, labels, scores, score_thr)
    for i, (cx, cy, w, h, ang) in enumerate(rbboxes):
        col = _color(labels[i])
        pts = cv2.boxPoints(((float(cx), float(cy)), (float(w), float(h)),
                             float(np.degrees(ang))))
        cv2.polylines(canvas, [pts.astype(np.int32)], True, col, thickness)
        _label(canvas, i, labels, scores, class_names,
               (int(cx - w / 2), max(int(cy - h / 2) - 2, 8)), col, font_scale)
    _write(canvas, out_file)
    return canvas
