"""Host-side preprocessing to fixed-shape arrays (the port's own copy of
point_teacher_tpu/data/pipeline.py; numpy, with PIL imported only where an
image is decoded or resized, so a machine without PIL runs every 800x800
AI-TOD image, which is never resized).

Capability target: the train/test pipelines of
aitodv2_point_teacher_0%.py:180-204 — LoadImageFromFile, Resize(keep_ratio,
(800, 800)), RandomFlip(ratio 0 — a no-op kept for config parity),
Normalize(identity: raw 0-255 pixels reach the model), Pad(size_divisor 32).
Strong augmentation and masking happen inside the train step, not here
(SURVEY.md §2.2 "data pipeline" note).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32)


def resize_keep_ratio(img: np.ndarray, target: Tuple[int, int]):
    """mmdet Resize(keep_ratio=True): scale = min over dims, bilinear."""
    h, w = img.shape[:2]
    th, tw = target
    scale = min(th / h, tw / w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    if (nh, nw) != (h, w):
        from PIL import Image

        img = np.asarray(
            Image.fromarray(img.astype(np.uint8)).resize((nw, nh), Image.BILINEAR),
            dtype=np.float32,
        )
    w_scale = nw / w
    h_scale = nh / h
    return img, np.asarray([w_scale, h_scale, w_scale, h_scale], np.float32)


def pad_to_canvas(img: np.ndarray, canvas: int) -> np.ndarray:
    out = np.zeros((canvas, canvas, img.shape[2]), np.float32)
    out[: img.shape[0], : img.shape[1]] = img
    return out


def preprocess(
    path: str,
    boxes: np.ndarray,
    canvas: int = 800,
    img_norm=None,
    return_shape: bool = False,
):
    """-> (image [canvas,canvas,3], boxes scaled, scale_factor [4]
    [, img_shape [2] (nh, nw) — the resized pre-padding extent, the
    reference's img_meta['img_shape'] used as the decode clamp]).

    img_norm: optional dict(mean, std) — identity (raw 0-255) for the AI-TOD
    configs, ImageNet stats for SODA-A (config img_norm_cfg). Images are
    loaded RGB, matching the reference's to_rgb=True convention.
    """
    img = load_image(path)
    img, scale = resize_keep_ratio(img, (canvas, canvas))
    shape = np.asarray(img.shape[:2], np.float32)
    if img_norm is not None:
        mean = np.asarray(img_norm["mean"], np.float32)
        std = np.asarray(img_norm["std"], np.float32)
        img = (img - mean) / std
    img = pad_to_canvas(img, canvas)
    if boxes is not None and len(boxes):
        if boxes.shape[-1] == 5:  # rotated: scale centre + size, keep angle
            boxes = boxes.copy()
            boxes[:, :2] *= scale[:2]
            boxes[:, 2:4] *= scale[:2]
        else:
            boxes = boxes * scale[None]
    if return_shape:
        return img, boxes, scale, shape
    return img, boxes, scale


def make_tta_views(img: np.ndarray, scales, flip: bool, img_norm=None):
    """MultiScaleFlipAug analog: one entry per (scale, flip) view with the
    arrays build_tta_inference_fn expects (numpy, single image).

    Capability target: mmdet/datasets/pipelines/test_time_aug.py — Resize to
    each scale, optional horizontal flip BEFORE padding, Normalize, Pad.
    """
    views = []
    for s in scales:
        s = int(s)
        resized, scale = resize_keep_ratio(img, (s, s))
        nh, nw = resized.shape[:2]
        if img_norm is not None:
            mean = np.asarray(img_norm["mean"], np.float32)
            std = np.asarray(img_norm["std"], np.float32)
            resized = (resized - mean) / std
        for flipped in ((False, True) if flip else (False,)):
            v = resized[:, ::-1] if flipped else resized
            views.append({
                "image": pad_to_canvas(np.ascontiguousarray(v), s)[None],
                "img_shape": np.asarray([[nh, nw]], np.float32),
                "scale_factor": scale[None],
                "flipped": np.asarray([flipped]),
            })
    return views


def pad_gts(boxes: np.ndarray, labels: np.ndarray, max_gt: int):
    dim = boxes.shape[-1] if len(boxes) else 4
    g = min(len(boxes), max_gt)
    out_b = np.zeros((max_gt, dim), np.float32)
    out_l = np.zeros((max_gt,), np.int32)
    out_v = np.zeros((max_gt,), bool)
    out_b[:g] = boxes[:g]
    out_l[:g] = labels[:g]
    out_v[:g] = True
    return out_b, out_l, out_v
