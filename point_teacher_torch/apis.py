"""High-level inference API (counterpart of point_teacher_tpu/apis.py):
init_detector(config, checkpoint) and inference_detector(detector, img),
which returns per-class numpy arrays like the reference's bbox2result (HBB)
and rbbox2result (rotated, SODA-A).
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch


class Detector:
    """The module to run (the teacher's weights, or the student's), its
    inference function, class names, canvas size, test settings and
    whether it is the rotated detector."""

    def __init__(self, model: torch.nn.Module, infer_fn, classes, img_size: int, test_cfg,
                 rotated: bool = False):
        self.model = model
        self.infer_fn = infer_fn
        self.CLASSES = classes
        self.img_size = img_size
        self.test_cfg = test_cfg
        self.rotated = rotated
        self.device = next(model.parameters()).device
        self._tta_key = None
        self._tta_fn = None


def init_detector(config_path: str, checkpoint: Optional[str] = None,
                  use_teacher: bool = True, device=None) -> Detector:
    """The detector of a config, with the teacher (or, use_teacher=False, the
    student) weights of a checkpoint written by tools.train --work-dir, or
    the seeded random init without one. Runs on the card unless `device`
    says otherwise (raises without CUDA)."""
    from .config_io import load_config
    from .data import AITODDataset, SODAADataset
    from .evalx.runner import build_infer
    from .tools.train import build_model, resolve_device
    from .utils.checkpoint import load_weights

    cfg = load_config(config_path)
    pt, rotated = cfg["pt"], bool(cfg.get("rotated"))
    dev = resolve_device(False) if device is None else torch.device(device)
    model = build_model(cfg, 0, dev)
    if checkpoint:
        load_weights(model, checkpoint, "teacher" if use_teacher else "student")
    classes = SODAADataset.CLASSES if rotated else AITODDataset.CLASSES
    infer = build_infer(pt, rotated, cfg.get("trainer", "point_teacher"))
    return Detector(model, infer, classes, pt.img_size, pt.test, rotated)


def _per_class(detector: Detector, dets, labels, valid) -> List[np.ndarray]:
    dets, labels, valid = (x[0].cpu().numpy() for x in (dets, labels, valid))
    dets, labels = dets[valid], labels[valid]
    return [dets[labels == c].reshape(-1, dets.shape[-1]) for c in range(len(detector.CLASSES))]


def inference_detector(detector: Detector, img: Union[str, np.ndarray]) -> List[np.ndarray]:
    """One image (a path or an [H, W, 3] array of 0-255 pixels), resized
    keep-ratio to the canvas: per-class [K, 5] arrays (x1, y1, x2, y2,
    score), rotated [K, 6] (cx, cy, w, h, a, score), in the image's own
    pixels. Like the JAX package's, it does not normalise the pixels."""
    from .data.pipeline import load_image, pad_to_canvas, resize_keep_ratio

    if isinstance(img, str):
        img = load_image(img)
    img, scale = resize_keep_ratio(np.asarray(img, np.float32),
                                   (detector.img_size, detector.img_size))
    shape = np.asarray(img.shape[:2], np.float32)
    img = pad_to_canvas(img, detector.img_size)
    dev = detector.device
    args = [torch.as_tensor(img[None], device=dev), torch.as_tensor(scale[None], device=dev)]
    if not detector.rotated:   # the rotated decode clamps to no image shape
        args.append(torch.as_tensor(shape[None], device=dev))
    return _per_class(detector, *detector.infer_fn(detector.model, *args))


def inference_detector_tta(detector: Detector, img: Union[str, np.ndarray], scales=None,
                           flip: bool = True) -> List[np.ndarray]:
    """Multi-scale + flip test-time augmentation of one image: each scale
    resized keep-ratio, with a horizontally flipped copy when `flip`, every
    view's top-k mapped back and merged by one NMS. `scales`: square canvas
    sizes, the detector's own by default. Returns inference_detector's
    per-class arrays. HBB only, as in the JAX package (the reference's
    rotated configs run single-scale without flip)."""
    from .data.pipeline import load_image, make_tta_views
    from .inference import build_tta_inference_fn

    if detector.rotated:
        raise NotImplementedError("TTA covers the HBB path (the reference's rotated configs "
                                  "run single-scale, flip=False)")
    if isinstance(img, str):
        img = load_image(img)
    img = np.asarray(img, np.float32)
    scales = tuple(int(s) for s in (scales or (detector.img_size,)))
    dev = detector.device
    views = [{k: torch.as_tensor(v, device=dev) for k, v in view.items()}
             for view in make_tta_views(img, scales, flip)]
    if detector._tta_key != (scales, flip):
        detector._tta_fn = build_tta_inference_fn(
            detector.test_cfg, [v["image"].shape[1] for v in views])
        detector._tta_key = (scales, flip)
    return _per_class(detector, *detector._tta_fn(detector.model, views))
