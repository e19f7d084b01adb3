"""Evaluation runner of the port (counterpart of
point_teacher_tpu/evalx/runner.py, HBB): teacher inference over a val set,
then AI-TOD COCO-style metrics (AP at IoU 0.25, vt/t/s/m buckets, oLRP).

Three HBB branches: a COCO-format dataset on disk (the config's
`dataset.val_ann` / `val_img_prefix`), a fabricated val set
(`synthetic_n`), and multi-scale + flip test-time augmentation over either.
The rotated (SODA-A) eval and `show_dir` are not ported yet.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import native
from .cocoeval import COCOStyleEval


def build_infer(pt, rotated: bool = False):
    """The inference function of a config: infer(model, images,
    scale_factors, img_shapes=None)."""
    if rotated:
        raise NotImplementedError("the rotated (SODA-A) inference is not ported yet "
                                  "(ROADMAP.md queue 1 item 3)")
    from ..inference import build_inference_fn

    return build_inference_fn(pt.test, pt.img_size, pt.stride)


def synthetic_val_set(pt, n: int, rotated: bool, seed: int = 0):
    """Deterministic fabricated val set: the JAX runner's RandomState stream,
    so both packages see the same images and boxes. Returns (image batches
    [B, S, S, 3] numpy, gt in the layout COCOStyleEval reads)."""
    r = np.random.RandomState(seed)
    bs = pt.batch_size
    batches, gt_annotations = [], []
    for start in range(0, n, bs):
        img = r.randint(0, 255, (bs, pt.img_size, pt.img_size, 3)).astype(np.float32)
        g = r.randint(1, 8)
        for b in range(bs):
            cxy = r.uniform(20, pt.img_size - 20, (g, 2))
            wh = r.uniform(6, 20, (g, 2))
            if rotated:
                ang = r.uniform(-np.pi / 2, np.pi / 2, (g, 1))
                boxes = np.concatenate([cxy, wh, ang], -1).astype(np.float32)
            else:
                boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
            labels = r.randint(0, pt.num_classes, g)
            gt_annotations.append(dict(boxes=boxes, labels=labels))
        batches.append(img)
    gt = dict(img_ids=list(range(len(gt_annotations))),
              classes=[f"c{i}" for i in range(pt.num_classes)],
              annotations=gt_annotations)
    return batches, gt


def _kept(d, l, v, b):
    """Image b's valid detections as numpy (boxes [K, 4], scores [K], labels [K])."""
    keep = v[b]
    return d[b, keep, :4], d[b, keep, 4], l[b, keep]


def evaluate_detector(
    infer,
    model: torch.nn.Module,
    pt,
    cfg: Dict,
    rotated: bool = False,
    synthetic_n: int = 0,
    out: Optional[str] = None,
    show_dir: Optional[str] = None,
    quiet: bool = False,
    tta: Optional[Dict] = None,
) -> Tuple[float, Dict[str, float]]:
    """Run val-set inference of `model` (the teacher, or the student) on its
    device, then the metrics. Returns (headline mAP, stats dict).

    infer: build_infer's function. tta: dict(scales=(800, ...), flip=bool)
    switches to multi-scale + flip test-time augmentation, each image's
    views merged by one NMS (`infer` is not used then). out: write the
    detections to an npz, one [K, 6] array (box, score, label) an image."""
    if rotated:
        raise NotImplementedError("the rotated (SODA-A) eval is not ported yet "
                                  "(ROADMAP.md queue 1 item 3)")
    if show_dir:
        raise NotImplementedError("show_dir needs utils/visualize.py, which is not ported "
                                  "yet (ROADMAP.md queue 5)")
    dev = next(model.parameters()).device

    def tensor(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    header = "AI-TOD COCO-style metrics (IoU 0.25)"
    dets_per_img = []
    if tta is not None:
        from ..data.pipeline import make_tta_views
        from ..inference import build_tta_inference_fn

        scales = tuple(int(s) for s in tta["scales"])
        flip = bool(tta.get("flip", True))
        canvases = [s for s in scales for _ in range(2 if flip else 1)]
        tta_fn = build_tta_inference_fn(pt.test, canvases, pt.stride)
        norm = cfg.get("dataset", {}).get("img_norm")
        if synthetic_n:
            batches, gt = synthetic_val_set(pt, synthetic_n, rotated)
            imgs_iter = (img[b] for img in batches for b in range(img.shape[0]))
        else:
            from ..data import AITODDataset
            from ..data.pipeline import load_image

            ds = AITODDataset(cfg["dataset"]["val_ann"], cfg["dataset"]["val_img_prefix"],
                              filter_empty=False)
            gt = ds.coco_gt()
            imgs_iter = (load_image(ds.image_path(i)) for i in range(len(ds)))
        for img_np in imgs_iter:
            views = [{k: tensor(v) for k, v in view.items()} for view in
                     make_tta_views(np.asarray(img_np, np.float32), scales, flip, img_norm=norm)]
            d, l, v = (x.cpu().numpy() for x in tta_fn(model, views))
            dets_per_img.append(_kept(d, l, v, 0))
        header += f", TTA scales={list(scales)} flip={flip}"
    elif synthetic_n:
        batches, gt = synthetic_val_set(pt, synthetic_n, rotated)
        for img in batches:
            d, l, v = (x.cpu().numpy() for x in
                       infer(model, tensor(img), torch.ones((img.shape[0], 4), device=dev)))
            dets_per_img += [_kept(d, l, v, b) for b in range(img.shape[0])]
    else:
        from ..data import AITODDataset, EvalLoader

        ds = AITODDataset(cfg["dataset"]["val_ann"], cfg["dataset"]["val_img_prefix"],
                          filter_empty=False)
        loader = EvalLoader(ds, pt.batch_size, pt.img_size,
                            img_norm=cfg["dataset"].get("img_norm"))
        for idxs, imgs, scales, shapes in loader:
            d, l, v = (x.cpu().numpy() for x in
                       infer(model, tensor(imgs), tensor(scales), tensor(shapes)))
            dets_per_img += [_kept(d, l, v, b) for b in range(len(idxs))]
        gt = ds.coco_gt()

    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        np.savez(out, **{
            f"img{i}": np.concatenate([d, s[:, None], l[:, None].astype(np.float32)], -1)
            for i, (d, s, l) in enumerate(dets_per_img)
        })

    ev = COCOStyleEval(gt, dets_per_img)
    stats = ev.evaluate()
    if not quiet:
        matcher = "native ccore/libptteval.so" if native.available() else "numpy"
        print(f"\n--- {header} ---\n(greedy matching: {matcher})")
        for k, v in stats.items():
            print(f"{k:>24s}: {v:.4f}")
        print("\nper-class AP:")
        for cls, ap in ev.per_class_ap.items():
            print(f"{cls:>24s}: {ap:.4f}")
    return float(stats.get("mAP", 0.0)), stats
