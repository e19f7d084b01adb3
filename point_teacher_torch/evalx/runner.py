"""Evaluation runner of the port (counterpart of
point_teacher_tpu/evalx/runner.py): teacher inference over a val set, then
the metrics.

HBB (AI-TOD COCO-style metrics: AP at IoU 0.25, vt/t/s/m buckets, oLRP):
a COCO-format dataset on disk (the config's `dataset.val_ann` /
`val_img_prefix`), a fabricated val set (`synthetic_n`), and multi-scale +
flip test-time augmentation over either. Rotated (SODA-A rotated COCO-style
metrics: AP over IoU .5:.95, the eS/rS/gS/Normal buckets, AR@20000): the
patch dataset (per-patch inference; each patch's detections translated
into its original image and merged there by a per-class rotated NMS;
scored against the original images' annotations, `dataset.ori_val_ann`)
and a fabricated val set. With `show_dir` every evaluated image (each
patch of the rotated patch set) is written there with its detections
drawn by utils/visualize.py.

In a world of ranks (parallel/dist.py; the counterpart of the JAX runner's
shard_infer) each rank infers its rows of each batch (TTA: one image of
each group of N), and the fixed-shape detections are gathered to every
rank in the global order; each rank draws the images it inferred; rank 0
runs the metrics and writes `out`, and every rank returns its headline and
stats.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel import dist
from . import native
from .cocoeval import COCOStyleEval

HBB_HEADER = "AI-TOD COCO-style metrics (IoU 0.25)"
ROTATED_HEADER = "SODA-A rotated metrics (AP over IoU .5:.95)"


def build_infer(pt, rotated: bool = False, trainer: str = "point_teacher"):
    """The inference function of a config: infer(model, images,
    scale_factors, img_shapes=None); rotated, infer(model, images,
    scale_factors). The `rfla_fcos` trainer's is the multi-level RFLA one."""
    from ..inference import (build_inference_fn, build_rfla_inference_fn,
                             build_rotated_inference_fn)

    if trainer == "rfla_fcos":
        return build_rfla_inference_fn(pt.test, pt.img_size)
    build = build_rotated_inference_fn if rotated else build_inference_fn
    return build(pt.test, pt.img_size, pt.stride)


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


def _infer_rows(infer, model, imgs, *extra, local: bool = False):
    """infer(model, imgs, *extra) over this rank's rows of a global batch
    (`local`: the arrays hold those rows already), the detections of every
    row gathered back in the global order, as numpy."""
    if not local:
        rows = dist.rank_rows(imgs.shape[0])
        imgs, extra = imgs[rows], [e[rows] for e in extra]
    return tuple(x.cpu().numpy() for x in dist.gather_rows(*infer(model, imgs, *extra)))


def _mine(b: int, batch_size: int) -> bool:
    """Whether row b of a global batch is this rank's."""
    rows = dist.rank_rows(batch_size)
    return rows.start <= b < rows.stop


def _kept(d, l, v, b, width: int = 4):
    """Image b's valid detections as numpy (boxes [K, width], scores [K],
    labels [K]); width 4 (x1, y1, x2, y2) or 5 (cx, cy, w, h, a)."""
    keep = v[b]
    return d[b, keep, :width], d[b, keep, width], l[b, keep]


def _drawer(show_dir: Optional[str], cfg: Dict, rotated: bool):
    """draw(img, (boxes, scores, labels), name, denorm=True), which writes
    `img` with the detections of score >= 0.3 drawn to show_dir/name (the
    JAX runner's drawing); None without show_dir. With denorm the image is
    de-normalised first by the config's dataset.img_norm, where it has one."""
    if not show_dir:
        return None
    from ..utils.visualize import imshow_det_bboxes, imshow_det_rbboxes

    norm = cfg.get("dataset", {}).get("img_norm")
    fn = imshow_det_rbboxes if rotated else imshow_det_bboxes

    def draw(img, dets, name: str, denorm: bool = True) -> None:
        boxes, scores, labels = dets
        if norm and denorm:
            img = img * np.asarray(norm["std"]) + np.asarray(norm["mean"])
        fn(img, boxes, labels, scores, score_thr=0.3, out_file=os.path.join(show_dir, name))

    return draw


def _patch_detections(infer, model, pt, cfg: Dict, tensor, draw=None):
    """The rotated dataset branch: per-patch inference over the config's
    SODA-A patch set, each patch's detections translated into its original
    image and merged there by a per-class rotated NMS. Returns (gt of the
    original images, detections per original image), on rank 0 only (None,
    None elsewhere). `draw` (_drawer's) draws each patch's own detections
    under the patch's file name."""
    from ..data import EvalLoader, SODAADataset
    from .sodaa import merge_patch_detections

    dcfg = cfg["dataset"]
    ds = SODAADataset(dcfg["val_ann"], dcfg["val_img_prefix"],
                      ori_ann_folder=dcfg.get("ori_val_ann"))
    loader = EvalLoader(ds, pt.batch_size, pt.img_size, img_norm=dcfg.get("img_norm"))
    names, patch_dets = [], []
    lo = loader.rows.start
    for idxs, imgs, scales, _shapes in loader:
        d, l, v = _infer_rows(infer, model, tensor(imgs), tensor(scales), local=True)
        for b, i in enumerate(idxs):
            names.append(ds.infos[i]["filename"])
            patch_dets.append(_kept(d, l, v, b, 5))
            if draw and _mine(b, pt.batch_size):
                draw(imgs[b - lo], patch_dets[-1], names[-1])
    if dist.rank() != 0:
        return None, None
    merged = merge_patch_detections(names, patch_dets, pt.num_classes)
    gt = ds.ori_gt()
    empty = (np.zeros((0, 5), np.float32), np.zeros(0), np.zeros(0))
    return gt, [merged.get(name.rsplit(".", 1)[0], empty) for name in gt["img_ids"]]


def _tta_detections(model, pt, cfg: Dict, synthetic_n: int, tta: Dict, tensor, draw=None):
    """The HBB multi-scale + flip branch: each image's views merged by one
    NMS. Returns (gt, detections per image, the header's note). `draw`
    (_drawer's) draws each image as read (raw pixels: the views are
    normalised inside make_tta_views) with its merged detections."""
    from ..data.pipeline import make_tta_views
    from ..inference import build_tta_inference_fn

    scales = tuple(int(s) for s in tta["scales"])
    flip = bool(tta.get("flip", True))
    canvases = [s for s in scales for _ in range(2 if flip else 1)]
    tta_fn = build_tta_inference_fn(pt.test, canvases, pt.stride)
    norm = cfg.get("dataset", {}).get("img_norm")
    if synthetic_n:
        batches, gt = synthetic_val_set(pt, synthetic_n, False)
        images = [img[b] for img in batches for b in range(img.shape[0])]
        load = images.__getitem__
        names = [f"img{i}.jpg" for i in range(len(images))]
    else:
        from ..data import AITODDataset
        from ..data.pipeline import load_image

        ds = AITODDataset(cfg["dataset"]["val_ann"], cfg["dataset"]["val_img_prefix"],
                          filter_empty=False)
        gt = ds.coco_gt()
        load = lambda i: load_image(ds.image_path(i))  # noqa: E731
        names = [_file_name(ds, i) for i in range(len(ds))]
    n_img, n_world = len(names), dist.world()
    dets_per_img = []
    # a world of N takes the images N at a time, one a rank; past the last
    # image a rank repeats its group's first, whose detections are dropped
    for start in range(0, n_img, n_world):
        n = start + dist.rank()
        img_np = np.asarray(load(n if n < n_img else start), np.float32)
        views = [{k: tensor(v) for k, v in view.items()} for view in
                 make_tta_views(img_np, scales, flip, img_norm=norm)]
        d, l, v = (x.cpu().numpy() for x in dist.gather_rows(*tta_fn(model, views)))
        dets_per_img += [_kept(d, l, v, j) for j in range(min(n_world, n_img - start))]
        if draw and n < n_img:
            draw(img_np, dets_per_img[n], names[n], denorm=False)
    return gt, dets_per_img, f", TTA scales={list(scales)} flip={flip}"


def _file_name(ds, i: int) -> str:
    """The drawn file's name of image i of an AITODDataset."""
    return os.path.basename(ds.img_infos[i].get("file_name", f"img{i}.jpg"))


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
    device, then the metrics. Returns (headline AP, stats dict): HBB
    stats["mAP"] (AP at IoU 0.25); rotated stats["AP"] (AP over IoU
    .5:.95), where the JAX runner returns stats.get("mAP", 0.0), a key that
    sodaa_evaluate never writes, so that its rotated headline is always 0.0.

    infer: build_infer's function. tta: dict(scales=(800, ...), flip=bool)
    switches the HBB path to multi-scale + flip test-time augmentation
    (`infer` is not used then); rotated, it raises, as the JAX test CLI
    does (the reference's rotated configs run single-scale). out: write the
    detections to an npz, one [K, 6] array (box, score, label) an image,
    [K, 7] rotated (for the patch set: an original image's merged
    detections). show_dir: write each evaluated image with its detections
    of score >= 0.3 drawn (utils/visualize.py), under the JAX runner's
    names: a fabricated set's img{i}.jpg, an on-disk image's file name, a
    rotated patch's file name (its own detections, before the merge);
    normalised images are de-normalised by the config's dataset.img_norm,
    and TTA draws each image as read with its merged detections (the
    --show-dir of the reference's tools/test.py)."""
    if rotated and tta is not None:
        raise ValueError("TTA covers the HBB path only (the reference's rotated configs run "
                         "single-scale without flip)")
    dev = next(model.parameters()).device

    def tensor(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    header = ROTATED_HEADER if rotated else HBB_HEADER
    draw = _drawer(show_dir, cfg, rotated)
    if tta is not None:
        gt, dets_per_img, note = _tta_detections(model, pt, cfg, synthetic_n, tta, tensor,
                                                 draw)
        header += note
    elif synthetic_n:
        batches, gt = synthetic_val_set(pt, synthetic_n, rotated)
        dets_per_img = []
        for img in batches:
            d, l, v = _infer_rows(infer, model, tensor(img),
                                  torch.ones((img.shape[0], 4), device=dev))
            for b in range(img.shape[0]):
                dets_per_img.append(_kept(d, l, v, b, 5 if rotated else 4))
                if draw and _mine(b, img.shape[0]):
                    draw(img[b], dets_per_img[-1], f"img{len(dets_per_img) - 1}.jpg")
    elif rotated:
        gt, dets_per_img = _patch_detections(infer, model, pt, cfg, tensor, draw)
        header += ", patches merged per original image"
    else:
        from ..data import AITODDataset, EvalLoader

        ds = AITODDataset(cfg["dataset"]["val_ann"], cfg["dataset"]["val_img_prefix"],
                          filter_empty=False)
        loader = EvalLoader(ds, pt.batch_size, pt.img_size,
                            img_norm=cfg["dataset"].get("img_norm"))
        dets_per_img = []
        lo = loader.rows.start
        for idxs, imgs, scales, shapes in loader:
            d, l, v = _infer_rows(infer, model, tensor(imgs), tensor(scales), tensor(shapes),
                                  local=True)
            for b, i in enumerate(idxs):
                dets_per_img.append(_kept(d, l, v, b))
                if draw and _mine(b, pt.batch_size):
                    draw(imgs[b - lo], dets_per_img[-1], _file_name(ds, i))
        gt = ds.coco_gt()

    if dist.rank() != 0:
        return dist.broadcast_object(None)
    return dist.broadcast_object(_metrics(gt, dets_per_img, rotated, header, out, quiet))


def _metrics(gt, dets_per_img, rotated: bool, header: str, out: Optional[str],
             quiet: bool) -> Tuple[float, Dict[str, float]]:
    """evaluate_detector's end on rank 0: `out`, the metrics and their table."""
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        np.savez(out, **{
            f"img{i}": np.concatenate([d, s[:, None], l[:, None].astype(np.float32)], -1)
            for i, (d, s, l) in enumerate(dets_per_img)
        })

    if rotated:
        from .sodaa import sodaa_evaluate

        stats = sodaa_evaluate(gt, dets_per_img)
        headline, per_class = stats["AP"], stats["per_class"]
        engine = "rotated IoU and merge NMS"
    else:
        ev = COCOStyleEval(gt, dets_per_img)
        stats = ev.evaluate()
        headline, per_class = stats.get("mAP", 0.0), ev.per_class_ap
        engine = "greedy matching"
    if not quiet:
        lib = "native ccore/libptteval.so" if native.available() else "numpy"
        print(f"\n--- {header} ---\n({engine}: {lib})")
        for k, v in stats.items():
            if k != "per_class":
                print(f"{k:>24s}: {v:.4f}")
        print("\nper-class AP:")
        for cls, ap in per_class.items():
            print(f"{cls:>24s}: {ap:.4f}")
    return float(headline), stats
