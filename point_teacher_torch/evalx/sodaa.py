"""SODA-A evaluation: rotated COCO-style AP + the patch->image merge stage
(the port's own copy of point_teacher_tpu/evalx/sodaa.py, on the port's
cocoeval.py and native.py).

Capability targets:
- SODAAeval (OBB_TOD/mmrotate/datasets/sodaa_eval/sodaa_eval.py, 693 LoC):
  COCO-style evaluation with rotated IoU, iouThrs [.5:.05:.95],
  areaRng Small/eS/rS/gS/Normal ([0,32^2],[0,12^2],[12^2,20^2],[20^2,32^2],
  [32^2,2000]), maxDets [20000].
- merge_det + _merge_func (sodaa.py:260-318,507-528): translate per-patch
  detections by the patch offsets parsed from `name__SIZE__X___Y` filenames,
  then per-class rotated NMS (IoU 0.5) across the patches of each original
  image.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np

from .cocoeval import COCOStyleEval
from .native import nms_rotated as nms_rotated_np  # native with numpy fallback
from .native import rbox_iou as rbox_iou_np

SODAA_AREA_RNGS = (
    ("Small", 0.0, 32.0 ** 2),
    ("eS", 0.0, 12.0 ** 2),
    ("rS", 12.0 ** 2, 20.0 ** 2),
    ("gS", 20.0 ** 2, 32.0 ** 2),
    ("Normal", 32.0 ** 2, 40.0 * 50.0),
)


def _rarea(b: np.ndarray) -> np.ndarray:
    return b[:, 2] * b[:, 3] if len(b) else np.zeros(0)


def parse_patch_name(filename: str) -> Tuple[str, int, int]:
    """'00001__800__3900___0.jpg' -> ('00001', 3900, 0)."""
    stem = filename.rsplit(".", 1)[0]
    x_start = int(stem.split("___")[0].split("__")[-1])
    y_start = int(stem.split("___")[-1])
    ori = stem.split("__")[0]
    return ori, x_start, y_start


def merge_patch_detections(
    patch_names: Sequence[str],
    dets_per_patch: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    num_classes: int,
    nms_iou_thr: float = 0.5,
) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """dets_per_patch: (rboxes [K,5], scores [K], labels [K]) per patch.

    Returns {original_image_name: (rboxes, scores, labels)} after translation
    and per-class rotated NMS across patches.
    """
    collector = defaultdict(list)
    for name, (rb, sc, lb) in zip(patch_names, dets_per_patch):
        ori, x0, y0 = parse_patch_name(name)
        rb = np.array(rb, np.float32)
        if len(rb):
            rb[:, 0] += x0
            rb[:, 1] += y0
        collector[ori].append((rb, np.asarray(sc, np.float32), np.asarray(lb)))

    merged = {}
    for ori, parts in collector.items():
        rb = np.concatenate([p[0] for p in parts]) if parts else np.zeros((0, 5))
        sc = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0)
        lb = np.concatenate([p[2] for p in parts]) if parts else np.zeros(0, np.int64)
        keep_rb, keep_sc, keep_lb = [], [], []
        for c in range(num_classes):
            m = lb == c
            if not m.any():
                continue
            keep = nms_rotated_np(rb[m], sc[m], nms_iou_thr)
            keep_rb.append(rb[m][keep])
            keep_sc.append(sc[m][keep])
            keep_lb.append(np.full(len(keep), c, np.int64))
        merged[ori] = (
            np.concatenate(keep_rb) if keep_rb else np.zeros((0, 5), np.float32),
            np.concatenate(keep_sc) if keep_sc else np.zeros(0, np.float32),
            np.concatenate(keep_lb) if keep_lb else np.zeros(0, np.int64),
        )
    return merged


def sodaa_evaluate(
    gt: dict,
    dets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    iou_thrs=None,
) -> Dict[str, float]:
    """gt annotations carry rotated boxes [G, 5]. Returns the SODAAeval stats
    table (AP over [.5:.95], AP_50, AP_75, size-bucket APs, AR@20000)."""
    if iou_thrs is None:
        iou_thrs = np.linspace(0.5, 0.95, 10).tolist()
    ev = COCOStyleEval(
        gt, dets, iou_thrs=iou_thrs, max_dets=(20000,), area_rngs=SODAA_AREA_RNGS,
        iou_fn=rbox_iou_np, area_fn=_rarea,
    )
    ev.evaluate()
    p = ev.precision  # [T, R, C, A]

    def ap(ti=None, ai=0):
        sl = p[:, :, :, ai] if ti is None else p[ti:ti + 1, :, :, ai]
        v = sl[sl > -1]
        return float(v.mean()) if v.size else -1.0

    def ar(ai=0):
        r = ev.recall[:, :, ai, -1]
        v = r[r > -1]
        return float(v.mean()) if v.size else -1.0

    names = [a for a, _, _ in SODAA_AREA_RNGS]
    stats = {
        "AP": ap(),
        "AP_50": ap(ti=0),
        "AP_75": ap(ti=5),
        "AP_eS": ap(ai=names.index("eS")),
        "AP_rS": ap(ai=names.index("rS")),
        "AP_gS": ap(ai=names.index("gS")),
        "AP_Normal": ap(ai=names.index("Normal")),
        "AR@20000": ar(0),
        "AR_eS@20000": ar(names.index("eS")),
        "AR_rS@20000": ar(names.index("rS")),
        "AR_gS@20000": ar(names.index("gS")),
        "AR_Normal@20000": ar(names.index("Normal")),
    }
    stats["per_class"] = ev.per_class_ap if hasattr(ev, "per_class_ap") else {}
    return stats
