"""COCO-style detection evaluation with AI-TOD semantics (the port's own copy
of point_teacher_tpu/evalx/cocoeval.py, pure numpy).

Re-implements what the reference gets from the external `aitodpycocotools`
COCOeval (imported at HBB_TOD/mmdet/datasets/aitod.py:10):
- AP at the dataset's hard-coded IoU threshold(s) (aitod.py:64 -> [0.25]);
- AI-TOD size buckets: very-tiny [2^2, 8^2], tiny [8^2, 16^2],
  small [16^2, 32^2], medium [32^2, 1e5^2];
- maxDets (100, 300, 1500);
- oLRP (optimal Localisation-Recall-Precision, Oksuz et al.) with its
  localisation / false-positive / false-negative components.

The matching algorithm follows the canonical COCOeval greedy procedure:
per (image, category), detections in descending score order claim the
still-unmatched GT with the highest IoU >= threshold; GTs outside the area
range are "ignore" (matching them neither scores nor penalises); unmatched
detections outside the area range are ignored too.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

AITOD_AREA_RNGS = (
    ("all", 0.0 ** 2, 1e5 ** 2),
    ("vt", 2.0 ** 2, 8.0 ** 2),
    ("t", 8.0 ** 2, 16.0 ** 2),
    ("s", 16.0 ** 2, 32.0 ** 2),
    ("m", 32.0 ** 2, 1e5 ** 2),
)
RECALL_THRS = np.linspace(0.0, 1.0, 101)


def _iou_xyxy(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    """[M,4] x [N,4] -> [M,N]."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)), np.float64)
    lt = np.maximum(d[:, None, :2], g[None, :, :2])
    rb = np.minimum(d[:, None, 2:], g[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ad = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    ag = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    union = ad[:, None] + ag[None] - inter
    return inter / np.maximum(union, 1e-12)


def _match_img(
    dets: np.ndarray,       # [M, 5] (x1,y1,x2,y2,score) score-desc sorted
    gts: np.ndarray,        # [N, 4]
    gt_ignore: np.ndarray,  # [N] bool
    iou_thr: float,
    iou=None,
):
    """Greedy COCO matching. Returns (dt_match_iou [M] (-1 unmatched),
    dt_ignore [M], n_gt_regular)."""
    m, n = len(dets), len(gts)
    if iou is None:
        iou = _iou_xyxy(dets[:, :4], gts)
    if m and n:
        from . import native
        res = native.match_greedy(np.asarray(iou, np.float64), gt_ignore, iou_thr)
        if res is not None:
            dt_iou, dt_ig = res
            return dt_iou, dt_ig, int((~gt_ignore).sum())
    gt_taken = np.zeros(n, bool)
    dt_iou = np.full(m, -1.0)
    dt_ig = np.zeros(m, bool)
    # order gts: regular first (canonical COCO sorts by ignore flag)
    order = np.argsort(gt_ignore, kind="stable")
    for di in range(m):
        best, best_iou = -1, iou_thr
        matched_ignore = False
        for gi in order:
            if gt_taken[gi]:
                continue
            # prefer regular gts: once matched to a regular gt, don't switch
            # to an ignored one unless no regular match exists
            if best > -1 and not matched_ignore and gt_ignore[gi]:
                break
            if iou[di, gi] >= best_iou:
                best, best_iou = gi, iou[di, gi]
                matched_ignore = bool(gt_ignore[gi])
        if best > -1:
            gt_taken[best] = True
            dt_iou[di] = best_iou
            dt_ig[di] = bool(gt_ignore[best])
    return dt_iou, dt_ig, int((~gt_ignore).sum())


class COCOStyleEval:
    """gt: dict(img_ids, classes, annotations=[{boxes, labels}, ...]);
    dets: per image list of (boxes [K,4], scores [K], labels [K])."""

    def __init__(
        self,
        gt: dict,
        dets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        iou_thrs: Sequence[float] = (0.25,),
        max_dets: Sequence[int] = (100, 300, 1500),
        area_rngs=AITOD_AREA_RNGS,
        iou_fn=None,
        area_fn=None,
    ):
        assert len(gt["annotations"]) == len(dets)
        self.gt = gt
        self.dets = dets
        self.iou_thrs = list(iou_thrs)
        self.max_dets = sorted(max_dets)
        self.area_rngs = area_rngs
        self.num_classes = len(gt["classes"])
        # pluggable geometry: rotated evaluation (SODA-A) passes a rotated IoU
        # and area = w * h; default is axis-aligned xyxy
        self.iou_fn = iou_fn or _iou_xyxy
        self.area_fn = area_fn or (
            lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) if len(b)
            else np.zeros(0)
        )

    def _per_class_data(self, c: int):
        """Collect per-image det/gt arrays for class c."""
        out = []
        for ann, (boxes, scores, labels) in zip(self.gt["annotations"], self.dets):
            gm = ann["labels"] == c
            dm = labels == c
            d = boxes[dm]
            s = scores[dm]
            o = np.argsort(-s, kind="stable")
            out.append((d[o], s[o], ann["boxes"][gm]))
        return out

    def evaluate(self) -> Dict[str, float]:
        t_count = len(self.iou_thrs)
        a_count = len(self.area_rngs)
        md_max = self.max_dets[-1]
        # precision [T, R, C, A] at maxDet=max; recall [T, C, A, MD]
        precision = -np.ones((t_count, len(RECALL_THRS), self.num_classes, a_count))
        recall = -np.ones((t_count, self.num_classes, a_count, len(self.max_dets)))
        olrp = -np.ones((self.num_classes, 4))  # oLRP, loc, fp, fn

        for c in range(self.num_classes):
            data = self._per_class_data(c)
            ious = [
                self.iou_fn(d[:md_max], g) for (d, s, g) in data
            ]
            for ai, (aname, a0, a1) in enumerate(self.area_rngs):
                for ti, thr in enumerate(self.iou_thrs):
                    scores_all, match_all, ignore_all = [], [], []
                    match_per_img, matchig_per_img = [], []
                    ngt = 0
                    for (d, s, g), iou in zip(data, ious):
                        d = d[:md_max]
                        s = s[:md_max]
                        garea = self.area_fn(g)
                        gt_ig = (garea < a0) | (garea > a1)
                        dt_iou, dt_ig, n_reg = _match_img(
                            d, g, gt_ig, thr, iou=iou,
                        )
                        darea = self.area_fn(d)
                        dt_out = (dt_iou < 0) & ((darea < a0) | (darea > a1))
                        ignore_all.append(dt_ig | dt_out)
                        scores_all.append(s)
                        match_all.append(dt_iou)
                        match_per_img.append(dt_iou)
                        matchig_per_img.append(dt_ig)
                        ngt += n_reg
                    scores_cat = np.concatenate(scores_all) if scores_all else np.zeros(0)
                    match_cat = np.concatenate(match_all) if match_all else np.zeros(0)
                    ig_cat = np.concatenate(ignore_all) if ignore_all else np.zeros(0, bool)
                    if ngt == 0:
                        continue
                    order = np.argsort(-scores_cat, kind="stable")
                    match_cat, ig_cat = match_cat[order], ig_cat[order]
                    scores_sorted = scores_cat[order]
                    keep = ~ig_cat
                    tp = ((match_cat >= 0) & keep).astype(np.float64)
                    fp = ((match_cat < 0) & keep).astype(np.float64)
                    # AR per maxDet: greedy matching in score order has the
                    # prefix property (a det's match never depends on
                    # lower-scored dets), so the maxDet=md matching IS the
                    # first md entries of the maxDet=max matching —
                    # pycocotools itself slices dtm[:, :maxDet]. No
                    # re-matching (this loop was O(T*A*MD) full re-matches
                    # per class; at SODA-A maxDets=20000 that dominated).
                    for mi, md in enumerate(self.max_dets):
                        tp_md = sum(
                            int(((di[:md] >= 0) & ~ig[:md]).sum())
                            for di, ig in zip(match_per_img, matchig_per_img)
                        )
                        recall[ti, c, ai, mi] = tp_md / ngt
                    ctp = np.cumsum(tp)
                    cfp = np.cumsum(fp)
                    rc = ctp / ngt
                    pr = ctp / np.maximum(ctp + cfp, 1e-12)
                    # monotone precision from the right
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, RECALL_THRS, side="left")
                    q = np.zeros(len(RECALL_THRS))
                    for ri, pi in enumerate(inds):
                        q[ri] = pr[pi] if pi < len(pr) else 0.0
                    precision[ti, :, c, ai] = q

                    # oLRP on the primary (full) area range at the first IoU thr
                    if ai == 0 and ti == 0:
                        olrp[c] = _olrp(scores_sorted[keep], match_cat[keep], ngt, thr)
        self.precision = precision
        self.recall = recall
        self.olrp = olrp
        return self.summarize()

    def summarize(self) -> Dict[str, float]:
        area_names = [a for (a, _, _) in self.area_rngs]

        def ap(ti=None, area=area_names[0]):
            ai = area_names.index(area)
            p = self.precision[:, :, :, ai] if ti is None else self.precision[ti:ti + 1, :, :, ai]
            valid = p > -1
            return float(p[valid].mean()) if valid.any() else -1.0

        def ar(area=area_names[0], mi=-1):
            ai = area_names.index(area)
            r = self.recall[:, :, ai, mi]
            valid = r > -1
            return float(r[valid].mean()) if valid.any() else -1.0

        primary = area_names[0]
        stats = {"mAP": ap()}
        for a in area_names[1:]:
            stats[f"mAP_{a}"] = ap(area=a)
        for mi, md in enumerate(self.max_dets):
            stats[f"AR@{md}"] = ar(mi=mi)
        for a in area_names[1:]:
            stats[f"AR_{a}@{self.max_dets[-1]}"] = ar(area=a, mi=len(self.max_dets) - 1)
        valid_lrp = self.olrp[:, 0] > -1
        if valid_lrp.any():
            stats["oLRP"] = float(self.olrp[valid_lrp, 0].mean())
            stats["oLRP_Localisation"] = float(self.olrp[valid_lrp, 1].mean())
            stats["oLRP_false_positive"] = float(self.olrp[valid_lrp, 2].mean())
            stats["oLRP_false_negative"] = float(self.olrp[valid_lrp, 3].mean())
        self.per_class_ap = {
            cls: (
                float(self.precision[:, :, ci, 0][self.precision[:, :, ci, 0] > -1].mean())
                if (self.precision[:, :, ci, 0] > -1).any() else -1.0
            )
            for ci, cls in enumerate(self.gt["classes"])
        }
        return stats


def _olrp(scores: np.ndarray, match_iou: np.ndarray, ngt: int, tau: float):
    """Optimal LRP over score thresholds (Oksuz et al., ECCV'18)."""
    if ngt == 0:
        return np.array([-1.0, -1.0, -1.0, -1.0])
    order = np.argsort(-scores, kind="stable")
    match_iou = match_iou[order]
    tp_mask = match_iou >= 0
    loc_err = np.where(tp_mask, (1 - np.clip(match_iou, 0, 1)) / (1 - tau), 0.0)
    cum_tp = np.cumsum(tp_mask)
    cum_fp = np.cumsum(~tp_mask)
    cum_loc = np.cumsum(loc_err)
    n = len(scores)
    best = (1.0, 0.0, 1.0, 1.0)  # threshold above all dets: FN = ngt
    for k in range(n):  # threshold = keep dets[0..k]
        tp = cum_tp[k]
        fp = cum_fp[k]
        fn = ngt - tp
        denom = tp + fp + fn
        lrp = (cum_loc[k] + fp + fn) / denom
        if lrp < best[0]:
            loc = cum_loc[k] / tp if tp else 0.0
            fpr = fp / (tp + fp) if (tp + fp) else 0.0
            fnr = fn / ngt
            best = (lrp, loc, fpr, fnr)
    return np.array(best)


def aitod_evaluate(gt: dict, dets, iou_thrs=(0.25,)) -> Dict[str, float]:
    """AITODDataset.evaluate equivalent: AP/AR table at IoU 0.25 + oLRP."""
    ev = COCOStyleEval(gt, dets, iou_thrs=iou_thrs)
    return ev.evaluate()
