"""Host-side (numpy) rotated-box geometry for evaluation and patch merging
(the port's own copy of point_teacher_tpu/evalx/rgeometry.py).

Replaces mmcv's box_iou_rotated / nms_rotated on the CPU eval path
(OBB_TOD/mmrotate/datasets/sodaa.py merge + sodaa_eval IoU computation) and
cv2-based poly<->obb conversions (poly2obb_np, le90).
"""
from __future__ import annotations

import numpy as np


def obb2poly_np(rb: np.ndarray) -> np.ndarray:
    """[N, 5] (cx, cy, w, h, a) -> [N, 4, 2] corners."""
    cx, cy, w, h, a = rb[:, 0], rb[:, 1], rb[:, 2], rb[:, 3], rb[:, 4]
    cos, sin = np.cos(a), np.sin(a)
    dx = np.stack([-w / 2, w / 2, w / 2, -w / 2], -1)
    dy = np.stack([-h / 2, -h / 2, h / 2, h / 2], -1)
    x = cos[:, None] * dx - sin[:, None] * dy + cx[:, None]
    y = sin[:, None] * dx + cos[:, None] * dy + cy[:, None]
    return np.stack([x, y], -1)


def poly2obb_np(poly: np.ndarray, version: str = "le90"):
    """8-value polygon -> (cx, cy, w, h, a) min-area rect (le90).

    For the quad annotations of SODA-A a rotating-calipers pass over the 4
    edge directions reproduces cv2.minAreaRect.
    """
    pts = np.asarray(poly, np.float64).reshape(-1, 2)
    if len(pts) < 3:
        return None
    best = None
    n = len(pts)
    for i in range(n):
        e = pts[(i + 1) % n] - pts[i]
        norm = np.hypot(*e)
        if norm < 1e-9:
            continue
        ux, uy = e / norm
        # rotate all points into this edge frame
        xs = pts @ np.array([ux, uy])
        ys = pts @ np.array([-uy, ux])
        w = xs.max() - xs.min()
        h = ys.max() - ys.min()
        area = w * h
        if best is None or area < best[0]:
            cx_f = (xs.max() + xs.min()) / 2
            cy_f = (ys.max() + ys.min()) / 2
            cx = cx_f * ux - cy_f * uy
            cy = cx_f * uy + cy_f * ux
            a = np.arctan2(uy, ux)
            best = (area, cx, cy, w, h, a)
    if best is None:
        return None
    _, cx, cy, w, h, a = best
    # le90 normalisation: a in [-pi/2, pi/2), w is the x-extent at that angle
    a = (a + np.pi / 2) % np.pi - np.pi / 2
    # after wrapping, ensure the (w, h) pair matches the wrapped angle:
    # wrapping by pi keeps the box identical, so only check swap by pi/2
    pts_c = pts - [cx, cy]
    cos, sin = np.cos(a), np.sin(a)
    xs = pts_c @ np.array([cos, sin])
    ys = pts_c @ np.array([-sin, cos])
    w2 = xs.max() - xs.min()
    h2 = ys.max() - ys.min()
    return float(cx), float(cy), float(w2), float(h2), float(a)


def _clip_poly(subject, cp1, cp2):
    out = []
    n = len(subject)
    for i in range(n):
        cur, nxt = subject[i], subject[(i + 1) % n]
        sc = (cp2[0] - cp1[0]) * (cur[1] - cp1[1]) - (cp2[1] - cp1[1]) * (cur[0] - cp1[0])
        sn = (cp2[0] - cp1[0]) * (nxt[1] - cp1[1]) - (cp2[1] - cp1[1]) * (nxt[0] - cp1[0])
        if sc >= 0:
            out.append(cur)
        if (sc >= 0) != (sn >= 0):
            t = sc / (sc - sn)
            out.append(cur + t * (nxt - cur))
    return out


def _poly_area(p):
    if len(p) < 3:
        return 0.0
    p = np.asarray(p)
    x, y = p[:, 0], p[:, 1]
    return abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2


def rbox_iou_np(rb1: np.ndarray, rb2: np.ndarray) -> np.ndarray:
    """Pairwise rotated IoU [M,5] x [N,5] -> [M,N] (exact convex clip)."""
    m, n = len(rb1), len(rb2)
    out = np.zeros((m, n), np.float64)
    if m == 0 or n == 0:
        return out
    p1 = obb2poly_np(np.asarray(rb1, np.float64))
    p2 = obb2poly_np(np.asarray(rb2, np.float64))
    a1 = rb1[:, 2] * rb1[:, 3]
    a2 = rb2[:, 2] * rb2[:, 3]
    # orient clippers ccw
    for j in range(n):
        q = p2[j]
        e0, e1 = q[1] - q[0], q[2] - q[1]
        if e0[0] * e1[1] - e0[1] * e1[0] < 0:   # np.cross of 2-vectors
            p2[j] = q[::-1]
    for i in range(m):
        # quick reject via axis-aligned covers
        c1 = p1[i]
        for j in range(n):
            q = p2[j]
            if (c1[:, 0].max() < q[:, 0].min() or q[:, 0].max() < c1[:, 0].min()
                    or c1[:, 1].max() < q[:, 1].min() or q[:, 1].max() < c1[:, 1].min()):
                continue
            sub = list(c1)
            for k in range(4):
                sub = _clip_poly(sub, q[k], q[(k + 1) % 4])
                if not sub:
                    break
            inter = _poly_area(sub) if sub else 0.0
            u = a1[i] + a2[j] - inter
            out[i, j] = inter / u if u > 0 else 0.0
    return out


def nms_rotated_np(rboxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy rotated NMS -> kept indices (score-descending order)."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(rboxes), bool)
    iou = None
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        if iou is None:
            iou = rbox_iou_np(rboxes, rboxes)
        suppressed |= iou[i] > iou_thr
        suppressed[i] = True  # keep it out of future checks; already kept
    return np.asarray(keep, np.int64)
