"""Rotated-box geometry (counterpart of point_teacher_tpu/ops/rotated.py).

Boxes are (cx, cy, w, h, theta), theta in radians (le90 convention). The
rotated IoU is a Sutherland-Hodgman clip of one box's polygon against the
other's four edges, over a ring of fixed size with duplicate vertices (4 ->
8 -> 16 -> 32 -> 64 slots) and a shoelace area: differentiable, no dynamic
shapes. The ring and the `where`-guarded denominators are kept exactly as in
the reference, so values and gradients agree on touching and degenerate
boxes too.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def obb2poly(rboxes: Tensor) -> Tensor:
    """[..., 5] -> [..., 8] corners (x0, y0, ..., x3, y3) in the order
    (-dx, -dy), (dx, -dy), (dx, dy), (-dx, dy) of the box frame."""
    cx, cy, w, h, a = rboxes.unbind(-1)
    dx = w * 0.5
    dy = h * 0.5
    cos, sin = torch.cos(a), torch.sin(a)
    xs = torch.stack([-dx, dx, dx, -dx], -1)
    ys = torch.stack([-dy, -dy, dy, dy], -1)
    px = cos[..., None] * xs - sin[..., None] * ys + cx[..., None]
    py = sin[..., None] * xs + cos[..., None] * ys + cy[..., None]
    return torch.stack([px, py], -1).reshape(*rboxes.shape[:-1], 8)


def obb2xyxy(obb: Tensor) -> Tensor:
    """Axis-aligned cover of a rotated box."""
    w, h, a = obb[..., 2], obb[..., 3], obb[..., 4]
    cosa, sina = torch.cos(a).abs(), torch.sin(a).abs()
    dw = cosa * w + sina * h
    dh = sina * w + cosa * h
    cx, cy = obb[..., 0], obb[..., 1]
    return torch.stack([cx - dw / 2, cy - dh / 2, cx + dw / 2, cy + dh / 2], -1)


def points_in_rbox(points: Tensor, rboxes: Tensor) -> Tensor:
    """points [..., P, 2] x rboxes [..., G, 5] -> bool [..., P, G]."""
    d = points[..., :, None, :] - rboxes[..., None, :, :2]
    a = rboxes[..., None, :, 4]
    cos, sin = torch.cos(a), torch.sin(a)
    lx = cos * d[..., 0] + sin * d[..., 1]
    ly = -sin * d[..., 0] + cos * d[..., 1]
    return ((lx.abs() <= rboxes[..., None, :, 2] * 0.5)
            & (ly.abs() <= rboxes[..., None, :, 3] * 0.5))


def _poly_area(poly_xy: Tensor) -> Tensor:
    """Shoelace area of a closed ring [..., K, 2]; duplicate vertices add 0.
    The absolute value takes the subgradient +1 at 0, as jnp.abs does
    (torch.abs takes 0): it decides the gradient of a degenerate, zero-area
    intersection such as that of touching boxes."""
    x, y = poly_xy[..., 0], poly_xy[..., 1]
    xn = torch.roll(x, -1, -1)
    yn = torch.roll(y, -1, -1)
    s = (x * yn - xn * y).sum(-1)
    return torch.where(s >= 0, s, -s) * 0.5


def _fill_ring_duplicates(verts: Tensor, emit: Tensor) -> Tensor:
    """Replace non-emitted slots with their most recent emitted predecessor
    (the ring wraps for leading slots), as an unrolled where-scan."""
    k = emit.shape[-1]
    last = verts[..., 0, :]
    for i in range(k):
        last = torch.where(emit[..., i, None], verts[..., i, :], last)
    filled = []
    cur = last
    for i in range(k):
        cur = torch.where(emit[..., i, None], verts[..., i, :], cur)
        filled.append(cur)
    return torch.stack(filled, -2)


def _clip_poly_halfplane(poly: Tensor, p0: Tensor, p1: Tensor):
    """Clip a closed ring [..., K, 2] against the half-plane left of p0 -> p1.
    Returns (ring [..., 2K, 2], whether any vertex was emitted)."""
    k = poly.shape[-2]
    cur = poly
    nxt = torch.roll(poly, -1, -2)
    e = p1 - p0

    def side(pt):
        d = pt - p0[..., None, :]
        return e[..., None, 0] * d[..., 1] - e[..., None, 1] * d[..., 0]

    s_cur = side(cur)
    s_nxt = side(nxt)
    in_cur = s_cur >= 0
    in_nxt = s_nxt >= 0
    denom = s_cur - s_nxt
    t = s_cur / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    inter = cur + t[..., None] * (nxt - cur)
    emit1 = in_cur
    emit2 = in_cur ^ in_nxt
    verts = torch.stack([cur, inter], -2).reshape(*poly.shape[:-2], 2 * k, 2)
    emits = torch.stack([emit1, emit2], -1).reshape(*poly.shape[:-2], 2 * k)
    return _fill_ring_duplicates(verts, emits), emits.any(-1)


def rbox_intersection_area(r1: Tensor, r2: Tensor) -> Tensor:
    """Intersection area of two rotated boxes, each [..., 5] -> [...]."""
    p1 = obb2poly(r1).reshape(*r1.shape[:-1], 4, 2)
    p2 = obb2poly(r2).reshape(*r2.shape[:-1], 4, 2)
    poly = p1
    # orient the clipper counter-clockwise by its signed area
    x, y = p2[..., 0], p2[..., 1]
    signed = (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(-1)
    p2 = torch.where((signed < 0)[..., None, None], p2.flip(-2), p2)
    nonempty = torch.ones(p1.shape[:-2], dtype=torch.bool, device=r1.device)
    for i in range(4):
        poly, any_emit = _clip_poly_halfplane(poly, p2[..., i, :], p2[..., (i + 1) % 4, :])
        nonempty = nonempty & any_emit
    return _poly_area(poly) * nonempty


def norm_angle_le90(a: Tensor) -> Tensor:
    """Angles into [-pi/2, pi/2): a floored modulo, as jnp's `%`."""
    return torch.remainder(a + math.pi / 2, math.pi) - math.pi / 2


def distance_angle_decode(points: Tensor, pred5: Tensor) -> Tensor:
    """DistanceAnglePointCoder.decode: (l, t, r, b, theta) at `points` ->
    (cx, cy, w, h, theta); the centre offset is rotated by theta and the
    angle normalised into le90."""
    l, t, r, b, a = pred5.unbind(-1)
    w = l + r
    h = t + b
    ox = (r - l) * 0.5
    oy = (b - t) * 0.5
    cos, sin = torch.cos(a), torch.sin(a)
    cx = points[..., 0] + cos * ox - sin * oy
    cy = points[..., 1] + sin * ox + cos * oy
    return torch.stack([cx, cy, w, h, norm_angle_le90(a)], -1)


def rbox_ltrb_targets(points: Tensor, rboxes: Tensor) -> Tensor:
    """(l, t, r, b) of each point in each rotated box's frame:
    points [P, 2], rboxes [G, 5] -> [P, G, 4]."""
    d = points[:, None, :] - rboxes[None, :, :2]
    a = rboxes[None, :, 4]
    cos, sin = torch.cos(a), torch.sin(a)
    ox = cos * d[..., 0] + sin * d[..., 1]
    oy = -sin * d[..., 0] + cos * d[..., 1]
    w = rboxes[None, :, 2]
    h = rboxes[None, :, 3]
    return torch.stack([w / 2 + ox, h / 2 + oy, w / 2 - ox, h / 2 - oy], -1)


def rbox_iou(rb1: Tensor, rb2: Tensor, aligned: bool = False, eps: float = 1e-6) -> Tensor:
    """Rotated IoU: pairwise [M, 5] x [N, 5] -> [M, N]; aligned [M, 5] x [M, 5] -> [M]."""
    if aligned:
        r1, r2 = rb1, rb2
    else:
        m, n = rb1.shape[-2], rb2.shape[-2]
        r1 = rb1[..., :, None, :].expand(*rb1.shape[:-2], m, n, 5)
        r2 = rb2[..., None, :, :].expand(*rb2.shape[:-2], m, n, 5)
    inter = rbox_intersection_area(r1, r2)
    a1 = r1[..., 2] * r1[..., 3]
    a2 = r2[..., 2] * r2[..., 3]
    return inter / (a1 + a2 - inter).clamp(min=eps)


IOU_TILE_ROWS = 256  # rows of a pairwise block a tile of rbox_iou_tiled computes


def rbox_iou_tiled(rb1: Tensor, rb2: Tensor) -> Tensor:
    """Pairwise rbox_iou [..., K, 5] x [..., L, 5] -> [..., K, L], computed
    IOU_TILE_ROWS rows of rb1 at a time. The polygon clip holds a 64-slot
    ring of f32 points (0.5 KB) a pair in each of several live tensors, so
    a tile of [2, 256, 2048] pairs stays within a few GB, where a whole
    [2, 2048, 2048] block of the class NMS would take ~25 GB. Each pair's
    IoU is computed on its own, so the result equals rbox_iou's bit for
    bit."""
    k = rb1.shape[-2]
    if k <= IOU_TILE_ROWS:
        return rbox_iou(rb1, rb2)
    return torch.cat([rbox_iou(rb1[..., i:i + IOU_TILE_ROWS, :], rb2)
                      for i in range(0, k, IOU_TILE_ROWS)], -2)
