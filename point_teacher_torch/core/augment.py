"""Strong augmentation (4-way flip + discrete rescale) and annotation-point
sampling (counterpart of point_teacher_tpu/core/augment.py).

Randomness is an input: per image a flip `direction` (0 horizontal,
1 vertical, 2 both, 3 none) and a uniform `u` in [0.8, 1.2) that rounds to
one of the scales {0.8, 0.9, 1.0, 1.1, 1.2}; per box the point uniforms.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class AugBatch(NamedTuple):
    image: Tensor          # [B, H, W, 3]
    gt_points: Tensor      # [B, G, 2]
    gt_valid: Tensor       # [B, G]
    pseudo_points: Tensor  # [B, G, 2]
    pseudo_boxes: Tensor   # [B, G, 4] xyxy
    pseudo_valid: Tensor   # [B, G]


def _flip(img, pts, boxes, direction: int, h: int, w: int):
    """One image [H, W, 3]; `pts` a list of [G, 2]; boxes [G, 4]."""
    if direction in (0, 2):
        img = img.flip(1)
        pts = [torch.stack([w - p[..., 0], p[..., 1]], -1) for p in pts]
        boxes = torch.stack([w - boxes[..., 0], boxes[..., 1], w - boxes[..., 2], boxes[..., 3]], -1)
    if direction in (1, 2):
        img = img.flip(0)
        pts = [torch.stack([p[..., 0], h - p[..., 1]], -1) for p in pts]
        boxes = torch.stack([boxes[..., 0], h - boxes[..., 1], boxes[..., 2], h - boxes[..., 3]], -1)
    return img, pts, boxes


def rescale_offsets(s: Tensor, h: int, w: int):
    """Size and paste (> 0) / crop (< 0) offsets of resize-then-centre-pad/crop."""
    sh = torch.floor(h * s + 1e-4)
    sw = torch.floor(w * s + 1e-4)
    return sh, sw, torch.trunc((h - sh) / 2), torch.trunc((w - sw) / 2)


def warp_rescale_image(img: Tensor, s: Tensor) -> Tensor:
    """Bilinear resize to (floor(h*s), floor(w*s)) (align_corners=False) then
    centre pad/crop, as one warp; rounded to integer pixel values."""
    h, w, _ = img.shape
    sh, sw, off_y, off_x = rescale_offsets(s, h, w)

    def axis_coords(n, off, sn):
        rel = torch.arange(n, device=img.device, dtype=img.dtype) - off
        src = (rel + 0.5) * (n / sn) - 0.5
        return src.clamp(0, n - 1), (rel >= 0) & (rel < sn)

    sy, vy = axis_coords(h, off_y, sh)
    sx, vx = axis_coords(w, off_x, sw)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    ly = (sy - y0)[:, None, None]
    lx = (sx - x0)[None, :, None]
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(max=h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    r0, r1 = img[y0i], img[y1i]
    top = r0[:, x0i] * (1 - lx) + r0[:, x1i] * lx
    bot = r1[:, x0i] * (1 - lx) + r1[:, x1i] * lx
    out = top * (1 - ly) + bot * ly
    mask = (vy[:, None] & vx[None, :])[..., None]
    return torch.round(torch.where(mask, out, 0.0))


def _rescale(img, pts, boxes, s, h: int, w: int):
    sh, sw, off_y, off_x = rescale_offsets(s, h, w)
    off = torch.stack([off_x, off_y])
    out = warp_rescale_image(img, s)
    new_pts = [p * s + off for p in pts]
    inframe = [(p[..., 0] >= 0) & (p[..., 0] < w) & (p[..., 1] >= 0) & (p[..., 1] < h)
               for p in new_pts]
    boxes = boxes * s
    boxes = boxes + torch.stack([off_x, off_y, off_x, off_y])
    return out, new_pts, boxes, inframe


def strong_augment(batch: AugBatch, direction: Tensor, u: Tensor) -> AugBatch:
    """direction [B] int in {0..3}; u [B] uniforms in [0.8, 1.2)."""
    b, h, w, _ = batch.image.shape
    dirs = direction.tolist()
    scales = torch.round(u.float() * 10.0) / 10.0
    fields = {k: [] for k in AugBatch._fields}
    for i in range(b):
        img, (gt_pts, ps_pts), boxes = _flip(
            batch.image[i], [batch.gt_points[i], batch.pseudo_points[i]],
            batch.pseudo_boxes[i], int(dirs[i]), h, w)
        img, (gt_pts, ps_pts), boxes, (gt_in, ps_in) = _rescale(
            img, [gt_pts, ps_pts], boxes, scales[i], h, w)
        # normalise flipped boxes (x1 < x2, y1 < y2)
        boxes = torch.stack([torch.minimum(boxes[..., 0], boxes[..., 2]),
                             torch.minimum(boxes[..., 1], boxes[..., 3]),
                             torch.maximum(boxes[..., 0], boxes[..., 2]),
                             torch.maximum(boxes[..., 1], boxes[..., 3])], -1)
        fields["image"].append(img)
        fields["gt_points"].append(gt_pts)
        fields["gt_valid"].append(batch.gt_valid[i] & gt_in)
        fields["pseudo_points"].append(ps_pts)
        fields["pseudo_boxes"].append(boxes)
        fields["pseudo_valid"].append(batch.pseudo_valid[i] & ps_in)
    return AugBatch(**{k: torch.stack(v) for k, v in fields.items()})


def random_point_in_boxes(boxes_xyxy: Tensor, position: float, u: Tensor) -> Tensor:
    """Annotation point uniform in the central `position` fraction of each box
    (position 0 -> the centre); u [..., 2] uniforms in [0, 1)."""
    wh = boxes_xyxy[..., 2:4] - boxes_xyxy[..., 0:2]
    space = wh * (1 - position) / 2
    return boxes_xyxy[..., 0:2] + space + u * wh * position
