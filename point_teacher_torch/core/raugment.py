"""Rotated strong augmentation (flip, random rotation, discrete rescale) and
annotation points in rotated boxes (counterpart of
point_teacher_tpu/core/raugment.py).

Randomness is an input: per image a flip `direction` (0 horizontal,
1 vertical, 2 both, 3 none), a uniform `u` in [0.8, 1.2) that rounds to a
scale in {0.8, ..., 1.2}, and a rotation `angle` in whole degrees 1-19. The
image is flipped, rotated by +angle about its centre (nearest, fill 0) and
rescaled; coordinates move by R(-angle) and the boxes' angles by -angle,
and every pseudo box ends in the le90 canonical form (w the long edge).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.rotated import norm_angle_le90
from .augment import flip_masks, rescale_offsets, warp_rescale_image

Tensor = torch.Tensor


class RAugBatch(NamedTuple):
    image: Tensor          # [B, H, W, 3]
    gt_points: Tensor      # [B, G, 2]
    gt_valid: Tensor       # [B, G]
    pseudo_points: Tensor  # [B, G, 2]
    pseudo_rboxes: Tensor  # [B, G, 5]
    pseudo_valid: Tensor   # [B, G]


def _flip_rboxes(rb: Tensor, direction, h: int, w: int) -> Tensor:
    """rb [..., G, 5]; direction of the leading dims. One flip negates the
    angle; both keep it."""
    cx, cy, bw, bh, a = rb.unbind(-1)
    hf, vf = flip_masks(direction)
    hf, vf = hf[..., None], vf[..., None]
    return torch.stack([torch.where(hf, w - cx, cx), torch.where(vf, h - cy, cy), bw, bh,
                        torch.where(hf ^ vf, norm_angle_le90(-a), a)], -1)


def _flip_points(p: Tensor, direction, h: int, w: int) -> Tensor:
    x, y = p.unbind(-1)
    hf, vf = flip_masks(direction)
    hf, vf = hf[..., None], vf[..., None]
    return torch.stack([torch.where(hf, w - x, x), torch.where(vf, h - y, y)], -1)


def _flip_image(img: Tensor, direction) -> Tensor:
    """img [..., H, W, C]."""
    hf, vf = flip_masks(direction)
    img = torch.where(hf[..., None, None, None], img.flip(-2), img)
    return torch.where(vf[..., None, None, None], img.flip(-3), img)


def _rotate_coords(p: Tensor, rad: Tensor, h: int, w: int) -> Tensor:
    """R(rad) about the image centre (w/2, h/2)."""
    cx, cy = w / 2.0, h / 2.0
    cos, sin = torch.cos(rad), torch.sin(rad)
    x = p[..., 0] - cx
    y = p[..., 1] - cy
    return torch.stack([cos * x - sin * y + cx, sin * x + cos * y + cy], -1)


def rotate_images_nearest(imgs: Tensor, rad_invs: Tensor) -> Tensor:
    """TF.rotate(img, angle, fill=0) analog for a batch [B, H, W, C]: nearest
    inverse warp about (w/2, h/2); rad_invs [B] is the inverse map's rotation."""
    b, h, w, _ = imgs.shape
    cx, cy = w / 2.0, h / 2.0
    cos = torch.cos(rad_invs)[:, None, None]
    sin = torch.sin(rad_invs)[:, None, None]
    ys = torch.arange(h, dtype=imgs.dtype, device=imgs.device) + 0.5
    xs = torch.arange(w, dtype=imgs.dtype, device=imgs.device) + 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    xr = (xx - cx)[None]
    yr = (yy - cy)[None]
    sx = cos * xr - sin * yr + cx - 0.5
    sy = sin * xr + cos * yr + cy - 0.5
    xi = torch.round(sx).long()
    yi = torch.round(sy).long()
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    bidx = torch.arange(b, device=imgs.device)[:, None, None]
    out = imgs[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    return torch.where(valid[..., None], out, 0.0)


def canon_le90(rb: Tensor) -> Tensor:
    """poly2obb_le90's canonical form: w the long edge, h the short edge, the
    angle along the long edge normalised into [-pi/2, pi/2)."""
    swap = rb[..., 3] > rb[..., 2]
    w2 = torch.where(swap, rb[..., 3], rb[..., 2])
    h2 = torch.where(swap, rb[..., 2], rb[..., 3])
    a2 = norm_angle_le90(torch.where(swap, rb[..., 4] + math.pi / 2, rb[..., 4]))
    return torch.cat([rb[..., :2], w2[..., None], h2[..., None], a2[..., None]], -1)


def strong_augment_rotated(batch: RAugBatch, direction: Tensor, u: Tensor,
                           angle: Tensor) -> RAugBatch:
    """direction [B] int in {0..3}; u [B] uniforms in [0.8, 1.2); angle [B]
    rotation in whole degrees (1-19), float. No host sync: the flips are
    selected on the device."""
    b, h, w, _ = batch.image.shape
    scales = torch.round(u.float() * 10.0) / 10.0
    rads = -angle.to(batch.image.dtype) * (math.pi / 180.0)

    imgs = rotate_images_nearest(_flip_image(batch.image, direction), -rads)
    imgs = torch.stack([warp_rescale_image(imgs[i], scales[i]) for i in range(b)])
    gt_all = _flip_points(batch.gt_points, direction, h, w)
    ps_all = _flip_points(batch.pseudo_points, direction, h, w)
    rb_all = _flip_rboxes(batch.pseudo_rboxes, direction, h, w)

    def inframe(p):
        return (p[..., 0] >= 0) & (p[..., 0] < w) & (p[..., 1] >= 0) & (p[..., 1] < h)

    fields = {k: [] for k in RAugBatch._fields if k != "image"}
    for i in range(b):
        s, rad = scales[i], rads[i]
        gt_pts = _rotate_coords(gt_all[i], rad, h, w)
        ps_pts = _rotate_coords(ps_all[i], rad, h, w)
        ps_rb = rb_all[i]
        ps_rb = torch.cat([_rotate_coords(ps_rb[..., :2], rad, h, w), ps_rb[..., 2:4],
                           (ps_rb[..., 4] + rad)[..., None]], -1)
        gt_valid = batch.gt_valid[i] & inframe(gt_pts)
        ps_valid = batch.pseudo_valid[i] & inframe(ps_pts)

        _, _, off_y, off_x = rescale_offsets(s, h, w)
        off = torch.stack([off_x, off_y])
        gt_pts = gt_pts * s + off
        ps_pts = ps_pts * s + off
        ps_rb = torch.cat([ps_rb[..., :2] * s + off, ps_rb[..., 2:4] * s, ps_rb[..., 4:]], -1)
        fields["gt_points"].append(gt_pts)
        fields["gt_valid"].append(gt_valid & inframe(gt_pts))
        fields["pseudo_points"].append(ps_pts)
        fields["pseudo_rboxes"].append(canon_le90(ps_rb))
        fields["pseudo_valid"].append(ps_valid & inframe(ps_pts))
    return RAugBatch(image=imgs, **{k: torch.stack(v) for k, v in fields.items()})


def random_point_in_rboxes(rboxes: Tensor, position, u: Tensor) -> Tensor:
    """Annotation points in rotated boxes: the centres for position 'center'
    or 0; else uniform in the central `position` fraction (1 for 'random') of
    the box frame. u [..., 2] uniforms in [0, 1)."""
    if position in ("center", 0.0, 0):
        return rboxes[..., :2]
    frac = 1.0 if position == "random" else float(position)
    v = (u - 0.5) * frac
    dx = v[..., 0] * rboxes[..., 2]
    dy = v[..., 1] * rboxes[..., 3]
    a = rboxes[..., 4]
    cos, sin = torch.cos(a), torch.sin(a)
    return torch.stack([rboxes[..., 0] + cos * dx - sin * dy,
                        rboxes[..., 1] + sin * dx + cos * dy], -1)
