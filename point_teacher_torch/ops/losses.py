"""Loss functions (counterpart of point_teacher_tpu/ops/losses.py, the members
that train/dense_losses.py, train/rdense_losses.py, train/mil.py and the
baselines' steps use)."""
from __future__ import annotations

import torch

from ..parallel import dist
from .rotated import rbox_iou

Tensor = torch.Tensor


def one_hot(labels: Tensor, num_classes: int, dtype=torch.float32) -> Tensor:
    """Like jax.nn.one_hot: out-of-range labels (background = num_classes)
    give an all-zero row."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def weight_reduce(loss: Tensor, weight=None, avg_factor=None) -> Tensor:
    """mmdet-style weighted reduction: the mean, or the sum over `avg_factor`."""
    if weight is not None:
        loss = loss * weight
    return loss.mean() if avg_factor is None else loss.sum() / avg_factor


def _bce_with_logits(logits: Tensor, targets: Tensor) -> Tensor:
    # numerically stable: max(x,0) - x*t + log(1 + exp(-|x|))
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: Tensor, targets_onehot: Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> Tensor:
    """Element-wise sigmoid focal loss; targets in {0, 1}, same shape as logits."""
    p = torch.sigmoid(logits)
    t = targets_onehot
    ce = _bce_with_logits(logits, t)
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return ce * alpha_t * torch.pow(1 - p_t, gamma)


def focal_loss_from_labels(logits: Tensor, labels: Tensor, num_classes: int, weight=None,
                           avg_factor=None, alpha: float = 0.25, gamma: float = 2.0) -> Tensor:
    """Focal loss with integer labels; background = `num_classes`."""
    onehot = one_hot(labels, num_classes, logits.dtype)
    return weight_reduce(sigmoid_focal_loss(logits, onehot, alpha, gamma).sum(-1), weight,
                         avg_factor)


def binary_cross_entropy(logits: Tensor, targets: Tensor, weight=None, avg_factor=None) -> Tensor:
    return weight_reduce(_bce_with_logits(logits, targets), weight, avg_factor)


def _diou_elem(pred: Tensor, target: Tensor, eps: float = 1e-7) -> Tensor:
    """Element-wise DIoU loss (1 - DIoU) on aligned xyxy boxes [..., 4] -> [...]."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:4], target[..., 2:4])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    ap = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    ag = (target[..., 2] - target[..., 0]) * (target[..., 3] - target[..., 1])
    ious = overlap / (ap + ag - overlap + eps)

    enc_lt = torch.minimum(pred[..., :2], target[..., :2])
    enc_rb = torch.maximum(pred[..., 2:4], target[..., 2:4])
    enc_wh = (enc_rb - enc_lt).clamp(min=0)
    c2 = enc_wh[..., 0] ** 2 + enc_wh[..., 1] ** 2 + eps
    rho2 = (((target[..., 0] + target[..., 2]) - (pred[..., 0] + pred[..., 2])) ** 2 / 4
            + ((target[..., 1] + target[..., 3]) - (pred[..., 1] + pred[..., 3])) ** 2 / 4)
    return 1 - (ious - rho2 / c2)


def diou_loss(pred: Tensor, target: Tensor, weight=None, avg_factor=None,
              eps: float = 1e-6) -> Tensor:
    return weight_reduce(_diou_elem(pred, target, eps), weight, avg_factor)


def iou_loss(pred: Tensor, target: Tensor, weight=None, avg_factor=None,
             eps: float = 1e-6) -> Tensor:
    """IoULoss on aligned xyxy boxes: -log(IoU), the IoU clamped below at eps."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:4], target[..., 2:4])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    ap = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    ag = (target[..., 2] - target[..., 0]) * (target[..., 3] - target[..., 1])
    ious = (overlap / (ap + ag - overlap + eps)).clamp(min=eps)
    return weight_reduce(-torch.log(ious), weight, avg_factor)


def dn_diou_loss(pred: Tensor, target: Tensor, weight=None, avg_factor=None,
                 hyper: float = 0.2, eps: float = 1e-6, base_valid=None) -> Tensor:
    """Denoising DIoU: min over a 3x3 bank of corner-perturbed targets, averaged
    with the base DIoU (a scalar mean over the `base_valid` rows, the
    reference's default-'mean' quirk — see the JAX docstring).

    In a world of several ranks the base is a mean over the global batch
    and multiplies every row's weight, so each rank returns its share of
    the global loss: its base rows' sum over the global count times the
    global weight sum, plus its own rows' bank term, over 2 x avg_factor
    (`weight` and `avg_factor` carry no gradient; without avg_factor, the
    global row count)."""
    base_elem = _diou_elem(pred, target, eps)
    if dist.world() > 1:
        return _dn_diou_share(pred, target, base_elem, weight, avg_factor, hyper, eps,
                              base_valid)
    if base_valid is None:
        base = base_elem.mean()
    else:
        m = base_valid.reshape(base_elem.shape).to(base_elem.dtype)
        base = (base_elem * m).sum() / m.sum().clamp(min=1.0)
    loss = (base + _dn_bank_min(pred, target, hyper, eps)) / 2
    return weight_reduce(loss, weight, avg_factor)


def _dn_bank_min(pred: Tensor, target: Tensor, hyper: float, eps: float) -> Tensor:
    """Per row, the least DIoU loss over the 3x3 bank of corner-perturbed targets."""
    a = hyper / 2
    w = target[..., 2] - target[..., 0]
    h = target[..., 3] - target[..., 1]
    shifts = (-1.0, 0.0, 1.0)
    bank = torch.stack([
        torch.stack([target[..., 0] - a * w * i, target[..., 1] - a * h * i,
                     target[..., 2] + a * w * j, target[..., 3] + a * h * j], -1)
        for i in shifts for j in shifts
    ])  # [9, ..., 4], (i, j) row-major as the JAX meshgrid(indexing="ij")
    bank_loss = _diou_elem(pred[None], bank, eps)
    return torch.amin(bank_loss, 0)  # amin splits tied grads as JAX does


def _dn_diou_share(pred, target, base_elem, weight, avg_factor, hyper, eps, base_valid):
    """dn_diou_loss's share of this rank in a world of several ranks."""
    m = (torch.ones_like(base_elem) if base_valid is None
         else base_valid.reshape(base_elem.shape).to(base_elem.dtype))
    w = torch.ones_like(base_elem) if weight is None else weight.reshape(base_elem.shape)
    count, wsum = dist.global_sum(m.sum(), w.sum())
    base = (base_elem * m).sum() / count.clamp(min=1.0)
    share = (base * wsum + (_dn_bank_min(pred, target, hyper, eps) * w).sum()) / 2
    if avg_factor is None:
        avg_factor = dist.global_sum(torch.full((), float(base_elem.numel()),
                                                device=base_elem.device))
    return share / avg_factor


def _rotated_iou_elem(pred5: Tensor, target5: Tensor, mode: str, eps: float) -> Tensor:
    ious = rbox_iou(pred5, target5, aligned=True).clamp(min=eps)
    if mode == "linear":
        return 1 - ious
    if mode == "square":
        return 1 - ious ** 2
    return -torch.log(ious)


def rotated_iou_loss(pred5: Tensor, target5: Tensor, weight=None, avg_factor=None,
                     mode: str = "log", eps: float = 1e-6, loss_weight: float = 1.0) -> Tensor:
    """RotatedIoULoss on aligned rotated boxes: -log(IoU) (default), 1 - IoU
    (linear) or 1 - IoU^2 (square), with the polygon-clip rbox_iou."""
    return loss_weight * weight_reduce(_rotated_iou_elem(pred5, target5, mode, eps), weight,
                                       avg_factor)


def dn_rotated_iou_loss(pred5: Tensor, target5: Tensor, weight=None, avg_factor=None,
                        hyper: float = 0.2, mode: str = "log", eps: float = 1e-6,
                        loss_weight: float = 1.0) -> Tensor:
    """Denoising rotated IoU loss: the min over a 3x3 bank of targets with
    w and h perturbed (w - a*w*i, h - a*h*j, a = hyper / 2, i, j in -1, 0,
    1), averaged with the base rotated IoU loss, per element."""
    base = _rotated_iou_elem(pred5, target5, mode, eps)
    a = hyper / 2
    cx, cy, w, h, ang = target5.unbind(-1)
    shifts = (-1.0, 0.0, 1.0)
    bank = torch.stack([torch.stack([cx, cy, w - a * w * i, h - a * h * j, ang], -1)
                        for i in shifts for j in shifts])   # [9, ..., 5], (i, j) row-major
    bank_loss = _rotated_iou_elem(pred5.expand_as(bank), bank, mode, eps)
    loss = (base + torch.amin(bank_loss, 0)) / 2
    return loss_weight * weight_reduce(loss, weight, avg_factor)


def gfocal_loss(p: Tensor, q: Tensor, w=1.0, eps: float = 1e-6) -> Tensor:
    """Bag-level generalised-focal loss, summed over classes: [..., C] -> [...]."""
    l1 = (p - q) ** 2
    l2 = q * torch.log(p + eps) + (1 - q) * torch.log(1 - p + eps)
    return -(l1 * l2 * w).sum(-1)


def centerness_target(bbox_targets_ltrb: Tensor) -> Tensor:
    """FCOS centerness from (l, t, r, b) targets; min clamp 0.01 as in the reference."""
    lr = bbox_targets_ltrb[..., 0::2]   # (l, r): slices, not a list index, which a
    tb = bbox_targets_ltrb[..., 1::2]   # card would copy from the host
    c = ((lr.amin(-1).clamp(min=0.01) / lr.amax(-1).clamp(min=1e-12))
         * (tb.amin(-1).clamp(min=0.01) / tb.amax(-1).clamp(min=1e-12)))
    return torch.sqrt(c)
