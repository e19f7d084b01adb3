"""Optimizer: the reference's optax chain, written out (counterpart of
point_teacher_tpu/train/optim.py).

Order, as optax.chain(clip_by_global_norm, multi_transform) runs it:
1. clip by the global norm of EVERY gradient that exists, including those of
   parameters the optimizer then freezes (the FrozenBN affines and stats of
   layers 2-4): g <- (g / norm) * max_norm when norm >= max_norm;
2. per label: "base" adds weight decay then momentum (trace: m <- g + mu m)
   then scales by -lr; "bias" the same at lr x bias_lr_mult and no decay;
   "frozen" is set to zero;
3. p <- p + update.
The schedule is read at the number of updates made before this one.
Parameters are updated in place.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from .config import OptimCfg


def param_label(name: str, frozen_stages: int, bn_affine_trainable: bool = False) -> str:
    """'base' | 'bias' | 'frozen' for a port parameter name (torch keys).

    FrozenBN running statistics are always frozen. Their affine (weight,
    bias) is frozen too, unless `bn_affine_trainable` (the SODA-A config)
    and the BN sits outside the stem and the frozen stages: then both take
    the 'base' label, bias included, as the reference's rule gives them."""
    *module, leaf = name.split(".")
    stem = module[:2] in (["backbone", "conv1"], ["backbone", "bn1"])
    in_frozen_stage = stem or any(module[:2] == ["backbone", f"layer{s}"]
                                  for s in range(1, frozen_stages + 1))
    # FrozenBN modules: bn1/bn2/bn3 and downsample.1
    is_bn = bool(module) and (module[-1].startswith("bn") or module[-2:] == ["downsample", "1"])
    if is_bn:
        trains = bn_affine_trainable and leaf in ("weight", "bias") and not in_frozen_stage
        return "base" if trains else "frozen"
    if frozen_stages >= 0 and in_frozen_stage:
        return "frozen"
    return "bias" if leaf == "bias" else "base"


def lr_at(cfg: OptimCfg, step: int, lr_mult: float = 1.0) -> float:
    """Constant warmup (ratio over the first warmup_iters), x0.1 at each step epoch."""
    warm = cfg.warmup_ratio if step < cfg.warmup_iters else 1.0
    epoch = step // cfg.iters_per_epoch
    decay = 1.0
    for e in cfg.step_epochs:
        if epoch >= e:
            decay *= 0.1
    return cfg.base_lr * lr_mult * warm * decay


class PointTeacherSGD:
    def __init__(self, model: nn.Module, cfg: OptimCfg):
        self.cfg = cfg
        self.count = 0
        self.groups: Dict[str, List[nn.Parameter]] = {"base": [], "bias": [], "frozen": []}
        self.labels: Dict[str, str] = {}
        for name, p in model.named_parameters():
            label = param_label(name, cfg.frozen_stages, cfg.bn_affine_trainable)
            self.labels[name] = label
            self.groups[label].append(p)
        self.params = [p for p in model.parameters()]
        self.trace = {k: [torch.zeros_like(p) for p in self.groups[k]] for k in ("base", "bias")}

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' .grad; returns the global norm."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))) if grads \
            else torch.zeros(())
        max_norm = self.cfg.grad_clip_norm
        keep = norm < max_norm
        # where(keep, g, (g / norm) * max_norm), as optax
        denom = torch.where(keep, torch.ones_like(norm), norm)
        mult = torch.where(keep, 1.0, max_norm).to(norm.dtype)
        for label, wd, mult_lr in (("base", self.cfg.weight_decay, 1.0),
                                   ("bias", 0.0, self.cfg.bias_lr_mult)):
            params = self.groups[label]
            if not params:
                continue
            g = [(p.grad if p.grad is not None else torch.zeros_like(p)) / denom * mult
                 for p in params]
            if wd:
                torch._foreach_add_(g, params, alpha=wd)
            trace = self.trace[label]
            torch._foreach_mul_(trace, self.cfg.momentum)
            torch._foreach_add_(trace, g)
            torch._foreach_add_(params, trace, alpha=-lr_at(self.cfg, self.count, mult_lr))
        self.count += 1
        return norm
