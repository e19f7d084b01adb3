"""Reference PyTorch weights into the port's modules (the port's counterpart
of point_teacher_tpu/utils/torch_port.py).

The port's modules carry the reference's torch key names and layouts
(conv weights OIHW, FrozenBN weight / bias / running_mean / running_var,
the first MIL-tower FC in the (C, H, W) order), so a reference state dict
loads key by key, with no transpose:
- `load_torch_resnet50_into`: a torchvision / mmcv-layout ResNet-50 .pth
  (`conv1`, `bn1`, `layer{1-4}.{b}.conv{1-3}`, `bn{1-3}`, `downsample.0/1`,
  optionally under `backbone.`) into the detector's backbone; the
  classifier (`fc.*`) and other keys are not read;
- `load_reference_ts_checkpoint`: one branch ("teacher." or "student.") of a
  reference TS_P2B_FCOS / RotatedFCOS_TS checkpoint into StudentFCOS /
  StudentRotatedFCOS. A file without such keys but with `backbone.` keys
  loads as a bare detector, with a warning, as the JAX loader does.

What the JAX loader does not read is not read here either: `fc_iou`,
`shared_fcs`, `shared_fcs_refine` (dead on the shipped path), the BN
`num_batches_tracked`, and any key outside the port's modules. A key the
port needs that the file lacks, or a shape that differs, raises.

Files are opened with `torch.load(weights_only=True)`, which unpickles no
code; `allow_pickle=True` opts in to a full unpickle of a reference
checkpoint that needs it. The JAX package reads the ResNet-50 file with
weights_only=False; the port reads it as a plain state dict.
"""
from __future__ import annotations

import warnings
from typing import Dict

import torch
from torch import nn

def _state_dict(raw) -> Dict[str, torch.Tensor]:
    """The state dict of a loaded file: its `state_dict` or `model` entry
    (mmdet / torchvision checkpoints), or the file itself."""
    if isinstance(raw, dict):
        return raw.get("state_dict", raw.get("model", raw))
    return raw


@torch.no_grad()
def _copy_into(module: nn.Module, sd: Dict[str, torch.Tensor], prefix: str, path: str,
               what: str) -> nn.Module:
    """module.<key> <- sd[prefix + key] for every parameter and buffer of
    `module`; a missing key or a shape that differs raises."""
    own = module.state_dict()
    missing = [k for k in own if prefix + k not in sd]
    if missing:
        raise KeyError(f"{path}: {len(missing)} {what} keys missing, e.g. "
                       f"{[prefix + k for k in missing[:3]]}")
    for k, dst in own.items():
        src = sd[prefix + k]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: {prefix + k} has shape {tuple(src.shape)}, the port's "
                             f"{what} {tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))
    return module


def load_torch_resnet50_into(model: nn.Module, path: str) -> nn.Module:
    """A torchvision-layout ResNet-50 .pth into `model.backbone`, in place;
    returns the model."""
    sd = _state_dict(torch.load(path, map_location="cpu", weights_only=True))
    sd = {k.removeprefix("backbone."): v for k, v in sd.items()}
    _copy_into(model.backbone, sd, "", path, "ResNet-50")
    return model


def load_reference_ts_checkpoint(model: nn.Module, path: str, branch: str = "teacher",
                                 rotated: bool = False, num_stages: int = 1,
                                 allow_pickle: bool = False) -> nn.Module:
    """One branch of a reference Point-Teacher checkpoint (.pth) into
    `model` (StudentFCOS, or StudentRotatedFCOS when `rotated`, built with
    `num_stages` MIL stages), in place; returns the model. The reference
    saves the teacher-student wrapper as one state dict with the branches
    under `teacher.*` / `student.*`; its inference runs the teacher."""
    if branch not in ("teacher", "student"):
        raise ValueError(f"branch must be 'teacher' or 'student', got {branch!r}")
    if rotated != hasattr(model.bbox_head, "conv_angle"):
        raise ValueError(f"rotated={rotated} does not match {type(model).__name__}")
    if num_stages != len(model.bbox_head.fc_reg):
        raise ValueError(f"num_stages={num_stages}, the model has "
                         f"{len(model.bbox_head.fc_reg)} MIL stages")
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise
        raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = _state_dict(raw)
    prefix = branch + "."
    if not any(k.startswith(prefix) for k in sd):
        if not any(k.startswith("backbone.") for k in sd):
            raise KeyError(f"no '{prefix}*' keys in {path}; top-level keys look like "
                           f"{sorted(sd)[:3]}...")
        warnings.warn(f"checkpoint {path} has no '{prefix}*' keys; loading it as a bare "
                      f"detector state dict: the requested '{branch}' branch does not exist "
                      f"in this file", stacklevel=2)
        prefix = ""
    return _copy_into(model, sd, prefix, path, "detector")
