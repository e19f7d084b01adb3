"""Load the JAX package's flax parameter tree into the port's modules (the
inverse of point_teacher_tpu/utils/torch_port.py, numpy only).

Conv kernels HWIO -> OIHW, Dense [I, O] -> [O, I], FrozenBN scale / bias /
mean / var -> weight / bias / running_mean / running_var, the FCOS Scale; for
StudentRotatedFCOS also the GroupNorm scale / bias of the head towers
(cls_gn{i}, reg_gn{i}), conv_angle and scale_angle; for RFLAFCOS (no PSAGG,
no MIL towers) the GroupNorm towers and the per-level scales, one flax
vector `scales` [L] into the reference's `scales.{i}.scale`.
The first MIL-tower Dense flattens roi features (H, W, C) in flax; the port
keeps the reference torch order (C, H, W), so its input rows are permuted.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ..models.mil_head import ROI


def _conv(tree) -> Dict[str, np.ndarray]:
    out = {"weight": np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in tree:
        out["bias"] = np.asarray(tree["bias"])
    return out


def _dense(tree) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(tree["kernel"]).T, "bias": np.asarray(tree["bias"])}


def _tower_fc0(tree) -> Dict[str, np.ndarray]:
    k = np.asarray(tree["kernel"])          # [H*W*C, O]
    o = k.shape[1]
    c = k.shape[0] // (ROI * ROI)
    w = k.T.reshape(o, ROI, ROI, c).transpose(0, 3, 1, 2).reshape(o, -1)
    return {"weight": w, "bias": np.asarray(tree["bias"])}


def _bn(tree) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(tree["scale"]), "bias": np.asarray(tree["bias"]),
            "running_mean": np.asarray(tree["mean"]), "running_var": np.asarray(tree["var"])}


def _entries(p: Dict[str, Any], num_stages: int) -> Iterator[Tuple[str, Dict[str, np.ndarray]]]:
    """(port module path, {param name: array}) for every module of the detector."""
    bb = p["backbone"]
    yield "backbone.conv1", _conv(bb["stem_conv"])
    yield "backbone.bn1", _bn(bb["stem_bn"])
    for name, block in bb.items():
        if not name.startswith("layer"):
            continue
        stage, idx = name[len("layer"):].split("_block")
        dst = f"backbone.layer{stage}.{idx}"
        for i in (1, 2, 3):
            yield f"{dst}.conv{i}", _conv(block[f"conv{i}"])
            yield f"{dst}.bn{i}", _bn(block[f"bn{i}"])
        if "downsample_conv" in block:
            yield f"{dst}.downsample.0", _conv(block["downsample_conv"])
            yield f"{dst}.downsample.1", _bn(block["downsample_bn"])
    neck = p["neck"]
    n_lat = sum(1 for k in neck if k.startswith("lateral"))
    for i in range(n_lat):
        yield f"neck.lateral_convs.{i}.conv", _conv(neck[f"lateral{i}"])
        yield f"neck.fpn_convs.{i}.conv", _conv(neck[f"fpn_conv{i}"])
    for i in range(sum(1 for k in neck if k.startswith("extra_conv"))):
        yield f"neck.fpn_convs.{n_lat + i}.conv", _conv(neck[f"extra_conv{i}"])
    for name, tree in p.get("neck_agg", {}).items():
        yield f"neck_agg.lateral_convs.{name[len('agg_conv'):]}.conv", _conv(tree)
    head = p["bbox_head"]
    for name, tree in head.items():
        if name.startswith(("cls_conv", "reg_conv")):
            side, i = name[:3], name[len("cls_conv"):]
            yield f"bbox_head.{side}_convs.{i}.conv", _conv(tree)
        elif name.startswith(("cls_gn", "reg_gn")):
            side, i = name[:3], name[len("cls_gn"):]
            yield f"bbox_head.{side}_convs.{i}.gn", {"weight": np.asarray(tree["scale"]),
                                                     "bias": np.asarray(tree["bias"])}
        elif name.startswith("conv_"):
            yield f"bbox_head.{name}", _conv(tree)
    if "scales" in head:
        for i, scale in enumerate(np.asarray(head["scales"])):
            yield f"bbox_head.scales.{i}", {"scale": np.asarray(scale)}
    else:
        yield "bbox_head.scales.0", {"scale": np.asarray(head["scale"])}
    if "scale_angle" in head:
        yield "bbox_head.scale_angle", {"scale": np.asarray(head["scale_angle"])}
    if "mil_head" not in p:
        return
    mil = p["mil_head"]
    for s in range(num_stages):
        for tower, dst in ((f"reg_tower{s}", "shared_fcs_reg"), (f"bag_tower{s}", "shared_fcs_bag")):
            yield f"bbox_head.{dst}.{s}.0", _tower_fc0(mil[tower]["fc0"])
            yield f"bbox_head.{dst}.{s}.1", _dense(mil[tower]["fc1"])
        for fc in ("fc_reg", "fc_cls", "fc_ins"):
            yield f"bbox_head.{fc}.{s}", _dense(mil[f"{fc}{s}"])


def port_arrays(params: Dict[str, Any], num_stages: int = 1) -> Dict[str, np.ndarray]:
    """A flax StudentFCOS, StudentRotatedFCOS or RFLAFCOS tree (`{"params": ...}` or its
    inner dict, leaves array-like) as {port parameter name: array in the
    port's layout}."""
    p = params.get("params", params)
    return {f"{path}.{name}": value
            for path, leaves in _entries(p, num_stages) for name, value in leaves.items()}


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy a flax StudentFCOS / StudentRotatedFCOS / RFLAFCOS tree into
    `model` in place. Every port parameter must be filled."""
    own = dict(model.named_parameters())
    filled = set()
    num_stages = len(getattr(model.bbox_head, "fc_reg", ()))
    for key, value in port_arrays(params, num_stages).items():
        if key not in own:
            raise KeyError(f"flax leaf maps to unknown port parameter {key}")
        dst = own[key]
        if tuple(dst.shape) != value.shape:
            raise ValueError(f"{key}: port {tuple(dst.shape)} vs flax {value.shape}")
        dst.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
        filled.add(key)
    missing = sorted(set(own) - filled)
    if missing:
        raise KeyError(f"port parameters not filled from the flax tree: {missing[:5]}")
    return model
