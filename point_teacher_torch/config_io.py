"""Config resolution and dotted overrides (the port's counterpart of
point_teacher_tpu/config_io.py).

The repository's config files import the JAX package, so the port does not
execute them: it resolves a config path by its file stem to its own copy of
that file's dict, and applies `--cfg-options` dotted overrides to the result:

  aitodv2_point_teacher_0 -> dict(pt=config_0pct(), dataset=<AI-TOD-v2>, model=<R50 caffe>,
                                  work_dir=...)
  aitodv2_point_teacher_{30,60,100} -> the same with pt=config_noisy(position=0.3 / 0.6 / 1.0)
  aitodv2_fcos_r50_1x -> the same as _0 with trainer="fcos" (the box-supervised FCOS)
  aitodv2_rfla_fcos_1x -> the same as _0 with trainer="rfla_fcos" (the RFLA-FCOS baseline)
  sodaa_point_teacher_1x -> dict(pt=config_sodaa(), rotated=True, dataset=<SODA-A>,
                                 model=<R50 pytorch>, work_dir=...)

<AI-TOD-v2> is the config files' COCO-format dataset: the train and val
annotation files and image folders under data/AI-TOD-v2/, relative to the
working directory (`--cfg-options dataset.train_ann=... dataset.val_ann=...`
moves them). <SODA-A> is the SODA-A config file's dataset dict: the
per-patch annotation and image folders of the divData layout (`train_ann`,
`train_img_prefix`, `val_ann`, `val_img_prefix`), the original images'
annotations (`ori_val_ann`) that the patch-merge eval scores against, and
the ImageNet normalisation (`img_norm`). `model` holds the backbone's depth
and style; `model.pretrained=PATH` (a torchvision-layout ResNet-50 .pth)
initialises the backbone of a training run.
"""
from __future__ import annotations

import ast
import os
from typing import Any, Dict, List

from .train.config import config_0pct, config_noisy, config_sodaa


def _aitod():
    return dict(
        type="AITODDataset",
        train_ann="data/AI-TOD-v2/annotations/aitodv2_train.json",
        train_img_prefix="data/AI-TOD-v2/train/",
        val_ann="data/AI-TOD-v2/annotations/aitodv2_val.json",
        val_img_prefix="data/AI-TOD-v2/val/",
    )


def _aitod_cfg(pt, name: str, **extra):
    return dict(pt=pt, dataset=_aitod(),
                model=dict(num_classes=8, depth=50, backbone_style="caffe"),
                work_dir=f"work_dirs/{name}", **extra)


def _sodaa():
    return dict(
        type="SODAADataset",
        train_ann="data/SODA-A/divData/train/Annotations/",
        train_img_prefix="data/SODA-A/divData/train/Images/",
        val_ann="data/SODA-A/divData/val/Annotations/",
        val_img_prefix="data/SODA-A/divData/val/Images/",
        ori_val_ann="data/SODA-A/rawData/val/Annotations",
        img_norm=dict(mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
                      to_rgb=True),
    )


_CONFIGS = {
    "aitodv2_point_teacher_0": lambda: _aitod_cfg(config_0pct(), "aitodv2_point_teacher_0"),
    "aitodv2_point_teacher_30": lambda: _aitod_cfg(config_noisy(position=0.3),
                                                   "aitodv2_point_teacher_30"),
    "aitodv2_point_teacher_60": lambda: _aitod_cfg(config_noisy(position=0.6),
                                                   "aitodv2_point_teacher_60"),
    "aitodv2_point_teacher_100": lambda: _aitod_cfg(config_noisy(position=1.0),
                                                    "aitodv2_point_teacher_100"),
    "aitodv2_fcos_r50_1x": lambda: _aitod_cfg(config_0pct(), "aitodv2_fcos_r50_1x",
                                              trainer="fcos"),
    "aitodv2_rfla_fcos_1x": lambda: _aitod_cfg(config_0pct(), "aitodv2_rfla_fcos_1x",
                                               trainer="rfla_fcos"),
    "sodaa_point_teacher_1x": lambda: dict(
        pt=config_sodaa(), rotated=True, dataset=_sodaa(),
        model=dict(num_classes=9, depth=50, backbone_style="pytorch"),
        work_dir="work_dirs/sodaa_point_teacher_1x"),
}


def load_config(path: str) -> Dict[str, Any]:
    stem = os.path.splitext(os.path.basename(path))[0]
    if stem not in _CONFIGS:
        raise ValueError(f"no port config for {stem!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[stem]()


def _parse_value(s: str):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _set_dotted(obj, keys: List[str], value):
    key = keys[0]
    if len(keys) > 1:
        child = obj[key] if isinstance(obj, dict) else getattr(obj, key)
        value = _set_dotted(child, keys[1:], value)
    if isinstance(obj, dict):
        obj[key] = value
        return obj
    if hasattr(obj, "_replace"):  # NamedTuple
        return obj._replace(**{key: value})
    setattr(obj, key, value)
    return obj


def apply_overrides(cfg: Dict[str, Any], options: List[str]) -> Dict[str, Any]:
    for opt in options or []:
        if "=" not in opt:
            raise ValueError(f"--cfg-options entries must be key=value, got {opt!r}")
        key, value = opt.split("=", 1)
        cfg = _set_dotted(cfg, key.split("."), _parse_value(value))
    return cfg
