"""Host values on the device without a host sync.

A blocking copy from pageable host memory waits for the card, and a CUDA
graph cannot hold one. The train step therefore takes its small constant
tables from `constant` (made once per device, later uses read the kept
tensor) and its per-step host numbers through `to_device` or
`copy_from_host` (pinned memory, an asynchronous copy). On the CPU these
are plain tensors and copies.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor

_CONSTANTS: Dict[Tuple, Tuple[Tensor, Tensor]] = {}


def to_device(t: Tensor, device) -> Tensor:
    """The CPU tensor `t` on `device`: on a card copied from pinned memory
    without a host sync (the pinned buffer is held until the copy is done);
    elsewhere t.to(device)."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def copy_from_host(dst: Tensor, src: Tensor) -> Tensor:
    """dst.copy_(src); from a CPU tensor into a card's tensor through pinned
    memory, without a host sync. Returns dst."""
    if dst.device.type != "cuda" or src.device.type != "cpu":
        return dst.copy_(src)
    return dst.copy_(src.pin_memory(), non_blocking=True)


def constant(values, dtype: torch.dtype, device) -> Tensor:
    """torch.tensor(values, dtype) on `device`, made at its first use and
    kept (with its pinned source) for every later use. Callers must not
    write to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (repr(values), dtype, device)
    kept = _CONSTANTS.get(key)
    if kept is None:
        host = torch.tensor(values, dtype=dtype)
        if device.type == "cuda":
            host = host.pin_memory()
        kept = (host, host.to(device, non_blocking=True))
        _CONSTANTS[key] = kept
    return kept[1]
