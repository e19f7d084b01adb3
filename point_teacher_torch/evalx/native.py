"""ctypes binding of the native evaluation core's greedy COCO matching
(ccore/libptteval.so; the port's own copy of the part of
point_teacher_tpu/evalx/native.py that the HBB eval uses, host-side only).

Build once with `sh ccore/build.sh`; without the library the numpy matching
of cocoeval runs (`available()` says which one runs).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(os.path.dirname(__file__), "..", "..", "ccore", "libptteval.so")
    path = os.path.abspath(path)
    if os.path.exists(path):
        lib = ctypes.CDLL(path)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.match_greedy.argtypes = [f32p, i64, i64, u8p, ctypes.c_float, f32p, u8p]
        lib.match_greedy.restype = None
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _up(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def match_greedy(iou: np.ndarray, gt_ignore: np.ndarray, thr: float):
    """Returns (dt_iou [M], dt_ig [M] bool), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    m, n = iou.shape
    iou_c = np.ascontiguousarray(iou, np.float32)
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    dt_iou = np.empty(m, np.float32)
    dt_ig = np.empty(m, np.uint8)
    lib.match_greedy(_fp(iou_c), m, n, _up(gi), ctypes.c_float(thr), _fp(dt_iou),
                     _up(dt_ig))
    return dt_iou.astype(np.float64), dt_ig.astype(bool)
