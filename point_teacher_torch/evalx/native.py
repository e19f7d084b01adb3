"""ctypes bindings of the native evaluation core (ccore/libptteval.so; the
port's own copy of point_teacher_tpu/evalx/native.py, host-side only): the
greedy COCO matching, the rotated IoU and the rotated NMS.

Build once with `sh ccore/build.sh`; without the library the numpy versions
run (cocoeval's matching, evalx/rgeometry.py), and `available()` says which
one runs.
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
        lib.rbox_iou.argtypes = [f32p, i64, f32p, i64, f32p]
        lib.rbox_iou.restype = None
        lib.nms_rotated.argtypes = [f32p, f32p, i64, ctypes.c_float, u8p]
        lib.nms_rotated.restype = None
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


def rbox_iou(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Pairwise rotated IoU [M, 5] x [N, 5] -> [M, N] f64: native in f32, or
    rgeometry.rbox_iou_np without the library."""
    lib = _load()
    if lib is None or len(d) == 0 or len(g) == 0:
        from .rgeometry import rbox_iou_np
        return rbox_iou_np(d, g)
    d = np.ascontiguousarray(d[:, :5], np.float32)
    g = np.ascontiguousarray(g[:, :5], np.float32)
    out = np.empty((len(d), len(g)), np.float32)
    lib.rbox_iou(_fp(d), len(d), _fp(g), len(g), _fp(out))
    return out.astype(np.float64)


def nms_rotated(rboxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy rotated NMS -> kept indices in descending score order: native,
    or rgeometry.nms_rotated_np without the library."""
    lib = _load()
    if lib is None:
        from .rgeometry import nms_rotated_np
        return nms_rotated_np(rboxes, scores, iou_thr)
    rb = np.ascontiguousarray(rboxes[:, :5], np.float32)
    sc = np.ascontiguousarray(scores, np.float32)
    keep = np.empty(len(rb), np.uint8)
    lib.nms_rotated(_fp(rb), _fp(sc), len(rb), ctypes.c_float(iou_thr), _up(keep))
    idx = np.nonzero(keep)[0]
    order = np.argsort(-sc[idx], kind="stable")
    return idx[order]
