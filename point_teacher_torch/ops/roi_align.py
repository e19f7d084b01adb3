"""Horizontal RoIAlign: the CUDA kernels of csrc/roi_align.cu, their plain
PyTorch version, and the dispatcher the MIL stage calls.

Counterpart of point_teacher_tpu/ops/roi_align.py (roi_align_matmul,
_axis_weights, _axis_rel_weights) and ops/roi_align_pallas.py (the Pallas
forward and d/dfeat kernels). Layout as in the reference: feat [B, H, W, C]
(NHWC), rois [B, N, 4] xyxy in image pixels, pooled [B, N, 7, 7, C]; stride
8, aligned=True, mmcv adaptive sampling clamped at ADAPTIVE_SMAX samples per
bin per axis.

Optional per-roi clamp bounds `clamp` [B, N, 4] int32 hold (y_lo, y_hi, x_lo,
x_hi) in feature cells: sample coordinates are clamped into [lo, hi] instead
of [0, size - 1], while the border rule is still checked against the true
map. With the bounds of a group window this is the reference's grouped
window pool (roi_align_grouped_from_windows) exactly; without, it is
roi_align_matmul.

On a CPU tensor `roi_align` takes the plain version; on a CUDA tensor it
launches the kernels or raises. The forward kernel reads and writes 16-byte
vectors of 8 channels, so on the card C must be a multiple of 8 (ValueError
otherwise); the plain version takes any C. The kernels are compiled with
nvcc at first use into build/point_teacher_torch/ and loaded with ctypes.
The backward with clamp bounds runs the windowed kernel, which sums the rois
that share one window in shared memory; without them (the whole map) it runs
the atomic kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.device import constant
from . import _cuda_build

Tensor = torch.Tensor

OUT_SIZE = 7
ADAPTIVE_SMAX = 4
SPATIAL_SCALE = 1.0 / 8
PLAIN_CHUNK = 256  # rois per einsum of the plain version (bounds its intermediate)

SOURCE = _cuda_build.CSRC / "roi_align.cu"
LIBRARY = _cuda_build.BUILD_DIR / "libroi_align.so"

# Kernel launches since the last reset_launch_counts(); the wrappers add one
# where they launch a kernel and nowhere else. launches_bwd counts the
# windowed backward, launches_bwd_atomic the atomic one.
launches_fwd = 0
launches_bwd = 0
launches_bwd_atomic = 0

_lib = None


def reset_launch_counts() -> None:
    global launches_fwd, launches_bwd, launches_bwd_atomic
    launches_fwd = 0
    launches_bwd = 0
    launches_bwd_atomic = 0


def launch_counts() -> dict:
    return {"fwd": launches_fwd, "bwd": launches_bwd, "bwd_atomic": launches_bwd_atomic}


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _roi_geometry(rois: Tensor):
    """rois [..., 4] image px -> (x1, y1, bin_w, bin_h) in feature cells."""
    r = rois * SPATIAL_SCALE
    x1, y1, x2, y2 = r.unbind(-1)
    # divide by a tensor: PyTorch's CUDA division by a python scalar multiplies
    # by its reciprocal, which moves sample positions by an ulp against the
    # kernels and the CPU
    out = torch.full_like(x1, float(OUT_SIZE))
    bin_w = (x2 - x1).clamp(min=1e-6) / out
    bin_h = (y2 - y1).clamp(min=1e-6) / out
    return x1, y1, bin_w, bin_h


def _axis_weights(start: Tensor, bin_sz: Tensor, size: int, lo: Tensor, hi: Tensor) -> Tensor:
    """Per-roi hat-weight matrices [..., OUT_SIZE, size] for one axis (f32).

    `_axis_weights` of the reference, with the sample clamp generalised from
    [0, size - 1] to the per-roi bounds [lo, hi] (`_axis_rel_weights` written
    in absolute cells)."""
    dev = start.device
    sn = torch.ceil(bin_sz).clamp(1, ADAPTIVE_SMAX)                      # [...]
    k = torch.arange(ADAPTIVE_SMAX, device=dev, dtype=torch.float32)
    offs = (k + 0.5) / sn[..., None]                                     # [..., smax]
    mask = k < sn[..., None]
    bins = torch.arange(OUT_SIZE, device=dev, dtype=torch.float32)
    frac = bins[:, None] + offs[..., None, :]                            # [..., out, smax]
    coords = start[..., None, None] + frac * bin_sz[..., None, None] - 0.5
    valid = (coords >= -1.0) & (coords <= float(size)) & mask[..., None, :]
    c = torch.minimum(torch.maximum(coords, lo[..., None, None]), hi[..., None, None])
    cells = torch.arange(size, device=dev, dtype=torch.float32)
    w = (1.0 - (c[..., None] - cells).abs()).clamp(min=0.0) * valid[..., None]
    return w.sum(-2) / sn[..., None, None]


def roi_align_plain(feat: Tensor, rois: Tensor, clamp: Optional[Tensor] = None) -> Tensor:
    """The plain version: hat-weight matrices and the two-einsum contraction
    of roi_align_matmul, chunked over rois. Weights are built in f32 and
    cast to the feature dtype; the einsums run in the feature dtype, like the
    reference. Differentiable w.r.t. feat by autograd."""
    b, h, w, c = feat.shape
    n = rois.shape[1]
    x1, y1, bin_w, bin_h = _roi_geometry(rois.float())
    if clamp is None:
        y_lo = x_lo = torch.zeros_like(x1)
        y_hi = torch.full_like(y1, h - 1.0)
        x_hi = torch.full_like(x1, w - 1.0)
    else:
        y_lo, y_hi, x_lo, x_hi = clamp.float().unbind(-1)
    outs = []
    for s in range(0, n, PLAIN_CHUNK):
        sl = slice(s, s + PLAIN_CHUNK)
        wy = _axis_weights(y1[:, sl], bin_h[:, sl], h, y_lo[:, sl], y_hi[:, sl]).to(feat.dtype)
        wx = _axis_weights(x1[:, sl], bin_w[:, sl], w, x_lo[:, sl], x_hi[:, sl]).to(feat.dtype)
        tmp = torch.einsum("bnih,bhwc->bniwc", wy, feat)
        outs.append(torch.einsum("bnjw,bniwc->bnijc", wx, tmp))
    if not outs:
        return feat.new_zeros((b, 0, OUT_SIZE, OUT_SIZE, c))
    return torch.cat(outs, 1)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def build(ptxas_verbose: bool = False) -> str:
    """Compile csrc/roi_align.cu into LIBRARY unless it is newer than the
    source. Returns nvcc's output (with -Xptxas -v: registers and spills)."""
    return _cuda_build.build(SOURCE, LIBRARY, ptxas_verbose)


def _library():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        for fn in (lib.pt_roi_align_fwd, lib.pt_roi_align_bwd, lib.pt_roi_align_bwd_windowed):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        for fn in (lib.pt_roi_align_fwd_info, lib.pt_roi_align_bwd_windowed_info):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launch(fn_name: str, src: Tensor, rois: Tensor, clamp: Optional[Tensor], dst: Tensor,
            b: int, h: int, w: int, c: int, n: int) -> None:
    fn = getattr(_library(), fn_name)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(src.data_ptr(), rois.data_ptr(), None if clamp is None else clamp.data_ptr(),
                dst.data_ptr(), _DTYPE_CODE[src.dtype], b, h, w, c, n, SPATIAL_SCALE, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed with CUDA error {rc}")


def fwd_layout() -> dict:
    """The forward kernel's launch layout and resources on the current card."""
    return _cuda_build.fwd_layout(_library().pt_roi_align_fwd_info, "pt_roi_align_fwd_info")


def windowed_layout() -> dict:
    """The windowed backward's tile and launch layout on the current card."""
    info = (ctypes.c_int * 7)()
    rc = _library().pt_roi_align_bwd_windowed_info(info)
    if rc != 0:
        raise RuntimeError(f"pt_roi_align_bwd_windowed_info failed with CUDA error {rc}")
    keys = ("rois_per_item", "tile_cells", "channels_per_block", "threads",
            "dynamic_smem_bytes", "blocks_per_sm", "grid_blocks")
    return dict(zip(keys, info))


def bwd_windowed(dout: Tensor, rois: Tensor, clamp: Tensor, feat_shape) -> Tensor:
    """d/dfeat [B, H, W, C] f32 of the pool with clamp bounds, by the
    windowed kernel: dout [B, N, 7, 7, C] contiguous, in feat's dtype."""
    global launches_bwd
    if rois.data_ptr() % 16 or clamp.data_ptr() % 16:
        raise ValueError("the windowed backward reads rois and clamp bounds 16 bytes a roi: "
                         "both must be 16-byte aligned")
    b, h, w, c = feat_shape
    dfeat = torch.zeros((b, h, w, c), device=dout.device, dtype=torch.float32)
    _launch("pt_roi_align_bwd_windowed", dout, rois, clamp, dfeat, b, h, w, c, rois.shape[1])
    launches_bwd += 1
    return dfeat


def bwd_atomic(dout: Tensor, rois: Tensor, clamp: Optional[Tensor], feat_shape) -> Tensor:
    """d/dfeat [B, H, W, C] f32 by the atomic kernel (one atomicAdd per tap
    and channel); clamp may be None (the whole map)."""
    global launches_bwd_atomic
    b, h, w, c = feat_shape
    dfeat = torch.zeros((b, h, w, c), device=dout.device, dtype=torch.float32)
    _launch("pt_roi_align_bwd", dout, rois, clamp, dfeat, b, h, w, c, rois.shape[1])
    launches_bwd_atomic += 1
    return dfeat


class RoIAlignFunction(torch.autograd.Function):
    """RoIAlign through the CUDA kernels; gradient w.r.t. feat only."""

    @staticmethod
    def forward(ctx, feat: Tensor, rois: Tensor, clamp: Optional[Tensor]):
        global launches_fwd
        if rois.requires_grad:
            raise ValueError("roi_align pools stop-gradient boxes: detach rois")
        b, h, w, c = feat.shape
        n = rois.shape[1]
        out = torch.empty((b, n, OUT_SIZE, OUT_SIZE, c), device=feat.device, dtype=feat.dtype)
        _launch("pt_roi_align_fwd", feat, rois, clamp, out, b, h, w, c, n)
        launches_fwd += 1
        ctx.save_for_backward(rois, clamp)
        ctx.feat_shape = (b, h, w, c)
        ctx.feat_dtype = feat.dtype
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        rois, clamp = ctx.saved_tensors
        dout = dout.to(ctx.feat_dtype).contiguous()
        bwd = bwd_atomic if clamp is None else bwd_windowed
        dfeat = bwd(dout, rois, clamp, ctx.feat_shape)
        return dfeat.to(ctx.feat_dtype), None, None


def _check(feat: Tensor, rois: Tensor, clamp: Optional[Tensor]) -> None:
    if feat.dim() != 4:
        raise ValueError(f"feat must be [B, H, W, C], got {tuple(feat.shape)}")
    if feat.dtype not in _DTYPE_CODE:
        raise TypeError(f"feat dtype {feat.dtype} not supported (float32, bfloat16)")
    b = feat.shape[0]
    if rois.dim() != 3 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"rois must be [B={b}, N, 4], got {tuple(rois.shape)}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if rois.requires_grad:
        raise ValueError("roi_align pools stop-gradient boxes: detach rois")
    tensors = [feat, rois]
    if clamp is not None:
        if clamp.shape != rois.shape or clamp.dtype != torch.int32:
            raise ValueError("clamp must be int32 with the shape of rois")
        tensors.append(clamp)
    if any(t.device != feat.device for t in tensors):
        raise ValueError("feat, rois and clamp must be on one device")
    if feat.device.type == "cuda":
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("roi_align's CUDA kernels take contiguous tensors")
        _cuda_build.check_vectors(feat, "roi_align")


def roi_align(feat: Tensor, rois: Tensor, clamp: Optional[Tensor] = None) -> Tensor:
    """feat [B, H, W, C], rois [B, N, 4] (stop-gradient), clamp [B, N, 4] int32
    or None -> pooled [B, N, 7, 7, C] in feat's dtype."""
    _check(feat, rois, clamp)
    if feat.device.type == "cpu":
        return roi_align_plain(feat, rois, clamp)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_align runs on cpu or cuda, not {feat.device}")
    return RoIAlignFunction.apply(feat, rois, clamp)


def group_window_origins(centers: Tensor, feat_hw, window: int) -> tuple:
    """Window origins (wy0, wx0) in feature cells of `extract_group_windows`:
    floor(c / 8 - win / 2) clamped to [0, size - win], win = min(window, H, W).
    centers [..., 2] (cx, cy) in image px; returns int32 tensors and win."""
    h, w = feat_hw
    win = min(window, h, w)
    cx = centers[..., 0] * SPATIAL_SCALE
    cy = centers[..., 1] * SPATIAL_SCALE
    wy0 = torch.floor(cy - win / 2).clamp(0, max(h - win, 0)).to(torch.int32)
    wx0 = torch.floor(cx - win / 2).clamp(0, max(w - win, 0)).to(torch.int32)
    return wy0, wx0, win


def window_clamp(wy0: Tensor, wx0: Tensor, win: int, feat_hw) -> Tensor:
    """Clamp bounds [..., 4] int32 (y_lo, y_hi, x_lo, x_hi) of group windows."""
    h, w = feat_hw
    return torch.stack([wy0, (wy0 + win - 1).clamp(max=h - 1),
                        wx0, (wx0 + win - 1).clamp(max=w - 1)], -1).to(torch.int32)


def full_map_clamp(shape, feat_hw, device) -> Tensor:
    """Clamp bounds [*shape, 4] int32 of the whole map (the unclamped pool)."""
    h, w = feat_hw
    return constant([0, h - 1, 0, w - 1], torch.int32, device).expand(*shape, 4)
