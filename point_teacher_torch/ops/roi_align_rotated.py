"""Rotated RoIAlign: the CUDA kernels of csrc/roi_align_rotated.cu, their
plain PyTorch version, and the dispatcher the rotated MIL stage calls.

Counterpart of point_teacher_tpu/ops/roi_align.py roi_align_rotated_matmul,
extract_group_windows + roi_align_rotated_grouped_from_windows and
roi_align_rotated, and of ops/rroi_pallas.py (rotated_window_weights and the
Pallas forward and d/dfeat kernels). Layout as in the reference: feat
[B, H, W, C] (NHWC), rrois [B, N, 5] (cx, cy, w, h, a) in image pixels
(mmcv RoIAlignRotated, clockwise), pooled [B, N, 7, 7, C]; stride 8,
sampling_ratio 2, each bin the mean of its 2 x 2 bilinear samples.

Every reference function is one set of per-roi clamp bounds `clamp`
[B, N, 4] int32 (y_lo, y_hi, x_lo, x_hi) in feature cells: sample
coordinates are clamped into [lo, hi] instead of [0, size - 1], while the
border rule is still checked against the true map.

  reference                                   bounds (see the helpers below)
  roi_align_rotated_matmul(window)            roi_window_clamp: a window on the roi's centre
  grouped_from_windows(extract_group_windows) roi_align.window_clamp of the group centre
  roi_align_rotated_pallas                    pallas_window_clamp: 16 x 32 cells, x 8-aligned
  roi_align_rotated (exact gather)            None: the whole map

Sample offsets and weights are built in f32 whatever the feature dtype, as
the Pallas kernel builds them (the XLA path builds them in the feature
dtype, so in bf16 the two differ by the rounding of the offsets).

On a CPU tensor `roi_align_rotated` takes the plain version; on a CUDA
tensor it launches the kernels or raises. The forward kernel reads and
writes 16-byte vectors of 8 channels, so on the card C must be a multiple of
8 (ValueError otherwise); the plain version takes any C. The kernels are
compiled with nvcc at first use into build/point_teacher_torch/ and loaded
with ctypes. The backward with clamp bounds runs the windowed kernel, which
sums the rois that share one window in shared memory; without them (the
whole map) it runs the atomic kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda_build
from .roi_align import SPATIAL_SCALE

Tensor = torch.Tensor

OUT_SIZE = 7
SAMPLING_RATIO = 2
SAMPLES = OUT_SIZE * SAMPLING_RATIO     # per axis
PALLAS_WIN_Y, PALLAS_WIN_X = 16, 32     # the Pallas kernel's window (cells)
PLAIN_BUDGET = 1 << 29                  # bytes of one chunk's intermediates (plain version)

SOURCE = _cuda_build.CSRC / "roi_align_rotated.cu"
LIBRARY = _cuda_build.BUILD_DIR / "libroi_align_rotated.so"

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
# clamp bounds of the reference's windows
# --------------------------------------------------------------------------

def roi_window_clamp(rrois: Tensor, feat_hw, window: int) -> Tensor:
    """Bounds of roi_align_rotated_matmul's per-roi window: `window` cells
    (at most the map) from floor(c - window / 2) of the roi's own centre,
    clamped inside the map. rrois [..., 5] -> [..., 4] int32."""
    h, w = feat_hw
    win = min(window, h, w)
    cx = rrois[..., 0] * SPATIAL_SCALE
    cy = rrois[..., 1] * SPATIAL_SCALE
    wy0 = torch.floor(cy - win / 2).clamp(0, max(h - win, 0))
    wx0 = torch.floor(cx - win / 2).clamp(0, max(w - win, 0))
    return torch.stack([wy0, (wy0 + win - 1).clamp(max=h - 1),
                        wx0, (wx0 + win - 1).clamp(max=w - 1)], -1).to(torch.int32)


def pallas_window_clamp(rrois: Tensor, feat_hw) -> Tensor:
    """Bounds of the Pallas kernel's window (rotated_window_weights): 16 rows
    from floor(cy - 8), 32 columns from an 8-aligned floor(cx - 8), over the
    map padded to a multiple of 8 columns. rrois [..., 5] -> [..., 4] int32."""
    h, w = feat_hw
    wp = -(-w // 8) * 8
    cx = rrois[..., 0] * SPATIAL_SCALE
    cy = rrois[..., 1] * SPATIAL_SCALE
    wy0 = torch.floor(cy - PALLAS_WIN_Y / 2).clamp(0, max(h - PALLAS_WIN_Y, 0))
    wx0 = torch.floor(cx - 8.0).clamp(0, max(wp - PALLAS_WIN_X, 0))
    wx0 = torch.div(wx0, 8, rounding_mode="floor") * 8
    return torch.stack([wy0, (wy0 + PALLAS_WIN_Y - 1).clamp(max=h - 1),
                        wx0, (wx0 + PALLAS_WIN_X - 1).clamp(max=w - 1)], -1).to(torch.int32)


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _sample_fracs(device) -> Tensor:
    """Box-frame fractions [14] of the samples along one axis,
    ((bin + (k + 0.5) / 2) / 7 - 0.5), divided by a tensor: PyTorch's CUDA
    division by a python scalar multiplies by the reciprocal."""
    k = torch.arange(SAMPLING_RATIO, dtype=torch.float32, device=device)
    offs = (k + 0.5) / torch.full_like(k, float(SAMPLING_RATIO))
    bins = torch.arange(OUT_SIZE, dtype=torch.float32, device=device)
    f = bins[:, None] + offs[None, :]
    return (f / torch.full_like(f, float(OUT_SIZE)) - 0.5).reshape(-1)


def _sample_coords(rrois: Tensor, cos_sin: Tensor):
    """Absolute sample coordinates (sx, sy) [..., 14 (y), 14 (x)] in cells."""
    r = rrois * SPATIAL_SCALE
    cx, cy, bw, bh = (r[..., i, None, None] for i in range(4))
    cos, sin = cos_sin[..., 0, None, None], cos_sin[..., 1, None, None]
    frac = _sample_fracs(rrois.device)
    bx = frac[None, :] * bw
    by = frac[:, None] * bh
    sx = cos * bx - sin * by + cx - 0.5
    sy = sin * bx + cos * by + cy - 0.5
    return sx, sy


def _hat(coord: Tensor, lo: Tensor, hi: Tensor, n: int) -> Tensor:
    """Bilinear hat weights [..., n] over the n window cells starting at lo,
    after clamping coord into [lo, hi] (absolute cells)."""
    c = torch.minimum(torch.maximum(coord, lo), hi) - lo
    k = torch.arange(n, dtype=torch.float32, device=coord.device)
    return (1.0 - (c[..., None] - k).abs()).clamp(min=0.0)


def roi_align_rotated_plain(feat: Tensor, rrois: Tensor, clamp: Optional[Tensor] = None) -> Tensor:
    """The plain version: per-sample hat weights under the clamp bounds,
    contracted with each roi's window of the map (roi_align_rotated_matmul's
    arithmetic, the window generalised to the bounds), chunked over rois.
    Weights and the contraction are f32; the result is cast to feat's dtype.
    Differentiable w.r.t. feat by autograd."""
    b, h, w, c = feat.shape
    n = rrois.shape[1]
    if n == 0:
        return feat.new_zeros((b, 0, OUT_SIZE, OUT_SIZE, c))
    if clamp is None:
        clamp = torch.tensor([0, h - 1, 0, w - 1], dtype=torch.int32,
                             device=feat.device).expand(b, n, 4)
    sx, sy = _sample_coords(rrois, _cos_sin(rrois))
    valid = (sx >= -1.0) & (sx <= float(w)) & (sy >= -1.0) & (sy <= float(h))
    bounds = clamp.float()
    y_lo, y_hi, x_lo, x_hi = (bounds[..., i, None, None] for i in range(4))
    win_y = int((clamp[..., 1] - clamp[..., 0]).max()) + 1
    win_x = int((clamp[..., 3] - clamp[..., 2]).max()) + 1
    # zero rows/columns past the map: a window that starts near the far edge
    # reads them with weight 0
    fpad = torch.nn.functional.pad(feat, (0, 0, 0, win_x, 0, win_y))
    ky = torch.arange(win_y, device=feat.device)
    kx = torch.arange(win_x, device=feat.device)
    bidx = torch.arange(b, device=feat.device)[:, None, None, None]
    chunk = max(1, PLAIN_BUDGET // (win_y * win_x * (SAMPLES * SAMPLES + c) * 4 * b))
    outs = []
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        hy = _hat(sy[:, sl], y_lo[:, sl], y_hi[:, sl], win_y) * valid[:, sl, ..., None]
        hx = _hat(sx[:, sl], x_lo[:, sl], x_hi[:, sl], win_x)
        wgt = (hy[..., :, None] * hx[..., None, :]).reshape(
            b, hy.shape[1], SAMPLES * SAMPLES, win_y * win_x)
        rows = clamp[:, sl, 0, None].long() + ky                       # [B, n, win_y]
        cols = clamp[:, sl, 2, None].long() + kx                       # [B, n, win_x]
        window = fpad[bidx, rows[..., :, None], cols[..., None, :]].float()
        pooled = torch.einsum("bnsp,bnpc->bnsc", wgt, window.reshape(b, -1, win_y * win_x, c))
        pooled = pooled.reshape(b, -1, OUT_SIZE, SAMPLING_RATIO, OUT_SIZE, SAMPLING_RATIO, c)
        outs.append(pooled.mean((3, 5)).to(feat.dtype))
    return torch.cat(outs, 1)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def build(ptxas_verbose: bool = False) -> str:
    """Compile csrc/roi_align_rotated.cu into LIBRARY unless it is newer than
    the source. Returns nvcc's output (with -Xptxas -v: registers and spills)."""
    return _cuda_build.build(SOURCE, LIBRARY, ptxas_verbose)


def _library():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        for fn in (lib.pt_roi_align_rotated_fwd, lib.pt_roi_align_rotated_bwd,
                   lib.pt_roi_align_rotated_bwd_windowed):
            fn.argtypes = [ctypes.c_void_p] * 5 + tail
            fn.restype = ctypes.c_int
        for fn in (lib.pt_roi_align_rotated_fwd_info, lib.pt_roi_align_rotated_bwd_windowed_info):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launch(fn_name: str, tensors, b: int, h: int, w: int, c: int, n: int) -> None:
    """Launch `fn_name` on the current stream; `tensors` are its pointer
    arguments (None for a null clamp), the first one giving the dtype."""
    src = tensors[0]
    fn = getattr(_library(), fn_name)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(*[None if t is None else t.data_ptr() for t in tensors],
                _DTYPE_CODE[src.dtype], b, h, w, c, n, SPATIAL_SCALE, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed with CUDA error {rc}")


def fwd_layout() -> dict:
    """The forward kernel's launch layout and resources on the current card."""
    return _cuda_build.fwd_layout(_library().pt_roi_align_rotated_fwd_info,
                                  "pt_roi_align_rotated_fwd_info")


def windowed_layout() -> dict:
    """The windowed backward's tile and launch layout on the current card."""
    info = (ctypes.c_int * 6)()
    rc = _library().pt_roi_align_rotated_bwd_windowed_info(info)
    if rc != 0:
        raise RuntimeError(f"pt_roi_align_rotated_bwd_windowed_info failed with CUDA error {rc}")
    keys = ("rois_per_block", "tile_cells", "channels_per_block", "threads",
            "dynamic_smem_bytes", "blocks_per_sm")
    return dict(zip(keys, info))


def bwd_windowed(dout: Tensor, rrois: Tensor, cos_sin: Tensor, clamp: Tensor,
                 feat_shape) -> Tensor:
    """d/dfeat [B, H, W, C] f32 of the pool with clamp bounds, by the
    windowed kernel: dout [B, N, 7, 7, C] contiguous, in feat's dtype."""
    global launches_bwd
    b, h, w, c = feat_shape
    dfeat = torch.zeros((b, h, w, c), device=dout.device, dtype=torch.float32)
    _launch("pt_roi_align_rotated_bwd_windowed", [dout, rrois, cos_sin, clamp, dfeat],
            b, h, w, c, rrois.shape[1])
    launches_bwd += 1
    return dfeat


def bwd_atomic(dout: Tensor, rrois: Tensor, cos_sin: Tensor, clamp: Optional[Tensor],
               feat_shape) -> Tensor:
    """d/dfeat [B, H, W, C] f32 by the atomic kernel (one atomicAdd per tap
    and channel); clamp may be None (the whole map)."""
    global launches_bwd_atomic
    b, h, w, c = feat_shape
    dfeat = torch.zeros((b, h, w, c), device=dout.device, dtype=torch.float32)
    _launch("pt_roi_align_rotated_bwd", [dout, rrois, cos_sin, clamp, dfeat],
            b, h, w, c, rrois.shape[1])
    launches_bwd_atomic += 1
    return dfeat


class RoIAlignRotatedFunction(torch.autograd.Function):
    """Rotated RoIAlign through the CUDA kernels; gradient w.r.t. feat only."""

    @staticmethod
    def forward(ctx, feat: Tensor, rrois: Tensor, cos_sin: Tensor, clamp: Optional[Tensor]):
        global launches_fwd
        if rrois.requires_grad:
            raise ValueError("roi_align_rotated pools stop-gradient boxes: detach rrois")
        b, h, w, c = feat.shape
        n = rrois.shape[1]
        out = torch.empty((b, n, OUT_SIZE, OUT_SIZE, c), device=feat.device, dtype=feat.dtype)
        _launch("pt_roi_align_rotated_fwd", [feat, rrois, cos_sin, clamp, out], b, h, w, c, n)
        launches_fwd += 1
        ctx.save_for_backward(rrois, cos_sin, clamp)
        ctx.feat_shape = (b, h, w, c)
        ctx.feat_dtype = feat.dtype
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        rrois, cos_sin, clamp = ctx.saved_tensors
        dout = dout.to(ctx.feat_dtype).contiguous()
        bwd = bwd_atomic if clamp is None else bwd_windowed
        dfeat = bwd(dout, rrois, cos_sin, clamp, ctx.feat_shape)
        return dfeat.to(ctx.feat_dtype), None, None, None


def _cos_sin(rrois: Tensor) -> Tensor:
    """[B, N, 2] (cos a, sin a) in f32, computed once on the rois' device."""
    a = rrois[..., 4].float()
    return torch.stack([torch.cos(a), torch.sin(a)], -1).contiguous()


def _check(feat: Tensor, rrois: Tensor, clamp: Optional[Tensor]) -> None:
    if feat.dim() != 4:
        raise ValueError(f"feat must be [B, H, W, C], got {tuple(feat.shape)}")
    if feat.dtype not in _DTYPE_CODE:
        raise TypeError(f"feat dtype {feat.dtype} not supported (float32, bfloat16)")
    b = feat.shape[0]
    if rrois.dim() != 3 or rrois.shape[0] != b or rrois.shape[2] != 5:
        raise ValueError(f"rrois must be [B={b}, N, 5], got {tuple(rrois.shape)}")
    if rrois.dtype != torch.float32:
        raise TypeError(f"rrois must be float32, got {rrois.dtype}")
    if rrois.requires_grad:
        raise ValueError("roi_align_rotated pools stop-gradient boxes: detach rrois")
    tensors = [feat, rrois]
    if clamp is not None:
        if clamp.shape != rrois.shape[:2] + (4,) or clamp.dtype != torch.int32:
            raise ValueError("clamp must be int32 [B, N, 4]")
        tensors.append(clamp)
    if any(t.device != feat.device for t in tensors):
        raise ValueError("feat, rrois and clamp must be on one device")
    if feat.device.type == "cuda":
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("roi_align_rotated's CUDA kernels take contiguous tensors")
        _cuda_build.check_vectors(feat, "roi_align_rotated")


def roi_align_rotated(feat: Tensor, rrois: Tensor, clamp: Optional[Tensor] = None) -> Tensor:
    """feat [B, H, W, C], rrois [B, N, 5] (stop-gradient), clamp [B, N, 4]
    int32 or None (the whole map) -> pooled [B, N, 7, 7, C] in feat's dtype."""
    _check(feat, rrois, clamp)
    if feat.device.type == "cpu":
        return roi_align_rotated_plain(feat, rrois, clamp)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_align_rotated runs on cpu or cuda, not {feat.device}")
    return RoIAlignRotatedFunction.apply(feat, rrois, _cos_sin(rrois), clamp)
