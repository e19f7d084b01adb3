"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases:
1. device: the card's name and power limit; TF32 off for the checks;
2. build: nvcc builds the horizontal and the rotated RoIAlign kernels from
   point_teacher_torch/csrc/, both sources at once, with -Xptxas -v;
3. K1 / K2 check: the horizontal forward kernel against the plain PyTorch
   version at the AI-TOD MIL shapes (group windows, the whole map, edge
   rois, a run of 64 coincident bags, far longer than the rois a block of
   the windowed K2 takes, bags whose dout is zero, the whole map as bounds
   and 32-cell windows, which exceed the windowed K2's tile), and the
   d/dfeat kernel against autograd through the plain version, twice (the
   run-to-run difference of the atomics), each in f32 and in bf16; with
   clamp bounds the backward is the windowed K2, without them (the whole
   map) the atomic kernel; then the cls+neg case on a 64-channel map, and a
   36-channel map, which the forward's 16-byte vectors of 8 channels cannot
   take: the dispatcher must raise ValueError;
4. K3 / K4 check: the same for the rotated kernels at the SODA-A MIL shapes
   (group windows, per-roi windows of the negatives, the Pallas window, the
   whole map, edge rois, a run of 64 coincident bags, far longer than the
   rois a block of the windowed K4 takes, and bags whose dout is zero);
   with clamp bounds the backward is the windowed K4, without them (the
   whole map) the atomic kernel; C = 64 and C = 36 as for K1;
5. timing: CUDA events, median of 20 runs after warm-up, at the two pool
   shapes a phase-2 step launches, beside the plain version and the bound
   (the larger of the bytes over the memory rate and the 4 bilinear
   multiply-adds per sample and channel over the FP32 rate), for all four
   kernels; for the forwards also zero_ of a tensor of the pooled output's
   size (the card's own write of the same bytes) and the forward kernel's
   layout and resources; for K2 and K4 also the atomic kernel at the same
   shapes, the zeroing and cast that both backward times include, and the
   windowed kernel's tile and launch layout;
6. port checks: a tiny HBB and a tiny rotated step of each phase on the
   card (kernels) and on the CPU (plain versions) from the same weights and
   draws must agree; the phase-1 synthesis (black-paper boxes, rotated NMS,
   rasterisation) at each fork's full width on the card against the CPU
   from the same draws: boxes close, keep masks equal, raster masks equal
   outside the pixels within 1e-4 px of a kept box's edge;
7. main paths, each driven with the launch counts set to 0 just before and
   read just after: HBB steps at full width (800 px, B=2, ResNet-50 caffe /
   FPN / PSAGG, 100 GTs, bags of 25, 200 negatives per image, bf16), then
   SODA-A rotated steps at full width (1200 px, B=2, ResNet-50 pytorch style
   with trainable BN affine, GN head with the angle branch, 100 GTs, bags of
   25, 200 negatives per image, bf16), through the functions the training
   CLI uses and its phase switch with burn_in_step 2: 3 phase-1 steps (3
   forward and 3 backward launches each: the synthetic reg bags, the real
   reg bags, the real cls + negative pool), then 3 phase-2 steps (2 and 2);
   each path must launch its windowed backward (K2, K4) and never the
   atomic one.

Any failure ends the run with a nonzero exit. The last line is the JSON
contract line; the line before it is the card's name and power limit, and
the line before that the kernels JSON line (K1-K4; `max_abs_err` is the f32
check's), after the run's total seconds.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from point_teacher_torch.config_io import apply_overrides, load_config
from point_teacher_torch.core.proposals import fine_proposals, negative_proposals
from point_teacher_torch.core.synthetic import (SynCfg, generate_black_paper_batch,
                                                make_syn_draws)
from point_teacher_torch.ops import roi_align as ra
from point_teacher_torch.ops import roi_align_rotated as rr
from point_teacher_torch.ops.masks import rasterize_rboxes
from point_teacher_torch.tools import train as cli
from point_teacher_torch.train.steps import make_draws

IMG, FEAT, CH, B, G, NEG = 800, 100, 256, 2, 100, 200
EXT_RATIOS = (1.0, 1.2, 1.3, 0.8, 0.7)
RIMG, RFEAT, RWIN = 1200, 150, 16              # SODA-A
REXT_RATIOS = (1.0, 1.2, 1.3, 0.8, 0.6)

# H100 peaks by part (NVIDIA data sheets): memory bytes/s, FP32 (non-tensor) FLOP/s
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12), "SXM": (3.35e12, 67e12)}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for part, p in PEAKS.items():
        if part in name:
            return p
    return PEAKS["SXM"]


def mil_rois(seed: int, dev):
    """Reg bags [B, 2500, 4], refined-bag + negative rois [B, 2700, 4] and their
    group-window clamp bounds, built as the MIL stage builds them."""
    from point_teacher_torch.core.proposals import FineProposalCfg
    r = np.random.RandomState(seed)
    cxy = r.uniform(12, IMG - 12, (B, G, 2))
    wh = r.uniform(4, 16, (B, G, 2))
    boxes = torch.tensor(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), dtype=torch.float32,
                         device=dev)
    props, pv = fine_proposals(boxes, FineProposalCfg(), (IMG, IMG))
    ext, _ = fine_proposals(props.reshape(B, G, 4), FineProposalCfg(EXT_RATIOS, None, 4.0),
                            (IMG, IMG))
    u = ext.shape[2]
    reg = ext.reshape(B, G * u, 4).contiguous()
    # refined bags: the reg bags moved by a few pixels, as the reg tower does
    cls = (reg + torch.tensor(r.uniform(-3, 3, reg.shape), dtype=torch.float32,
                              device=dev)).contiguous()
    neg_u = torch.tensor(r.uniform(size=(B, 4, NEG)), dtype=torch.float32, device=dev)
    neg, _ = negative_proposals(neg_u, props, pv, (IMG, IMG))
    ctr = (boxes[..., :2] + boxes[..., 2:]) / 2
    wy0, wx0, win = ra.group_window_origins(ctr, (FEAT, FEAT), 24)
    member = ra.window_clamp(wy0, wx0, win, (FEAT, FEAT))[:, :, None].expand(B, G, u, 4)
    member = member.reshape(B, G * u, 4)
    cls_neg = torch.cat([cls, neg], 1).contiguous()
    cls_neg_clamp = torch.cat([member, ra.full_map_clamp((B, NEG), (FEAT, FEAT), dev)], 1)
    return reg, member.contiguous(), cls_neg, cls_neg_clamp.contiguous()


def edge_rois(dev):
    """Rois across the border, beyond [-1, size], zero-sized and with bins
    wider than 4 cells (the ADAPTIVE_SMAX clamp), image px."""
    e = torch.tensor([[-30, -30, 20, 20], [780, 760, 830, 820], [-90, -90, -20, -40],
                      [830, 10, 900, 60], [400, 300, 400, 360], [200, 500, 260, 500],
                      [0, 0, 799, 799], [-200, -100, 1000, 900], [10, 5, 700, 40]],
                     dtype=torch.float32, device=dev)
    return e[None].expand(B, -1, 4).contiguous()


def timed(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of `fn` over `reps` runs, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# --------------------------------------------------------------------------
# rotated RoIAlign (K3 / K4), SODA-A shapes
# --------------------------------------------------------------------------

def rotated_mil_rois(seed: int, dev):
    """Reg bags [B, 2500, 5], refined-bag + negative rois [B, 2700, 5] and
    their clamp bounds, built as the rotated MIL stage builds them: members
    share their GT's group window, negatives (angle 0) each get a window on
    their own centre."""
    from point_teacher_torch.core.proposals import FineProposalCfg
    from point_teacher_torch.ops.boxes import cxcywh_to_xyxy, xyxy_to_cxcywh
    r = np.random.RandomState(seed)
    rb = np.concatenate([r.uniform(12, RIMG - 12, (B, G, 2)), r.uniform(4, 16, (B, G, 2)),
                         r.uniform(-np.pi / 2, np.pi / 2, (B, G, 1))], -1)
    rboxes = torch.tensor(rb, dtype=torch.float32, device=dev)
    hw = (RIMG, RIMG)
    props, pv = fine_proposals(cxcywh_to_xyxy(rboxes[..., :4]), FineProposalCfg(), hw)
    ext, _ = fine_proposals(props.reshape(B, G, 4), FineProposalCfg(REXT_RATIOS, None, 4.0), hw)
    u = ext.shape[2]
    ang = rboxes[:, :, None, 4:5].expand(B, G, u, 1)
    reg = torch.cat([xyxy_to_cxcywh(ext), ang], -1).reshape(B, G * u, 5).contiguous()
    # refined bags: the reg bags moved and resized by a few pixels, as the reg tower does
    jitter = torch.tensor(np.concatenate([r.uniform(-3, 3, (B, G * u, 4)),
                                          np.zeros((B, G * u, 1))], -1),
                          dtype=torch.float32, device=dev)
    cls = (reg + jitter).contiguous()
    neg_u = torch.tensor(r.uniform(size=(B, 4, NEG)), dtype=torch.float32, device=dev)
    neg, _ = negative_proposals(neg_u, props, pv, hw)
    neg_rb = torch.cat([xyxy_to_cxcywh(neg), torch.zeros_like(neg[..., :1])], -1)
    wy0, wx0, win = ra.group_window_origins(rboxes[..., :2], (RFEAT, RFEAT), RWIN)
    member = ra.window_clamp(wy0, wx0, win, (RFEAT, RFEAT))[:, :, None].expand(B, G, u, 4)
    member = member.reshape(B, G * u, 4).contiguous()
    cls_neg = torch.cat([cls, neg_rb], 1).contiguous()
    cls_neg_clamp = torch.cat([member, rr.roi_window_clamp(neg_rb, (RFEAT, RFEAT), RWIN)], 1)
    return reg, member, cls_neg, cls_neg_clamp.contiguous()


def rotated_edge_rois(dev):
    """Rotated rois across the border, beyond [-1, size], of zero size,
    larger than a 16-cell window, and at angles +-pi/2, image px."""
    e = torch.tensor([[-20, 30, 90, 40, 0.3], [1190, 1180, 80, 60, -1.2],
                      [-150, -120, 40, 30, 0.5], [1400, 300, 50, 50, 0.0],
                      [500, 400, 0, 40, 0.2], [600, 600, 0, 0, -0.7],
                      [600, 500, 420, 300, 0.7], [300, 800, 60, 20, np.pi / 2],
                      [800, 300, 60, 20, -np.pi / 2]], dtype=torch.float32, device=dev)
    return e[None].expand(B, -1, 5).contiguous()


# --------------------------------------------------------------------------
# one check, one timing and one bound for each kernel family
# --------------------------------------------------------------------------

def sample_count(rois: torch.Tensor) -> int:
    """Bilinear samples the horizontal kernels take for these rois (49 bins x
    sn_y x sn_x, the adaptive sampling of each roi)."""
    _, _, bw, bh = ra._roi_geometry(rois)
    sn = torch.ceil(bw).clamp(1, 4) * torch.ceil(bh).clamp(1, 4)
    return int(sn.sum().item()) * 49


@dataclass(frozen=True)
class Family:
    """A forward / backward kernel pair: its tags, op module (with the
    backward wrappers bwd_windowed and bwd_atomic), autograd function
    (called as fn.apply(feat, rois, *extra(rois), clamp)), plain version,
    the dispatcher the MIL stage calls, map side, bilinear samples for given
    rois, the f32 values per roi the kernels read besides rois and clamps,
    and whether the backward without clamp bounds is another kernel (the
    atomic one)."""
    tags: tuple
    module: object
    fn: object
    plain: object
    dispatch: object
    extra: object
    feat_hw: int
    samples: object
    per_roi_meta: int
    atomic_without_clamp: bool = False

    def kernel(self, feat, rois, clamp, extra=None):
        extra = self.extra(rois) if extra is None else extra
        return self.fn.apply(feat, rois, *extra, clamp)


HBB = Family(("K1", "K2"), ra, ra.RoIAlignFunction, ra.roi_align_plain, ra.roi_align,
             lambda r: (), FEAT, sample_count, 0, atomic_without_clamp=True)
ROT = Family(("K3", "K4"), rr, rr.RoIAlignRotatedFunction, rr.roi_align_rotated_plain,
             rr.roi_align_rotated, lambda r: (rr._cos_sin(r),), RFEAT,
             lambda r: r.shape[0] * r.shape[1] * 196, 2, atomic_without_clamp=True)


def hbb_long_run(dev):
    """64 coincident GTs per image, 25 members each, all on one 24-cell group
    window (as padded or coincident GTs give): one run of 1600 rois, which
    the windowed K2 splits across many blocks; in the second image the
    window sits at the map's corner."""
    r = np.random.RandomState(8)
    g, u = 64, 25
    ctr = np.array([[400.0, 420.0], [20.0, 790.0]])
    c = ctr[:, None, :] + r.uniform(-30, 30, (B, g * u, 2))
    wh = r.uniform(4, 48, (B, g * u, 2))
    rois = torch.tensor(np.concatenate([c - wh / 2, c + wh / 2], -1), dtype=torch.float32,
                        device=dev)
    wy0, wx0, win = ra.group_window_origins(torch.tensor(ctr[:, None, :], dtype=torch.float32,
                                                         device=dev), (FEAT, FEAT), 24)
    clamp = ra.window_clamp(wy0, wx0, win, (FEAT, FEAT)).expand(B, g * u, 4)
    return rois.contiguous(), clamp.contiguous()


def hbb_cases(dev):
    reg, member, cls_neg, cls_neg_clamp = mil_rois(1, dev)
    edge = edge_rois(dev)
    # group windows on the edge rois' own centres: the large ones escape them
    wy0, wx0, win = ra.group_window_origins((edge[..., :2] + edge[..., 2:]) / 2, (FEAT, FEAT), 24)
    edge_clamp = ra.window_clamp(wy0, wx0, win, (FEAT, FEAT)).contiguous()
    # the whole map as bounds on a subset: the windowed K2's untiled path
    sub = torch.cat([reg[:, :64], edge], 1).contiguous()
    full = ra.full_map_clamp(sub.shape[:2], (FEAT, FEAT), dev).contiguous()
    # 40 bags on 32-cell group windows (1024 cells) around their mean centre,
    # which exceed the windowed K2's tile
    bags = reg[:, :1000].contiguous()
    quad = bags.reshape(B, 40, 25, 4)
    ctr = ((quad[..., :2] + quad[..., 2:]) / 2).mean(2)
    wy0, wx0, win = ra.group_window_origins(ctr, (FEAT, FEAT), 32)
    win32 = ra.window_clamp(wy0, wx0, win, (FEAT, FEAT))[:, :, None].expand(B, 40, 25, 4)
    run, run_clamp = hbb_long_run(dev)
    # members of every third bag, and one member in five elsewhere, get no gradient
    bag = torch.arange(reg.shape[1], device=dev) // 25
    some = torch.tensor(np.random.RandomState(10).uniform(size=reg.shape[:2]) < 0.2, device=dev)
    zero = (bag % 3 == 0) | some
    return [("reg_bags+clamp", reg, member, None), ("reg_bags", reg, None, None),
            ("cls+neg+clamp", cls_neg, cls_neg_clamp, None), ("edges", edge, None, None),
            ("edges+clamp", edge, edge_clamp, None), ("subset+full_map", sub, full, None),
            ("bags+window32", bags, win32.reshape(B, 1000, 4).contiguous(), None),
            ("long_run+clamp", run, run_clamp, None),
            ("reg_bags+zero_dout", reg, member, zero)]


def rotated_long_run(dev):
    """64 coincident GTs per image, 25 members each, all on one group window
    (as padded or coincident GTs give): one run of 1600 rois, which the
    windowed K4 splits across many blocks; in the second image the window
    sits at the map's corner."""
    r = np.random.RandomState(7)
    g, u = 64, 25
    ctr = np.array([[600.0, 640.0], [30.0, 1180.0]])
    rb = np.concatenate([ctr[:, None, :] + r.uniform(-30, 30, (B, g * u, 2)),
                         r.uniform(4, 48, (B, g * u, 2)),
                         r.uniform(-np.pi / 2, np.pi / 2, (B, g * u, 1))], -1)
    rois = torch.tensor(rb, dtype=torch.float32, device=dev)
    wy0, wx0, win = ra.group_window_origins(torch.tensor(ctr[:, None, :], dtype=torch.float32,
                                                         device=dev), (RFEAT, RFEAT), RWIN)
    clamp = ra.window_clamp(wy0, wx0, win, (RFEAT, RFEAT)).expand(B, g * u, 4)
    return rois.contiguous(), clamp.contiguous()


def rotated_cases(dev):
    reg, member, cls_neg, cls_neg_clamp = rotated_mil_rois(3, dev)
    edge = rotated_edge_rois(dev)
    wy0, wx0, win = ra.group_window_origins(edge[..., :2], (RFEAT, RFEAT), RWIN)
    edge_group = ra.window_clamp(wy0, wx0, win, (RFEAT, RFEAT)).contiguous()
    # the whole map on a subset: the plain version's windows are then the map
    sub = torch.cat([reg[:, :64], edge], 1).contiguous()
    full = ra.full_map_clamp(sub.shape[:2], (RFEAT, RFEAT), dev).contiguous()
    run, run_clamp = rotated_long_run(dev)
    # members of every third bag, and one member in five elsewhere, get no gradient
    bag = torch.arange(reg.shape[1], device=dev) // 25
    some = torch.tensor(np.random.RandomState(9).uniform(size=reg.shape[:2]) < 0.2, device=dev)
    zero = (bag % 3 == 0) | some
    return [("reg_bags+group", reg, member, None),
            ("cls+neg+group/roi", cls_neg, cls_neg_clamp, None),
            ("reg_bags+pallas", reg, rr.pallas_window_clamp(reg, (RFEAT, RFEAT)).contiguous(),
             None),
            ("subset+full_map", sub, full, None),
            ("subset+no_clamp", sub, None, None),
            ("edges+roi_window", edge, rr.roi_window_clamp(edge, (RFEAT, RFEAT), RWIN), None),
            ("edges+group", edge, edge_group, None),
            ("long_run+group", run, run_clamp, None),
            ("reg_bags+zero_dout", reg, member, zero)]


def bounds(fam: Family, rois, clamp, elt: int, bw: float, f32_rate: float):
    """(bytes_ms, ops_ms) of one launch, forward and backward alike: the bytes
    the function must move (the map read once and the pooled values written
    once, or dout read once and d/dfeat written once; rois, clamps and the
    per-roi extras read once) over the memory rate, and its operations, the 4
    bilinear multiply-adds (8 FLOPs) per sample and channel, over the FP32
    rate."""
    n = rois.shape[0] * rois.shape[1]
    feat_b = B * fam.feat_hw * fam.feat_hw * CH * elt
    pooled_b = n * 49 * CH * elt
    meta_b = 4 * (rois.numel() + (0 if clamp is None else clamp.numel()) + n * fam.per_roi_meta)
    return ((feat_b + pooled_b + meta_b) / bw * 1e3,
            fam.samples(rois) * CH * 8 / f32_rate * 1e3)


def check_family(fam: Family, dev, cases, seed: int, ch: int = CH):
    """The forward kernel against the plain version, in f32 (atol 1e-5 x
    max|feat|) and bf16 (2e-2 x max|feat|), and the backward kernel against
    autograd through the plain version on the same inputs, in f32 (1e-4 x
    max|grad|) and bf16 (2e-2 x max|grad|, autograd in f32 on the bf16
    values), run twice (the run-to-run difference of the atomics), on a map
    of `ch` channels. A case is (name, rois, clamp, zero): dout is 0 on the
    rois where the bool mask `zero` [B, N] is set. Returns the f32 errors
    {"fwd", "bwd", "bwd_atomic"} (the last: the atomic backward, which runs
    where clamp is None)."""
    fwd_tag, bwd_tag = fam.tags
    torch.manual_seed(seed)
    feat32 = torch.randn(B, fam.feat_hw, fam.feat_hw, ch, device=dev) * 4
    fmax = float(feat32.abs().max())
    errs = {"fwd": 0.0, "bwd": 0.0, "bwd_atomic": 0.0}
    for dtype, ftol, gtol in ((torch.float32, 1e-5, 1e-4), (torch.bfloat16, 2e-2, 2e-2)):
        feat = feat32.to(dtype)
        dt = str(dtype)[6:]
        for name, rois, clamp, zero in cases:
            got = fam.kernel(feat, rois, clamp)
            want = fam.plain(feat, rois, clamp)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            print(f"{fwd_tag} {dt:8s} {name:18s} C={ch} max_abs_err={err:.3e} "
                  f"(atol {ftol * fmax:.3e})", flush=True)
            check(err <= ftol * fmax, f"{fwd_tag} {dtype} {name}: {err} > {ftol * fmax}")
            del got, want
            dout = torch.randn(B, rois.shape[1], 7, 7, ch, device=dev).to(dtype)
            if zero is not None:
                dout = dout.masked_fill(zero[..., None, None, None], 0)
            bwd_key = "bwd_atomic" if fam.atomic_without_clamp and clamp is None else "bwd"
            # reference: autograd through the plain version on the same values in
            # f32, as the kernels sum; autograd on a bf16 leaf sums the rois' window
            # gradients in bf16, which alone drifts past the tolerance on long runs
            f32 = feat.detach().to(torch.float32, copy=True).requires_grad_(True)
            (want,) = torch.autograd.grad(fam.plain(f32, rois, clamp), f32, dout.float())
            f = feat.clone().requires_grad_(True)
            runs = [torch.autograd.grad(fam.kernel(f, rois, clamp), f, dout)[0]
                    for _ in range(2)]
            note = ""
            if dtype != torch.float32:
                (plain_bf,) = torch.autograd.grad(fam.plain(f, rois, clamp), f, dout)
                note = (f"; bf16 autograd through the plain version: "
                        f"{float((plain_bf.float() - want).abs().max()):.3e}")
                del plain_bf
            torch.cuda.synchronize()
            gerr = float((runs[0].float() - want).abs().max())
            scale = float(want.abs().max())
            rerun = float((runs[0].float() - runs[1].float()).abs().max())
            tag = bwd_tag + (" atomic" if bwd_key == "bwd_atomic" else "")
            print(f"{tag} {dt:8s} {name:18s} C={ch} max_abs_err={gerr:.3e} ({gtol:g} x max|grad| "
                  f"{gtol * scale:.3e}) run-to-run max diff={rerun:.3e}{note}", flush=True)
            check(gerr <= gtol * scale, f"{tag} {dtype} {name}: {gerr} > {gtol * scale}")
            del want, runs
            if dtype == torch.float32:
                errs["fwd"] = max(errs["fwd"], err)
                errs[bwd_key] = max(errs[bwd_key], gerr)
    return errs


def check_channels(fam: Family, dev, case, seed: int):
    """`case` at C = 64 (check_family's checks), and C = 36, which the
    forward's 16-byte vectors of 8 channels cannot take: the dispatcher must
    raise ValueError on the card. Returns check_family's f32 errors."""
    errs = check_family(fam, dev, [case], seed, ch=64)
    _, rois, clamp, _ = case
    feat = torch.zeros(B, fam.feat_hw, fam.feat_hw, 36, device=dev, dtype=torch.bfloat16)
    try:
        fam.dispatch(feat, rois, clamp)
    except ValueError as e:
        print(f"{fam.tags[0]} C=36 on the card raises ValueError: {e}", flush=True)
    else:
        fail(f"{fam.tags[0]}: C=36 on the card did not raise ValueError")
    return errs


def merge_errs(*errs) -> dict:
    return {k: max(e[k] for e in errs) for k in errs[0]}


def time_family(fam: Family, dev, shapes, bw: float, f32_rate: float):
    """CUDA-event medians of the kernels and of the plain version in bf16 at
    `shapes` ((name, rois, clamp): the pools a phase-2 step launches), each
    beside its bound."""
    feat = (torch.randn(B, fam.feat_hw, fam.feat_hw, CH, device=dev) * 4).to(torch.bfloat16)
    print(f"{fam.tags[0]} forward layout: {fam.module.fwd_layout()}", flush=True)
    rows = {}
    for shape, rois, clamp in shapes:
        extra = fam.extra(rois)
        dout = torch.randn(B, rois.shape[1], 7, 7, CH, device=dev).to(torch.bfloat16)
        fk = feat.clone().requires_grad_(True)
        out_k = fam.kernel(fk, rois, clamp, extra)
        fp = feat.clone().requires_grad_(True)
        out_p = fam.plain(fp, rois, clamp)
        pooled = torch.empty_like(out_p)
        t = {
            "fwd_ms": timed(lambda: fam.kernel(feat, rois, clamp, extra)),
            "write_floor_ms": timed(pooled.zero_),
            "fwd_plain_ms": timed(lambda: fam.plain(feat, rois, clamp)),
            "bwd_ms": timed(lambda: torch.autograd.grad(out_k, fk, dout, retain_graph=True)),
            "bwd_plain_ms": timed(lambda: torch.autograd.grad(out_p, fp, dout,
                                                              retain_graph=True)),
        }
        del out_p, pooled
        bytes_ms, ops_ms = bounds(fam, rois, clamp, 2, bw, f32_rate)
        t.update(bytes_ms=bytes_ms, ops_ms=ops_ms, rois=rois.shape[0] * rois.shape[1],
                 samples=fam.samples(rois))
        rows[shape] = t
        print(f"timing bf16 {'/'.join(fam.tags)} {shape:9s} N={rois.shape[1]}/img: "
              f"fwd kernel_ms={t['fwd_ms']:.4f} plain_ms={t['fwd_plain_ms']:.4f} "
              f"(zero_ of the pooled output: {t['write_floor_ms']:.4f}); "
              f"bwd kernel_ms={t['bwd_ms']:.4f} plain_ms={t['bwd_plain_ms']:.4f}; "
              f"bound_ms each={max(bytes_ms, ops_ms):.4f} (bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f})", flush=True)
    return rows


def time_backward(fam: Family, dev, shapes, rows) -> None:
    """A family's windowed and atomic backward at the main-path shapes,
    through the same wrapper steps (the f32 zeroing, the kernel and the cast
    to bf16, which a zeroing plus cast alone times separately) and timed as
    every kernel is, in turns: windowed, atomic, atomic, windowed. Adds the
    times to rows, whose `bwd_ms` (through autograd) is the kernels line's."""
    mod, tag = fam.module, fam.tags[1]
    print(f"{tag} windowed layout: {mod.windowed_layout()}", flush=True)
    for shape, rois, clamp in shapes:
        extra = fam.extra(rois)
        dout = torch.randn(B, rois.shape[1], 7, 7, CH, device=dev).to(torch.bfloat16)
        fshape = (B, fam.feat_hw, fam.feat_hw, CH)
        t = rows[shape]
        fns = {k: (lambda f=f: f(dout, rois, *extra, clamp, fshape).to(torch.bfloat16))
               for k, f in (("windowed", mod.bwd_windowed), ("atomic", mod.bwd_atomic))}
        for key, k in (("win_ms", "windowed"), ("atomic_ms", "atomic"),
                       ("atomic_ms_2", "atomic"), ("win_ms_2", "windowed")):
            t[key] = timed(fns[k])
        t["zero_cast_ms"] = timed(lambda: torch.zeros(fshape, device=dev).to(torch.bfloat16))
        ratio = (t["atomic_ms"] + t["atomic_ms_2"]) / (t["win_ms"] + t["win_ms_2"])
        print(f"timing bf16 {tag} {shape:9s} N={rois.shape[1]}/img, through the wrapper: "
              f"windowed ms={t['win_ms']:.4f}, {t['win_ms_2']:.4f}; atomic ms="
              f"{t['atomic_ms']:.4f}, {t['atomic_ms_2']:.4f}; atomic / windowed = "
              f"{ratio:.2f}x; each includes zeroing + cast {t['zero_cast_ms']:.4f} ms; "
              f"through autograd (kernels line) {t['bwd_ms']:.4f} ms; bytes bound "
              f"{t['bytes_ms']:.4f} ms", flush=True)


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------

def condition(state) -> None:
    """The test suites' conditioning of a random init, on student and
    teacher: the last PSAGG conv x 1e-2 (bag logits out of f32 sigmoid
    saturation) and, for the rotated head, a regression bias of 1.0 (boxes of
    ~16 px, rotated IoUs away from 0). Without them last-bit differences of
    two devices grow to percent level in gfocal and -log(IoU)."""
    with torch.no_grad():
        for model in (state.student, state.teacher):
            conv = model.neck_agg.lateral_convs[4].conv
            conv.weight.mul_(1e-2)
            conv.bias.mul_(1e-2)
            if hasattr(model.bbox_head, "conv_angle"):
                model.bbox_head.conv_reg.bias.fill_(1.0)


def phase_port_check(dev, config: str, phase1: bool):
    """One tiny step on the card and on the CPU from the same weights and
    draws: the step's metrics must agree (TF32 is off, f32 throughout). The
    phase-1 step synthesises with the config's shape priors scaled by 1/4
    to the 64 px image."""
    cfg = apply_overrides(load_config(config),
                          ["pt.img_size=64", "pt.max_gt=6", "pt.burn_in_step=-1",
                           "pt.num_training_burninstep1=6", "pt.num_training_burninstep2=6"])
    cfg["pt"] = cfg["pt"]._replace(shape_list=tuple(
        (w / 4, h / 4, dw, dr) for w, h, dw, dr in cfg["pt"].shape_list))
    rotated = bool(cfg.get("rotated"))
    results = {}
    for device in (torch.device("cpu"), dev):
        pt2, state, step_fn = cli.setup(cfg, 4, 0, device, dtype=torch.float32)
        if rotated:
            condition(state)
        batch = next(cli.synthetic_dataset(4, pt2, 0, rotated=rotated)(pt2.batch_size))
        draws = make_draws(torch.Generator().manual_seed(5), pt2, pt2.batch_size, device, phase1)
        results[device.type] = {k: float(v) for k, v in step_fn(
            state, cli.to_batch(batch, device), phase1=phase1, draws=draws).items()}
    worst = 0.0
    for k, want in results["cpu"].items():
        got = results["cuda"][k]
        rel = abs(got - want) / max(abs(want), 1e-6)
        worst = max(worst, rel)
        check(np.isfinite(got) and rel <= 1e-3,
              f"port check {config} phase {2 - phase1} {k}: cuda {got} vs cpu {want}")
    print(f"port check {config}: tiny phase-{2 - phase1} step, cuda (kernels) vs cpu (plain): "
          f"{len(results['cpu'])} metrics agree, worst rel diff {worst:.2e}", flush=True)


def edge_pixels(rboxes, keep, h: int, w: int, margin: float = 1e-4):
    """Pixels [B, H, W] within `margin` px of a kept box's edge, in f64: set
    in the raster of the boxes grown by `margin`, not in that of the boxes
    shrunk by it."""
    rb = rboxes.double()
    grow = torch.tensor([0, 0, 2 * margin, 2 * margin, 0], dtype=torch.float64,
                        device=rb.device)
    return (rasterize_rboxes(rb + grow, keep, h, w)
            & ~rasterize_rboxes(rb - grow, keep, h, w))


def phase_synthesis_check(dev, config: str) -> None:
    """generate_black_paper_batch at the config's full width (B=2, 100 GTs of
    4-16 px, a quarter of them padding) on the card against the CPU from the
    same draws: keep masks equal, box coordinates within 1e-6 relative plus
    1e-6 of the image side (a chain box's centre sums an offset of a few
    hundred px, whose sin / cos differ by an ulp between the devices), raster
    masks (the painted pixels) equal outside the pixels within 1e-4 px of an
    edge."""
    cfg = load_config(config)
    pt, rotated = cfg["pt"], bool(cfg.get("rotated"))
    s, g = pt.img_size, pt.max_gt
    arrays = next(cli.synthetic_dataset(2, pt, 7, rotated=rotated)(B))  # pixels 0-254
    arrays["gt_valid"][:, g - g // 4:] = False
    draws = make_syn_draws(torch.Generator().manual_seed(11), len(pt.shape_list), B, g, "cpu")
    outs = []
    for device in (torch.device("cpu"), dev):
        batch = cli.to_batch(arrays, device)
        d = type(draws)(*(t.to(device) for t in draws))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_black_paper_batch(d, batch.image, batch.gt_boxes, batch.gt_valid,
                                         SynCfg(pt.shape_list, s), pt.syn_fill_value)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        outs.append([x.cpu() for x in out] + [ms])
    (cimg, cxyxy, crb, cvalid, cms), (gimg, gxyxy, grb, gvalid, gms) = outs
    check(torch.equal(cvalid, gvalid), f"synthesis {config}: keep masks differ "
          f"({int((cvalid != gvalid).sum())} slots)")
    check(bool(cvalid.any(-1).all()), f"synthesis {config}: an image kept no box")
    worst = 0.0
    for name, got, want in (("rboxes", grb, crb), ("xyxy", gxyxy, cxyxy)):
        err = float(((got - want).abs() / (1e-6 * want.abs() + 1e-6 * s)).max())
        check(err <= 1.0, f"synthesis {config}: {name} differ by {err:.2f} x the tolerance")
        worst = max(worst, err)
    cmask, gmask = (cimg == 255).all(-1), (gimg == 255).all(-1)
    edge = edge_pixels(crb.to(dev), cvalid.to(dev), s, s).cpu()
    diff = cmask != gmask
    check(not bool((diff & ~edge).any()), f"synthesis {config}: {int((diff & ~edge).sum())} "
          f"raster pixels differ away from an edge")
    print(f"synthesis check {config} ({s} px, {g} GTs): kept {cvalid.sum(-1).tolist()} of "
          f"{cvalid.shape[1]} slots on both; boxes within {worst:.2f} x the tolerance; {int(edge.sum())} pixels within 1e-4 "
          f"px of an edge, {int(diff.sum())} of them differ; cuda {gms:.1f} ms (first call), "
          f"cpu {cms:.1f} ms", flush=True)


def phase_main_path(dev, config: str, kernels, others, frozen, unchanged, trainable):
    """Full-width steps of `config` through the CLI's setup, step and phase
    switch, burn_in_step 2: 3 phase-1 steps (3 forward and 3 backward
    launches each of `kernels`' op module), then 3 phase-2 steps (2 and 2);
    `others` is an op module whose kernels the path must not launch;
    `frozen` and `unchanged` parameters must not move, `trainable` ones
    must. Returns the launch counts of the run."""
    cfg = apply_overrides(load_config(config), ["pt.burn_in_step=2"])
    rotated = bool(cfg.get("rotated"))
    pt, state, step_fn = cli.setup(cfg, 12, 0, dev)
    img = RIMG if rotated else IMG
    check(pt.img_size == img and pt.max_gt == G and pt.batch_size == B, "config drifted")
    named = {**dict(state.student.named_parameters()), **dict(state.student.named_buffers())}
    watch = frozen + unchanged + trainable
    before = {k: named[k].detach().clone() for k in watch}
    teacher0 = dict(state.teacher.named_parameters())["bbox_head.conv_cls.weight"].detach().clone()
    batches = cli.synthetic_dataset(12, pt, 0, rotated=rotated)(pt.batch_size)
    arrays = [next(batches) for _ in range(6)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    others.reset_launch_counts()
    step_ms, peaks = {1: [], 2: []}, {}
    for i, a in enumerate(arrays):
        batch = cli.to_batch(a, dev)
        phase1 = cli.is_phase1(state.step, pt.burn_in_step)
        phase = 1 if phase1 else 2
        # per step: 3 (phase 1) or 2 (phase 2) forward and windowed backward
        # launches, none of any other kernel (the atomic backward)
        n = 3 if phase1 else 2
        want = {k: n if k in ("fwd", "bwd") else 0 for k in kernels.launch_counts()}
        if phase == 2 and not step_ms[2]:
            peaks[1] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        counts0 = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step_fn(state, batch, phase1=phase1)
        torch.cuda.synchronize()
        step_ms[phase].append((time.perf_counter() - t0) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"{config} step {i + 1}: non-finite metrics {bad}")
        got = {k: v - counts0[k] for k, v in kernels.launch_counts().items()}
        check(got == want, f"{config} step {i + 1} (phase {phase}): launches {got} != {want}")
        check(bool(state.points_cached[batch.image_ids].all()),
              f"{config} step {i + 1}: point caches not set")
        print(f"{config} step {i + 1} (phase {phase}): {step_ms[phase][-1]:.1f} ms "
              f"total_loss={m['total_loss']:.4f} loss_cls={m['loss_cls']:.4f} "
              f"loss_bbox={m['loss_bbox']:.4f} mil_bags={m['stage0_loss_mil_bags']:.4f} "
              f"coverage={m['stage0_cls_pool_coverage']:.4f} launches={got}", flush=True)
    peaks[2] = torch.cuda.max_memory_allocated()
    check(len(step_ms[1]) == 3 and len(step_ms[2]) == 3, f"{config}: phase switch {step_ms}")
    counts = kernels.launch_counts()
    launches = (counts["fwd"], counts["bwd"])
    check(not any(others.launch_counts().values()),
          f"{config}: launched the other module's kernels {others.launch_counts()}")
    moved = {k: float((named[k].detach() - before[k]).abs().max()) for k in watch}
    for k in frozen + unchanged:
        check(moved[k] == 0.0, f"{config}: frozen {k} changed by {moved[k]}")
    for k in trainable:
        check(moved[k] > 0.0, f"{config}: trainable {k} did not change")
    t_now = dict(state.teacher.named_parameters())["bbox_head.conv_cls.weight"]
    check(float((t_now - teacher0).abs().max()) > 0.0, f"{config}: teacher did not move by EMA")
    for phase in (1, 2):
        steady = step_ms[phase][1:]
        print(f"main path {config}: phase-{phase} step ms (steps 2, 3 of the phase) = "
              f"{steady[0]:.1f}, {steady[1]:.1f}; imgs/s = {B * 1e3 / np.mean(steady):.3f}; "
              f"peak memory {peaks[phase] / 2**30:.2f} GiB", flush=True)
    print(f"main path {config}: launches {counts}; frozen unchanged "
          f"{len(frozen + unchanged)}, trainable moved {len(trainable)}", flush=True)
    return launches


def build_all() -> None:
    """nvcc for both sources at once (one process each), with -Xptxas -v."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        logs = list(pool.map(lambda mod: mod.build(ptxas_verbose=True), (ra, rr)))
    print(f"[2/7] build: {time.perf_counter() - t0:.1f} s -> {ra.LIBRARY}, {rr.LIBRARY} "
          f"(sm_90a)", flush=True)
    for mod, log in zip((ra, rr), logs):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {mod.SOURCE.name}:", line.strip(), flush=True)


def kernel_rows(launches, errs, rows, src, names):
    """The kernels-line entries of one family: the main path's launches, the
    f32 check's max error, and the sums over the timed pool shapes."""
    bytes_ms = sum(r["bytes_ms"] for r in rows.values())
    ops_ms = sum(r["ops_ms"] for r in rows.values())
    return [{
        "name": kname, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[idx], "max_abs_err": errs[key],
        "ms": sum(r[f"{key}_ms"] for r in rows.values()),
        "plain_ms": sum(r[f"{key}_plain_ms"] for r in rows.values()),
        "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in rows.values()),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    } for kname, key, idx, replaces in names]


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke needs a CUDA card",
              flush=True)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1/7] device: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all()

    print("[3/7] K1 / K2 checks against the plain version (AI-TOD shapes)", flush=True)
    cases = hbb_cases(dev)
    errs = merge_errs(check_family(HBB, dev, cases, seed=0),
                      check_channels(HBB, dev, cases[2], seed=5))
    print("[4/7] K3 / K4 checks against the plain version (SODA-A shapes)", flush=True)
    cases = rotated_cases(dev)
    rerrs = merge_errs(check_family(ROT, dev, cases, seed=1),
                       check_channels(ROT, dev, cases[1], seed=6))
    del cases
    torch.cuda.empty_cache()
    print("[5/7] kernel timing (bf16, main-path shapes)", flush=True)
    bw, f32_rate = peaks(name)
    reg, member, cls_neg, cls_neg_clamp = mil_rois(2, dev)
    shapes = [("reg_bags", reg, member), ("cls+neg", cls_neg, cls_neg_clamp)]
    rows = time_family(HBB, dev, shapes, bw, f32_rate)
    time_backward(HBB, dev, shapes, rows)
    reg, member, cls_neg, cls_neg_clamp = rotated_mil_rois(4, dev)
    rshapes = [("reg_bags", reg, member), ("cls+neg", cls_neg, cls_neg_clamp)]
    rrows = time_family(ROT, dev, rshapes, bw, f32_rate)
    time_backward(ROT, dev, rshapes, rrows)
    del shapes, rshapes
    del reg, member, cls_neg, cls_neg_clamp
    torch.cuda.empty_cache()
    print("[6/7] port checks", flush=True)
    for phase1 in (False, True):
        phase_port_check(dev, "aitodv2_point_teacher_0.py", phase1)
        phase_port_check(dev, "sodaa_point_teacher_1x.py", phase1)
    phase_synthesis_check(dev, "aitodv2_point_teacher_0.py")
    phase_synthesis_check(dev, "sodaa_point_teacher_1x.py")
    # the main paths run as in training: the default precision settings
    torch.backends.cudnn.allow_tf32 = True
    print("[7/7] main paths", flush=True)
    launches = phase_main_path(
        dev, "configs/point_teacher/aitodv2_point_teacher_0.py", ra, rr,
        frozen=["backbone.conv1.weight", "backbone.layer1.0.conv2.weight",
                "backbone.layer3.0.bn1.weight"],
        unchanged=[],
        trainable=["backbone.layer3.0.conv2.weight", "bbox_head.conv_cls.weight",
                   "bbox_head.shared_fcs_bag.0.0.weight"])
    torch.cuda.empty_cache()
    rlaunches = phase_main_path(
        dev, "configs/point_teacher/sodaa_point_teacher_1x.py", rr, ra,
        frozen=["backbone.conv1.weight", "backbone.bn1.weight",
                "backbone.layer1.0.conv2.weight", "backbone.layer1.0.bn1.weight"],
        unchanged=["backbone.layer3.0.bn1.running_mean", "backbone.layer3.0.bn1.running_var"],
        trainable=["backbone.layer3.0.bn1.weight", "backbone.layer3.0.bn1.bias",
                   "backbone.layer3.0.conv2.weight", "bbox_head.conv_angle.weight",
                   "bbox_head.cls_convs.0.gn.weight", "bbox_head.scale_angle.scale",
                   "bbox_head.shared_fcs_bag.0.0.weight"])

    kernels = kernel_rows(launches, errs, rows, "point_teacher_torch/csrc/roi_align.cu", (
        ("roi_align_fwd", "fwd", 0, "point_teacher_tpu/ops/roi_align_pallas.py:49"),
        ("roi_align_bwd", "bwd", 1, "point_teacher_tpu/ops/roi_align_pallas.py:83")))
    kernels += kernel_rows(rlaunches, rerrs, rrows,
                           "point_teacher_torch/csrc/roi_align_rotated.cu", (
        ("roi_align_rotated_fwd", "fwd", 0, "point_teacher_tpu/ops/rroi_pallas.py:79"),
        ("roi_align_rotated_bwd", "bwd", 1, "point_teacher_tpu/ops/rroi_pallas.py:110")))
    print(f"smoke total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
