"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases:
1. device: the card's name and power limit; TF32 off for the checks;
2. build: nvcc builds the horizontal and the rotated RoIAlign kernels and
   the NMS fixpoint kernel from point_teacher_torch/csrc/, all three
   sources at once, with -Xptxas -v;
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
   atomic one, and the NMS fixpoint kernel once a phase-1 step (the
   synthesis's rotated NMS) and never in phase 2;
8. inference and eval, with the launch counts set to 0 just before and
   read just after (inference pools nothing: no RoIAlign kernel may
   launch): the HBB teacher that phase 7 trained, at full width (800 px,
   B=2, bf16, nms_pre 3000, score_thr 0.05, IoU 0.5, max 3000), as trained
   and dense (a copy whose classification bias is 0 and whose boxes span
   ~3.5 strides: all 24,000 candidates pass, the class NMS runs its 6
   chunks with suppression chains). For each: decode + NMS on the card against the CPU from the
   same head outputs (valid sets, labels and boxes equal; a difference is
   printed with the IoU of the flipped pairs and fails), the forward, the
   NMS and the whole inference timed (CUDA events, median of 10 after
   warm-up), the peak memory, and TTA at 800 px with flip (2 views, 48,000
   candidates). Then the eval: phase 7's train state written by
   save_checkpoint, as `tools.train --work-dir` writes it, evaluated by the
   test CLI's main on 8 fabricated 800 px images (the AP@0.25 table), and
   the dense copy through evaluate_detector, each with its host time;
9. SODA-A inference and eval, with the launch counts set to 0 just before
   and read just after (no RoIAlign kernel may launch): the SODA-A teacher
   that phase 7 trained, at full width (1200 px, B=2, bf16, nms_pre 2000,
   score_thr 0.05, IoU 0.1, max 2000: 18,000 class-expanded candidates an
   image, 9 chunks of 2048, each chunk's IoU blocks in tiles of 256 rows),
   as trained and dense (make_dense: every candidate passes, neighbours
   suppress each other). For each: finite dets, scores descending, the
   kept boxes of each class overlapping by IoU <= 0.1 (+ 1e-3, recomputed
   on the card without the class offset), two runs bit-identical; the
   forward timed (CUDA events, median of 10), decode + NMS and the whole
   inference (one run each: ~4.8 s a run) and the peak memory; decode + NMS
   on the card against the CPU from the same head outputs with nms_pre cut
   (one-shot: 1,800 candidates an image, where any class score passes
   score_thr; dense also chunked: 2,160 in two chunks behind a full buffer
   of 150), as matched sets, a
   row kept by one side only printed with its
   IoU to the box that decided it and failing unless that IoU lies within
   1e-4 of 0.1. Then the eval through the test CLI's main from phase 7's
   SODA-A state written by save_checkpoint on 4 fabricated 1200 px images,
   and, from the same state with the dense teacher, on a fabricated SODA-A
   patch set under build/ (one 2000 px image split by data/patch.py into
   four 1200 px patches, PNGs and jsons) with the dataset paths and
   max_per_img 100 passed by --cfg-options;
10. the CLI at parity, on datasets written under build/ in the real
   on-disk layouts: an AI-TOD-v2 set (one COCO json a split with the 8
   class names, 8 train and 4 val 800 px PNGs of random pixels, 1-100 boxes
   of 4-16 px an image). tools.train main on the HBB config at full width
   (B=2, bf16) with --max-steps 6 --val-interval 1 and burn_in_step 2 (two
   epochs of 4 steps, phase 1 then phase 2), fed by TrainLoader: K1 / K2
   launched 3 / 3 in each phase-1 step and 2 / 2 in each phase-2 step (the
   counts read around every step), train and val records in
   train_log.jsonl, finite; epoch_1.pth, epoch_2.pth, latest.pth and
   best.pth with their meta; each step's wall and the loop's time between
   steps beside phase 7's wall on fabricated batches; the validations'
   seconds. Then a fresh state loaded from epoch_1.pth, bit-equal to the
   file (student, teacher, optimizer trace, point caches), with its time,
   and a resumed run into a second work dir (the `resumed from ... at step
   4` line, steps 5 and 6); tools.test main on best.pth over the on-disk val
   set; the trained state as a reference-format teacher-student file
   (teacher. / student. keys and keys no loader reads) through --torch-ckpt:
   the loaded teacher bit-equal to the state's, the headline equal to
   latest.pth's. Then each baseline config (fcos, rfla_fcos) for 3 steps
   with --val-interval 1 at 800 px: step ms, peak memory, a val batch's
   inference ms of the teacher as trained and dense (FCOS: make_dense;
   RFLA: make_dense_rfla; every candidate passes, the class NMS runs its
   6 / 13 chunks with live candidates), no RoIAlign launch.
   Then the SODA-A config for 2 steps (phase 1, then 2) from a divData
   train split at 1200 px, no validation: K3 / K4 3 / 3 then 2 / 2. Prints
   the phase's own time;
11. the learning check on the card: first K1 / K2 and K3 / K4 against
   their plain versions (phase 3's checks and tolerances) at the pools a
   point_teacher_torch.tools.sanity_train step gives them in f32: B=4, 4
   GTs of its fabricated objects (make_visible_batch, make_visible_rbatch)
   with the bags of its build_config (one proposal a GT, extensive ratios
   1.0 / 1.2 / 0.8: 36 reg rois an image) and 16 negatives an image, built
   by mil_rois / rotated_mil_rois, on a 16 x 16 map (128 px: the HBB group
   window of 24 cells is the whole map) and a 32 x 32 map (256 px, where
   the runs train); then sanity_train's run, in this
   process, for the fcos trainer (600 steps at 256 px), the point_teacher
   trainer (300 steps) and the rotated trainer (350 steps; both at 256 px,
   burn-in half the steps), all
   from scratch (--frozen-stages 0), f32, each with the launch counts set
   to 0 just before and read just after: each must exit 0 (LEARNING: OK,
   the student's AP@0.25 up by more than 0.02); fcos launches no RoIAlign
   kernel, point_teacher K1 / K2 3 / 3 a phase-1 step and 2 / 2 a phase-2
   step and no K3 / K4, rotated the same with K3 / K4. Prints each run's
   AP before and after (and the teacher's), steps a second, launches per
   phase and the minimum pool coverage, and the phase's own time;
12. data parallel (point_teacher_torch/parallel): the card's compute mode
   and its name and power limit, then (a) a world of one rank over NCCL:
   the HBB config at full width (800 px, B=2, bf16) through the CLI's train
   function, a phase-1 then a phase-2 step, twice in this process and once
   in the world from the same seed: the world's metrics and student within
   twice the spread of the two one-process runs, K1 / K2 3 / 3 then 2 / 2
   in each run; (b) a world of two ranks on the one card over gloo with
   CUDA tensors, spawned by parallel/launch.py, each rank on one image of a
   global batch of 2: HBB and SODA-A at full width (f32 with TF32 off and
   conditioned, as phase 6), a phase-1 then a phase-2 step, every metric
   within rtol 1e-3 of this process's step on the global batch from the
   same weights and draws (beside the spread of two such one-process runs),
   student, teacher, optimizer state and caches bit-equal across the
   ranks, K1 / K2 (K3 / K4) 3 / 3 then 2 / 2 on each rank, read around each
   step; (c) tools.test main sharded over the two ranks on 8 fabricated
   800 px images (the HBB state of (b), every candidate kept): the AP@0.25
   table equal to one process's, as many detections an image, each image's
   sorted scores within 1e-3. Prints each rank's step ms beside one
   process's and the phase's own time. With a compute mode other than
   Default, (b) and (c) cannot run and say so.

13. steps per dispatch (train/superstep.py): the NMS fixpoint kernel
   (csrc/nms_fixpoint.cu) against its plain version, keep masks equal, at
   the synthesis's shape of the main path, on a suppression chain deeper
   than the rounds and on random boxes, timed beside the plain version and
   its bound; then for HBB (800 px) and SODA-A (1200 px), B=2, bf16, the
   config as trained: 4 phase-1 then 4 phase-2 steps from one seeded state
   through the trainer's scan, one dispatch a phase (a CUDA graph of the
   step: the first step eager, then the capture, then replays, under
   torch.cuda.set_sync_debug_mode("error") save the capture's own sync),
   each step's starting state, batch, draws and learning rates recorded;
   then each of those steps again eagerly, twice, from its recorded state
   with its inputs (the first time timed and under the sync check, the
   second time of a phase-2 step under the profiler: the host calls): every
   step's metrics (step_spreads) and its student, teacher, momentum and
   point caches after it within twice the spread of the two eager steps
   (at least 2% of the step's move for the student, teacher and momentum),
   the learning rates each replay copied in equal to the eager step's;
   held step by step because a chain of steps turns the atomics' rounding
   into metrics apart by up to 21 whatever ran; the kernels' launch
   counters, which count at the warm-up step and the capture and not at
   the replays (2 x 3 / 3 a phase-1 dispatch, 2 x 2 / 2 a phase-2 one);
   the phase-2 wall ms a step (median of 4) eager and replayed, the host
   calls that put work on the card a dispatch of 4, the device busy ms and
   idle share, with the card's name and power limit. Then tools.train main for fcos and
   rfla_fcos, 4 steps on fabricated batches, --steps-per-dispatch 3 (its
   scans under the sync check) against 1 (twice): every step's metrics
   within twice the spread of the two runs at 1. The spread of a metric is
   its difference between the two runs, or, where larger, its value times
   the step's largest relative difference (step_spreads: two runs that sum
   with atomics can agree on one metric by chance). Last, (d): the HBB
   config through the CLI's train function at --steps-per-dispatch 2 in a
   world of one rank over NCCL (the graph holds its all-reduces) against
   one process, every metric within 1e-3.

`--only 12` (or 13, or 12,13) runs phases 1, 2 and the named ones and
prints no result line (for work on those phases). Any failure ends the run with a nonzero exit. The last line
is the JSON contract line; the line before it is the card's name and power
limit, and the line before that the kernels JSON line (K1-K4, then the
NMS fixpoint kernel; `max_abs_err` is the largest of the f32 checks',
phases 3 / 4 and 11, and for the fixpoint the keep flags that differ),
after the run's total seconds.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import os
import shutil
import socket
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
from point_teacher_torch.data.patch import patch_name, split_image
from point_teacher_torch.data.pipeline import make_tta_views
from point_teacher_torch.evalx.rgeometry import obb2poly_np
from point_teacher_torch.evalx.runner import build_infer, evaluate_detector, synthetic_val_set
from point_teacher_torch.inference import (build_tta_inference_fn, get_bboxes, get_rbboxes,
                                           score_sigmoid)
from point_teacher_torch.ops import nms as nms_ops
from point_teacher_torch.ops.boxes import bbox_overlaps, grid_points
from point_teacher_torch.ops import roi_align as ra
from point_teacher_torch.ops import roi_align_rotated as rr
from point_teacher_torch.ops.masks import rasterize_rboxes
from point_teacher_torch.ops.rotated import IOU_TILE_ROWS, rbox_iou, rbox_iou_tiled
from point_teacher_torch.parallel import dist, launch
from point_teacher_torch.tools import sanity_train as sanity
from point_teacher_torch.tools import test as test_cli
from point_teacher_torch.tools import train as cli
from point_teacher_torch.tools.profile_step import make_dense
from point_teacher_torch.train.rsteps import _flatten_rhead
from point_teacher_torch.train.steps import _flatten_head, make_draws
from point_teacher_torch.train.superstep import StepGraph, _map
from point_teacher_torch.utils.device import to_device
from point_teacher_torch.utils.checkpoint import save_checkpoint

IMG, FEAT, CH, B, G, NEG = 800, 100, 256, 2, 100, 200
HBB_CONFIG = "configs/point_teacher/aitodv2_point_teacher_0.py"
SODAA_CONFIG = "configs/point_teacher/sodaa_point_teacher_1x.py"
ROOT = os.path.dirname(os.path.abspath(__file__))
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


def mil_rois(seed: int, dev, boxes=None, cfgs=None, img: int = IMG, feat: int = FEAT,
             window: int = 24):
    """Reg bags, refined-bag + negative rois and their group-window clamp
    bounds, built as the MIL stage builds them from `boxes` (xyxy [b, g, 4]
    image px; by default B x G boxes of 4-16 px drawn from `seed`) with the
    (fine, extensive) proposal configs `cfgs` (by default one proposal a GT,
    EXT_RATIOS and NEG negatives an image) on an `img` px image, a `feat`
    map and group windows of `window` cells. At the defaults: reg bags
    [B, 2500, 4], cls + neg rois [B, 2700, 4]."""
    from point_teacher_torch.core.proposals import FineProposalCfg
    r = np.random.RandomState(seed)
    if boxes is None:
        cxy = r.uniform(12, img - 12, (B, G, 2))
        wh = r.uniform(4, 16, (B, G, 2))
        boxes = torch.tensor(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1),
                             dtype=torch.float32, device=dev)
    fine, extensive = cfgs or (FineProposalCfg(gen_num_neg=NEG),
                               FineProposalCfg(EXT_RATIOS, None, 4.0))
    b, g = boxes.shape[:2]
    props, pv = fine_proposals(boxes, fine, (img, img))
    ext, _ = fine_proposals(props.reshape(b, g, 4), extensive, (img, img))
    u = ext.shape[2]
    reg = ext.reshape(b, g * u, 4).contiguous()
    # refined bags: the reg bags moved by a few pixels, as the reg tower does
    cls = (reg + torch.tensor(r.uniform(-3, 3, reg.shape), dtype=torch.float32,
                              device=dev)).contiguous()
    neg_u = torch.tensor(r.uniform(size=(b, 4, fine.gen_num_neg)), dtype=torch.float32,
                         device=dev)
    neg, _ = negative_proposals(neg_u, props, pv, (img, img))
    ctr = (boxes[..., :2] + boxes[..., 2:]) / 2
    wy0, wx0, win = ra.group_window_origins(ctr, (feat, feat), window)
    member = ra.window_clamp(wy0, wx0, win, (feat, feat))[:, :, None].expand(b, g, u, 4)
    member = member.reshape(b, g * u, 4)
    cls_neg = torch.cat([cls, neg], 1).contiguous()
    cls_neg_clamp = torch.cat([member, ra.full_map_clamp((b, fine.gen_num_neg), (feat, feat),
                                                         dev)], 1)
    return reg, member.contiguous(), cls_neg, cls_neg_clamp.contiguous()


def edge_rois(dev):
    """Rois across the border, beyond [-1, size], zero-sized and with bins
    wider than 4 cells (the ADAPTIVE_SMAX clamp), image px."""
    e = torch.tensor([[-30, -30, 20, 20], [780, 760, 830, 820], [-90, -90, -20, -40],
                      [830, 10, 900, 60], [400, 300, 400, 360], [200, 500, 260, 500],
                      [0, 0, 799, 799], [-200, -100, 1000, 900], [10, 5, 700, 40]],
                     dtype=torch.float32, device=dev)
    return e[None].expand(B, -1, 4).contiguous()


def timed_on(fn, make, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of fn(*make()) over `reps` runs, each timed with CUDA
    events around fn alone (its inputs made before)."""
    for _ in range(warmup):
        fn(*make())
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        args = make()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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

def rotated_mil_rois(seed: int, dev, rboxes=None, cfgs=None, img: int = RIMG,
                     feat: int = RFEAT, window: int = RWIN):
    """Reg bags, refined-bag + negative rois and their clamp bounds, built as
    the rotated MIL stage builds them from `rboxes` ((cx, cy, w, h, a)
    [b, g, 5] image px; by default B x G boxes of 4-16 px drawn from `seed`)
    with the (fine, extensive) proposal configs `cfgs` (by default one
    proposal a GT, REXT_RATIOS and NEG negatives an image) on an `img` px
    image and a `feat` map: members share their GT's group window of
    `window` cells, negatives (angle 0) each get a window on their own
    centre. At the defaults: reg bags [B, 2500, 5], cls + neg [B, 2700, 5]."""
    from point_teacher_torch.core.proposals import FineProposalCfg
    from point_teacher_torch.ops.boxes import cxcywh_to_xyxy, xyxy_to_cxcywh
    r = np.random.RandomState(seed)
    if rboxes is None:
        rb = np.concatenate([r.uniform(12, img - 12, (B, G, 2)), r.uniform(4, 16, (B, G, 2)),
                             r.uniform(-np.pi / 2, np.pi / 2, (B, G, 1))], -1)
        rboxes = torch.tensor(rb, dtype=torch.float32, device=dev)
    fine, extensive = cfgs or (FineProposalCfg(gen_num_neg=NEG),
                               FineProposalCfg(REXT_RATIOS, None, 4.0))
    b, g = rboxes.shape[:2]
    hw = (img, img)
    props, pv = fine_proposals(cxcywh_to_xyxy(rboxes[..., :4]), fine, hw)
    ext, _ = fine_proposals(props.reshape(b, g, 4), extensive, hw)
    u = ext.shape[2]
    ang = rboxes[:, :, None, 4:5].expand(b, g, u, 1)
    reg = torch.cat([xyxy_to_cxcywh(ext), ang], -1).reshape(b, g * u, 5).contiguous()
    # refined bags: the reg bags moved and resized by a few pixels, as the reg tower does
    jitter = torch.tensor(np.concatenate([r.uniform(-3, 3, (b, g * u, 4)),
                                          np.zeros((b, g * u, 1))], -1),
                          dtype=torch.float32, device=dev)
    cls = (reg + jitter).contiguous()
    neg_u = torch.tensor(r.uniform(size=(b, 4, fine.gen_num_neg)), dtype=torch.float32,
                         device=dev)
    neg, _ = negative_proposals(neg_u, props, pv, hw)
    neg_rb = torch.cat([xyxy_to_cxcywh(neg), torch.zeros_like(neg[..., :1])], -1)
    wy0, wx0, win = ra.group_window_origins(rboxes[..., :2], (feat, feat), window)
    member = ra.window_clamp(wy0, wx0, win, (feat, feat))[:, :, None].expand(b, g, u, 4)
    member = member.reshape(b, g * u, 4).contiguous()
    cls_neg = torch.cat([cls, neg_rb], 1).contiguous()
    cls_neg_clamp = torch.cat([member, rr.roi_window_clamp(neg_rb, (feat, feat), window)], 1)
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
    rois where the bool mask `zero` [B, N] is set; the map's batch is the
    rois'. Returns the f32 errors {"fwd", "bwd", "bwd_atomic"} (the last:
    the atomic backward, which runs where clamp is None)."""
    fwd_tag, bwd_tag = fam.tags
    torch.manual_seed(seed)
    feat32 = torch.randn(cases[0][1].shape[0], fam.feat_hw, fam.feat_hw, ch, device=dev) * 4
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
            dout = torch.randn(*rois.shape[:2], 7, 7, ch, device=dev).to(dtype)
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
    must. Returns the launch counts of the run, the train state and the
    mean wall ms of each phase's steps 2, 3 ({1: ms, 2: ms})."""
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
    nms_ops.reset_launch_counts()
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
        fix0 = nms_ops.launch_counts()["fixpoint"]
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
        # the synthesis's rotated NMS finishes its fixpoint on the card: one
        # launch a phase-1 step
        fix = nms_ops.launch_counts()["fixpoint"] - fix0
        check(fix == int(phase1), f"{config} step {i + 1} (phase {phase}): {fix} fixpoint "
                                  f"launches, want {int(phase1)}")
        check(bool(state.points_cached[batch.image_ids].all()),
              f"{config} step {i + 1}: point caches not set")
        print(f"{config} step {i + 1} (phase {phase}): {step_ms[phase][-1]:.1f} ms "
              f"total_loss={m['total_loss']:.4f} loss_cls={m['loss_cls']:.4f} "
              f"loss_bbox={m['loss_bbox']:.4f} mil_bags={m['stage0_loss_mil_bags']:.4f} "
              f"coverage={m['stage0_cls_pool_coverage']:.4f} launches={got}", flush=True)
    peaks[2] = torch.cuda.max_memory_allocated()
    check(len(step_ms[1]) == 3 and len(step_ms[2]) == 3, f"{config}: phase switch {step_ms}")
    counts = kernels.launch_counts()
    launches = (counts["fwd"], counts["bwd"], nms_ops.launch_counts()["fixpoint"])
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
    print(f"main path {config}: launches {counts}, NMS fixpoint {launches[2]}; frozen unchanged "
          f"{len(frozen + unchanged)}, trainable moved {len(trainable)}", flush=True)
    return launches, state, {phase: float(np.mean(step_ms[phase][1:])) for phase in (1, 2)}


# --------------------------------------------------------------------------
# inference and eval (phase 8)
# --------------------------------------------------------------------------

def compare_nms(case: str, card, cpu) -> str:
    """Decode + NMS of the card against the CPU's, per image: the valid rows'
    (label, box) sets must be equal. Prints each row that only one side
    kept with its IoU against the other side's rows of its class (flips
    against the 0.5 threshold), then fails. Returns whether the outputs
    were also bit-identical in order and score."""
    (cd, cl, cv), (pd, pl, pv) = [x.cpu() for x in card], cpu
    if all(torch.equal(a, b) for a, b in ((cd, pd), (cl, pl), (cv, pv))):
        return "bit-identical, every row"
    bad = 0
    for b in range(B):
        rows = [{(int(l),) + tuple(d[:4].tolist()): float(d[4]) for d, l in zip(dd[vv], ll[vv])}
                for dd, ll, vv in ((cd[b], cl[b], cv[b]), (pd[b], pl[b], pv[b]))]
        for side, mine, other in (("card", rows[0], rows[1]), ("cpu", rows[1], rows[0])):
            for key in sorted(set(mine) - set(other)):
                bad += 1
                peers = [k for k in other if k[0] == key[0] and k not in mine]
                iou = (bbox_overlaps(torch.tensor([key[1:]]), torch.tensor([k[1:] for k in peers]))
                       if peers else torch.zeros(1, 0))
                top = sorted(zip(iou[0].tolist(), peers), reverse=True)[:3]
                print(f"  {case} image {b}: only the {side} kept label {key[0]} box "
                      f"{key[1:]} score {mine[key]:.9g}; IoU with the other side's rows of "
                      f"its class: {[(round(v, 6), v > 0.5) for v, _ in top]}", flush=True)
    check(bad == 0, f"{case}: the card's NMS differs from the CPU's in {bad} rows")
    err = float((cd[..., 4] - pd[..., 4]).abs().max())
    return f"the same sets; order or scores differ (max score diff {err:.3e})"


def phase_inference(dev, state) -> None:
    """Phase 8 (see the module docstring): the HBB teacher of `state`."""
    ra.reset_launch_counts()
    rr.reset_launch_counts()
    cfg = load_config(HBB_CONFIG)
    pt = cfg["pt"]
    check(pt.img_size == IMG and pt.batch_size == B and pt.test.nms_pre == 3000
          and pt.test.max_per_img == 3000 and pt.num_classes == 8, "test config drifted")
    infer = build_infer(pt)
    batches, _ = synthetic_val_set(pt, B, False)
    images = torch.as_tensor(batches[0], device=dev)
    ones = torch.ones((B, 4), device=dev)
    points = grid_points(FEAT, FEAT, pt.stride, device=dev)
    views = [{k: torch.as_tensor(v, device=dev) for k, v in view.items()}
             for view in make_tta_views(batches[0][0], (IMG,), True)]
    tta_fn = build_tta_inference_fn(pt.test, [IMG, IMG], pt.stride)
    dense = copy.deepcopy(state.teacher)
    make_dense(dense)

    def decode(heads, pts, scale):
        return get_bboxes(*heads, pts, (IMG, IMG), scale, pt.test)

    for case, model in (("as trained", state.teacher), ("dense", dense)):
        with torch.no_grad():
            heads = _flatten_head(model(images)[0])
        above = int((torch.sigmoid(heads[0]) > pt.test.score_thr).sum())
        card = decode(heads, points, ones)
        cpu = decode([h.cpu() for h in heads], points.cpu(), ones.cpu())
        same = compare_nms(case, card, cpu)
        n_valid = card[2].sum(-1).tolist()
        check(bool(torch.isfinite(card[0]).all()), f"{case}: non-finite detections")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fwd_ms = timed(lambda: model(images), reps=10)
        nms_ms = timed(lambda: decode(heads, points, ones), reps=10)
        infer_ms = timed(lambda: infer(model, images, ones), reps=10)
        peak = torch.cuda.max_memory_allocated()
        d, lab, v = tta_fn(model, views)
        check(d.shape == (1, pt.test.max_per_img, 5) and bool(torch.isfinite(d).all()),
              f"{case}: TTA output {tuple(d.shape)}")
        tta_ms = timed(lambda: tta_fn(model, views), reps=10)
        print(f"inference {case}: {above} of {B * FEAT * FEAT * pt.num_classes} class scores "
              f"above score_thr; valid detections per image {n_valid}; card vs cpu decode + "
              f"NMS: {same}", flush=True)
        print(f"inference {case} (B={B}, {IMG} px, bf16): forward ms={fwd_ms:.3f}, decode + "
              f"NMS ms={nms_ms:.3f}, infer ms={infer_ms:.3f} ({B * 1e3 / infer_ms:.3f} imgs/s); "
              f"TTA {IMG} px + flip (1 image, 2 views) ms={tta_ms:.3f}, valid {int(v.sum())}; "
              f"peak memory {peak / 2**30:.2f} GiB", flush=True)

    # the eval: phase 7's train state as tools.train --work-dir writes it, through the CLI
    ckpt_dir = os.path.join(ROOT, "build", "smoke_checkpoint")
    path = os.path.join(ckpt_dir, "latest.pth")
    save_checkpoint(state, path, meta=dict(step=state.step, num_images=12))
    try:
        t0 = time.perf_counter()
        ap = test_cli.main([os.path.join(ROOT, HBB_CONFIG), path, "--synthetic-data", "8"])
        host_s = time.perf_counter() - t0
        check(np.isfinite(ap), f"eval mAP {ap}")
        t0 = time.perf_counter()
        out = os.path.join(ckpt_dir, "dense.npz")
        dense_ap, stats = evaluate_detector(infer, dense, pt, cfg, synthetic_n=8, quiet=True,
                                            out=out)
        dense_s = time.perf_counter() - t0
        n_dets = [len(a) for a in np.load(out).values()]
    finally:
        shutil.rmtree(ckpt_dir)
    check(all(np.isfinite(x) for x in stats.values()), f"dense eval stats {stats}")
    print(f"eval (8 images at {IMG} px): as trained, through tools.test main, mAP@0.25 "
          f"{ap:.4f} in {host_s:.2f} s host time (the model's build and load included); "
          f"dense ({int(np.mean(n_dets))} detections an image) through evaluate_detector, "
          f"mAP@0.25 {dense_ap:.4f} in {dense_s:.2f} s host time", flush=True)
    counts = {"roi_align": ra.launch_counts(), "roi_align_rotated": rr.launch_counts()}
    check(not any(v for c in counts.values() for v in c.values()),
          f"inference launched RoIAlign kernels: {counts}")
    print(f"inference and eval launched no RoIAlign kernel: {counts}; class NMS chunk "
          f"{nms_ops.CLASS_NMS_CHUNK}", flush=True)


# --------------------------------------------------------------------------
# SODA-A inference and eval (phase 9)
# --------------------------------------------------------------------------

# card against CPU: (name, nms_pre, max_per_img), cut from 2000 / 2000 so
# that the CPU's polygon clip stays within seconds: 1,800 class-expanded
# candidates an image run one-shot; 2,160 run in two chunks (2048 and 112)
# behind a buffer of 150 that the first chunk fills
RCPU_CUTS = (("one-shot", 200, 2000), ("chunked", 240, 150))
RNMS_MARGIN = 1e-4     # a row kept by one side only: its IoU must lie this close to 0.1
RBOX_RTOL = 1e-5       # matched rows' boxes, relative to max(1, |value|)
# the kept pairs' IoU is recomputed on the boxes without the class offset,
# which moves cx to up to ~2e4 px in the NMS (f32 ulp 2e-3 px there)
IOU_SLACK = 1e-3
PATCH_MAX_PER_IMG = 100   # the patch eval's cut: its merge NMS is numpy, O(n^2) in Python


def _rrows(d, lab, v):
    """Image rows of rotated detections: {(label, score): [box, ...]}."""
    rows = {}
    for row, c in zip(d[v].tolist(), lab[v].tolist()):
        rows.setdefault((c, row[5]), []).append(row[:5])
    return rows


def compare_rnms(case: str, card, cpu, max_out: int) -> str:
    """Rotated decode + NMS of the card against the CPU's as matched sets,
    per image: rows matched by label and score (bit-equal on both: the f64
    sigmoid) with boxes within RBOX_RTOL. A row that only one side kept is
    printed with its IoU to the box that decided it (the other side's kept
    box of its class and higher score that overlaps it most); it fails
    unless that IoU lies within RNMS_MARGIN of 0.1, or the other side's
    buffer is full and the row scores below all of it (pushed out by a
    near-threshold row). Returns a summary."""
    (cd, cl, cv), (pd, pl, pv) = [x.cpu() for x in card], cpu
    if all(torch.equal(a, b) for a, b in ((cd, pd), (cl, pl), (cv, pv))):
        return "bit-identical, every row"
    near, tail, bad, box_err = 0, 0, 0, 0.0
    for b in range(cd.shape[0]):
        sides = [(dd[b], ll[b], vv[b]) for dd, ll, vv in ((cd, cl, cv), (pd, pl, pv))]
        rows = [_rrows(*sd) for sd in sides]
        only = ([], [])
        for key in set(rows[0]) | set(rows[1]):
            a, c = rows[0].get(key, []), rows[1].get(key, [])
            for box in a[len(c):]:
                only[0].append((key, box))
            for box in c[len(a):]:
                only[1].append((key, box))
            for x, y in zip(a, c):
                err = max(abs(p - q) / max(1.0, abs(q)) for p, q in zip(x, y))
                box_err = max(box_err, err)
        for side in (0, 1):
            od, ol, ov = sides[1 - side]
            full = int(ov.sum()) == max_out
            floor = float(od[ov][:, 5].min()) if int(ov.sum()) else float("inf")
            for (label, score), box in only[side]:
                peers = ov & (ol == label) & (od[:, 5] > score)
                iou = (float(rbox_iou(torch.tensor([box]), od[peers][:, :5]).max())
                       if bool(peers.any()) else 0.0)
                if abs(iou - 0.1) <= RNMS_MARGIN:
                    near += 1
                    kind = "near IoU 0.1"
                elif full and score <= floor:
                    tail += 1
                    kind = "below the other side's full buffer"
                else:
                    bad += 1
                    kind = "NOT near IoU 0.1"
                print(f"  {case} image {b}: only the {('card', 'cpu')[side]} kept label {label} "
                      f"box {[round(x, 4) for x in box]} score {score:.9g}; IoU to the box that "
                      f"decided it on the other side {iou:.7f} ({kind})", flush=True)
    check(bad == 0 and (tail == 0 or near > 0) and box_err <= RBOX_RTOL,
          f"{case}: the card's rotated NMS differs from the CPU's ({bad} rows not near IoU "
          f"0.1, {tail} tail rows, {near} near, box error {box_err:.3e})")
    return (f"matched sets; rows kept by one side only: {near} near IoU 0.1, {tail} below a "
            f"full buffer; matched boxes within {box_err:.3e} (relative)")


def check_rdets(case: str, dets, labels, valid) -> float:
    """Finite dets, valid rows first with scores descending, and within each
    class the kept boxes' pairwise IoU at most 0.1 + IOU_SLACK (recomputed
    on the card). Returns the largest such IoU."""
    check(bool(torch.isfinite(dets).all()), f"{case}: non-finite detections")
    worst = 0.0
    for b in range(dets.shape[0]):
        n = int(valid[b].sum())
        check(bool(valid[b, :n].all()), f"{case}: image {b}: valid rows not first")
        s = dets[b, :n, 5]
        check(bool((s[1:] <= s[:-1]).all()), f"{case}: image {b}: scores not descending")
        if n > 1:
            lab = labels[b, :n]
            iou = rbox_iou_tiled(dets[b, :n, :5], dets[b, :n, :5])
            same = (lab[:, None] == lab[None, :]) & ~torch.eye(n, dtype=torch.bool,
                                                                 device=lab.device)
            worst = max(worst, float(torch.where(same, iou, 0.0).max()))
    check(worst <= 0.1 + IOU_SLACK, f"{case}: kept boxes of one class overlap by IoU {worst}")
    return worst


def write_sodaa_layout(root: str, seed: int = 0) -> dict:
    """A SODA-A set in the divData / rawData layout, a val and a train split,
    each one 2000 x 2000 original image (random pixels) with 60 rotated GTs
    of 8-40 px, split by data/patch.py into four 1200 px patches (sizes
    (1200,), gaps (200,)), written as PNG pixels under the patch names the
    dataset reads, each patch's json with the GTs whose centre lies in it,
    translated, and, for val, the original's json. Returns the config's
    dataset paths."""
    from PIL import Image

    r = np.random.RandomState(seed)
    paths = {k: os.path.join(root, k) for k in ("ann", "img", "ori", "train_ann", "train_img")}
    for p in paths.values():
        os.makedirs(p, exist_ok=True)

    def write(path, boxes, labs):
        polys = obb2poly_np(boxes).reshape(-1, 8).tolist()
        with open(path, "w") as f:
            json.dump(dict(annotations=[dict(poly=p, category_id=int(c))
                                        for p, c in zip(polys, labs)]), f)

    for ann_dir, img_dir in (("ann", "img"), ("train_ann", "train_img")):
        img = r.randint(0, 255, (2000, 2000, 3)).astype(np.uint8)
        gts = np.concatenate([r.uniform(20, 1980, (60, 2)), r.uniform(8, 40, (60, 2)),
                              r.uniform(-np.pi / 2, np.pi / 2, (60, 1))], -1)
        labels = r.randint(0, 9, 60)
        if ann_dir == "ann":
            write(os.path.join(paths["ori"], "scene.json"), gts, labels)
        for patch, (x0, y0) in split_image(img, (1200,), (200,)):
            name = patch_name("scene.png", 1200, x0, y0)
            Image.fromarray(patch).save(os.path.join(paths[img_dir], name), format="PNG")
            h, w = patch.shape[:2]
            inside = ((gts[:, 0] >= x0) & (gts[:, 0] < x0 + w) & (gts[:, 1] >= y0)
                      & (gts[:, 1] < y0 + h))
            write(os.path.join(paths[ann_dir], name.replace(".jpg", ".json")),
                  gts[inside] - [x0, y0, 0, 0, 0], labels[inside])
    return dict(val_ann=paths["ann"], val_img_prefix=paths["img"], ori_val_ann=paths["ori"],
                train_ann=paths["train_ann"], train_img_prefix=paths["train_img"])


def phase_rotated_inference(dev, state) -> None:
    """Phase 9 (see the module docstring): the SODA-A teacher of `state`."""
    ra.reset_launch_counts()
    rr.reset_launch_counts()
    cfg = load_config(SODAA_CONFIG)
    pt = cfg["pt"]
    check(pt.img_size == RIMG and pt.batch_size == B and pt.test.nms_pre == 2000
          and pt.test.max_per_img == 2000 and pt.test.nms_iou == 0.1 and pt.num_classes == 9,
          "SODA-A test config drifted")
    m = pt.test.nms_pre * pt.num_classes
    chunks = -(-m // nms_ops.ROTATED_CLASS_NMS_CHUNK)
    infer = build_infer(pt, rotated=True)
    batches, _ = synthetic_val_set(pt, B, True)
    images = torch.as_tensor(batches[0], device=dev)
    ones = torch.ones((B, 4), device=dev)
    points = grid_points(RFEAT, RFEAT, pt.stride, device=dev)
    dense = copy.deepcopy(state.teacher)
    make_dense(dense)

    def decode(heads, pts, scale, test=pt.test):
        cls, bbox, angle, _ = heads
        return get_rbboxes(cls, torch.cat([bbox, angle], -1), pts, scale, test)

    for case, model in (("as trained", state.teacher), ("dense", dense)):
        with torch.no_grad():
            heads = _flatten_rhead(model(images)[0])
        above = int((score_sigmoid(heads[0]) > pt.test.score_thr).sum())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first = decode(heads, points, ones)
        second = decode(heads, points, ones)
        check(all(torch.equal(a, c) for a, c in zip(first, second)),
              f"{case}: two runs of decode + NMS differ")
        worst = check_rdets(case, *first)
        n_valid = first[2].sum(-1).tolist()
        with torch.no_grad():
            fwd_ms = timed(lambda: model(images), reps=10)
        # decode + NMS ran twice above, and the forward's warm-up: no more;
        # one run each (each ~4.8 s)
        nms_ms = timed(lambda: decode(heads, points, ones), reps=1, warmup=0)
        infer_ms = timed(lambda: infer(model, images, ones), reps=1, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        print(f"rotated inference {case}: {above} of {B * RFEAT * RFEAT * pt.num_classes} class "
              f"scores above score_thr; {m} class-expanded candidates an image in {chunks} "
              f"chunks of {nms_ops.ROTATED_CLASS_NMS_CHUNK} (IoU tiles of {IOU_TILE_ROWS} rows); "
              f"valid detections per image {n_valid}; scores descending; largest IoU of two kept "
              f"boxes of one class {worst:.6f}; two runs bit-identical", flush=True)
        print(f"rotated inference {case} (B={B}, {RIMG} px, bf16): forward ms={fwd_ms:.3f}, "
              f"decode + NMS ms={nms_ms:.3f}, infer ms={infer_ms:.3f} "
              f"({B * 1e3 / infer_ms:.3f} imgs/s); peak memory {peak / 2**30:.2f} GiB", flush=True)
        cpu_heads = [h.cpu() for h in heads]
        for cut, nms_pre, max_out in RCPU_CUTS:
            # the CPU's time (30-45 s a cut): the chunked cut runs on the
            # dense case only, and a case with no candidate above score_thr
            # (whose NMS keeps nothing) is not compared
            if case == "as trained" and (cut == "chunked" or not above):
                print(f"rotated inference {case}, {cut}: not compared on the CPU "
                      f"({above} class scores above score_thr)", flush=True)
                continue
            test = pt.test._replace(nms_pre=nms_pre, max_per_img=max_out)
            card = decode(heads, points, ones, test)
            t0 = time.perf_counter()
            cpu = decode(cpu_heads, points.cpu(), ones.cpu(), test)
            cpu_s = time.perf_counter() - t0
            same = compare_rnms(f"{case}, {cut}", card, cpu, max_out)
            print(f"rotated inference {case}, {cut} (nms_pre {nms_pre}: {nms_pre * 9} "
                  f"candidates an image, max_per_img {max_out}): valid per image "
                  f"{card[2].sum(-1).tolist()}; card vs cpu decode + NMS: {same}; "
                  f"cpu {cpu_s:.1f} s", flush=True)
        del heads, cpu_heads, first, second

    # the eval: phase 7's SODA-A train state as tools.train --work-dir writes
    # it, and the same state with the dense teacher, whose detections give
    # the patch set's merge NMS work to do
    ckpt_dir = os.path.join(ROOT, "build", "smoke_rcheckpoint")
    path = os.path.join(ckpt_dir, "latest.pth")
    dense_path = os.path.join(ckpt_dir, "dense.pth")
    meta = dict(step=state.step, num_images=12)
    save_checkpoint(state, path, meta=meta)
    save_checkpoint(dataclasses.replace(state, teacher=dense), dense_path, meta=meta)
    config = os.path.join(ROOT, SODAA_CONFIG)
    try:
        t0 = time.perf_counter()
        ap = test_cli.main([config, path, "--synthetic-data", "4"])
        synth_s = time.perf_counter() - t0
        check(np.isfinite(ap), f"SODA-A synthetic eval AP {ap}")
        layout = write_sodaa_layout(os.path.join(ckpt_dir, "sodaa"))
        out = os.path.join(ckpt_dir, "patches.npz")
        t0 = time.perf_counter()
        pap = test_cli.main([config, dense_path, "--out", out, "--cfg-options",
                             *[f"dataset.{k}={v}" for k, v in layout.items()
                               if not k.startswith("train")],
                             f"pt.test.max_per_img={PATCH_MAX_PER_IMG}"])
        patch_s = time.perf_counter() - t0
        merged = [a.shape for a in np.load(out).values()]
    finally:
        shutil.rmtree(ckpt_dir)
    check(np.isfinite(pap) and len(merged) == 1 and merged[0][1:] == (7,),
          f"SODA-A patch eval: AP {pap}, merged {merged}")
    print(f"rotated eval: 4 fabricated {RIMG} px images through tools.test main, AP .5:.95 "
          f"{ap:.4f} in {synth_s:.2f} s host time (the model's build and load included); the "
          f"patch set (one 2000 px image, 4 patches of 1200 px, 60 GTs) through tools.test "
          f"main, the dense teacher, pt.test.max_per_img cut to {PATCH_MAX_PER_IMG} (the "
          f"numpy merge NMS), "
          f"AP .5:.95 {pap:.4f}, {merged[0][0]} merged detections, in {patch_s:.2f} s host "
          f"time", flush=True)
    counts = {"roi_align": ra.launch_counts(), "roi_align_rotated": rr.launch_counts()}
    check(not any(v for c in counts.values() for v in c.values()),
          f"rotated inference launched RoIAlign kernels: {counts}")
    print(f"rotated inference and eval launched no RoIAlign kernel: {counts}", flush=True)


# --------------------------------------------------------------------------
# the CLI at parity (phase 10)
# --------------------------------------------------------------------------

FCOS_CONFIG = "configs/baselines/aitodv2_fcos_r50_1x.py"
RFLA_CONFIG = "configs/baselines/aitodv2_rfla_fcos_1x.py"
AITOD_CLASSES = ("airplane", "bridge", "storage-tank", "ship", "swimming-pool", "vehicle",
                 "person", "wind-mill")


def make_dense_rfla(model) -> None:
    """make_dense for an RFLAFCOS: the classification bias 0 (every
    candidate above score_thr) and each level's Scale such that
    exp(bias x scale) is 1.75 strides a side, so that a box spans ~3.5
    strides and neighbours suppress each other in chains."""
    head = model.bbox_head
    with torch.no_grad():
        head.conv_cls.bias.zero_()
        head.conv_reg.bias.fill_(1.0)
        for scale, stride in zip(head.scales, model.strides):
            scale.scale.fill_(float(np.log(1.75 * stride)))


def write_aitod_layout(root: str, seed: int = 0, n_train: int = 8, n_val: int = 4) -> dict:
    """An AI-TOD-v2 set in its on-disk layout: per split an image folder of
    800 x 800 PNGs of random pixels and one COCO json with the 8 AI-TOD class
    names, 1-100 boxes of 4-16 px an image. Returns the config's dataset
    paths."""
    from PIL import Image

    r = np.random.RandomState(seed)
    out = {}
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, split)
        os.makedirs(img_dir, exist_ok=True)
        images, anns = [], []
        for i in range(n):
            name = f"{split}_{i:04d}.png"
            Image.fromarray(r.randint(0, 255, (IMG, IMG, 3)).astype(np.uint8)).save(
                os.path.join(img_dir, name))
            images.append(dict(id=i + 1, file_name=name, width=IMG, height=IMG))
            for _ in range(r.randint(1, 101)):
                bw, bh = r.uniform(4, 16, 2)
                x, y = r.uniform(0, IMG - bw), r.uniform(0, IMG - bh)
                anns.append(dict(id=len(anns) + 1, image_id=i + 1, iscrowd=0,
                                 category_id=int(r.randint(1, 9)),
                                 bbox=[float(x), float(y), float(bw), float(bh)]))
        ann = os.path.join(root, f"aitodv2_{split}.json")
        with open(ann, "w") as f:
            json.dump(dict(images=images, annotations=anns, categories=[
                dict(id=i + 1, name=c) for i, c in enumerate(AITOD_CLASSES)]), f)
        out[f"{split}_ann"], out[f"{split}_img_prefix"] = ann, img_dir + "/"
    return out


class StepProbe:
    """Wraps the CLI's build_step so that each step of a run records its
    phase, the launches of `kernels` and of `others` it made, its wall
    (synchronised, host clock) and the time it ended; with `metrics`, also
    its metrics."""

    def __init__(self, kernels, others, metrics: bool = False):
        self.kernels, self.others, self.rows = kernels, others, []
        self.metrics = metrics

    def __enter__(self):
        self.orig = cli.build_step

        def build(cfg, pt):
            fn = self.orig(cfg, pt)

            def step(state, batch, phase1=False):
                c0 = (self.kernels.launch_counts(), self.others.launch_counts())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = fn(state, batch, phase1=phase1)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                c1 = (self.kernels.launch_counts(), self.others.launch_counts())
                self.rows.append(dict(
                    phase1=phase1, step_ms=(t1 - t0) * 1e3, end=t1,
                    launches={k: v - c0[0][k] for k, v in c1[0].items()},
                    others=sum(c1[1].values()) - sum(c0[1].values())))
                if self.metrics:
                    self.rows[-1]["metrics"] = {k: float(v) for k, v in metrics.items()}
                return metrics

            return step

        cli.build_step = build
        return self

    def __exit__(self, *exc):
        cli.build_step = self.orig

    def check_launches(self, name: str, n_fwd) -> None:
        """Each step launched n_fwd(phase1) forwards and as many windowed
        backwards of `kernels`, nothing else of them and none of `others`."""
        for i, row in enumerate(self.rows):
            n = n_fwd(row["phase1"])
            want = {k: n if k in ("fwd", "bwd") else 0 for k in row["launches"]}
            check(row["launches"] == want and row["others"] == 0,
                  f"{name} step {i + 1} (phase {2 - row['phase1']}): launches "
                  f"{row['launches']} (others {row['others']}), want {want}")

    def walls(self, phase1: bool):
        """(step ms, loop ms) of the steps of one phase that are not the first
        of an epoch of 4 steps: each step's synchronised wall, and the time
        from the previous step's end to this one's (the loader's wait, the
        host-to-device copy, the step and the CLI's logging)."""
        rows = [(r, self.rows[i - 1]) for i, r in enumerate(self.rows)
                if i % 4 and r["phase1"] == phase1]
        return ([r["step_ms"] for r, _ in rows],
                [(r["end"] - prev["end"]) * 1e3 for r, prev in rows])


def run_cli(main, argv):
    """main(argv), its standard output also kept; returns (result, output)."""
    class Tee(io.TextIOBase):
        def __init__(self):
            self.parts = []

        def write(self, text):
            self.parts.append(text)
            return sys.__stdout__.write(text)

        def flush(self):
            sys.__stdout__.flush()

    tee = Tee()
    with contextlib.redirect_stdout(tee):
        result = main(argv)
    return result, "".join(tee.parts)


def check_log(work_dir: str, modes) -> list:
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    check([r["mode"] for r in log] == list(modes), f"{work_dir}: log modes "
          f"{[r['mode'] for r in log]}")
    bad = [r for r in log if not all(np.isfinite(v) for k, v in r.items() if k != "mode")]
    check(not bad, f"{work_dir}: non-finite log records {bad}")
    return log


def phase_cli(dev, fab_ms) -> None:
    """Phase 10 (see the module docstring); `fab_ms` is phase 7's HBB step
    wall on fabricated batches, {phase: ms}."""
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    try:
        _phase_cli(dev, root, fab_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 10 total: {time.perf_counter() - t_phase:.1f} s", flush=True)


def _phase_cli(dev, root: str, fab) -> None:
    from point_teacher_torch.data import AITODDataset, EvalLoader
    from point_teacher_torch.utils import checkpoint as ckpt
    from point_teacher_torch.utils.torch_port import load_reference_ts_checkpoint

    t0 = time.perf_counter()
    layout = write_aitod_layout(os.path.join(root, "aitod"))
    data_opts = [f"dataset.{k}={v}" for k, v in layout.items()]
    print(f"AI-TOD-v2 layout: 8 train and 4 val {IMG} px PNGs, 1-100 boxes of 4-16 px an "
          f"image, in {time.perf_counter() - t0:.1f} s", flush=True)
    hbb = os.path.join(ROOT, HBB_CONFIG)

    # the HBB Point-Teacher fed from disk: 6 steps, phase 1 then 2, two epochs
    d1 = os.path.join(root, "run")
    ra.reset_launch_counts()
    rr.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with StepProbe(ra, rr) as probe:
        t0 = time.perf_counter()
        state, out = run_cli(cli.main, [hbb, "--work-dir", d1, "--max-steps", "6",
                                        "--val-interval", "1", "--cfg-options",
                                        "pt.burn_in_step=2", *data_opts])
        run_s = time.perf_counter() - t0
    check(state.step == 6 and "training done at step 6" in out, "HBB CLI run did not reach 6")
    check([r["phase1"] for r in probe.rows] == [True] * 3 + [False] * 3,
          f"phase switch {[r['phase1'] for r in probe.rows]}")
    probe.check_launches("HBB from disk", lambda p1: 3 if p1 else 2)
    log = check_log(d1, ["train", "val", "train", "val"])
    val_s = [float(line.rsplit("; ", 1)[1].split()[0]) for line in out.splitlines()
             if ": val mAP = " in line]
    for name in ("epoch_1.pth", "epoch_2.pth", "latest.pth", "best.pth"):
        meta = ckpt.load_meta(os.path.join(d1, name))
        check(os.path.exists(os.path.join(d1, name)) and {"epoch", "step", "num_images"}
              <= set(meta), f"{name}: meta {meta}")
    check(ckpt.load_meta(os.path.join(d1, "latest.pth"))["step"] == 6, "latest.pth step")
    walls = []
    for phase1 in (True, False):
        steps, loops = probe.walls(phase1)
        ph = 1 if phase1 else 2
        walls.append(f"phase {ph}: step ms {np.mean(steps):.1f}, loop ms {np.mean(loops):.1f} "
                     f"(loader wait, copy and logging {np.mean(loops) - np.mean(steps):.1f}); "
                     f"phase 7 on fabricated batches {fab[ph]:.1f}")
    print(f"HBB from disk (aitodv2_point_teacher_0, {IMG} px, B={B}, bf16, burn_in_step 2): "
          f"per step launches {[r['launches'] for r in probe.rows]}; step ms "
          f"{[round(r['step_ms'], 1) for r in probe.rows]}; steps not first of an epoch: "
          f"{'; '.join(walls)}; validation s {val_s} (val mAP "
          f"{[r['val_mAP'] for r in log if r['mode'] == 'val']}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; whole run {run_s:.1f} s "
          f"(6 steps, 2 validations, 3 checkpoint files)", flush=True)

    # resume from epoch_1.pth: the loaded state bit for bit the file's, then steps 5 and 6
    t0 = time.perf_counter()
    pt0, fresh, _ = cli.setup(cli.apply_overrides(load_config(hbb), [*data_opts]), 8, 0, dev)
    ckpt.load_checkpoint(fresh, os.path.join(d1, "epoch_1.pth"))
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    saved = torch.load(os.path.join(d1, "epoch_1.pth"), map_location="cpu", weights_only=True)
    diff = [f"{b}.{k}" for b in ("student", "teacher")
            for k, v in getattr(fresh, b).state_dict().items()
            if not torch.equal(v.cpu(), saved[b][k])]
    diff += [f"trace.{lab}.{i}" for lab in ("base", "bias")
             for i, (x, y) in enumerate(zip(fresh.optimizer.trace[lab],
                                            saved["optimizer"]["trace"][lab]))
             if not torch.equal(x.cpu(), y)]
    diff += [n for n in ("origin_points", "refined_points", "points_cached")
             if not torch.equal(getattr(fresh, n).cpu(), saved[n])]
    check(not diff and fresh.step == 4 and fresh.optimizer.count == 4,
          f"resumed state differs from epoch_1.pth: {diff[:5]} step {fresh.step}")
    check(bool(fresh.points_cached.all()), "resumed point caches not all set")
    del fresh, saved
    d2 = os.path.join(root, "resumed")
    with StepProbe(ra, rr) as probe2:
        _, out2 = run_cli(cli.main, [hbb, "--work-dir", d2, "--max-steps", "6", "--resume-from",
                                     os.path.join(d1, "epoch_1.pth"), "--cfg-options",
                                     "pt.burn_in_step=2", *data_opts])
    check(f"resumed from {os.path.join(d1, 'epoch_1.pth')} at step 4" in out2
          and "training done at step 6" in out2 and len(probe2.rows) == 2,
          "resumed run: no resume line or not 2 steps")
    probe2.check_launches("HBB resumed", lambda p1: 3 if p1 else 2)
    shutil.rmtree(d2)
    print(f"resume: setup + load of epoch_1.pth {resume_s:.2f} s; student, teacher, optimizer "
          f"trace and count, point caches bit-equal to the file; the resumed run printed the "
          f"resume line at step 4 and took steps 5, 6", flush=True)

    # tools.test on best.pth over the on-disk val set; the reference-format
    # file of the state's branches through --torch-ckpt against latest.pth
    t0 = time.perf_counter()
    best_ap, _ = run_cli(test_cli.main, [hbb, os.path.join(d1, "best.pth"), "--cfg-options",
                                         *data_opts])
    best_s = time.perf_counter() - t0
    ts = os.path.join(root, "reference_ts.pth")
    sd = {f"{b}.{k}": v.cpu() for b in ("teacher", "student")
          for k, v in getattr(state, b).state_dict().items()}
    sd.update({"teacher.bbox_head.fc_iou.0.weight": torch.ones(1, 1024),
               "teacher.bbox_head.shared_fcs.0.weight": torch.ones(1024, 12544),
               "teacher.backbone.bn1.num_batches_tracked": torch.tensor(6)})
    torch.save({"state_dict": sd, "meta": {"epoch": 2}}, ts)
    del sd
    loaded = cli.build_model(load_config(hbb), 1, dev)
    load_reference_ts_checkpoint(loaded, ts, "teacher", num_stages=pt0.num_stages)
    tsd = state.teacher.state_dict()
    bad = [k for k, v in loaded.state_dict().items() if not torch.equal(v, tsd[k])]
    check(not bad, f"--torch-ckpt teacher differs from the state's: {bad[:5]}")
    del loaded
    ts_ap, _ = run_cli(test_cli.main, [hbb, "--torch-ckpt", ts, "--cfg-options", *data_opts])
    latest_ap, _ = run_cli(test_cli.main, [hbb, os.path.join(d1, "latest.pth"),
                                           "--cfg-options", *data_opts])
    check(np.isfinite(best_ap) and ts_ap == latest_ap,
          f"eval: best {best_ap}, --torch-ckpt {ts_ap} vs latest.pth {latest_ap}")
    print(f"tools.test: best.pth over the 4 on-disk val images mAP@0.25 {best_ap:.4f} in "
          f"{best_s:.2f} s host time; the reference-format file (teacher. / student. keys, "
          f"fc_iou, shared_fcs, num_batches_tracked) through --torch-ckpt: teacher bit-equal to "
          f"the state's, mAP@0.25 {ts_ap:.4f} = latest.pth's {latest_ap:.4f}", flush=True)
    del state
    shutil.rmtree(d1)
    os.remove(ts)
    torch.cuda.empty_cache()

    # the two box-supervised baselines: 3 steps each, a validation, their inference
    for config, name in ((FCOS_CONFIG, "fcos"), (RFLA_CONFIG, "rfla_fcos")):
        db = os.path.join(root, name)
        ra.reset_launch_counts()
        rr.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with StepProbe(ra, rr) as probe:
            bstate, out = run_cli(cli.main, [os.path.join(ROOT, config), "--work-dir", db,
                                             "--max-steps", "3", "--val-interval", "1",
                                             "--cfg-options", *data_opts])
        peak = torch.cuda.max_memory_allocated()
        probe.check_launches(name, lambda p1: 0)
        counts = {**ra.launch_counts(), **{f"rotated_{k}": v for k, v in rr.launch_counts()
                                           .items()}}
        check(not any(counts.values()), f"{name}: RoIAlign launches {counts}")
        check_log(db, ["train", "val"])
        cfg = load_config(config)
        pt = cfg["pt"]
        infer = build_infer(pt, False, cfg.get("trainer"))
        ds = AITODDataset(layout["val_ann"], layout["val_img_prefix"], filter_empty=False)
        _, imgs, scales, shapes = next(iter(EvalLoader(ds, B, IMG)))
        args = [torch.as_tensor(x, device=dev) for x in (imgs, scales, shapes)]
        dense = copy.deepcopy(bstate.teacher)
        (make_dense_rfla if name == "rfla_fcos" else make_dense)(dense)
        timing = {}
        for case, model in (("as trained", bstate.teacher), ("dense", dense)):
            d, _, v = infer(model, *args)
            check(bool(torch.isfinite(d).all()), f"{name} {case}: non-finite detections")
            with torch.no_grad():
                fwd_ms = timed(lambda: model(args[0]), reps=5, warmup=1)
            timing[case] = (fwd_ms, timed(lambda: infer(model, *args), reps=5, warmup=1),
                            v.sum(-1).tolist())
        check(all(n > 0 for n in timing["dense"][2]),
              f"{name} dense: valid {timing['dense'][2]}, an image kept nothing")
        del dense
        if name == "rfla_fcos":
            per_level = [min(pt.test.nms_pre, (-(-pt.img_size // s)) ** 2)
                         for s in (8, 16, 32, 64, 128)]
            m = sum(per_level) * pt.num_classes
            nms_txt = (f"{sum(per_level)} candidates ({per_level}) x {pt.num_classes} classes "
                       f"= {m} class-expanded an image, {-(-m // nms_ops.CLASS_NMS_CHUNK)} "
                       f"chunks of {nms_ops.CLASS_NMS_CHUNK}")
        else:
            m = min(pt.test.nms_pre, pt.feat_size ** 2) * pt.num_classes
            nms_txt = f"{m} class-expanded candidates an image, " \
                      f"{-(-m // nms_ops.CLASS_NMS_CHUNK)} chunks"
        check(not any(v for c in (ra.launch_counts(), rr.launch_counts()) for v in c.values()),
              f"{name}: inference launched RoIAlign kernels")
        steps = [r["step_ms"] for r in probe.rows]
        print(f"baseline {name} ({IMG} px, B={B}, bf16), from disk: step ms "
              f"{[round(x, 1) for x in steps]} (steps 2, 3: {np.mean(steps[1:]):.1f}); peak "
              f"memory {peak / 2**30:.2f} GiB; RoIAlign launches 0; inference of a val batch "
              f"(teacher; {nms_txt}): " + "; ".join(
                  f"{case}: forward ms {f:.3f}, whole ms {w:.3f}, valid {n}"
                  for case, (f, w, n) in timing.items()), flush=True)
        del bstate
        shutil.rmtree(db)

    # the SODA-A Point-Teacher fed from a divData train split: 2 steps, phase 1 then 2
    slayout = write_sodaa_layout(os.path.join(root, "sodaa"), seed=3)
    ds_dir = os.path.join(root, "sodaa_run")
    torch.cuda.empty_cache()
    with StepProbe(rr, ra) as probe:
        sstate, out = run_cli(cli.main, [os.path.join(ROOT, SODAA_CONFIG), "--work-dir", ds_dir,
                                         "--max-steps", "2", "--cfg-options",
                                         "pt.burn_in_step=0",
                                         f"dataset.train_ann={slayout['train_ann']}",
                                         f"dataset.train_img_prefix="
                                         f"{slayout['train_img_prefix']}"])
    check(sstate.step == 2 and [r["phase1"] for r in probe.rows] == [True, False],
          f"SODA-A from disk: {[r['phase1'] for r in probe.rows]}")
    probe.check_launches("SODA-A from disk", lambda p1: 3 if p1 else 2)
    check_log(ds_dir, ["train"])
    print(f"SODA-A from disk (sodaa_point_teacher_1x, {RIMG} px patches of a divData train "
          f"split, B={B}): per step launches {[r['launches'] for r in probe.rows]}; step ms "
          f"{[round(r['step_ms'], 1) for r in probe.rows]}", flush=True)
    del sstate


# --------------------------------------------------------------------------
# the learning check (phase 11)
# --------------------------------------------------------------------------

# (trainer, flags): sanity_train runs from scratch, as many steps as the
# smoke's time allows (PERF.md section 6 says which counts and why)
LEARNING_RUNS = (
    ("fcos", ["--steps", "600", "--img", "256"]),
    ("point_teacher", ["--steps", "300", "--img", "256", "--burn-in-frac", "0.5"]),
    ("rotated", ["--steps", "350", "--img", "256", "--burn-in-frac", "0.5"]),
)


def harness_cases(dev, img: int, rotated: bool):
    """The two pools of a sanity_train step at `img` px (B=4, 4 GTs of its
    fabricated objects, make_visible_batch or, `rotated`,
    make_visible_rbatch), built by mil_rois / rotated_mil_rois from
    build_config's proposal configs and pool window: the reg bags on their
    GTs' group windows (24 cells HBB, the whole map at 128 px; 16 rotated),
    and the cls bags with the 16 negatives an image (HBB on the whole map,
    rotated each on its own window). Returns (feature side, cases)."""
    args = sanity.parse_args(["--img", str(img)])
    cfg = sanity.build_config(args)
    make = sanity.make_visible_rbatch if rotated else sanity.make_visible_batch
    _, boxes, _ = make(np.random.RandomState(img), args.batch, img, args.gt, args.classes)
    boxes = torch.tensor(boxes, device=dev)
    cfgs = (cfg.fine_proposal_cfg[0], cfg.fine_proposal_extensive_cfg[0])
    if rotated:
        pools = rotated_mil_rois(img + 1, dev, boxes, cfgs, img, cfg.feat_size,
                                 cfg.mil_pool_window_rotated)
    else:
        pools = mil_rois(img + 1, dev, boxes, cfgs, img, cfg.feat_size, cfg.mil_pool_window)
    reg, member, cls_neg, cls_neg_clamp = pools
    return cfg.feat_size, [(f"harness{img} reg", reg, member, None),
                           (f"harness{img} cls+neg", cls_neg, cls_neg_clamp, None)]


def phase_learning(dev):
    """Phase 11 (see the module docstring). Returns the f32 errors of the
    K1 / K2 and of the K3 / K4 checks."""
    t_phase = time.perf_counter()
    errs = {False: [], True: []}
    for img in (128, 256):
        for rotated, fam in ((False, HBB), (True, ROT)):
            feat, cases = harness_cases(dev, img, rotated)
            errs[rotated].append(check_family(dataclasses.replace(fam, feat_hw=feat), dev,
                                              cases, seed=img))
    for trainer, flags in LEARNING_RUNS:
        argv = ["--trainer", trainer, "--frozen-stages", "0", "--log-interval", "100", *flags]
        torch.cuda.empty_cache()
        ra.reset_launch_counts()
        rr.reset_launch_counts()
        t0 = time.perf_counter()
        res, out = run_cli(sanity.run, argv)
        wall = time.perf_counter() - t0
        counts = {"roi_align": ra.launch_counts(), "roi_align_rotated": rr.launch_counts()}
        check(res["code"] == 0 and "LEARNING: OK" in out,
              f"sanity_train {trainer}: exit code {res['code']}, AP {res['ap0']:.4f} -> "
              f"{res['student_ap']:.4f}")
        n = res["steps_per_phase"]
        own = {"fcos": None, "point_teacher": "roi_align", "rotated": "roi_align_rotated"}[trainer]
        for phase, per_step in ((1, 3), (2, 2)):
            for mod, c in res["launches"][phase].items():
                want = per_step * n[phase] if mod == own else 0
                check(c == {"fwd": want, "bwd": want, "bwd_atomic": 0},
                      f"sanity_train {trainer} phase {phase}: {mod} launches {c}, want "
                      f"{want} / {want} over {n[phase]} steps")
        total = {m: {k: res["launches"][1][m][k] + res["launches"][2][m][k] for k in c}
                 for m, c in counts.items()}
        check(total == counts, f"sanity_train {trainer}: launches {counts} read around the "
                               f"run, {total} by phase")
        teacher = "" if res["teacher_ap"] is None else f", teacher {res['teacher_ap']:.4f}"
        cov = "" if trainer == "fcos" else (f"; min pool coverage {res['min_cov']:.4f} "
                                            f"(phase 2: {res['min_cov_p2']:.4f})")
        print(f"learning check {trainer} ({' '.join(argv)}): AP@0.25 {res['ap0']:.4f} -> "
              f"student {res['student_ap']:.4f}{teacher}; {res['steps']} steps in "
              f"{res['train_s']:.1f} s, {res['steps'] / res['train_s']:.3f} steps/s (the "
              f"evaluations {res['eval_s']:.1f} s; the run {wall:.1f} s); launches phase 1 "
              f"({n[1]} steps) {res['launches'][1]}, phase 2 ({n[2]} steps) "
              f"{res['launches'][2]}{cov}", flush=True)
    print(f"phase 11 total: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return merge_errs(*errs[False]), merge_errs(*errs[True])


# --------------------------------------------------------------------------
# data parallel (phase 12)
# --------------------------------------------------------------------------

def compute_mode() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else f"unknown ({out.stderr})"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def state_digests(state) -> dict:
    trace = [t for k in ("base", "bias") for t in state.optimizer.trace[k]]
    return dict(student=digest(state.student.state_dict().values()),
                teacher=digest(state.teacher.state_dict().values()), optimizer=digest(trace),
                caches=digest((state.origin_points, state.refined_points, state.points_cached)))


def dp_chain(config: str, dev):
    """A phase-1 then a phase-2 step of `config` at full width (f32 with
    TF32 off, as phase 6: a bf16 ulp is 4e-3, and a rank's batch-1
    convolutions round otherwise than the batch-2 ones; the CLI's setup, the
    seeded init conditioned as phase 6 conditions it) on
    the first two fabricated global batches of 2, through its step with the
    state's own draws; in a world, on this rank's rows. The launch counts
    are set to 0 before and read around each step. Returns the steps'
    (phase1, metrics, ms, launches) and the state."""
    cfg = apply_overrides(load_config(os.path.join(ROOT, config)), ["pt.burn_in_step=0"])
    rotated = bool(cfg.get("rotated"))
    kernels = rr if rotated else ra
    pt, state, step_fn = cli.setup(cfg, 4, 0, dev, dtype=torch.float32)
    condition(state)
    rows = dist.rank_rows(pt.batch_size)
    batches = cli.synthetic_dataset(4, pt, 0, rotated=rotated)(pt.batch_size)
    ra.reset_launch_counts()
    rr.reset_launch_counts()
    out = []
    for _ in range(2):
        batch = cli.to_batch({k: v[rows] for k, v in next(batches).items()}, dev)
        phase1 = cli.is_phase1(state.step, pt.burn_in_step)
        c0 = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step_fn(state, batch, phase1=phase1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out.append(dict(phase1=phase1, ms=ms, metrics={k: float(v) for k, v in metrics.items()},
                        launches={k: v - c0[k] for k, v in kernels.launch_counts().items()}))
    return out, state


DP_EVAL = ["--synthetic-data", "8", "--cfg-options", "pt.test.score_thr=0.0"]
DP_DEVICE = "cuda"   # the ranks' device: both on the one card


def dp_rank(out_dir: str) -> None:
    """One rank of phase 12 (b) and (c), on the one card over gloo: the
    HBB and the SODA-A chain on this rank's image, the digests of each
    state, then tools.test main on the HBB state (rank 0 saves it) over 8
    fabricated images, every candidate kept; results to out_dir/rank{r}.json."""
    dev = torch.device(DP_DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = dist.rank()
    res = {}
    ckpt = os.path.join(out_dir, "hbb.pth")
    for name, config in (("hbb", HBB_CONFIG), ("sodaa", SODAA_CONFIG)):
        steps, state = dp_chain(config, dev)
        res[name] = dict(steps=steps, digests=state_digests(state))
        if name == "hbb":
            save_checkpoint(state, ckpt, meta=dict(step=state.step, num_images=4))
        del state
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, out = run_cli(test_cli.main, [os.path.join(ROOT, HBB_CONFIG), ckpt, "--out",
                                     os.path.join(out_dir, "world.npz"), *DP_EVAL])
    res["eval"] = dict(out=out, s=time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)


def eval_table(out: str) -> list:
    """A tools.test output's metrics table, from its header to the headline."""
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("--- "))
    end = next(i for i, line in enumerate(lines) if line.startswith(("mAP@0.25 ", "AP .5:.95 ")))
    return lines[start:end] + [lines[end].split(";")[0]]


def phase_nccl_world1(dev) -> None:
    """Phase 12 (a): the HBB config through the CLI's train function,
    burn_in_step 0 (a phase-1, then a phase-2 step), twice in one process
    and once in a world of one rank over NCCL from the same seed; the
    world's metrics and student within twice the spread of the two runs,
    K1 / K2 3 / 3 then 2 / 2 in each run."""
    cfg = apply_overrides(load_config(os.path.join(ROOT, HBB_CONFIG)), ["pt.burn_in_step=0"])
    work = os.path.join(ROOT, "build", "smoke_dp")
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1")
    runs = {}
    try:
        for name in ("one", "one_again", "nccl1"):
            if name == "nccl1":
                os.environ.update(env, MASTER_PORT=str(free_port()))
                dist.init_from_env(cli.resolve_device(False))
                check(dist.active() and dist.world() == 1
                      and torch.distributed.get_backend() == "nccl",
                      "phase 12: no NCCL world of one rank")
            try:
                torch.cuda.empty_cache()
                ra.reset_launch_counts()
                rr.reset_launch_counts()
                with StepProbe(ra, rr, metrics=True) as probe:
                    state, _ = run_cli(lambda argv: cli.train(cfg, work, 0, dev, 4, 2), [])
                probe.check_launches(f"phase 12 (a) {name}", lambda phase1: 3 if phase1 else 2)
                check([r["phase1"] for r in probe.rows] == [True, False],
                      f"phase 12 (a) {name}: phases {[r['phase1'] for r in probe.rows]}")
                runs[name] = dict(rows=probe.rows, student={
                    k: v.detach().float().clone() for k, v in state.student.state_dict().items()})
                del state
            finally:
                if name == "nccl1":
                    dist.shutdown()
                    for k in (*env, "MASTER_PORT"):
                        os.environ.pop(k, None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    one, again, w = runs["one"], runs["one_again"], runs["nccl1"]
    for i in range(2):
        for k, want in one["rows"][i]["metrics"].items():
            spread = abs(again["rows"][i]["metrics"][k] - want)
            got = w["rows"][i]["metrics"][k]
            check(np.isfinite(got) and abs(got - want) <= 2 * spread,
                  f"phase 12 (a) step {i + 1} {k}: NCCL world of 1 {got} vs one process {want}, "
                  f"spread of two one-process runs {spread}")

    def apart(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    spread, got = apart(one["student"], again["student"]), apart(w["student"], one["student"])
    check(got <= 2 * spread, f"phase 12 (a): student {got} from one process, spread {spread}")
    print(f"phase 12 (a) NCCL world of 1, HBB {IMG} px B={B} bf16 through cli.train: metrics "
          f"and student within twice the spread of two one-process runs (student max |diff| "
          f"{got:.3e}, spread {spread:.3e}); step ms phase 1 / 2: NCCL "
          f"{w['rows'][0]['step_ms']:.1f} / {w['rows'][1]['step_ms']:.1f}, one process "
          f"{one['rows'][0]['step_ms']:.1f} / {one['rows'][1]['step_ms']:.1f}, "
          f"{again['rows'][0]['step_ms']:.1f} / {again['rows'][1]['step_ms']:.1f}; K1 / K2 "
          f"launches {[r['launches'] for r in w['rows']]}", flush=True)


def phase_two_ranks(dev) -> None:
    """Phase 12 (b) and (c): a world of two ranks on the one card over gloo
    with CUDA tensors (dp_rank), against this process on the global batch."""
    out_dir = os.path.join(ROOT, "build", "smoke_dp2")
    os.makedirs(out_dir, exist_ok=True)
    try:
        t0 = time.perf_counter()
        launch.spawn(dp_rank, 2, out_dir, backend="gloo", timeout=300)
        world_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        refs, again = {}, {}
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            for name, config in (("hbb", HBB_CONFIG), ("sodaa", SODAA_CONFIG)):
                # twice: the spread of one process (K2 and K4 sum in varying order)
                for runs in (refs, again):
                    runs[name], state = dp_chain(config, dev)
                    del state
                    torch.cuda.empty_cache()
            _, one_out = run_cli(test_cli.main, [os.path.join(ROOT, HBB_CONFIG),
                                                 os.path.join(out_dir, "hbb.pth"), "--out",
                                                 os.path.join(out_dir, "one.npz"), *DP_EVAL])
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        dets = [dict(np.load(os.path.join(out_dir, f"{n}.npz"))) for n in ("world", "one")]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    kernel_names = {"hbb": "K1 / K2", "sodaa": "K3 / K4"}
    for name, ref in refs.items():
        check(ranks[0][name]["digests"] == ranks[1][name]["digests"],
              f"phase 12 (b) {name}: the ranks' states differ {ranks[0][name]['digests']} "
              f"{ranks[1][name]['digests']}")
        worst, worst_key = 0.0, None
        for i, want in enumerate(ref):
            check(ranks[0][name]["steps"][i]["metrics"] == ranks[1][name]["steps"][i]["metrics"],
                  f"phase 12 (b) {name} step {i + 1}: the ranks' metrics differ")
            n = 3 if want["phase1"] else 2
            for r, rank in enumerate(ranks):
                got = rank[name]["steps"][i]
                check(got["phase1"] == want["phase1"] and all(
                    got["launches"][k] == (n if k in ("fwd", "bwd") else 0)
                    for k in got["launches"]),
                      f"phase 12 (b) {name} step {i + 1} rank {r}: launches {got['launches']}")
            for k, v in want["metrics"].items():
                got = ranks[0][name]["steps"][i]["metrics"][k]
                rel = abs(got - v) / max(abs(v), 1e-6)
                if rel >= worst:
                    worst, worst_key = rel, f"step {i + 1} {k}"
                check(np.isfinite(got) and rel <= 1e-3,
                      f"phase 12 (b) {name} step {i + 1} {k}: world of 2 {got} vs one process {v}")
        spread = max(abs(again[name][i]["metrics"][k] - v) / max(abs(v), 1e-6)
                     for i, want in enumerate(ref) for k, v in want["metrics"].items())
        print(f"phase 12 (b) two ranks on one card (gloo, CUDA tensors), {name} (f32, TF32 "
              f"off): {len(ref[0]['metrics'])} metrics of each step within rel {worst:.2e} "
              f"({worst_key}) of one process on the global batch (two one-process runs: "
              f"{spread:.2e}); student, teacher, optimizer and caches bit-equal "
              f"across the ranks; step ms phase 1 / 2: rank 0 "
              f"{ranks[0][name]['steps'][0]['ms']:.1f} / {ranks[0][name]['steps'][1]['ms']:.1f}, "
              f"rank 1 {ranks[1][name]['steps'][0]['ms']:.1f} / "
              f"{ranks[1][name]['steps'][1]['ms']:.1f}, one process {ref[0]['ms']:.1f} / "
              f"{ref[1]['ms']:.1f}; {kernel_names[name]} launches a step on each rank "
              f"{[s['launches'] for s in ranks[0][name]['steps']]}", flush=True)
    world_out = ranks[0]["eval"]["out"]
    check(world_out.count("eval sharded over 2 devices") == 1, "phase 12 (c): no sharded eval")
    got, want = eval_table(world_out), eval_table(one_out)
    check(got == want, f"phase 12 (c): the sharded eval's table {got} != one process's {want}")
    # a rank's forward runs at batch 1, one process's at 2: the convolutions
    # may round otherwise, so the detections are held as sets of scores
    check(dets[0].keys() == dets[1].keys()
          and all(len(dets[0][k]) == len(dets[1][k]) for k in dets[1]),
          "phase 12 (c): the sharded eval kept other detection counts than one process")
    score_diff = max(float(np.abs(np.sort(dets[0][k][:, 4]) - np.sort(dets[1][k][:, 4])).max(
        initial=0.0)) for k in dets[1])
    # an image's detections in another image's place would part by far more
    check(score_diff <= 1e-3, f"phase 12 (c): an image's sorted scores part by {score_diff} "
                              f"from one process's")
    print(f"phase 12 (c) tools.test sharded over the two ranks, 8 fabricated {IMG} px images, "
          f"every candidate kept ({sum(len(v) for v in dets[1].values())} detections, as one "
          f"process, the sorted scores within {score_diff:.2e}): the AP@0.25 table equals one "
          f"process's ({want[-1]}); {ranks[0]['eval']['s']:.2f} s in the world; the world "
          f"{world_s:.1f} s", flush=True)


def phase_data_parallel(dev) -> None:
    """Phase 12 (see the module docstring)."""
    t_phase = time.perf_counter()
    mode = compute_mode()
    print(f"phase 12: compute mode {mode}; {card_line()}", flush=True)
    phase_nccl_world1(dev)
    torch.cuda.empty_cache()
    if mode != "Default":
        print(f"phase 12 (b), (c): NOT RUN: compute mode {mode} lets one process a card "
              f"only", flush=True)
    else:
        phase_two_ranks(dev)
    print(f"phase 12 total: {time.perf_counter() - t_phase:.1f} s", flush=True)


# --------------------------------------------------------------------------
# steps per dispatch: the step as a CUDA graph (phase 13)
# --------------------------------------------------------------------------

K13 = 4                      # steps a dispatch, each phase
HOST_CALLS = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync")


def host_calls(fn):
    """fn() under the profiler (CUDA activity): (its result, the host calls
    that put work on the card, by kind, and the device busy ms, the union
    of the kernels' and copies' intervals)."""
    from torch.profiler import ProfilerActivity, profile

    from point_teacher_torch.tools.profile_step import _busy_us
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    calls = dict.fromkeys(HOST_CALLS, 0)
    device = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((e.time_range.start, e.time_range.end))
            continue
        for kind in HOST_CALLS:
            if kind in e.name:
                calls[kind] += 1
    return out, calls, _busy_us(device) / 1e3


@contextlib.contextmanager
def no_host_sync():
    """torch.cuda.set_sync_debug_mode("error") inside: any host sync raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def state_refs(state) -> dict:
    """The tensors of a train state that a step reads or moves, by name
    (the modules' parameters and buffers, the momentum, the point caches):
    the state's own tensors, not copies."""
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v for k, v in state.teacher.state_dict().items()})
    out.update({f"momentum.{g}.{i}": t for g in ("base", "bias")
                for i, t in enumerate(state.optimizer.trace[g])})
    out.update(origin=state.origin_points, refined=state.refined_points,
               cached=state.points_cached)
    return out


def snapshot(state) -> dict:
    return {k: v.detach().clone() for k, v in state_refs(state).items()}


@torch.no_grad()
def load_state(state, snap: dict, step: int, count: int) -> None:
    """`snap` (a snapshot) and the host counters into `state`, in place."""
    for k, v in state_refs(state).items():
        v.copy_(snap[k])
    state.step, state.optimizer.count = step, count


STATE_PARTS = ("student", "teacher", "momentum", "origin", "refined", "cached")


def part_apart(a: dict, b: dict) -> dict:
    """The largest |a - b| of each part of two states (state_refs names)."""
    tops = {p: [] for p in STATE_PARTS}
    for k, v in a.items():
        if v.numel():
            tops[k.split(".")[0]].append((v.float() - b[k].float()).abs().max())
    return {p: float(torch.stack(t).max()) if t else 0.0 for p, t in tops.items()}


@contextlib.contextmanager
def recorded_steps(log: list):
    """Inside, each step of a StepGraph (its eager warm-up step and each
    replay) appends to `log`, before it runs: a snapshot of the state, the
    host counters, the batch, the host draws and the negated learning rates
    the replay copies in (None for the warm-up step, which sets its own)."""
    warm_up, replay = StepGraph.warm_up, StepGraph.replay

    def record(g, batch, draws, neg_lr=None):
        log.append(dict(pre=snapshot(g.state), step=g.state.step,
                        count=g.state.optimizer.count, batch=batch, draws=draws,
                        neg_lr=None if neg_lr is None else neg_lr.clone()))

    def rec_warm_up(g, batch, draws):
        record(g, batch, draws)
        return warm_up(g, batch, draws)

    def rec_replay(g, batch, draws, neg_lr, out_row):
        record(g, batch, draws, neg_lr)
        return replay(g, batch, draws, neg_lr, out_row)

    StepGraph.warm_up, StepGraph.replay = rec_warm_up, rec_replay
    try:
        yield log
    finally:
        StepGraph.warm_up, StepGraph.replay = warm_up, replay


def graph_chain(config: str, dev) -> dict:
    """Phase 13 (a) / (b) of one fork: K13 phase-1 then K13 phase-2 steps at
    full width (bf16, the config as trained, the CLI's setup from seed 0,
    burn_in_step K13 - 1) through the trainer's scan, one dispatch a phase
    (the first step eager, then the capture, then replays; under
    no_host_sync save the capture's own sync), each step's state, counters,
    batch, draws and learning rates recorded as it starts (recorded_steps).
    Then each step of the two dispatches again, eagerly, from that same
    state with the same inputs, twice, on two other states of the same
    setup (each step under no_host_sync and timed; the second time of a
    phase-2 step under the profiler): the graph's metrics of the step and
    its state after the step within twice the spread of the two eager steps
    (step_spreads for the metrics; for the student, the teacher and the
    momentum at least 2% of the step's largest move). Held step by step and
    not as two chains: the atomics of K2 / K4 make two runs of a chain part
    by rounding, and the chain's discrete choices (pseudo boxes, the top-k
    of the proposals) turn that into metrics that differ by up to 21 from
    step 5 on (SODA-A, two eager chains against the graph's), whatever
    code ran. Then two more dispatches of the graph: the replays timed one
    by one, and under the profiler. Returns what check_graph_chain prints."""
    # the warmup ends after 2 steps: the learning rate a replay copies in
    # changes inside each phase's dispatch
    cfg = apply_overrides(load_config(os.path.join(ROOT, config)),
                          [f"pt.burn_in_step={K13 - 1}", "pt.optim.warmup_iters=2"])
    rotated = bool(cfg.get("rotated"))
    kernels, others = (rr, ra) if rotated else (ra, rr)
    n_images = 2 * K13 * B
    pt, state, _ = cli.setup(cfg, n_images, 0, dev)
    twins = [cli.setup(cfg, n_images, 0, dev)[1] for _ in range(2)]
    step_fn = cli.build_step(cfg, pt)
    scan = cli.build_step(cfg, pt, scan=True)
    arrays = list(cli.synthetic_dataset(n_images, pt, 0, rotated=rotated)(B))
    groups = {True: arrays[:K13], False: arrays[K13:]}
    run = dict(ms={}, calls={}, busy={}, launches={}, first_s=0.0, worst=0.0,
               apart={p: (0.0, 0.0) for p in STATE_PARTS})
    counters = lambda: (kernels.launch_counts(), nms_ops.launch_counts(),  # noqa: E731
                        sum(others.launch_counts().values()))
    for phase1 in (True, False):
        check(cli.is_phase1(state.step, pt.burn_in_step) == phase1,
              f"phase 13 {config}: step {state.step} is not phase {2 - phase1}")
        batches = [cli.to_batch(a, dev) for a in groups[phase1]]
        for mod in (kernels, others, nms_ops):
            mod.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_steps([]) as log, no_host_sync():
            ms = scan(state, batches, phase1=phase1)
        torch.cuda.synchronize()
        run["first_s"] += time.perf_counter() - t0
        run["launches"][phase1, "graph"] = counters()
        check(all(v.shape == (K13,) for v in ms.values()),
              f"phase 13 {config}: the scan's metrics are not [{K13}]")
        check(len(log) == K13 and log[0]["neg_lr"] is None
              and all(r["neg_lr"] is not None for r in log[1:]),
              f"phase 13 {config}: {len(log)} steps recorded, want a warm-up step and "
              f"{K13 - 1} replays")
        table = torch.stack(list(ms.values()), 1).cpu().tolist()
        graph_metrics = [dict(zip(ms, row)) for row in table]
        posts = [r["pre"] for r in log[1:]] + [snapshot(state)]
        for mod in (kernels, others, nms_ops):
            mod.reset_launch_counts()
        walls, calls, busy = [], dict.fromkeys(HOST_CALLS, 0), 0.0
        for i, rec in enumerate(log):
            first = K13 * (not phase1)
            check(rec["step"] == first + i and rec["count"] == first + i,
                  f"phase 13 {config}: replay {i + 1} of phase {2 - phase1} starts at step "
                  f"{rec['step']}, update {rec['count']}")
            eager = []
            for j, twin in enumerate(twins):
                load_state(twin, rec["pre"], rec["step"], rec["count"])
                draws = _map(lambda t: to_device(t, dev), rec["draws"])
                torch.cuda.synchronize()
                call = lambda: step_fn(twin, rec["batch"], phase1=phase1,  # noqa: E731
                                       draws=draws)
                t0 = time.perf_counter()
                if j == 0:
                    with no_host_sync():
                        m = call()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    if rec["neg_lr"] is not None:
                        check(torch.equal(twin.optimizer.neg_lr.cpu(), rec["neg_lr"]),
                              f"phase 13 {config} step {first + i + 1}: the replay's learning "
                              f"rates {rec['neg_lr'].tolist()}, eager "
                              f"{twin.optimizer.neg_lr.tolist()}")
                elif phase1:
                    m = call()
                else:
                    m, c, b = host_calls(call)
                    calls = {k: calls[k] + c[k] for k in calls}
                    busy += b
                eager.append({k: float(v) for k, v in m.items()})
            want, again = eager
            got = graph_metrics[i]
            check(set(got) == set(want), f"phase 13 {config} step {first + i + 1}: keys")
            spreads = step_spreads(want, again)
            for k, w in want.items():
                check(np.isfinite(got[k]) and abs(got[k] - w) <= 2 * spreads[k],
                      f"phase 13 {config} step {first + i + 1} {k}: graph {got[k]} vs eager "
                      f"{w}, spread of two eager steps {spreads[k]}")
                run["worst"] = max(run["worst"], abs(got[k] - w))
            e1, e2 = (state_refs(t) for t in twins)
            apart = part_apart(posts[i], e1)
            spread = part_apart(e2, e1)
            moved = part_apart(e1, rec["pre"])
            for p in STATE_PARTS:
                # a step with a stale learning rate, or left out, moves the
                # state by far more than 2% of its move from the eager step's
                s = max(spread[p], 1e-2 * moved[p]) if p in STATE_PARTS[:3] else spread[p]
                check(apart[p] <= 2 * s, f"phase 13 {config} step {first + i + 1}: graph "
                                         f"{p} {apart[p]} from eager, spread {s}")
                run["apart"][p] = max(run["apart"][p], (apart[p], s))
        run["launches"][phase1, "eager"] = counters()
        run["ms"][phase1] = walls
        if not phase1:
            run["calls"]["eager"], run["busy"]["eager"] = calls, busy
        del log, posts
    # the graph's time: the phase-2 dispatch again, each replay timed on
    # the host clock, then once more under the profiler
    batches = [cli.to_batch(a, dev) for a in groups[False]]
    walls = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan(state, [b], phase1=False)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    run["ms"]["graph"] = walls
    _, run["calls"]["graph"], run["busy"]["graph"] = host_calls(
        lambda: scan(state, batches, phase1=False))
    del state, twins, scan, step_fn
    torch.cuda.empty_cache()
    return run


SPREAD_FLOOR = 5e-4


def step_spreads(want: dict, again: dict) -> dict:
    """The spread of each metric of one step between two runs: its own
    difference, or, where larger, its value times the step's relative
    spread (the largest relative difference of any of the step's metrics)
    or SPREAD_FLOOR. Two runs that sum with atomics (K2, K4, cuDNN's weight
    gradients) can sum in the same order by chance, and then agree on a
    step that a third run, summing otherwise, does not (graph replays
    parted from two bit-equal eager runs by up to 2.9e-4 of a metric on
    the card)."""
    rel = max([abs(again[k] - w) / max(abs(w), 1e-6) for k, w in want.items()]
              + [SPREAD_FLOOR])
    return {k: max(abs(again[k] - w), rel * abs(w)) for k, w in want.items()}


def check_graph_chain(config: str, run: dict) -> dict:
    """The launch counts of graph_chain's run, and the printout; returns the
    numbers for the summary."""
    rotated = "sodaa" in config
    for (phase1, name), (counts, fix, other) in run["launches"].items():
        # the graph counts its warm-up step and its capture, not its
        # replays; the eager steps are two a recorded step
        n_steps = 2 if name == "graph" else 2 * K13
        n = (3 if phase1 else 2) * n_steps
        want = {k: n if k in ("fwd", "bwd") else 0 for k in counts}
        want_fix = {"fixpoint": n_steps if phase1 else 0}
        check(counts == want and fix == want_fix and other == 0,
              f"phase 13 {config} {name} phase {2 - phase1}: launches {counts} fixpoint "
              f"{fix} others {other}, want {want} {want_fix}")
    eager_ms = float(np.median(run["ms"][False]))
    graph_ms = float(np.median(run["ms"]["graph"]))
    calls_e = sum(run["calls"]["eager"].values())
    calls_g = sum(run["calls"]["graph"].values())
    idle_e = 1 - run["busy"]["eager"] / sum(run["ms"][False])
    idle_g = 1 - run["busy"]["graph"] / sum(run["ms"]["graph"])
    launches = run["launches"]
    print(f"phase 13 {config} ({RIMG if rotated else IMG} px, B={B}, bf16): {K13} phase-1 then "
          f"{K13} phase-2 steps as graph replays, each step held against two eager steps from "
          f"its own starting state with its inputs: every metric within twice their spread "
          f"(largest |graph - eager| {run['worst']:.3e}); states after each step, largest "
          + ", ".join(f"{k} {g:.3e} (spread {s:.3e})" for k, (g, s) in run["apart"].items())
          + f"; the replays' learning rates equal the eager steps'; no host sync in any timed "
          f"eager step, warm-up step or replay; launches counted {launches[True, 'graph'][0]} / "
          f"{launches[False, 'graph'][0]} (warm-up step and capture) against eager "
          f"{launches[True, 'eager'][0]} / {launches[False, 'eager'][0]} "
          f"({2 * K13} steps)", flush=True)
    print(f"phase 13 {config} phase-2 wall ms/step (median of {K13}): eager {eager_ms:.2f} "
          f"(each {', '.join(f'{w:.1f}' for w in run['ms'][False])}), graph {graph_ms:.2f} "
          f"(each {', '.join(f'{w:.1f}' for w in run['ms']['graph'])}); phase-1 eager "
          f"{float(np.median(run['ms'][True])):.2f}; host calls a dispatch of {K13}: eager "
          f"{calls_e} {run['calls']['eager']}, graph {calls_g} {run['calls']['graph']}; "
          f"device busy ms a dispatch: eager {run['busy']['eager']:.2f}, graph "
          f"{run['busy']['graph']:.2f}; idle share eager {idle_e:.3f}, graph {idle_g:.3f}; "
          f"first dispatches (warm-up, capture, replays) {run['first_s']:.1f} s; "
          f"{card_line()}", flush=True)
    return dict(eager_ms=eager_ms, graph_ms=graph_ms, calls=(calls_e, calls_g))


def baseline_cli(dev, config: str) -> None:
    """Phase 13 (c): tools.train main for `config` with --steps-per-dispatch
    3 against 1 (twice: the spread), 4 steps on 8 fabricated images (a
    group of 3, then one of 1 at --max-steps); the scans run under
    no_host_sync, save the capture."""
    work = os.path.join(ROOT, "build", "smoke_spd")
    orig = cli.build_step

    def strict_build(cfg, pt, scan=False):
        fn = orig(cfg, pt, scan)
        if not scan:
            return fn

        def strict(*args, **kwargs):
            with no_host_sync():
                return fn(*args, **kwargs)
        return strict

    recs = {}
    try:
        cli.build_step = strict_build
        for name, k in (("k1", 1), ("k1_again", 1), ("k3", 3)):
            shutil.rmtree(work, ignore_errors=True)
            _, out = run_cli(cli.main, [os.path.join(ROOT, config), "--synthetic-data", "8",
                                        "--max-steps", "4", "--work-dir", work,
                                        "--steps-per-dispatch", str(k)])
            recs[name] = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
            torch.cuda.empty_cache()
    finally:
        cli.build_step = orig
        shutil.rmtree(work, ignore_errors=True)
    one, again, three = recs["k1"], recs["k1_again"], recs["k3"]
    check([r["step"] for r in three] == [r["step"] for r in one] == list(range(1, 5)),
          f"phase 13 {config}: steps {[r['step'] for r in three]}")
    worst = 0.0
    for i, rec in enumerate(one):
        want = {k: v for k, v in rec.items() if k not in ("step", "epoch", "step_ms")}
        spreads = step_spreads(want, again[i])
        for k, w in want.items():
            check(np.isfinite(three[i][k]) and abs(three[i][k] - w) <= 2 * spreads[k],
                  f"phase 13 {config} step {i + 1} {k}: --steps-per-dispatch 3 {three[i][k]} vs "
                  f"1 {w}, spread of two runs {spreads[k]}")
            worst = max(worst, abs(three[i][k] - w))
    print(f"phase 13 {config} through tools.train: --steps-per-dispatch 3 against 1, 4 steps: "
          f"every metric within twice the spread of two runs at 1 (largest difference "
          f"{worst:.3e}); step_ms at 3 (the group's wall over 3) "
          f"{[round(r['step_ms'], 1) for r in three]}, at 1 {[round(r['step_ms'], 1) for r in one]}",
          flush=True)


def nccl_graph(dev) -> None:
    """Phase 13 (d): the HBB config through the CLI's train function at
    --steps-per-dispatch 2, 3 phase-2 steps (a group of 2, captured with its
    NCCL all-reduces, then one plain step), in this process and in a world
    of one rank over NCCL: every metric within 1e-3 of the one-process
    run's (bf16, K2's atomics; SPREAD_FLOOR)."""
    cfg = apply_overrides(load_config(os.path.join(ROOT, HBB_CONFIG)), ["pt.burn_in_step=-1"])
    work = os.path.join(ROOT, "build", "smoke_nccl_graph")
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1")
    runs = {}
    try:
        for name in ("one", "nccl1"):
            if name == "nccl1":
                os.environ.update(env, MASTER_PORT=str(free_port()))
                dist.init_from_env(cli.resolve_device(False))
                check(dist.active() and torch.distributed.get_backend() == "nccl",
                      "phase 13 (d): no NCCL world of one rank")
            try:
                torch.cuda.empty_cache()
                _, out = run_cli(lambda argv: cli.train(cfg, work, 0, dev, 8, 3,
                                                        steps_per_dispatch=2), [])
                runs[name] = [json.loads(line) for line in out.splitlines()
                              if line.startswith("{")]
            finally:
                if name == "nccl1":
                    dist.shutdown()
                    for k in (*env, "MASTER_PORT"):
                        os.environ.pop(k, None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    one, w = runs["one"], runs["nccl1"]
    check([r["step"] for r in w] == [r["step"] for r in one] == [1, 2, 3],
          f"phase 13 (d): steps {[r['step'] for r in w]}")
    worst = 0.0
    for i, rec in enumerate(one):
        want = {k: v for k, v in rec.items() if k not in ("step", "epoch", "step_ms")}
        for k, tol in step_spreads(want, want).items():
            got = w[i][k]
            check(np.isfinite(got) and abs(got - want[k]) <= 2 * tol,
                  f"phase 13 (d) step {i + 1} {k}: NCCL world of 1 {got} vs one process "
                  f"{want[k]}")
            worst = max(worst, abs(got - want[k]) / max(abs(want[k]), 1e-6))
    print(f"phase 13 (d) NCCL world of 1 at --steps-per-dispatch 2 (the group's graph holds "
          f"the all-reduces), HBB {IMG} px: 3 steps within rel {worst:.2e} of one process; "
          f"step_ms {[round(r['step_ms'], 1) for r in w]} against "
          f"{[round(r['step_ms'], 1) for r in one]}", flush=True)


def fixpoint_cases(dev):
    """Conflict matrices with the fixpoint's state after its rounds, as
    _greedy_suppress leaves them: (name, conflict, alive, keep). The main
    path's: the phase-1 synthesis NMS at the HBB config's full width (the
    synthesis's candidates, B=2, 2 x 100 + 10 slots, 32 rounds); then a row
    of 200 boxes each overlapping its neighbours (greedy keeps every other
    one: 64 rounds leave 72 alive), and 4 problems of 500 random boxes after
    2 rounds."""
    cases = []

    def state_after(iou, scores, thr, rounds, valid=None):
        if valid is not None:
            scores = torch.where(valid, scores, -torch.inf)
            iou = torch.where(valid[..., None, :] & valid[..., :, None], iou, 0.0)
        order = torch.argsort(-scores, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        conflict = (rank[..., None, :] < rank[..., :, None]) & (iou > thr)
        alive = torch.ones(iou.shape[:-1], dtype=torch.bool, device=iou.device)
        keep = torch.zeros_like(alive)
        for _ in range(rounds):
            alive, keep = nms_ops._round(conflict, alive, keep)
        return conflict.contiguous(), alive.contiguous(), keep.contiguous()

    pt = load_config(HBB_CONFIG)["pt"]
    arrays = next(cli.synthetic_dataset(2, pt, 7)(B))
    batch = cli.to_batch(arrays, dev)
    draws = make_syn_draws(torch.Generator().manual_seed(11), len(pt.shape_list), B, G, dev)
    captured = []
    real = nms_ops._greedy_suppress

    def spy(iou, scores, thr, iters=32):
        captured.append((iou, scores, thr, iters))
        return real(iou, scores, thr, iters)
    nms_ops._greedy_suppress = spy
    try:
        generate_black_paper_batch(draws, batch.image, batch.gt_boxes, batch.gt_valid,
                                   SynCfg(pt.shape_list, pt.img_size), pt.syn_fill_value)
    finally:
        nms_ops._greedy_suppress = real
    iou, scores, thr, iters = captured[0]
    cases.append(("synthesis (main path)", *state_after(iou, scores, thr, iters)))
    n = 200
    x = torch.arange(n, dtype=torch.float32, device=dev) * 4.0
    row = torch.stack([x, torch.zeros_like(x), x + 10.0, torch.full_like(x, 10.0)], -1)
    cases.append(("chain of 200", *state_after(bbox_overlaps(row, row),
                                               torch.linspace(1, 0.1, n, device=dev), 0.3, 64)))
    r = np.random.RandomState(13)
    cxy = r.uniform(0, 200, (4, 500, 2))
    wh = r.uniform(4, 40, (4, 500, 2))
    boxes = torch.tensor(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), dtype=torch.float32,
                         device=dev)
    cases.append(("4 x 500 random", *state_after(bbox_overlaps(boxes, boxes),
                                                 torch.rand((4, 500), device=dev), 0.3, 2)))
    return cases


def phase_fixpoint(dev, bw: float) -> dict:
    """The NMS fixpoint kernel against its plain version on every case
    (keep masks equal), its launches, and its time beside the plain
    version's at the main path's shape; the kernels-line numbers."""
    rows = {}
    for name, conflict, alive, keep in fixpoint_cases(dev):
        nms_ops.reset_launch_counts()
        want = nms_ops.finish_fixpoint_plain(conflict, alive.clone(), keep.clone())
        got = nms_ops.finish_fixpoint_cuda(conflict, alive.clone(), keep.clone())
        check(nms_ops.launch_counts() == {"fixpoint": 1},
              f"fixpoint {name}: launches {nms_ops.launch_counts()}")
        errs = int((got != want).sum())
        check(errs == 0, f"fixpoint {name}: {errs} keep flags differ from the plain version")
        fresh = lambda: (conflict, alive.clone(), keep.clone())  # noqa: E731
        ms = timed_on(nms_ops.finish_fixpoint_cuda, fresh)
        plain_ms = timed_on(nms_ops.finish_fixpoint_plain, fresh)
        # the bytes the kernel must move: the alive flags read, and for each
        # round the conflict rows of the boxes alive in it (twice: the newly
        # kept test and the suppression test), the keep flags written
        rounds_rows, a, k = 0, alive.clone(), keep.clone()
        while bool(a.any()):
            rounds_rows += int(a.sum())
            a, k = nms_ops._round(conflict, a, k)
        nbytes = alive.numel() * 2 + 2 * rounds_rows * conflict.shape[-1]
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=nbytes / bw * 1e3,
                          alive=int(alive.sum()))
        print(f"fixpoint {name}: conflict {tuple(conflict.shape)}, {int(alive.sum())} boxes "
              f"alive after the rounds, {rounds_rows} alive rows over the remaining rounds; "
              f"kernel = plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{nbytes / bw * 1e3:.6f} ms ({nbytes} bytes)", flush=True)
    return rows


def phase_graph(dev, bw: float) -> dict:
    """Phase 13 (see the module docstring); returns the fixpoint kernel's
    kernels-line numbers."""
    t_phase = time.perf_counter()
    fix = phase_fixpoint(dev, bw)
    for config in (HBB_CONFIG, SODAA_CONFIG):
        check_graph_chain(config, graph_chain(config, dev))
        torch.cuda.empty_cache()
    for config in ("configs/baselines/aitodv2_fcos_r50_1x.py",
                   "configs/baselines/aitodv2_rfla_fcos_1x.py"):
        baseline_cli(dev, config)
    nccl_graph(dev)
    print(f"phase 13 total: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return fix["synthesis (main path)"]


def build_all() -> None:
    """nvcc for every source at once (one process each), with -Xptxas -v."""
    t0 = time.perf_counter()
    mods = (ra, rr, nms_ops)
    with ThreadPoolExecutor(len(mods)) as pool:
        logs = list(pool.map(lambda mod: mod.build(ptxas_verbose=True), mods))
    print(f"[2/13] build: {time.perf_counter() - t0:.1f} s -> "
          f"{', '.join(str(m.LIBRARY) for m in mods)} (sm_90a)", flush=True)
    for mod, log in zip(mods, logs):
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


def main(argv=None):
    """Every phase; `--only 12` (or 13, or 12,13) runs phases 1, 2 and the
    named ones and prints no result line."""
    argv = sys.argv[1:] if argv is None else argv
    only = ({int(x) for x in argv[argv.index("--only") + 1].split(",")} if "--only" in argv
            else None)
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke needs a CUDA card",
              flush=True)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1/13] device: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all()

    def stage(k: int, text: str) -> None:
        print(f"[{k}/13] {text} (at {time.perf_counter() - t_start:.1f} s)", flush=True)

    if only:
        # a partial run (phases 1, 2 and the named ones), for work on one phase
        torch.backends.cudnn.allow_tf32 = True
        if 12 in only:
            stage(12, "data parallel")
            phase_data_parallel(dev)
        if 13 in only:
            stage(13, "steps per dispatch: the step as a CUDA graph")
            phase_graph(dev, peaks(name)[0])
        print(f"partial smoke (phases 1, 2, {sorted(only)}): "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0

    stage(3, "K1 / K2 checks against the plain version (AI-TOD shapes)")
    cases = hbb_cases(dev)
    errs = merge_errs(check_family(HBB, dev, cases, seed=0),
                      check_channels(HBB, dev, cases[2], seed=5))
    stage(4, "K3 / K4 checks against the plain version (SODA-A shapes)")
    cases = rotated_cases(dev)
    rerrs = merge_errs(check_family(ROT, dev, cases, seed=1),
                       check_channels(ROT, dev, cases[1], seed=6))
    del cases
    torch.cuda.empty_cache()
    stage(5, "kernel timing (bf16, main-path shapes)")
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
    stage(6, "port checks")
    for phase1 in (False, True):
        phase_port_check(dev, "aitodv2_point_teacher_0.py", phase1)
        phase_port_check(dev, "sodaa_point_teacher_1x.py", phase1)
    phase_synthesis_check(dev, "aitodv2_point_teacher_0.py")
    phase_synthesis_check(dev, "sodaa_point_teacher_1x.py")
    # the main paths run as in training: the default precision settings
    torch.backends.cudnn.allow_tf32 = True
    stage(7, "main paths")
    launches, hbb_state, hbb_ms = phase_main_path(
        dev, HBB_CONFIG, ra, rr,
        frozen=["backbone.conv1.weight", "backbone.layer1.0.conv2.weight",
                "backbone.layer3.0.bn1.weight"],
        unchanged=[],
        trainable=["backbone.layer3.0.conv2.weight", "bbox_head.conv_cls.weight",
                   "bbox_head.shared_fcs_bag.0.0.weight"])
    torch.cuda.empty_cache()
    rlaunches, sodaa_state, _ = phase_main_path(
        dev, SODAA_CONFIG, rr, ra,
        frozen=["backbone.conv1.weight", "backbone.bn1.weight",
                "backbone.layer1.0.conv2.weight", "backbone.layer1.0.bn1.weight"],
        unchanged=["backbone.layer3.0.bn1.running_mean", "backbone.layer3.0.bn1.running_var"],
        trainable=["backbone.layer3.0.bn1.weight", "backbone.layer3.0.bn1.bias",
                   "backbone.layer3.0.conv2.weight", "bbox_head.conv_angle.weight",
                   "bbox_head.cls_convs.0.gn.weight", "bbox_head.scale_angle.scale",
                   "bbox_head.shared_fcs_bag.0.0.weight"])
    torch.cuda.empty_cache()
    stage(8, "inference and eval")
    phase_inference(dev, hbb_state)
    del hbb_state
    torch.cuda.empty_cache()
    stage(9, "SODA-A inference and eval")
    phase_rotated_inference(dev, sodaa_state)
    del sodaa_state
    torch.cuda.empty_cache()
    stage(10, "the CLI at parity")
    phase_cli(dev, hbb_ms)
    torch.cuda.empty_cache()
    # the learning runs train as sanity_train does: the default precision settings
    stage(11, "the learning check (sanity_train)")
    herrs, hrerrs = phase_learning(dev)
    errs, rerrs = merge_errs(errs, herrs), merge_errs(rerrs, hrerrs)
    torch.cuda.empty_cache()
    stage(12, "data parallel")
    phase_data_parallel(dev)
    torch.cuda.empty_cache()
    stage(13, "steps per dispatch: the step as a CUDA graph")
    fix = phase_graph(dev, bw)

    kernels = kernel_rows(launches, errs, rows, "point_teacher_torch/csrc/roi_align.cu", (
        ("roi_align_fwd", "fwd", 0, "point_teacher_tpu/ops/roi_align_pallas.py:49"),
        ("roi_align_bwd", "bwd", 1, "point_teacher_tpu/ops/roi_align_pallas.py:83")))
    kernels += kernel_rows(rlaunches, rerrs, rrows,
                           "point_teacher_torch/csrc/roi_align_rotated.cu", (
        ("roi_align_rotated_fwd", "fwd", 0, "point_teacher_tpu/ops/rroi_pallas.py:79"),
        ("roi_align_rotated_bwd", "bwd", 1, "point_teacher_tpu/ops/rroi_pallas.py:110")))
    # not a Pallas kernel: it replaces the lax.while_loop that finishes JAX's
    # fixpoint on the device
    kernels.append({
        "name": "nms_fixpoint", "route": "cuda", "source": "point_teacher_torch/csrc/nms_fixpoint.cu",
        "replaces": "point_teacher_tpu/ops/nms.py:65", "launches": launches[2] + rlaunches[2],
        "max_abs_err": 0.0, "ms": fix["ms"], "plain_ms": fix["plain_ms"],
        "bound_ms": fix["bound_ms"], "bound_by": "bytes", "library_ms": None})
    print(f"smoke total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
