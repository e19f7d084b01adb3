"""Smoke run of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases:
1. device: the card's name and power limit; TF32 off for the checks;
2. build: nvcc builds the RoIAlign kernels from point_teacher_torch/csrc/;
3. K1 check: the forward kernel against the plain PyTorch version at the MIL
   shapes (f32 and bf16, with and without group-window clamp bounds);
4. K2 check: the d/dfeat kernel against autograd through the plain version,
   twice, reporting the run-to-run difference of the atomics;
5. timing: CUDA events, median of 20 runs after warm-up, at the two pool
   shapes a phase-2 step launches, beside the plain version and the bound;
6. port check: a tiny phase-2 step on the card (kernels) and on the CPU
   (plain version) from the same weights and draws must agree;
7. main path: 3 phase-2 steps at full width (800 px, B=2, ResNet-50 / FPN /
   PSAGG, 100 GTs, bags of 25, 200 negatives per image, bf16) through the
   functions the training CLI uses, with the kernels' launch counts.

Any failure ends the run with a nonzero exit. The last line is the JSON
contract line; the kernel table is the JSON line before the card line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from point_teacher_torch.config_io import apply_overrides, load_config
from point_teacher_torch.core.proposals import fine_proposals, negative_proposals
from point_teacher_torch.ops import roi_align as ra
from point_teacher_torch.tools import train as cli
from point_teacher_torch.train.steps import make_draws

IMG, FEAT, CH, B, G, NEG = 800, 100, 256, 2, 100, 200
EXT_RATIOS = (1.0, 1.2, 1.3, 0.8, 0.7)

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


def sample_count(rois: torch.Tensor) -> int:
    """Bilinear samples the kernels take for these rois (49 bins x sn_y x sn_x)."""
    _, _, bw, bh = ra._roi_geometry(rois)
    sn = torch.ceil(bw).clamp(1, 4) * torch.ceil(bh).clamp(1, 4)
    return int(sn.sum().item()) * 49


def bounds(rois, clamp, elt: int, bw: float, f32_rate: float):
    """(fwd_ms, fwd_by, bwd_ms, bwd_by): the least time for the function's bytes
    (each input read once, each output written once) and operations (4 taps x
    one multiply-add per channel per sample, plus the weight products)."""
    n = rois.shape[0] * rois.shape[1]
    feat_b = B * FEAT * FEAT * CH * elt
    pooled_b = n * 49 * CH * elt
    meta_b = rois.numel() * 4 + (0 if clamp is None else clamp.numel() * 4)
    flops = sample_count(rois) * CH * 12
    op_ms = flops / f32_rate * 1e3
    fwd = max((feat_b + meta_b + pooled_b) / bw * 1e3, op_ms)
    bwd = max((pooled_b + meta_b + feat_b) / bw * 1e3, op_ms)
    by = lambda t: "bytes" if t > op_ms else "operations"  # noqa: E731
    return fwd, by(fwd), bwd, by(bwd)


def phase_kernel_checks(dev):
    errs = {}
    torch.manual_seed(0)
    reg, member, cls_neg, cls_neg_clamp = mil_rois(1, dev)
    edge = edge_rois(dev)
    # group windows on the edge rois' own centres: the large ones escape them
    wy0, wx0, win = ra.group_window_origins((edge[..., :2] + edge[..., 2:]) / 2, (FEAT, FEAT), 24)
    edge_clamp = ra.window_clamp(wy0, wx0, win, (FEAT, FEAT)).contiguous()
    cases = [("reg_bags+clamp", reg, member), ("reg_bags", reg, None),
             ("cls+neg+clamp", cls_neg, cls_neg_clamp), ("edges", edge, None),
             ("edges+clamp", edge, edge_clamp)]
    feat32 = torch.randn(B, FEAT, FEAT, CH, device=dev) * 4
    fmax = float(feat32.abs().max())
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        feat = feat32.to(dtype)
        for name, rois, clamp in cases:
            got = ra.RoIAlignFunction.apply(feat, rois, clamp)
            want = ra.roi_align_plain(feat, rois, clamp)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            print(f"K1 {str(dtype)[6:]:8s} {name:16s} max_abs_err={err:.3e} "
                  f"(atol {tol * fmax:.3e})", flush=True)
            check(err <= tol * fmax, f"K1 {dtype} {name}: {err} > {tol * fmax}")
            if dtype == torch.float32:
                errs["fwd"] = max(errs.get("fwd", 0.0), err)
    # K2: d/dfeat against autograd through the plain version (f32)
    for name, rois, clamp in cases:
        dout = torch.randn(B, rois.shape[1], 7, 7, CH, device=dev)
        f = feat32.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(ra.roi_align_plain(f, rois, clamp), f, dout)
        runs = []
        for _ in range(2):
            f = feat32.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(ra.RoIAlignFunction.apply(f, rois, clamp), f, dout)
            runs.append(g)
        torch.cuda.synchronize()
        err = float((runs[0] - want).abs().max())
        scale = float(want.abs().max())
        rerun = float((runs[0] - runs[1]).abs().max())
        print(f"K2 float32  {name:16s} max_abs_err={err:.3e} (1e-4 x max|grad| "
              f"{1e-4 * scale:.3e}) run-to-run max diff={rerun:.3e}", flush=True)
        check(err <= 1e-4 * scale, f"K2 {name}: {err} > {1e-4 * scale}")
        errs["bwd"] = max(errs.get("bwd", 0.0), err)
    return errs


def phase_timing(dev, name):
    bw, f32_rate = peaks(name)
    reg, member, cls_neg, cls_neg_clamp = mil_rois(2, dev)
    feat = (torch.randn(B, FEAT, FEAT, CH, device=dev) * 4).to(torch.bfloat16)
    rows = {}
    for shape, rois, clamp in (("reg_bags", reg, member), ("cls+neg", cls_neg, cls_neg_clamp)):
        dout = torch.randn(B, rois.shape[1], 7, 7, CH, device=dev).to(torch.bfloat16)
        fk = feat.clone().requires_grad_(True)
        out_k = ra.RoIAlignFunction.apply(fk, rois, clamp)
        fp = feat.clone().requires_grad_(True)
        out_p = ra.roi_align_plain(fp, rois, clamp)
        t = {
            "fwd_ms": timed(lambda: ra.RoIAlignFunction.apply(feat, rois, clamp)),
            "fwd_plain_ms": timed(lambda: ra.roi_align_plain(feat, rois, clamp)),
            "bwd_ms": timed(lambda: torch.autograd.grad(out_k, fk, dout, retain_graph=True)),
            "bwd_plain_ms": timed(lambda: torch.autograd.grad(out_p, fp, dout,
                                                              retain_graph=True)),
        }
        fb, fby, bb, bby = bounds(rois, clamp, 2, bw, f32_rate)
        t.update(fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb, bwd_bound_by=bby,
                 rois=rois.shape[0] * rois.shape[1], samples=sample_count(rois))
        rows[shape] = t
        print(f"timing bf16 {shape:9s} N={rois.shape[1]}/img: "
              f"fwd kernel_ms={t['fwd_ms']:.4f} plain_ms={t['fwd_plain_ms']:.4f} "
              f"bound_ms={fb:.4f} ({fby}); bwd kernel_ms={t['bwd_ms']:.4f} "
              f"plain_ms={t['bwd_plain_ms']:.4f} bound_ms={bb:.4f} ({bby})", flush=True)
    return rows


def phase_port_check(dev):
    """One tiny phase-2 step on the card and on the CPU from the same weights
    and draws: the step's metrics must agree (TF32 is off, f32 throughout)."""
    cfg = apply_overrides(load_config("aitodv2_point_teacher_0.py"),
                          ["pt.img_size=64", "pt.max_gt=6", "pt.burn_in_step=-1",
                           "pt.num_training_burninstep2=6"])
    pt = cfg["pt"]
    results = {}
    for device in (torch.device("cpu"), dev):
        pt2, state, step_fn = cli.setup(pt, 4, 0, device, dtype=torch.float32)
        batch = next(cli.synthetic_dataset(4, pt2, 0)(pt2.batch_size))
        draws = make_draws(torch.Generator().manual_seed(5), pt2, pt2.batch_size, device)
        results[device.type] = {k: float(v) for k, v in
                                step_fn(state, cli.to_batch(batch, device), draws=draws).items()}
    worst = 0.0
    for k, want in results["cpu"].items():
        got = results["cuda"][k]
        rel = abs(got - want) / max(abs(want), 1e-6)
        worst = max(worst, rel)
        check(np.isfinite(got) and rel <= 1e-3, f"port check {k}: cuda {got} vs cpu {want}")
    print(f"port check: tiny phase-2 step, cuda (kernels) vs cpu (plain): "
          f"{len(results['cpu'])} metrics agree, worst rel diff {worst:.2e}", flush=True)


def phase_main_path(dev):
    cfg = apply_overrides(load_config("configs/point_teacher/aitodv2_point_teacher_0.py"),
                          ["pt.burn_in_step=-1"])
    pt, state, step_fn = cli.setup(cfg["pt"], 6, 0, dev)
    check(pt.img_size == IMG and pt.max_gt == G and pt.batch_size == B, "config drifted")
    student = state.student
    named = dict(student.named_parameters())
    watch = ["backbone.conv1.weight", "backbone.layer1.0.conv2.weight",
             "backbone.layer3.0.bn1.weight", "backbone.layer3.0.conv2.weight",
             "bbox_head.conv_cls.weight", "bbox_head.shared_fcs_bag.0.0.weight"]
    before = {k: named[k].detach().clone() for k in watch}
    teacher0 = dict(state.teacher.named_parameters())["bbox_head.conv_cls.weight"].detach().clone()
    batches = cli.synthetic_dataset(6, pt, 0)(pt.batch_size)
    torch.cuda.reset_peak_memory_stats()
    ra.reset_launch_counts()
    step_ms, per_step = [], []
    for i in range(3):
        arrays = next(batches)
        batch = cli.to_batch(arrays, dev)
        f0, b0 = ra.launches_fwd, ra.launches_bwd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step_fn(state, batch, phase1=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"step {i + 1}: non-finite metrics {bad}")
        per_step.append((ra.launches_fwd - f0, ra.launches_bwd - b0))
        check(per_step[-1] == (2, 2), f"step {i + 1}: launches fwd/bwd {per_step[-1]} != (2, 2)")
        check(bool(state.points_cached[batch.image_ids].all()),
              f"step {i + 1}: point caches not set")
        print(f"step {i + 1}: {step_ms[-1]:.1f} ms total_loss={m['total_loss']:.4f} "
              f"loss_cls={m['loss_cls']:.4f} loss_bbox={m['loss_bbox']:.4f} "
              f"mil_bags={m['stage0_loss_mil_bags']:.4f} "
              f"coverage={m['stage0_cls_pool_coverage']:.4f} launches={per_step[-1]}",
              flush=True)
    launches = (ra.launches_fwd, ra.launches_bwd)
    peak = torch.cuda.max_memory_allocated()
    moved = {k: float((named[k].detach() - before[k]).abs().max()) for k in watch}
    for k in ("backbone.conv1.weight", "backbone.layer1.0.conv2.weight",
              "backbone.layer3.0.bn1.weight"):
        check(moved[k] == 0.0, f"frozen parameter {k} changed by {moved[k]}")
    for k in ("backbone.layer3.0.conv2.weight", "bbox_head.conv_cls.weight",
              "bbox_head.shared_fcs_bag.0.0.weight"):
        check(moved[k] > 0.0, f"trainable parameter {k} did not change")
    t_now = dict(state.teacher.named_parameters())["bbox_head.conv_cls.weight"]
    check(float((t_now - teacher0).abs().max()) > 0.0, "teacher did not move by EMA")
    steady = step_ms[1:]
    print(f"main path: phase-2 step ms (steps 2, 3) = {steady[0]:.1f}, {steady[1]:.1f}; "
          f"imgs/s = {B * 1e3 / np.mean(steady):.3f}; peak memory "
          f"{peak / 2**30:.2f} GiB; launches fwd/bwd = {launches}", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke needs a CUDA card",
              flush=True)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1/7] device: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    log = ra.build(ptxas_verbose=True)
    print(f"[2/7] build: {time.perf_counter() - t0:.1f} s -> {ra.LIBRARY}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    print("[3/7, 4/7] kernel checks against the plain version", flush=True)
    errs = phase_kernel_checks(dev)
    print("[5/7] kernel timing (bf16, main-path shapes)", flush=True)
    rows = phase_timing(dev, name)
    print("[6/7] port check", flush=True)
    phase_port_check(dev)
    # the main path runs as in training: the default precision settings
    torch.backends.cudnn.allow_tf32 = True
    print("[7/7] main path", flush=True)
    launches = phase_main_path(dev)

    src = "point_teacher_torch/csrc/roi_align.cu"
    kernels = []
    for kname, key, idx, replaces in (
            ("roi_align_fwd", "fwd", 0, "point_teacher_tpu/ops/roi_align_pallas.py:49"),
            ("roi_align_bwd", "bwd", 1, "point_teacher_tpu/ops/roi_align_pallas.py:83")):
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[idx], "max_abs_err": errs[key],
            "ms": sum(r[f"{key}_ms"] for r in rows.values()),
            "plain_ms": sum(r[f"{key}_plain_ms"] for r in rows.values()),
            "bound_ms": sum(r[f"{key}_bound_ms"] for r in rows.values()),
            "bound_by": rows["reg_bags"][f"{key}_bound_by"],
            "library_ms": None,
        })
    print("kernels: " + json.dumps({"kernels": kernels}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
