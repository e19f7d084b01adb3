"""Where a phase-2 step's time goes on the card.

  python -m point_teacher_torch.tools.profile_step [CONFIG]

Runs the full-width phase-2 step of CONFIG (default
configs/point_teacher/aitodv2_point_teacher_0.py: 800 px, B=2; the SODA-A
config sodaa_point_teacher_1x.py runs the rotated step at 1200 px) in bf16
on fabricated batches from a seeded init, WARMUP times, then STEPS times
timed with the host clock around a synchronised step, then STEPS more
times under torch.profiler. Prints per step: the wall time (unprofiled), the
device busy time (the union of the kernels' intervals, profiled) and the idle
share, the launches, the busy time inside each `pt.*` range of the step, and
the kernels with the most device time. Needs a CUDA card.
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..config_io import apply_overrides, load_config
from . import train as cli

WARMUP, STEPS, TOP = 2, 3, 20


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


DEFAULT_CONFIG = "configs/point_teacher/aitodv2_point_teacher_0.py"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config = argv[0] if argv else DEFAULT_CONFIG
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    cfg = apply_overrides(load_config(config), ["pt.burn_in_step=-1"])
    n_images = 2 * (WARMUP + 2 * STEPS)
    pt, state, step_fn = cli.setup(cfg, n_images, 0, dev)
    batches = [cli.to_batch(a, dev) for a in
               cli.synthetic_dataset(n_images, pt, 0, rotated=bool(cfg.get("rotated")))(pt.batch_size)]
    for batch in batches[:WARMUP]:
        step_fn(state, batch)
    torch.cuda.synchronize()
    walls = []
    for batch in batches[WARMUP:WARMUP + STEPS]:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches[WARMUP + STEPS:]:
            step_fn(state, batch)
        torch.cuda.synchronize()
    n = STEPS
    gpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in gpu if e.name.startswith("pt.")]   # the ranges on the device timeline
    kernels = [e for e in gpu if not e.name.startswith("pt.")]
    iv = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _busy_us(iv) / 1e3
    wall_ms = sum(walls)
    print(f"config: {config}; card: {torch.cuda.get_device_name(0)}; "
          f"steps: {n} timed, then {n} profiled")
    print(f"wall ms/step (not profiled): {wall_ms / n:.2f} "
          f"(each: {', '.join(f'{w:.1f}' for w in walls)})")
    print(f"device busy ms/step (profiled run): {busy_ms / n:.2f}; "
          f"idle share of the unprofiled wall time: {1 - busy_ms / wall_ms:.3f}")
    print(f"kernel launches/step: {len(kernels) // n}; distinct kernels: "
          f"{len({e.name for e in kernels})}")
    ranges = defaultdict(float)
    for sp in spans:
        inside = [(a, b) for a, b in iv if a >= sp.time_range.start and b <= sp.time_range.end]
        ranges[sp.name] += _busy_us(inside) / 1e3
    ranges["(outside the ranges: backward, point update)"] = busy_ms - sum(ranges.values())
    print("device busy ms/step by range:")
    for name, ms in sorted(ranges.items(), key=lambda kv: -kv[1]):
        print(f"  {name:46s} {ms / n:9.3f}  {ms / busy_ms:6.3f}")
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_kernel[e.name][1] += 1
    print(f"top {TOP} kernels by device time (ms/step, share of busy, launches/step):")
    for k, (ms, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {ms / n:8.3f} {ms / busy_ms:6.3f} {cnt // n:5d}  {k[:90]}")
    for k, (ms, cnt) in by_kernel.items():
        if "roi_align" in k:
            print(f"roi_align: {ms / n:.3f} ms/step, {cnt // n} launches/step  {k[:70]}")


if __name__ == "__main__":
    main()
