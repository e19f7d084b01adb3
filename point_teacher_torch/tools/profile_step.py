"""Where a step's time goes on the card.

  python -m point_teacher_torch.tools.profile_step [CONFIG] [--phase1 | --infer]

Runs the full-width phase-2 step (with --phase1 the phase-1 step) of CONFIG
(default configs/point_teacher/aitodv2_point_teacher_0.py: 800 px, B=2; the
SODA-A config sodaa_point_teacher_1x.py runs the rotated step at 1200 px) in
bf16 on fabricated batches from a seeded init, WARMUP times, then STEPS
times timed with the host clock around a synchronised step, then STEPS more
times under torch.profiler. With --infer the same for teacher inference of
one batch (forward, top-k, decode and the class NMS with the test settings
of the config: multiclass NMS for HBB, rotated multiclass NMS for SODA-A)
on the fabricated val images of the eval, twice: as initialised and dense
(`make_dense`: every candidate passes score_thr, neighbours overlap), with
the peak memory. Prints per step (or batch):
the wall time (unprofiled), the device busy time (the union of the
kernels' intervals, profiled) and the idle share, the launches, the busy
time and the launches inside each `pt.*` range of the step (a range
named `pt.<part>/<sub>` lies inside `pt.<part>` and is listed under it,
not counted twice; `pt.infer`, which launches nothing itself, shows only
as its parts `pt.infer/forward` and `pt.infer/nms`), and the kernels with
the most device time. Needs a CUDA card.
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..config_io import load_config
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


def report(prof, walls, label: str, outside: str) -> None:
    """Print the wall, busy, idle share, launches, per-range and per-kernel
    device time of len(walls) timed and as many profiled calls; `label`
    starts with the unit a call is ("step; ...", "batch; ...")."""
    n = len(walls)
    unit = label.split(";")[0]
    gpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in gpu if e.name.startswith("pt.")]   # the ranges on the device timeline
    kernels = [e for e in gpu if not e.name.startswith("pt.")]
    iv = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _busy_us(iv) / 1e3
    wall_ms = sum(walls)
    print(f"{label}; card: {torch.cuda.get_device_name(0)}; {n} timed, then {n} profiled")
    print(f"wall ms/{unit} (not profiled): {wall_ms / n:.2f} "
          f"(each: {', '.join(f'{w:.1f}' for w in walls)})")
    print(f"device busy ms/{unit} (profiled run): {busy_ms / n:.2f}; "
          f"idle share of the unprofiled wall time: {1 - busy_ms / wall_ms:.3f}")
    print(f"kernel launches/{unit}: {len(kernels) // n}; distinct kernels: "
          f"{len({e.name for e in kernels})}")
    ranges = defaultdict(float)
    counts = defaultdict(int)
    for sp in spans:
        inside = [(a, b) for a, b in iv if a >= sp.time_range.start and b <= sp.time_range.end]
        ranges[sp.name] += _busy_us(inside) / 1e3
        counts[sp.name] += len(inside)
    # a range the device shows is listed under its parent where the parent
    # shows too; a parent that launches nothing outside its sub-ranges
    # (pt.infer) has no span on the device, and its sub-ranges stand alone
    top = [k for k in ranges if "/" not in k or k.rsplit("/", 1)[0] not in ranges]
    ranges[outside] = busy_ms - sum(ranges[k] for k in top)
    counts[outside] = len(kernels) - sum(counts[k] for k in top)
    print(f"device busy ms/{unit} by range (ms, share of busy, launches/{unit}):")
    for name in sorted(top + [outside], key=lambda k: -ranges[k]):
        for sub in [name] + sorted(k for k in ranges if k.startswith(name + "/")):
            label = sub if sub == name else "  " + sub
            print(f"  {label:46s} {ranges[sub] / n:9.3f}  {ranges[sub] / busy_ms:6.3f} "
                  f"{counts[sub] // n:6d}")
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_kernel[e.name][1] += 1
    print(f"top {TOP} kernels by device time (ms/{unit}, share of busy, launches/{unit}):")
    for k, (ms, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {ms / n:8.3f} {ms / busy_ms:6.3f} {cnt // n:5d}  {k[:90]}")
    for k, (ms, cnt) in by_kernel.items():
        if "roi_align" in k:
            print(f"roi_align: {ms / n:.3f} ms/{unit}, {cnt // n} launches/{unit}  {k[:70]}")


def run_profiled(fn, inputs, label: str, outside: str) -> None:
    """WARMUP calls of fn(x) over the first inputs, STEPS timed, STEPS profiled."""
    for x in inputs[:WARMUP]:
        fn(x)
    torch.cuda.synchronize()
    walls = []
    for x in inputs[WARMUP:WARMUP + STEPS]:
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x in inputs[WARMUP + STEPS:]:
            fn(x)
        torch.cuda.synchronize()
    report(prof, walls, label, outside)


def make_dense(model) -> None:
    """Every candidate above score_thr, boxes of about 3.5 strides, so that
    neighbours 1 stride apart overlap by IoU ~0.56 and suppress each other in
    chains: the classification bias 0 (scores near 0.5) and the regression
    bias such that relu(bias x scale) x stride is 14 px a side. The HBB and
    the rotated head both decode bbox_pred as relu(conv_reg x scale) x
    stride, so this serves either; the rotated head's angle branch is left
    as it is."""
    head = model.bbox_head
    with torch.no_grad():
        head.conv_cls.bias.zero_()
        head.conv_reg.bias.fill_(14.0 / head.stride / float(head.scales[0].scale))


def profile_infer(cfg: dict, config: str, dev) -> None:
    """Teacher inference of one batch at full width, as initialised and dense."""
    from ..evalx.runner import build_infer, synthetic_val_set

    pt, rotated = cfg["pt"], bool(cfg.get("rotated"))
    model = cli.build_model(cfg, 0, dev)
    infer = build_infer(pt, rotated)
    batches, _ = synthetic_val_set(pt, pt.batch_size * (WARMUP + 2 * STEPS), rotated)
    images = [torch.as_tensor(b, device=dev) for b in batches]
    ones = torch.ones((pt.batch_size, 4), device=dev)
    for case in ("as initialised", "dense"):
        if case == "dense":
            make_dense(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        valid = []
        run_profiled(lambda x: valid.append(infer(model, x, ones)[2]), images,
                     f"batch; infer ({case}); config: {config}", "(outside the ranges)")
        print(f"valid detections per image (last batch): {valid[-1].sum(-1).tolist()}; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    phase1 = "--phase1" in argv
    infer = "--infer" in argv
    args = [a for a in argv if a not in ("--phase1", "--infer")]
    config = args[0] if args else DEFAULT_CONFIG
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    cfg = load_config(config)
    if infer:
        profile_infer(cfg, config, dev)
        return
    n_images = 2 * (WARMUP + 2 * STEPS)
    pt, state, step_fn = cli.setup(cfg, n_images, 0, dev)
    batches = [cli.to_batch(a, dev) for a in
               cli.synthetic_dataset(n_images, pt, 0, rotated=bool(cfg.get("rotated")))(pt.batch_size)]
    run_profiled(lambda b: step_fn(state, b, phase1=phase1), batches,
            f"step; config: {config}; phase {1 if phase1 else 2}",
            "(outside the ranges: backward, point update)")


if __name__ == "__main__":
    main()
