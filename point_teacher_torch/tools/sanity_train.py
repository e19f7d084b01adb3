"""Closed-loop learning check of the port (counterpart of tools/sanity_train.py):
train from scratch on fabricated images with VISIBLE objects (bright
class-coded rectangles on noise) and check that AP@0.25 rises.

  python -m point_teacher_torch.tools.sanity_train [--trainer fcos|point_teacher|rotated]
      [--steps N] [--img S] [--batch B] [--gt G] [--frozen-stages K]
      [--burn-in-frac F] [--eval-interval N] [--assert-no-collapse]
      [--metrics-out F.jsonl] [--cpu] ...

It drives the whole learning stack (model, targets, losses, optimizer,
teacher EMA, MIL with the RoIAlign kernels, inference, evaluator) without a
dataset on disk. Runs on the CUDA card unless --cpu is given; asked for CUDA
without a card it raises. The flags, their defaults, the fabricated data
(`make_visible_batch`, `make_visible_rbatch`: the same numpy RandomState
draws), the config (`build_config`), the printed lines, the --metrics-out
JSONL keys (`kind`, `step`, `lr` and the step's metrics; eval records
`phase`, `student_ap`, `teacher_ap`; tools/analyze_loop.py reads them) and
the exit codes are the JAX tool's:
  0 learning (the final student AP beats the initial one by more than 0.02),
  1 not improving, 2 collapsed (--assert-no-collapse: the final teacher AP
  under --collapse-ratio x its phase-2 peak), 3 the pool-coverage gate (the
  phase-2 minimum of cls_pool_coverage under 0.98).
The models run in f32 from the port's seeded init (seed 0), and the step's
draws come from the train state's torch.Generator seeded 0, so a run is not
the JAX tool's run: JAX's PRNG streams cannot be reproduced.

Beyond the JAX tool's lines it prints the training loop's step rate (the
evaluations excluded) and the RoIAlign kernels' launches in each phase;
`run` returns them with the APs. The minimum pool coverage is kept on the
device and read at the end, so a step adds no host sync beyond the metrics
read every --log-interval steps. The regression gate of the JAX record:

  python -m point_teacher_torch.tools.sanity_train --trainer point_teacher \\
      --steps 3000 --img 256 --frozen-stages 0 --burn-in-frac 0.2 \\
      --eval-interval 300 --assert-no-collapse
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from functools import partial

import numpy as np
import torch

N_DATA_BATCHES = 16


def make_visible_batch(rng, b, size, g, num_classes, objects="fill"):
    """Objects = rectangles with class-coded intensity, pixel range ~[0, 2]
    (training from a random init with identity FrozenBN needs normalised
    inputs). Returns (img [b, size, size, 3] f32, boxes [b, g, 4] xyxy,
    labels [b, g] int32).

    objects="fill": uniformly filled. On a uniform fill a slightly smaller
    crop is a purer class sample than the tight box, so MIL bag selection
    and the teacher's score-weighted box averaging prefer smaller members,
    and the teacher-student loop contracts its pseudo boxes.
    objects="ring": a full-intensity 3 px boundary and a 65%-intensity
    interior, so that the tight box is the best-scoring crop, as for real
    objects."""
    img = rng.uniform(0, 0.3, (b, size, size, 3)).astype(np.float32)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    for bi in range(b):
        for gi in range(g):
            w, h = rng.randint(8, 20, 2)
            x = rng.randint(4, size - w - 4)
            y = rng.randint(4, size - h - 4)
            c = rng.randint(0, num_classes)
            val = 1.0 + (c + 1) / num_classes
            for ch, v in ((c % 3, val), ((c + 1) % 3, 2.0 - val)):
                if objects == "ring":
                    img[bi, y:y + h, x:x + w, ch] = 0.65 * v
                    img[bi, y:y + 3, x:x + w, ch] = v
                    img[bi, y + h - 3:y + h, x:x + w, ch] = v
                    img[bi, y:y + h, x:x + 3, ch] = v
                    img[bi, y:y + h, x + w - 3:x + w, ch] = v
                else:
                    img[bi, y:y + h, x:x + w, ch] = v
            boxes[bi, gi] = [x, y, x + w, y + h]
            labels[bi, gi] = c
    return img, boxes, labels


def make_visible_rbatch(rng, b, size, g, num_classes, objects="fill"):
    """The rotated variant: class-coded rotated rectangles (cv2.fillPoly) on
    noise; returns (img, rboxes [b, g, 5] (cx, cy, w, h, a), labels).
    objects="ring" draws a full-intensity 3 px boundary and a 65% interior."""
    import cv2

    img = rng.uniform(0, 0.3, (b, size, size, 3)).astype(np.float32)
    rboxes = np.zeros((b, g, 5), np.float32)
    labels = np.zeros((b, g), np.int32)
    for bi in range(b):
        for gi in range(g):
            w, h = rng.randint(10, 24, 2)
            a = rng.uniform(-np.pi / 2, np.pi / 2)
            cx = rng.randint(20, size - 20)
            cy = rng.randint(20, size - 20)
            c = rng.randint(0, num_classes)
            val = 1.0 + (c + 1) / num_classes
            pts = cv2.boxPoints(((float(cx), float(cy)), (float(w), float(h)),
                                 float(np.degrees(a)))).astype(np.int32)
            mask = np.zeros((size, size), np.uint8)
            cv2.fillPoly(mask, [pts], 1)
            m = mask.astype(bool)
            if objects == "ring":
                ring = np.zeros((size, size), np.uint8)
                cv2.polylines(ring, [pts], isClosed=True, color=1, thickness=3)
                rm = ring.astype(bool)
                for ch, v in ((c % 3, val), ((c + 1) % 3, 2.0 - val)):
                    img[bi, :, :, ch][m] = 0.65 * v
                    img[bi, :, :, ch][rm] = v
            else:
                img[bi, :, :, c % 3][m] = val
                img[bi, :, :, (c + 1) % 3][m] = 2.0 - val
            rboxes[bi, gi] = [cx, cy, w, h, a]
            labels[bi, gi] = c
    return img, rboxes, labels


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Closed-loop learning check (PyTorch port)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gt", type=int, default=4)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--trainer", default="fcos", choices=["fcos", "point_teacher", "rotated"])
    ap.add_argument("--frozen-stages", type=int, default=1,
                    help="frozen backbone stages (0 from scratch: a frozen random stem "
                         "blocks learning)")
    ap.add_argument("--ema-alpha", type=float, default=0.99,
                    help="teacher EMA (the reference uses 0.999; 0.9 tracks the student "
                         "too fast after the phase switch)")
    ap.add_argument("--filter-score", type=float, default=0.0)
    ap.add_argument("--lamda", type=float, default=1.0)
    ap.add_argument("--position", type=float, default=0.0,
                    help="central fraction of the box for annotation-point sampling "
                         "(0 = centre, 1 = anywhere)")
    ap.add_argument("--burn-in-frac", type=float, default=0.7,
                    help="burn_in_step = frac * steps")
    ap.add_argument("--eval-interval", type=int, default=0,
                    help="evaluate teacher and student AP every N steps")
    ap.add_argument("--assert-no-collapse", action="store_true",
                    help="exit 2 if the final teacher AP drops below --collapse-ratio of "
                         "its phase-2 peak (needs --eval-interval), 3 if the phase-2 "
                         "pool coverage drops under 0.98")
    ap.add_argument("--collapse-ratio", type=float, default=0.7)
    ap.add_argument("--lr-epochs", type=int, default=12,
                    help="divide the run into N epochs for the reference's step-lr "
                         "schedule (x0.1 at epochs 8 and 11); 0 = constant lr")
    ap.add_argument("--pool-grouped", type=int, default=1, choices=[0, 1],
                    help="0 = exact per-roi MIL pooling (mil_pool_grouped=False)")
    ap.add_argument("--ablate-aug", action="store_true",
                    help="replace the strong augmentation with the identity view")
    ap.add_argument("--objects", default="fill", choices=["fill", "ring"],
                    help="fabricated-object texture (make_visible_batch)")
    ap.add_argument("--top-k", type=int, default=1, help="MIL selection top-k")
    ap.add_argument("--gen-neg", type=int, default=16,
                    help="negative proposals per image (reference: 200)")
    ap.add_argument("--ext-ratios", default="1.0,1.2,0.8",
                    help="extensive-bag base_ratios (comma list)")
    ap.add_argument("--metrics-out", default=None,
                    help="write one JSON line per --log-interval step (and per eval)")
    ap.add_argument("--log-interval", type=int, default=20)
    return ap.parse_args(argv)


def build_config(args):
    """The harness's PointTeacherConfig, as the JAX tool builds it: the
    harness's scale (classes, image, GTs, batch, burn-in), a fast teacher
    EMA, one bag a GT with --gen-neg negatives, --ext-ratios extensive bags,
    the synthetic fill at the normalised pixel range, a 10-step warmup at
    ratio 1 and the reference's step-lr schedule over --lr-epochs epochs."""
    from ..core.proposals import FineProposalCfg
    from ..train.config import PointTeacherConfig

    return PointTeacherConfig(
        num_classes=args.classes, img_size=args.img, max_gt=args.gt,
        batch_size=args.batch, burn_in_step=int(args.steps * args.burn_in_frac),
        ema_alpha=args.ema_alpha,
        filter_score=args.filter_score,
        lamda=args.lamda,
        position=args.position,
        num_training_burninstep1=args.gt, num_training_burninstep2=args.gt,
        top_k=args.top_k,
        fine_proposal_cfg=(FineProposalCfg(base_ratios=(1.0,), min_scale=0.0,
                                           gen_num_neg=args.gen_neg),),
        fine_proposal_extensive_cfg=(FineProposalCfg(
            base_ratios=tuple(float(r) for r in args.ext_ratios.split(",")),
            min_scale=4.0),),
        syn_fill_value=2.0,
        mil_pool_grouped=bool(args.pool_grouped),
        optim=PointTeacherConfig().optim._replace(
            base_lr=args.lr, warmup_iters=10, warmup_ratio=1.0,
            frozen_stages=args.frozen_stages,
            iters_per_epoch=(max(1, args.steps // args.lr_epochs)
                             if args.lr_epochs else 10 ** 9)),
    )


@contextlib.contextmanager
def harness_patches(ablate_aug: bool, objects: str):
    """The JAX tool's harness-side wrappers, on the port's step modules'
    attributes for the length of a run (the library's functions stay as
    they are): --ablate-aug swaps the strong augmentation for the identity
    view; --objects ring paints the synthetic boxes with the rings' 65%
    interior, so that phase 1 trains on objects like the real ones."""
    from ..ops.masks import rasterize_rboxes
    from ..train import rsteps, steps

    saved = []

    def patch(mod, name, value):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    if ablate_aug:
        patch(steps, "strong_augment", lambda aug, *draws: aug)
        patch(rsteps, "strong_augment_rotated", lambda aug, *draws: aug)
    if objects == "ring":
        gbp = steps.generate_black_paper_batch

        def ring_gbp(syn_draws, images, gt_boxes, gt_valid, syn_cfg, fill_value=255.0):
            img_syn, xyxy, rb, v = gbp(syn_draws, images, gt_boxes, gt_valid, syn_cfg,
                                       fill_value=fill_value)
            inner = torch.cat([rb[..., :2], (rb[..., 2:4] - 6.0).clamp(min=0.0), rb[..., 4:]],
                              -1)
            imask = rasterize_rboxes(inner, v, images.shape[1], images.shape[2])
            fill = torch.tensor(0.65 * fill_value, dtype=img_syn.dtype, device=img_syn.device)
            return torch.where(imask[..., None], fill, img_syn), xyxy, rb, v

        # rsteps synthesises through steps.synthesize, which reads this name
        patch(steps, "generate_black_paper_batch", ring_gbp)
    try:
        yield
    finally:
        for mod, name, value in reversed(saved):
            setattr(mod, name, value)


def _launches():
    from ..ops import roi_align, roi_align_rotated

    return {"roi_align": roi_align.launch_counts(),
            "roi_align_rotated": roi_align_rotated.launch_counts()}


def _delta(after, before):
    return {m: {k: after[m][k] - before[m][k] for k in after[m]} for m in after}


def run(argv=None) -> dict:
    """One run of the check; returns dict(code: the exit code, ap0,
    student_ap, teacher_ap (None for fcos), min_cov, min_cov_p2, steps,
    train_s (the loop less its evaluations), eval_s, launches {1: phase 1,
    2: phase 2} of the RoIAlign kernels by op module, steps_per_phase)."""
    args = parse_args(argv)
    from ..evalx.cocoeval import COCOStyleEval
    from ..inference import build_inference_fn, build_rotated_inference_fn
    from ..models.detector import StudentFCOS
    from ..models.rotated_detector import StudentRotatedFCOS
    from ..train.config import InferenceCfg
    from ..train.fcos_baseline import build_fcos_train_step
    from ..train.optim import lr_at
    from ..train.rsteps import build_rotated_train_step
    from ..train.state import Batch, create_train_state
    from ..train.steps import build_train_step
    from .train import resolve_device

    dev = resolve_device(args.cpu)
    cfg = build_config(args)
    rotated = args.trainer == "rotated"
    fcos = args.trainer == "fcos"
    if rotated:
        from ..evalx.rgeometry import rbox_iou_np

        model = StudentRotatedFCOS(num_classes=cfg.num_classes, num_stages=cfg.num_stages,
                                   frozen_stages=args.frozen_stages, dtype=torch.float32,
                                   seed=0).to(dev)
        step = build_rotated_train_step(cfg)
        infer = build_rotated_inference_fn(
            InferenceCfg(nms_pre=256, score_thr=0.05, nms_iou=0.1, max_per_img=64), args.img)
        make_batch = partial(make_visible_rbatch, objects=args.objects)
        box_dim = 5
        eval_kw = dict(iou_fn=rbox_iou_np,
                       area_fn=lambda b: b[:, 2] * b[:, 3] if len(b) else np.zeros(0))
    else:
        model = StudentFCOS(num_classes=cfg.num_classes, num_stages=cfg.num_stages,
                            frozen_stages=args.frozen_stages, dtype=torch.float32,
                            seed=0).to(dev)
        step = build_fcos_train_step(cfg) if fcos else build_train_step(cfg)
        infer = build_inference_fn(
            InferenceCfg(nms_pre=256, score_thr=0.05, nms_iou=0.5, max_per_img=64), args.img)
        make_batch = partial(make_visible_batch, objects=args.objects)
        box_dim = 4
        eval_kw = {}
    # the point caches are indexed by image id over the fixed dataset below
    state = create_train_state(model, cfg.optim, num_images=N_DATA_BATCHES * args.batch,
                               max_gt=args.gt, seed=0)
    ones = torch.ones((args.batch, 4), device=dev)
    eval_batches = []

    def evaluate(m, n_batches=4):
        if not eval_batches:   # the same RandomState(999) stream at every evaluation
            r = np.random.RandomState(999)
            eval_batches.extend(make_batch(r, args.batch, args.img, args.gt, args.classes)
                                for _ in range(n_batches))
        gts, dets = [], []
        for img, boxes, labels in eval_batches:
            d, l, v = (x.cpu().numpy() for x in infer(m, torch.as_tensor(img, device=dev), ones))
            for bi in range(args.batch):
                gts.append(dict(boxes=boxes[bi], labels=labels[bi].astype(np.int64)))
                dets.append((d[bi, v[bi], :box_dim], d[bi, v[bi], box_dim], l[bi, v[bi]]))
        gt = dict(img_ids=list(range(len(gts))),
                  classes=[f"c{i}" for i in range(args.classes)], annotations=gts)
        return COCOStyleEval(gt, dets, **eval_kw).evaluate()["mAP"]

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with harness_patches(args.ablate_aug, args.objects):
        ap0 = evaluate(state.student if fcos else state.teacher)
        print(f"AP@0.25 before training: {ap0:.4f}")

        # a fixed dataset cycled in epochs: the point caches are keyed by image
        # id, so an id must always map to the same image
        r = np.random.RandomState(0)
        dataset = []
        for bi in range(N_DATA_BATCHES):
            img, boxes, labels = make_batch(r, args.batch, args.img, args.gt, args.classes)
            dataset.append(Batch(
                image=torch.as_tensor(img, device=dev),
                gt_boxes=torch.as_tensor(boxes, device=dev),
                gt_labels=torch.as_tensor(labels, dtype=torch.long, device=dev),
                gt_valid=torch.ones((args.batch, args.gt), dtype=torch.bool, device=dev),
                image_ids=torch.arange(args.batch, device=dev) + bi * args.batch))
        peak_phase2_ap = -1.0
        # the grouped MIL pool's window coverage of the refined cls bags: the
        # gate reads phase 2, where the refined boxes train the student; the
        # minima stay on the device until the end
        min_cov = torch.ones((), device=dev)
        min_cov_p2 = torch.ones((), device=dev)
        mfile = open(args.metrics_out, "w") if args.metrics_out else None

        def mdump(rec):
            if mfile:
                mfile.write(json.dumps(rec) + "\n")
                mfile.flush()

        eval_s = 0.0
        n_phase1 = min(cfg.burn_in_step + 1, args.steps)
        start = switch = _launches()
        sync()
        t0 = time.perf_counter()
        try:
            for i in range(args.steps):
                if i == n_phase1:
                    switch = _launches()
                batch = dataset[i % N_DATA_BATCHES]
                metrics = step(state, batch, phase1=(i <= cfg.burn_in_step))
                for k, v in metrics.items():
                    if k.endswith("cls_pool_coverage"):
                        min_cov = torch.minimum(min_cov, v)
                        if i > cfg.burn_in_step:
                            min_cov_p2 = torch.minimum(min_cov_p2, v)
                if i % args.log_interval == 0:
                    extra = ""
                    if "coarse_bboxes_iou" in metrics:
                        extra = (f" coarse_iou={float(metrics['coarse_bboxes_iou']):.3f}"
                                 f" pseudo_iou={float(metrics.get('pseudo_mean_iou', 0)):.3f}")
                    if "pseudo_mean_wh" in metrics:
                        extra += (f" pwh={float(metrics['pseudo_mean_wh']):.1f}"
                                  f"/{float(metrics['pseudo_max_wh']):.0f}")
                    print(f"step {i}: total={float(metrics['total_loss']):.3f} "
                          f"cls={float(metrics['loss_cls']):.3f} "
                          f"bbox={float(metrics['loss_bbox']):.3f}" + extra, flush=True)
                    mdump(dict({k: float(v) for k, v in metrics.items()}, step=i,
                               kind="train", lr=lr_at(cfg.optim, i)))
                if args.eval_interval and i and i % args.eval_interval == 0:
                    t_eval = time.perf_counter()
                    s_ap = evaluate(state.student)
                    t_ap = s_ap if fcos else evaluate(state.teacher)
                    eval_s += time.perf_counter() - t_eval
                    phase = "burn-in" if i <= cfg.burn_in_step else "phase-2"
                    print(f"eval step {i} ({phase}): student AP={s_ap:.4f} "
                          f"teacher AP={t_ap:.4f}", flush=True)
                    mdump(dict(step=i, kind="eval", phase=phase, student_ap=s_ap,
                               teacher_ap=t_ap))
                    if i > cfg.burn_in_step:
                        peak_phase2_ap = max(peak_phase2_ap, t_ap)
            sync()
        finally:
            if mfile:
                mfile.close()
        train_s = time.perf_counter() - t0 - eval_s
        end = _launches()
        if args.steps <= n_phase1:
            switch = end
        launches = {1: _delta(switch, start), 2: _delta(end, switch)}

        student_ap = evaluate(state.student)
        print(f"AP@0.25 after {args.steps} steps (student): {student_ap:.4f}")
        teacher_ap = None
        if not fcos:
            teacher_ap = evaluate(state.teacher)
            print(f"AP@0.25 after {args.steps} steps (teacher): {teacher_ap:.4f}")
    ok = student_ap > ap0 + 0.02
    print("LEARNING:", "OK" if ok else "NOT IMPROVING")
    rate = args.steps / train_s if train_s > 0 else float("nan")
    print(f"train loop: {args.steps} steps in {train_s:.1f} s, {rate:.3f} steps/s "
          f"(evaluations excluded, {eval_s:.1f} s)")
    steps_per_phase = {1: n_phase1, 2: args.steps - n_phase1}
    for phase in (1, 2):
        print(f"RoIAlign launches in phase {phase} ({steps_per_phase[phase]} steps): "
              f"{launches[phase]}")
    min_cov, min_cov_p2 = float(min_cov), float(min_cov_p2)
    if not fcos:
        print(f"MIN cls_pool_coverage over run: {min_cov:.4f} "
              f"(phase-2 only: {min_cov_p2:.4f})")
    code = 0 if ok else 1
    if args.assert_no_collapse and not fcos:
        collapsed = (peak_phase2_ap > 0.05
                     and teacher_ap < args.collapse_ratio * peak_phase2_ap)
        print(f"COLLAPSE CHECK: peak phase-2 teacher AP={peak_phase2_ap:.4f}, "
              f"final={teacher_ap:.4f} (gate {args.collapse_ratio:.2f}*peak) -> "
              f"{'COLLAPSED' if collapsed else 'STABLE'}")
        if collapsed:
            code = 2
        elif min_cov_p2 < 0.98:
            print(f"POOL COVERAGE GATE: min phase-2 cls_pool_coverage {min_cov_p2:.4f} < 0.98 "
                  f"- grouped-pool window assumption violated where refined boxes train the "
                  f"student (widen mil_pool_window or set mil_pool_grouped=False)")
            code = 3
    return dict(code=code, ap0=ap0, student_ap=student_ap, teacher_ap=teacher_ap,
                min_cov=min_cov, min_cov_p2=min_cov_p2, steps=args.steps, train_s=train_s,
                eval_s=eval_s, launches=launches, steps_per_phase=steps_per_phase)


def main(argv=None) -> int:
    return run(argv)["code"]


if __name__ == "__main__":
    sys.exit(main())
