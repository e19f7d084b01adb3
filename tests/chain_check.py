"""Chained train steps of both packages from one state, off the test suite:
the learning check's config (`tools/sanity_train.py` `build_config`: lr 0.01
from the first step, EMA 0.99, one bag a GT, 16 negatives, from scratch)
on its fabricated visible objects, JAX's draws replayed into the port, the
strong augmentation the identity view in both (as test_torch_step_chain.py
does), the port on one CPU thread:

  JAX_PLATFORMS=cpu python tests/chain_check.py hbb      # 4 phase-1 steps, then 4 phase-2
  JAX_PLATFORMS=cpu python tests/chain_check.py rotated  # 6 rotated phase-2 steps
  JAX_PLATFORMS=cpu python tests/chain_check.py rotated --reg-bias 1.0
  JAX_PLATFORMS=cpu python tests/chain_check.py rotated --reg-bias 1.0 --resync

at 256 px (the card's closed loops' size; at 64 px the harness's shape
priors leave the phase-1 gate closed, and rotated steps fall to the box
loss's -log(1e-6) floor). Prints each step's metrics of both packages and
their relative difference, each step's phase-1 gate, and after the chain
the student's distance to JAX's over how far JAX's student moved; exits 1
when a metric parts by more than test_torch_step_chain.py's 3%. With
--resync each step starts the port from JAX's state (student, teacher,
point caches; the momentum, which the metrics do not read, stays the
port's): a step that parts then parts by itself, not by what earlier steps
left. Minutes of
CPU; not collected by pytest."""
import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import test_torch_rotated_train_step as trs  # noqa: E402
import test_torch_train_step as tts  # noqa: E402
from point_teacher_tpu.train.optim import make_optimizer  # noqa: E402
from point_teacher_tpu.train.state import Batch as JaxBatch  # noqa: E402
from point_teacher_tpu.train.state import create_train_state as jax_create_state  # noqa: E402
from point_teacher_tpu.utils.torch_port import (load_torch_detector_into,  # noqa: E402
                                                load_torch_rotated_detector_into)
from point_teacher_torch.models.detector import StudentFCOS  # noqa: E402
from point_teacher_torch.models.rotated_detector import StudentRotatedFCOS  # noqa: E402
from point_teacher_torch.tools import sanity_train as port  # noqa: E402
from point_teacher_torch.train.state import create_train_state  # noqa: E402
from point_teacher_torch.utils.jax_weights import load_jax_params  # noqa: E402
from test_torch_models import NUM_CLASSES, random_flax_params  # noqa: E402
from test_torch_rotated_models import random_rotated_flax_params  # noqa: E402
from test_torch_sanity import _jax_config  # noqa: E402

B, G, N_BATCHES = tts.B, 4, 4
KEYS = ("total_loss", "loss_cls", "loss_bbox", "loss_centerness", "stage0_loss_mil_bags",
        "stage0_loss_mil_bbox", "coarse_bboxes_iou", "pseudo_mean_wh", "refined_points_distance")


def leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("fork", choices=["hbb", "rotated"])
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--phase1-steps", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--resync", action="store_true",
                    help="before each step, load JAX's student, teacher and point caches "
                         "into the port: each step's metrics then come from one state")
    ap.add_argument("--reg-bias", type=float, default=None,
                    help="the rotated head's regression bias (test_torch_rotated_train_step.py "
                         "conditions it to 1.0: boxes of ~16 px, rotated IoUs away from 0)")
    a = ap.parse_args()
    rotated = a.fork == "rotated"
    n1 = a.phase1_steps if a.phase1_steps is not None else (0 if rotated else 4)
    steps = a.steps or (6 if rotated else 8)
    args = port.parse_args(["--img", str(a.img), "--batch", str(B), "--gt", str(G),
                            "--classes", str(NUM_CLASSES), "--frozen-stages", "0",
                            "--steps", str(steps), "--burn-in-frac", "0"])
    # each step's phase is passed to both steps: the first n1 run phase 1
    jcfg, tcfg = _jax_config(args), port.build_config(args)
    import point_teacher_tpu.train.rsteps as jax_rsteps
    import point_teacher_tpu.train.steps as jax_steps
    from point_teacher_torch.train import rsteps as port_rsteps
    from point_teacher_torch.train import steps as port_steps

    jax_steps.strong_augment = lambda key, b: b
    jax_rsteps.strong_augment_rotated = lambda key, b: b
    port_steps.strong_augment = lambda aug, *draws: aug
    port_rsteps.strong_augment_rotated = lambda aug, *draws: aug
    if rotated:
        from point_teacher_tpu.train.rsteps import build_rotated_train_step as jbuild
        from point_teacher_torch.train.rsteps import build_rotated_train_step as tbuild

        jmodel, params = random_rotated_flax_params(seed=3, frozen_stages=0)
        if a.reg_bias is not None:
            params["params"]["bbox_head"]["conv_reg"]["bias"] = np.full(4, a.reg_bias, np.float32)
        model = StudentRotatedFCOS(num_classes=NUM_CLASSES, frozen_stages=0, dtype=torch.float32)
        make_batch, replay = port.make_visible_rbatch, trs.replay_rotated_draws
    else:
        from point_teacher_tpu.train.steps import build_train_step as jbuild
        from point_teacher_torch.train.steps import build_train_step as tbuild

        jmodel, params = random_flax_params(seed=3, frozen_stages=0)
        model = StudentFCOS(num_classes=NUM_CLASSES, frozen_stages=0, dtype=torch.float32)
        make_batch, replay = port.make_visible_batch, tts.replay_draws
    load_jax_params(model, params)
    tx = make_optimizer(params, jcfg.optim)
    jstep = jbuild(jmodel, tx, jcfg)
    r = np.random.RandomState(0)
    batches = []
    for bi in range(N_BATCHES):
        img, boxes, labels = make_batch(r, B, a.img, G, NUM_CLASSES)
        batches.append(dict(image=img, gt_boxes=boxes, gt_labels=labels,
                            gt_valid=np.ones((B, G), bool),
                            image_ids=(np.arange(B) + bi * B).astype(np.int32)))
    jstate = jax_create_state(params, tx, num_images=N_BATCHES * B, max_gt=G,
                              rng=jax.random.PRNGKey(0))
    tstate = create_train_state(model, tcfg.optim, N_BATCHES * B, G)
    tstep = tbuild(tcfg)
    torch.set_num_threads(1)
    worst = 0.0
    for i in range(steps):
        phase1 = i < n1
        b = batches[i % N_BATCHES]
        fresh = not np.asarray(jstate.points_cached)[b["image_ids"]].any()
        draws = replay(jstate.rng, b, jcfg, phase1)
        tgate = (bool(port_steps.synthesize(draws.syn, tts._torch_batch(b), tcfg, rotated)[3])
                 if phase1 else None)
        if a.resync and i:
            load_jax_params(tstate.student, jstate.params)
            load_jax_params(tstate.teacher, jstate.teacher_params)
            with torch.no_grad():
                for name in ("origin_points", "refined_points", "points_cached"):
                    getattr(tstate, name).copy_(torch.from_numpy(
                        np.asarray(getattr(jstate, name)).copy()))
        jstate, jm = jstep(jstate, JaxBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
                           phase1=phase1)
        tm = tstep(tstate, tts._torch_batch(b), phase1=phase1, draws=draws)
        jgate = (bool((np.asarray(jstate.refined_points)[b["image_ids"]] != 0).all())
                 if phase1 and fresh else None)
        rows = []
        for k in KEYS:
            want, got = float(jm[k]), float(tm[k])
            rel = abs(got - want) / (abs(want) + 1e-3 / 3e-2)
            worst = max(worst, rel)
            rows.append(f"{k} {want:.5g}/{got:.5g} ({rel:.1e})")
        print(f"step {i + 1} phase {1 if phase1 else 2} gate jax {jgate} port {tgate}: "
              + "; ".join(rows), flush=True)
    to_jax = load_torch_rotated_detector_into if rotated else load_torch_detector_into
    student = leaves(to_jax(params, {k: v.detach().clone()
                                     for k, v in tstate.student.state_dict().items()},
                            num_stages=1))
    start, jend = leaves(params), leaves(jstate.params)
    moved = np.sqrt(sum(((j - s) ** 2).sum() for j, s in zip(jend, start)))
    apart = np.sqrt(sum(((p - j) ** 2).sum() for p, j in zip(student, jend)))
    print(f"{a.fork}: worst metric difference {worst:.3e} (of |JAX| + 1/30); student apart "
          f"{apart:.4g} of JAX's move {moved:.4g} ({apart / moved:.3e})", flush=True)
    return 1 if worst > 3e-2 else 0


if __name__ == "__main__":
    sys.exit(main())
