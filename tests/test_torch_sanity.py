"""The port's closed-loop learning check (point_teacher_torch/tools/sanity_train.py)
against the root tools/sanity_train.py, which drives the JAX package: the
fabricated batches bit-equal (the root module, loaded with importlib,
imports only numpy at its top), the flags and their defaults and choices
(read from the root tool's source), the config field by field against the
root tool's expression, the --objects ring wrapper of the synthesis against
the root tool's (raster masks equal away from box edges, as in
test_torch_synthetic.py), and --cpu runs of each trainer at 64 px for a few
steps: exit 0 or 1, a --metrics-out file that the root tools/analyze_loop.py
reads, and the RoIAlign launches of each phase (none on the CPU)."""
import ast
import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_torch.core.synthetic import SynCfg
from point_teacher_torch.tools import sanity_train as port
from point_teacher_torch.train import rsteps, steps
from point_teacher_tpu.core import synthetic as js
from point_teacher_tpu.core.proposals import FineProposalCfg as JaxFine
from point_teacher_tpu.ops.masks import rasterize_rboxes as j_rasterize
from point_teacher_tpu.train.config import PointTeacherConfig as JaxPT
from test_torch_fcos_baseline import one_thread
from test_torch_synthetic import (B, SIZES, assert_masks_match, replay_syn_draws,
                                  syn_inputs)
from torch_port_env import port_test_module  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_TOOL = os.path.join(REPO, "tools/sanity_train.py")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root():
    return _load(ROOT_TOOL, "root_sanity_train")


@pytest.mark.parametrize("objects", ["fill", "ring"])
@pytest.mark.parametrize("rotated", [False, True], ids=["hbb", "rotated"])
def test_fabricated_batches_match_the_root_tool(root, rotated, objects):
    name = "make_visible_rbatch" if rotated else "make_visible_batch"
    for seed, size in ((0, 64), (999, 128)):
        want = getattr(root, name)(np.random.RandomState(seed), 4, size, 4, 3, objects)
        got = getattr(port, name)(np.random.RandomState(seed), 4, size, 4, 3, objects)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _root_flags():
    """{flag: (type name, default, choices)} of the root tool's argparse calls."""
    out = {}
    for node in ast.walk(ast.parse(open(ROOT_TOOL).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            typ = kw["type"].id if "type" in kw else None
            default = ast.literal_eval(kw["default"]) if "default" in kw else None
            if kw.get("action") is not None:
                default = False
            choices = ast.literal_eval(kw["choices"]) if "choices" in kw else None
            out[node.args[0].value] = (typ, default, choices)
    return out


def test_flags_defaults_and_choices_match_the_root_tool():
    want = _root_flags()
    parser_actions = {}
    orig = port.argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        parser_actions.update({a.option_strings[0]: a for a in self._actions
                               if a.option_strings and a.option_strings[0] != "-h"})
        return orig(self, argv, namespace)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port.argparse.ArgumentParser, "parse_args", capture)
        port.parse_args([])
    assert set(parser_actions) == set(want)
    for flag, (typ, default, choices) in want.items():
        action = parser_actions[flag]
        assert action.default == default, flag
        assert (action.type.__name__ if action.type else None) == typ, flag
        assert (list(action.choices) if action.choices else None) == choices, flag


def _jax_config(args):
    """The root tool's config expression (tools/sanity_train.py:227-253)."""
    return JaxPT(
        num_classes=args.classes, img_size=args.img, max_gt=args.gt,
        batch_size=args.batch, burn_in_step=int(args.steps * args.burn_in_frac),
        ema_alpha=args.ema_alpha,
        filter_score=args.filter_score,
        lamda=args.lamda,
        position=args.position,
        num_training_burninstep1=args.gt, num_training_burninstep2=args.gt,
        top_k=args.top_k,
        fine_proposal_cfg=(JaxFine(base_ratios=(1.0,), min_scale=0.0,
                                   gen_num_neg=args.gen_neg),),
        fine_proposal_extensive_cfg=(JaxFine(
            base_ratios=tuple(float(r) for r in args.ext_ratios.split(",")),
            min_scale=4.0),),
        syn_fill_value=2.0,
        mil_pool_grouped=bool(args.pool_grouped),
        optim=JaxPT().optim._replace(
            base_lr=args.lr, warmup_iters=10, warmup_ratio=1.0,
            frozen_stages=args.frozen_stages,
            iters_per_epoch=(max(1, args.steps // args.lr_epochs)
                             if args.lr_epochs else 10 ** 9)),
    )


@pytest.mark.parametrize("argv", [
    [], ["--lr-epochs", "0", "--ext-ratios", "1.0,1.2", "--gen-neg", "200"],
    ["--steps", "3000", "--img", "256", "--frozen-stages", "0", "--burn-in-frac", "0.2",
     "--top-k", "3", "--pool-grouped", "0", "--lamda", "0.5", "--position", "0.3"]],
    ids=["defaults", "lr_epochs0_ext_gen_neg", "gate_flags"])
def test_build_config_matches_the_root_expression(argv):
    args = port.parse_args(argv)
    got, want = port.build_config(args), _jax_config(args)
    assert set(got._fields) == set(want._fields) - {"remat"}
    for field in got._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a == b and type(a).__name__ == type(b).__name__, field


def test_ring_wrapper_matches_the_root_tool_and_restores():
    """--objects ring: the synthetic boxes' interior (the boxes shrunk by 6
    px) painted 0.65 x fill, as the root tool's ring_gbp; both patched
    attributes back after the run."""
    s, g, _, shape_list = SIZES["small"]
    img, boxes, valid = syn_inputs("small", seed=5)
    key = jax.random.PRNGKey(29)
    cfg = js.SynCfg(shape_list, s)
    jimg, _, jrb, jv = js.generate_black_paper_batch(key, jnp.asarray(img), jnp.asarray(boxes),
                                                     jnp.asarray(valid), cfg, fill_value=255.0)
    inner = jrb.at[..., 2:4].set(jnp.maximum(jrb[..., 2:4] - 6.0, 0.0))
    imask = jax.vmap(lambda bb, vv: j_rasterize(bb, vv, s, s))(inner, jv)
    jimg = np.asarray(jnp.where(imask[..., None], jnp.asarray(0.65 * 255.0, jimg.dtype), jimg))
    before = (steps.generate_black_paper_batch, steps.strong_augment,
              rsteps.strong_augment_rotated)
    with port.harness_patches(ablate_aug=True, objects="ring"):
        assert steps.generate_black_paper_batch is not before[0]
        aug = object()
        assert steps.strong_augment(aug, 0, 1) is aug
        assert rsteps.strong_augment_rotated(aug, 0, 1, 2) is aug
        timg, _, trb, tv = steps.generate_black_paper_batch(
            replay_syn_draws(key, B, g, len(shape_list)), torch.from_numpy(img),
            torch.from_numpy(boxes), torch.from_numpy(valid), SynCfg(shape_list, s),
            fill_value=255.0)
    assert (steps.generate_black_paper_batch, steps.strong_augment,
            rsteps.strong_augment_rotated) == before
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    timg = timg.numpy()
    jinner, tinner = jimg == np.float32(0.65 * 255.0), timg == np.float32(0.65 * 255.0)
    assert jinner.all(-1).any()
    inner_np = np.asarray(inner)
    assert_masks_match(tinner.all(-1), jinner.all(-1), inner_np, np.asarray(jv), "ring interior")
    untouched = ~(timg >= 165.0).all(-1) & ~(jimg >= 165.0).all(-1)
    np.testing.assert_array_equal(timg[untouched], jimg[untouched])


@pytest.fixture(scope="module")
def analyze_loop():
    return _load(os.path.join(REPO, "tools/analyze_loop.py"), "root_analyze_loop")


@pytest.mark.parametrize("trainer", ["fcos", "point_teacher", "rotated"])
def test_cpu_run_and_metrics_file(trainer, tmp_path, analyze_loop):
    """4 steps (3 in phase 1), the HBB trainers with an evaluation at step
    2; the rotated trainer at B=1 without one (its evaluation's polygon-clip
    NMS takes seconds a batch on one CPU thread)."""
    rotated = trainer == "rotated"
    metrics = tmp_path / "m.jsonl"
    argv = ["--cpu", "--trainer", trainer, "--steps", "4", "--img", "64", "--frozen-stages",
            "0", "--burn-in-frac", "0.5", "--log-interval", "1", "--assert-no-collapse",
            "--metrics-out", str(metrics),
            *(["--batch", "1"] if rotated else ["--eval-interval", "2"])]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = one_thread(lambda: port.run(argv))
    text = out.getvalue()
    assert res["code"] in (0, 1) and port.main is not None
    assert ("LEARNING: OK" if res["code"] == 0 else "LEARNING: NOT IMPROVING") in text
    assert res["steps_per_phase"] == {1: 3, 2: 1}
    assert not any(v for phase in res["launches"].values() for c in phase.values()
                   for v in c.values())
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    train = [r for r in recs if r["kind"] == "train"]
    evals = [r for r in recs if r["kind"] == "eval"]
    assert [r["step"] for r in train] == [0, 1, 2, 3]
    assert [r["step"] for r in evals] == ([] if rotated else [2])
    assert rotated or evals[0]["phase"] == "burn-in" and set(evals[0]) == {
        "step", "kind", "phase", "student_ap", "teacher_ap"}
    assert {"total_loss", "loss_cls", "loss_bbox", "lr"} <= set(train[0])
    assert train[0]["lr"] == 0.01 and all(np.isfinite(r["total_loss"]) for r in train)
    if trainer != "fcos":
        assert "MIN cls_pool_coverage over run: " in text and "COLLAPSE CHECK: " in text
        assert any(k.endswith("cls_pool_coverage") for k in train[0])
        assert res["teacher_ap"] is not None
    with contextlib.redirect_stdout(io.StringIO()) as summary:
        analyze_loop.summarize(str(metrics))
    assert ("no eval records" if rotated else "min cls_pool_coverage over run") in \
        summary.getvalue()
