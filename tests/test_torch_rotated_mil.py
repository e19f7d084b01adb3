"""The port's rotated MIL stage (point_teacher_torch.train.mil
mil_stage_rotated) against the JAX mil_stage_rotated, in both pooling modes:
group windows that cover the map, group windows whose clamps bite, and
per-roi windows. Same tower params, features, boxes and injected negative
draws; losses, refined boxes, diagnostics and the gradients w.r.t. the
feature and the tower params are compared at rtol 1e-4, f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.core.proposals import FineProposalCfg
from point_teacher_tpu.models.rotated_detector import StudentRotatedFCOS as JaxRotated
from point_teacher_tpu.train.mil import mil_stage_rotated as jax_mil_stage_rotated
from point_teacher_torch.core import proposals as tp
from point_teacher_torch.models.rotated_detector import StudentRotatedFCOS
from point_teacher_torch.train.mil import mil_stage_rotated
from point_teacher_torch.utils.jax_weights import load_jax_params, port_arrays
from test_torch_models import NUM_CLASSES
from test_torch_rotated_models import random_rotated_flax_params
from test_torch_rotated_train_step import B, EXT, FINE, G, NNEG, TOP_K, _neg_draws, _rboxes
from torch_port_env import port_test_module  # noqa: F401 (autouse)

ALPHA = (0.01, 0.25)
BETA, DN = 0.25, 0.2


MIL_MAP = 20   # feature cells (160 px): a window of 6 cells bites


@pytest.fixture(scope="module")
def mil_setup():
    jmodel, params = random_rotated_flax_params(seed=3)
    port = StudentRotatedFCOS(num_classes=NUM_CLASSES, dtype=torch.float32)
    load_jax_params(port, params)
    r = np.random.RandomState(4)
    img = MIL_MAP * 8
    feat = (r.randn(B, MIL_MAP, MIL_MAP, 256) * 0.5).astype(np.float32)
    rboxes = _rboxes(r, G, 6, img - 6, wh=(8, 40))
    real = rboxes + np.concatenate([r.uniform(-2, 2, (B, G, 4)), r.uniform(-0.1, 0.1, (B, G, 1))],
                                   -1).astype(np.float32)
    labels = r.randint(0, NUM_CLASSES, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    valid[0, -1] = valid[1, -2:] = False
    key = jax.random.PRNGKey(9)
    return jmodel, params, port, dict(feat=feat, rboxes=rboxes, real=real, labels=labels,
                                      valid=valid, key=key, neg_u=_neg_draws(key, NNEG), img=img)


def _jax_mil(jmodel, params, d, grouped, window):
    box = [params]

    def method(name):
        return lambda f, s: jmodel.apply(box[0], f, s, method=getattr(JaxRotated, name))

    def run(feat, p):
        box[0] = p
        return jax_mil_stage_rotated(
            method("mil_regress"), method("mil_classify"), method("mil_classify_neg"), feat,
            jnp.asarray(d["rboxes"]), jnp.asarray(d["labels"]), jnp.asarray(d["valid"]),
            jnp.asarray(d["real"]), FineProposalCfg(**FINE), FineProposalCfg(**EXT), 0,
            (d["img"], d["img"]), TOP_K, BETA, DN, d["key"], True, window=window,
            grouped=grouped)

    def loss(feat, p):
        out = run(feat, p)
        return out.loss_mil_bbox * ALPHA[0] + out.loss_mil_bags * ALPHA[1]

    out = run(jnp.asarray(d["feat"]), params)
    gfeat, gparams = jax.grad(loss, argnums=(0, 1))(jnp.asarray(d["feat"]), params)
    return out, np.asarray(gfeat), gparams


@pytest.mark.parametrize("grouped,window", [(True, 16), (True, 6), (False, 16)],
                         ids=["grouped16", "grouped6_clamps_bite", "per_roi16"])
def test_mil_stage_rotated_matches_jax(mil_setup, grouped, window):
    jmodel, params, port, d = mil_setup
    want, want_gfeat, want_gparams = _jax_mil(jmodel, params, d, grouped, window)

    feat = torch.tensor(d["feat"], requires_grad=True)
    port.zero_grad(set_to_none=True)
    got = mil_stage_rotated(
        port, feat, torch.from_numpy(d["rboxes"]), torch.from_numpy(d["labels"]),
        torch.from_numpy(d["valid"]), torch.from_numpy(d["real"]),
        tp.FineProposalCfg(**FINE), tp.FineProposalCfg(**EXT), 0, (d["img"], d["img"]),
        TOP_K, BETA, DN, torch.from_numpy(d["neg_u"]), True, window=window, grouped=grouped)
    (got.loss_mil_bbox * ALPHA[0] + got.loss_mil_bags * ALPHA[1]).backward()

    for name in ("loss_mil_bbox", "loss_mil_bags", "coarse_bags_iou", "refine_bags_iou",
                 "cls_pool_coverage", "refined_boxes"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    if window == 6:
        assert float(want.cls_pool_coverage) < 1.0   # the clamps do bite
    np.testing.assert_allclose(feat.grad.numpy(), want_gfeat, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want_gfeat).max()))
    want_named = port_arrays(jax.tree_util.tree_map(np.asarray, want_gparams))
    towers = [n for n, _ in port.named_parameters()
              if n.startswith(("bbox_head.shared_fcs", "bbox_head.fc_"))]
    assert len(towers) == 14
    gmax = max(float(np.abs(want_named[n]).max()) for n in towers)
    named = dict(port.named_parameters())
    for name in towers:
        w = want_named[name]
        np.testing.assert_allclose(named[name].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-3 * gmax),
                                   err_msg=name)
