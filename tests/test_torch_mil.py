"""The port's MIL stage (point_teacher_torch.train.mil) against the JAX
mil_stage, in both pooling modes: grouped window pools (window 24 covers the
map at this size; window 4 makes the clamps bite) and the per-roi pool.
Same tower params, features, boxes and injected negative draws; losses,
refined boxes, diagnostics and the gradients w.r.t. the feature and the
tower params are compared at rtol 1e-4, f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.core.proposals import FineProposalCfg
from point_teacher_tpu.models.detector import StudentFCOS as JaxStudent
from point_teacher_tpu.train.mil import mil_stage as jax_mil_stage
from point_teacher_torch.core import proposals as tp
from point_teacher_torch.models.detector import StudentFCOS
from point_teacher_torch.train.mil import mil_stage
from point_teacher_torch.utils.jax_weights import load_jax_params, port_arrays
from test_torch_models import NUM_CLASSES, random_flax_params
from torch_port_env import port_test_module  # noqa: F401 (autouse)

B, IMG, G, NNEG = 2, 64, 6, 8
FINE = FineProposalCfg(base_ratios=(1.0,), shake_ratio=None, min_scale=0.0, gen_num_neg=NNEG)
EXT = FineProposalCfg(base_ratios=(1.0, 1.2, 0.8), shake_ratio=None, min_scale=4.0)
ALPHA = (0.01, 0.25)
TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jmodel, params = random_flax_params(seed=3)
    port = StudentFCOS(num_classes=NUM_CLASSES, dtype=torch.float32)
    load_jax_params(port, params)
    r = np.random.RandomState(4)
    feat = (r.randn(B, IMG // 8, IMG // 8, 256) * 0.5).astype(np.float32)
    cxy = r.uniform(6, IMG - 6, (B, G, 2))
    wh = r.uniform(6, 20, (B, G, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    real = (boxes + r.uniform(-2, 2, boxes.shape)).astype(np.float32)
    labels = r.randint(0, NUM_CLASSES, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    valid[0, -1] = valid[1, -2:] = False
    key = jax.random.PRNGKey(9)
    neg_u = np.stack([np.stack([np.asarray(jax.random.uniform(k4, (NNEG,)))
                                for k4 in jax.random.split(k, 4)])
                      for k in jax.random.split(key, B)])
    return jmodel, params, port, dict(feat=feat, boxes=boxes, real=real, labels=labels,
                                      valid=valid, key=key, neg_u=neg_u)


def _jax_run(jmodel, params, d, grouped, window):
    def regress(f, s):
        return jmodel.apply(params_box[0], f, s, method=JaxStudent.mil_regress)

    def classify(f, s):
        return jmodel.apply(params_box[0], f, s, method=JaxStudent.mil_classify)

    def classify_neg(f, s):
        return jmodel.apply(params_box[0], f, s, method=JaxStudent.mil_classify_neg)

    params_box = [params]

    def run(feat, p):
        params_box[0] = p
        return jax_mil_stage(regress, classify, classify_neg, feat, jnp.asarray(d["boxes"]),
                             jnp.asarray(d["labels"]), jnp.asarray(d["valid"]),
                             jnp.asarray(d["real"]), FINE, EXT, 0, (IMG, IMG), 1, 0.25, 0.2,
                             d["key"], True, window=window, grouped=grouped)

    def loss(feat, p):
        out = run(feat, p)
        return out.loss_mil_bbox * ALPHA[0] + out.loss_mil_bags * ALPHA[1]

    out = run(jnp.asarray(d["feat"]), params)
    gfeat, gparams = jax.grad(loss, argnums=(0, 1))(jnp.asarray(d["feat"]), params)
    return out, np.asarray(gfeat), gparams


@pytest.mark.parametrize("grouped,window", [(True, 24), (True, 4), (False, 32)],
                         ids=["grouped24", "grouped4_clamps_bite", "per_roi"])
def test_mil_stage_matches_jax(setup, grouped, window):
    jmodel, params, port, d = setup
    want, want_gfeat, want_gparams = _jax_run(jmodel, params, d, grouped, window)

    feat = torch.tensor(d["feat"], requires_grad=True)
    port.zero_grad(set_to_none=True)
    got = mil_stage(port, feat, torch.from_numpy(d["boxes"]), torch.from_numpy(d["labels"]),
                    torch.from_numpy(d["valid"]), torch.from_numpy(d["real"]),
                    tp.FineProposalCfg(*FINE), tp.FineProposalCfg(*EXT), 0, (IMG, IMG), 1, 0.25,
                    0.2, torch.from_numpy(d["neg_u"]), True, window=window, grouped=grouped)
    (got.loss_mil_bbox * ALPHA[0] + got.loss_mil_bags * ALPHA[1]).backward()

    for name in ("loss_mil_bbox", "loss_mil_bags", "coarse_bags_iou", "refine_bags_iou",
                 "cls_pool_coverage", "refined_boxes"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), rtol=TOL, atol=1e-5,
                                   err_msg=name)
    if window == 4:
        assert float(want.cls_pool_coverage) < 1.0   # the clamps do bite
    np.testing.assert_allclose(feat.grad.numpy(), want_gfeat, rtol=TOL,
                               atol=TOL * float(np.abs(want_gfeat).max()))
    # tower gradients: the JAX grad tree in the port's layout
    want_named = port_arrays(jax.tree_util.tree_map(np.asarray, want_gparams))
    towers = [n for n, _ in port.named_parameters()
              if n.startswith(("bbox_head.shared_fcs", "bbox_head.fc_"))]
    assert len(towers) == 14
    # fc_ins.bias has an exactly-zero gradient (a softmax over the members of
    # a shared bias); compare near-zero leaves against the largest tower grad
    gmax = max(float(np.abs(want_named[n]).max()) for n in towers)
    named = dict(port.named_parameters())
    for name in towers:
        w = want_named[name]
        np.testing.assert_allclose(named[name].grad.numpy(), w, rtol=TOL,
                                   atol=TOL * max(float(np.abs(w).max()), 1e-3 * gmax),
                                   err_msg=name)
