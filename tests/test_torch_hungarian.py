"""The port's Point-Hungarian assigner (point_teacher_torch/core/hungarian.py)
against the JAX package's numpy one on the same seeded inputs: the
assignment bit for bit, and the cost matrix handed to linear_sum_assignment
within 1e-6 of its largest magnitude, for P > G, G > P, tied costs,
invalid GTs, no valid GT and P = 0. Both compute the class cost in f32
(numpy's promotion of f32 inputs); torch's and numpy's f32 exp and log
differ by an ulp on about a third of the inputs, so a cost that cancels
to near 0 may differ from JAX's by more than 1e-6 of itself (up to 4e-5
on these cases), never by more than 1e-6 of the matrix's scale."""
from unittest import mock

import numpy as np
import pytest
import scipy.optimize
import torch

from point_teacher_torch.core import hungarian as port
from point_teacher_tpu.core import hungarian as ref
from torch_port_env import port_test_module  # noqa: F401 (autouse)

C = 5


def _case(seed, p, g, n_valid=None, ties=False, dtype=np.float32):
    r = np.random.RandomState(seed)
    pred = np.concatenate([r.uniform(0, 64, (p, 2)), r.uniform(4, 40, (p, 2))], -1)
    logits = r.normal(0, 2, (p, C))
    ctr = r.normal(0, 2, p)
    if ties and p:
        # every prediction is a copy of the first: each GT costs the same from all of them
        pred, logits, ctr = pred[:1].repeat(p, 0), logits[:1].repeat(p, 0), ctr[:1].repeat(p)
    pts = r.uniform(0, 64, (g, 2))
    labels = r.randint(0, C, g)
    valid = np.ones(g, bool) if n_valid is None else np.arange(g) < n_valid
    if n_valid is not None:
        r.shuffle(valid)
    return (pred.astype(dtype), logits.astype(dtype), ctr.astype(dtype), pts.astype(dtype),
            labels.astype(np.int64), valid)


CASES = {
    "p_gt_g": dict(seed=0, p=40, g=6),
    "g_gt_p": dict(seed=1, p=5, g=12),
    "square": dict(seed=2, p=9, g=9),
    "ties": dict(seed=3, p=8, g=4, ties=True),
    "some_invalid": dict(seed=4, p=30, g=10, n_valid=6),
    "no_valid": dict(seed=5, p=20, g=5, n_valid=0),
    "p_zero": dict(seed=6, p=0, g=4),
    "f64_inputs": dict(seed=7, p=25, g=7, dtype=np.float64),
}


def _port(*args, **kw):
    """The port's assigner on CPU tensors of the numpy inputs, as numpy."""
    tensors = [torch.as_tensor(a) for a in args]
    return port.hungarian_assign(*tensors, **kw).numpy()


def _run(fn, args):
    """fn(*args) and the cost matrices it handed to linear_sum_assignment."""
    costs = []
    solve = scipy.optimize.linear_sum_assignment

    def spy(cost):
        costs.append(np.array(cost))
        return solve(cost)

    with mock.patch.object(scipy.optimize, "linear_sum_assignment", spy):
        out = fn(*args)
    return out, costs


@pytest.mark.parametrize("name", list(CASES))
def test_assignment_matches_jax(name):
    args = _case(**CASES[name])
    want, want_cost = _run(ref.hungarian_assign_np, args)
    got, got_cost = _run(_port, args)
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert len(got_cost) == len(want_cost)
    for a, b in zip(got_cost, want_cost):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
    if name in ("no_valid", "p_zero"):
        assert not want_cost and (got == -1).all()
    else:
        n = min(args[0].shape[0], int(args[5].sum()))
        assert (got >= 0).sum() == n and args[5][got[got >= 0]].all()


def test_tensor_entry_returns_on_the_input_device():
    args = _case(**CASES["some_invalid"])
    tensors = [torch.as_tensor(a) for a in args]
    got = port.hungarian_assign(*tensors)
    assert got.dtype == torch.int64 and got.device == tensors[0].device
    np.testing.assert_array_equal(got.numpy(), ref.hungarian_assign_np(*args))
    cfg = port.HungarianCfg(cls_weight=2.0, center_weight=0.5, insider_weight=3.0)
    jcfg = ref.HungarianCfg(cls_weight=2.0, center_weight=0.5, insider_weight=3.0)
    np.testing.assert_array_equal(_port(*args, cfg=cfg),
                                  ref.hungarian_assign_np(*args, cfg=jcfg))
