"""The port's plain RoIAlign (point_teacher_torch.ops.roi_align) against the
JAX package: roi_align_gather / roi_align_matmul, the grouped window pool
(extract_group_windows + roi_align_grouped_from_windows) through clamp
bounds, and the Pallas kernel itself in interpret mode. Forward and d/dfeat,
f32 on the CPU, at atol = 1e-5 * the magnitude of the compared quantity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.ops.roi_align import (extract_group_windows, roi_align_gather,
                                             roi_align_grouped_from_windows, roi_align_matmul)
from point_teacher_tpu.ops.roi_align_pallas import roi_align_batched_pallas
from point_teacher_torch.ops import _cuda_build
from point_teacher_torch.ops import roi_align as ra
from torch_port_env import port_test_module  # noqa: F401 (autouse)

B, H, W, C = 2, 16, 20, 8
TOL = 1e-5


def _feat(seed=0):
    return np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32) * 3


def _edge_rois(r):
    """[B, N, 4]: MIL-sized boxes plus the edge cases (across the border,
    beyond [-1, size], zero width / height, bins wider than 4 cells)."""
    xy = r.uniform(0, 150, (B, 24, 2))
    small = np.concatenate([xy, xy + r.uniform(4, 24, (B, 24, 2))], -1)
    edge = np.array([
        [-30.0, -30.0, 20.0, 20.0],      # across the top-left border
        [140.0, 110.0, 190.0, 150.0],    # across the bottom-right border
        [-60.0, -60.0, -20.0, -30.0],    # wholly beyond -1 cell
        [200.0, 10.0, 260.0, 60.0],      # wholly beyond the right edge
        [50.0, 40.0, 50.0, 70.0],        # zero width
        [30.0, 64.0, 90.0, 64.0],        # zero height
        [0.0, 0.0, 159.0, 127.0],        # whole map: bins of ~2.8 cells
        [-100.0, -80.0, 300.0, 240.0],   # bins of 7 cells: ADAPTIVE_SMAX clamp
        [10.0, 5.0, 250.0, 30.0],        # wide: 4.3-cell bins in x only
    ], np.float32)
    return np.concatenate([small, np.broadcast_to(edge, (B,) + edge.shape)], 1).astype(np.float32)


def _port(feat, rois, clamp=None, zero=None):
    """Port forward and d/dfeat of sum(out * proj); proj is 0 on the rois
    where the bool mask `zero` [B, N] is set."""
    f = torch.tensor(feat, requires_grad=True)
    cl = None if clamp is None else torch.from_numpy(clamp)
    out = ra.roi_align(f, torch.from_numpy(rois), cl)
    proj = np.random.RandomState(7).randn(*out.shape).astype(np.float32)
    if zero is not None:
        proj[zero] = 0.0
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach().numpy(), f.grad.numpy(), proj


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("ref", ["matmul", "gather", "pallas_interpret"])
def test_plain_matches_jax(ref):
    feat = _feat(1)
    rois = _edge_rois(np.random.RandomState(2))
    out, grad, proj = _port(feat, rois)

    def jax_fwd(f):
        if ref == "pallas_interpret":
            return roi_align_batched_pallas(f, jnp.asarray(rois), chunk=8, interpret=True)
        fn = roi_align_matmul if ref == "matmul" else roi_align_gather
        return jnp.stack([fn(f[b], jnp.asarray(rois[b])) for b in range(B)])

    want = np.asarray(jax_fwd(jnp.asarray(feat)))
    np.testing.assert_allclose(out, want, rtol=0, atol=TOL * float(np.abs(feat).max()))
    want_grad = jax.grad(lambda f: (jax_fwd(f) * proj).sum())(jnp.asarray(feat))
    _close(grad, np.asarray(want_grad))


def _group_members(run):
    """(feat, centres [B, G, 2], members [B, G, U, 4], zero [B, G * U] or
    None) for the group-window test. run None: 5 GTs of 6 members jittered
    around their centres, the first window pinned at the map origin;
    "zero_dout": the same bags, with every third member's dout zero and
    every member's of every other bag. Otherwise a run of bags on one window
    far longer than the rois a block of the windowed CUDA backward takes: 12
    GTs per image on one centre ("coincident", or the zero boxes of padded
    GTs at the map origin) plus 2 on windows of their own, 6 members each,
    so one run of 72 rois; every third member's dout is zero, and for
    padded GTs so is that of every member of every other bag."""
    if run in (None, "zero_dout"):
        r = np.random.RandomState(3)
        g, u = 5, 6
        ctr = r.uniform(-10, 170, (B, g, 2)).astype(np.float32)
        ctr[:, 0] = (3.0, 2.0)                           # window pinned at the map origin
        wh = r.uniform(8, 60, (B, g, u, 2))
        c = ctr[:, :, None, :] + r.uniform(-12, 12, (B, g, u, 2))
        zero = None
        if run == "zero_dout":
            zero = np.zeros((B, g, u), bool)
            zero.reshape(B, -1)[:, ::3] = True
            zero[:, ::2] = True
            zero = zero.reshape(B, g * u)
        return _feat(4), ctr, np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32), zero
    r = np.random.RandomState(5)
    g_run, g, u = 12, 14, 6
    ctr = np.empty((B, g, 2), np.float32)
    ctr[:, :g_run] = (0.0, 0.0) if run == "padded_zero_boxes" else (70.0, 90.0)
    ctr[:, g_run:] = ((84.0, 140.0), (150.0, 20.0))    # windows of their own
    wh = r.uniform(4, 40, (B, g, u, 2))
    c = ctr[:, :, None, :] + r.uniform(-12, 12, (B, g, u, 2))
    if run == "padded_zero_boxes":
        wh[:, :g_run] = 0.0
        c[:, :g_run] = 0.0
    zero = np.zeros((B, g, u), bool)
    zero.reshape(B, -1)[:, ::3] = True
    if run == "padded_zero_boxes":
        zero[:, :g_run:2] = True
    members = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    return _feat(6), ctr, members, zero.reshape(B, g * u)


@pytest.mark.parametrize("window, run", [(6, None), (24, None), (24, "coincident"),
                                         (24, "padded_zero_boxes"), (24, "zero_dout")],
                         ids=["6", "24", "long_run_coincident", "long_run_padded_zero_boxes",
                              "zero_dout"])
def test_clamped_matches_grouped_window_pool(window, run):
    """Clamp bounds reproduce extract_group_windows + roi_align_grouped_from_windows,
    including members whose samples escape the group window (window 6). The
    long runs and the bags with zero dout are the inputs the card's check of
    the windowed backward finds hardest, pinned here on the plain version it
    is held to."""
    feat, ctr, rois, zero = _group_members(run)
    g, u = rois.shape[1:3]
    wy0, wx0, win = ra.group_window_origins(torch.from_numpy(ctr), (H, W), window)
    clamp = ra.window_clamp(wy0, wx0, win, (H, W))[:, :, None, :].expand(B, g, u, 4)
    clamp = clamp.reshape(B, g * u, 4).contiguous()
    if run in ("coincident", "padded_zero_boxes"):     # one run of 72 rois, then one per other GT
        assert (clamp[:, 1:] != clamp[:, :-1]).any(-1).sum(1).tolist() == [2] * B
    out, grad, proj = _port(feat, rois.reshape(B, g * u, 4), clamp.numpy(), zero)

    def jax_fwd(f):
        outs = []
        for b in range(B):
            jwin, jy0, jx0 = extract_group_windows(f[b], jnp.asarray(ctr[b]), window=window)
            outs.append(roi_align_grouped_from_windows(jwin, jy0, jx0, jnp.asarray(rois[b]),
                                                       (H, W)))
        return jnp.stack(outs).reshape(B, g * u, 7, 7, C)

    jwin, jy0, jx0 = extract_group_windows(jnp.asarray(feat[0]), jnp.asarray(ctr[0]),
                                           window=window)
    np.testing.assert_array_equal(wy0[0].numpy(), np.asarray(jy0))
    np.testing.assert_array_equal(wx0[0].numpy(), np.asarray(jx0))
    want = np.asarray(jax_fwd(jnp.asarray(feat)))
    np.testing.assert_allclose(out, want, rtol=0, atol=TOL * float(np.abs(feat).max()))
    want_grad = jax.grad(lambda f: (jax_fwd(f) * proj).sum())(jnp.asarray(feat))
    _close(grad, np.asarray(want_grad))
    if zero is not None:
        assert zero.any() and not zero.all() and np.abs(np.asarray(want_grad)).max() > 0
    if window == 6:
        # the window clamp bites for some members, so the clamped pool differs
        # from the unclamped one: the test is not vacuous
        free = ra.roi_align(torch.from_numpy(feat), torch.from_numpy(rois.reshape(B, g * u, 4)))
        assert np.abs(free.numpy() - out).max() > 1e-2


def test_full_map_clamp_equals_no_clamp():
    feat = torch.from_numpy(_feat(5))
    rois = torch.from_numpy(_edge_rois(np.random.RandomState(6)))
    clamp = ra.full_map_clamp(rois.shape[:2], (H, W), "cpu").contiguous()
    np.testing.assert_array_equal(ra.roi_align(feat, rois, clamp).numpy(),
                                  ra.roi_align(feat, rois).numpy())


@pytest.mark.parametrize("bounds, channels", [(False, C), (True, C), (True, 36)],
                         ids=["no_clamp", "clamp", "clamp_c36"])
def test_dispatcher_takes_plain_path_on_cpu(bounds, channels):
    """On the CPU, with or without clamp bounds (the windowed backward's
    input on the card), the plain version runs and no launch counter moves;
    it takes any channel count (the card's kernels want a multiple of 8)."""
    ra.reset_launch_counts()
    feat = torch.from_numpy(np.random.RandomState(8).randn(B, H, W, channels).astype(np.float32)
                            * 3).requires_grad_(True)
    rois = torch.from_numpy(_edge_rois(np.random.RandomState(9)))
    clamp = None
    if bounds:
        wy0, wx0, win = ra.group_window_origins((rois[..., :2] + rois[..., 2:]) / 2, (H, W), 6)
        clamp = ra.window_clamp(wy0, wx0, win, (H, W)).contiguous()
    out = ra.roi_align(feat, rois, clamp)
    (grad,) = torch.autograd.grad(out.sum(), feat)
    want = ra.roi_align_plain(feat, rois, clamp)
    (want_grad,) = torch.autograd.grad(want.sum(), feat)
    np.testing.assert_array_equal(out.detach().numpy(), want.detach().numpy())
    np.testing.assert_array_equal(grad.numpy(), want_grad.numpy())
    assert ra.launch_counts() == {"fwd": 0, "bwd": 0, "bwd_atomic": 0}


@pytest.mark.parametrize("bad", ["rois_grad", "rois_shape", "rois_dtype", "clamp_dtype",
                                 "feat_dtype"])
def test_dispatcher_rejects_bad_inputs(bad):
    feat = torch.zeros(B, H, W, C)
    rois = torch.zeros(B, 3, 4)
    clamp = None
    if bad == "rois_grad":
        rois.requires_grad_(True)
    elif bad == "rois_shape":
        rois = torch.zeros(B, 3, 5)
    elif bad == "rois_dtype":
        rois = rois.double()
    elif bad == "clamp_dtype":
        clamp = torch.zeros(B, 3, 4, dtype=torch.int64)
    else:
        feat = feat.half()
    with pytest.raises((ValueError, TypeError)):
        ra.roi_align(feat, rois, clamp)


@pytest.mark.parametrize("case", ["c64", "c36", "misaligned"])
def test_forward_vector_rule(case):
    """The rule the dispatchers apply to a map on the card before the forward
    kernels read it as 16-byte vectors of 8 channels: C a multiple of 8 and a
    16-byte aligned start. Checked here on CPU tensors of the same layout."""
    channels = 36 if case == "c36" else 64
    flat = torch.zeros(B * H * W * channels + 8, dtype=torch.bfloat16)
    start = 1 if case == "misaligned" else (-flat.data_ptr() % 16) // 2
    feat = flat[start:start + B * H * W * channels].view(B, H, W, channels)
    if case == "c64":
        _cuda_build.check_vectors(feat, "roi_align")
    else:
        with pytest.raises(ValueError, match="8 channels a vector" if case == "c36" else "aligned"):
            _cuda_build.check_vectors(feat, "roi_align")
