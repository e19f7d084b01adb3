"""The port's plain rotated RoIAlign (point_teacher_torch.ops.roi_align_rotated)
against every JAX function it stands for, one row of the clamp table each:
roi_align_rotated_matmul (per-roi window), extract_group_windows +
roi_align_rotated_grouped_from_windows (group window), roi_align_rotated
(exact gather) and the Pallas kernel in interpret mode. Forward at atol
1e-5 x max|feat|, d/dfeat against jax.grad at atol 1e-4 x max|grad|, f32 on
the CPU; plus the bf16 difference of the f32 sample offsets."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu.ops.roi_align import (extract_group_windows, roi_align_rotated,
                                             roi_align_rotated_grouped_from_windows,
                                             roi_align_rotated_matmul)
from point_teacher_tpu.ops.rroi_pallas import roi_align_rotated_pallas
from point_teacher_torch.ops import roi_align as ra
from point_teacher_torch.ops import roi_align_rotated as rr
from torch_port_env import port_test_module  # noqa: F401 (autouse)

B, H, W, C = 2, 40, 44, 8
FWD_TOL, BWD_TOL = 1e-5, 1e-4


def _feat(seed=0):
    return np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32) * 3


def _rrois(r, n=20):
    """[B, N, 5] image px: MIL-sized rotated boxes anywhere on the map plus the
    edge cases (across the border, beyond [-1, size], zero size, larger than
    a 16-cell window, angles at +-pi/2)."""
    small = np.concatenate([r.uniform(0, 8 * W, (B, n, 2)), r.uniform(4, 60, (B, n, 2)),
                            r.uniform(-np.pi / 2, np.pi / 2, (B, n, 1))], -1)
    edge = np.array([
        [-10.0, 20.0, 60.0, 30.0, 0.3],       # across the left border
        [340.0, 310.0, 50.0, 70.0, -1.2],     # across the bottom-right border
        [-100.0, -90.0, 30.0, 20.0, 0.5],     # wholly beyond -1 cell
        [500.0, 100.0, 40.0, 40.0, 0.0],      # wholly beyond the right edge
        [100.0, 120.0, 0.0, 30.0, 0.2],       # zero width
        [150.0, 150.0, 0.0, 0.0, -0.7],       # zero size
        [170.0, 160.0, 250.0, 200.0, 0.7],    # far larger than a 16-cell window
        [120.0, 200.0, 40.0, 12.0, np.pi / 2],
        [200.0, 80.0, 40.0, 12.0, -np.pi / 2],
    ])
    return np.concatenate([small, np.broadcast_to(edge, (B,) + edge.shape)], 1).astype(np.float32)


def _port(feat, rrois, clamp=None, zero=None):
    """Port forward and d/dfeat of sum(out * proj); proj is 0 on the rois
    where the bool mask `zero` [B, N] is set."""
    f = torch.tensor(feat, requires_grad=True)
    cl = None if clamp is None else clamp.contiguous()
    out = rr.roi_align_rotated(f, torch.from_numpy(rrois), cl)
    proj = np.random.RandomState(7).randn(*out.shape).astype(np.float32)
    if zero is not None:
        proj[zero] = 0.0
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach().numpy(), f.grad.numpy(), proj


def _check(feat, out, grad, proj, jax_fwd):
    want = np.asarray(jax_fwd(jnp.asarray(feat)))
    np.testing.assert_allclose(out, want, rtol=0, atol=FWD_TOL * float(np.abs(feat).max()))
    want_grad = np.asarray(jax.grad(lambda f: (jax_fwd(f) * proj).sum())(jnp.asarray(feat)))
    np.testing.assert_allclose(grad, want_grad, rtol=0,
                               atol=BWD_TOL * float(np.abs(want_grad).max()))
    return want


@pytest.mark.parametrize("window", [16, 6])
def test_per_roi_window_matches_matmul(window):
    feat, rrois = _feat(1), _rrois(np.random.RandomState(2))
    clamp = rr.roi_window_clamp(torch.from_numpy(rrois), (H, W), window)
    out, grad, proj = _port(feat, rrois, clamp)

    def jax_fwd(f):
        return jnp.stack([roi_align_rotated_matmul(f[b], jnp.asarray(rrois[b]), window=window)
                          for b in range(B)])

    want = _check(feat, out, grad, proj, jax_fwd)
    # the large roi is clamped by its window: the test is not vacuous
    free = rr.roi_align_rotated(torch.from_numpy(feat), torch.from_numpy(rrois)).numpy()
    assert np.abs(free - want).max() > 1e-2


def _group_members(run):
    """(feat, centres [B, G, 2], members [B, G, U, 5], zero [B, G * U]) for
    the group-window test. run None: 5 GTs of 6 members jittered around
    their centres, the first window pinned at the map origin. Otherwise a
    run of bags on one window far longer than the rois a block of the
    windowed CUDA backward takes: 12 GTs per image on one centre
    ("coincident", or the zero boxes of padded GTs at the map origin) plus 2
    on windows of their own, 6 members each, so one run of 72 rois; every
    third member's dout is zero, and for padded GTs so is that of every
    member of every other bag."""
    if run is None:
        r = np.random.RandomState(3)
        feat = _feat(4)
        g, u = 5, 6
        ctr = r.uniform(-20, 8 * W + 20, (B, g, 2)).astype(np.float32)
        ctr[:, 0] = (5.0, 4.0)                            # window pinned at the map origin
        members = np.concatenate([ctr[:, :, None, :] + r.uniform(-16, 16, (B, g, u, 2)),
                                  r.uniform(6, 50, (B, g, u, 2)),
                                  r.uniform(-np.pi / 2, np.pi / 2, (B, g, 1, 1)).repeat(u, 2)],
                                 -1).astype(np.float32)
        return feat, ctr, members, None
    r = np.random.RandomState(5)
    g_run, g, u = 12, 14, 6
    ctr = np.empty((B, g, 2), np.float32)
    ctr[:, :g_run] = (0.0, 0.0) if run == "padded_zero_boxes" else (150.0, 170.0)
    ctr[:, g_run:] = ((40.0, 300.0), (330.0, 40.0))    # windows of their own, at two corners
    size = r.uniform(6, 50, (B, g, u, 2))
    if run == "padded_zero_boxes":
        size[:, :g_run] = 0.0
    members = np.concatenate([ctr[:, :, None, :] + r.uniform(-16, 16, (B, g, u, 2)), size,
                              r.uniform(-np.pi / 2, np.pi / 2, (B, g, u, 1))],
                             -1).astype(np.float32)
    zero = np.zeros((B, g, u), bool)
    zero.reshape(B, -1)[:, ::3] = True
    if run == "padded_zero_boxes":
        zero[:, :g_run:2] = True
    return _feat(6), ctr, members, zero.reshape(B, g * u)


@pytest.mark.parametrize("window, run", [(16, None), (6, None), (16, "coincident"),
                                         (16, "padded_zero_boxes")],
                         ids=["16", "6", "long_run_coincident", "long_run_padded_zero_boxes"])
def test_group_window_matches_grouped_from_windows(window, run):
    """Members jittered around their group centre; window 6 makes the group
    window clamp some of them. The long runs are the inputs the card's check
    of the windowed backward finds hardest, pinned here on the plain version
    it is held to."""
    feat, ctr, members, zero = _group_members(run)
    g, u = members.shape[1:3]
    wy0, wx0, win = ra.group_window_origins(torch.from_numpy(ctr), (H, W), window)
    clamp = ra.window_clamp(wy0, wx0, win, (H, W))[:, :, None, :].expand(B, g, u, 4)
    clamp = clamp.reshape(B, g * u, 4)
    if run is not None:     # one run of 72 rois, then one per other GT
        assert (clamp[:, 1:] != clamp[:, :-1]).any(-1).sum(1).tolist() == [2] * B
    out, grad, proj = _port(feat, members.reshape(B, g * u, 5), clamp, zero)

    def jax_fwd(f):
        outs = []
        for b in range(B):
            jwin, jy0, jx0 = extract_group_windows(f[b], jnp.asarray(ctr[b]), window=window)
            outs.append(roi_align_rotated_grouped_from_windows(
                jwin, jy0, jx0, jnp.asarray(members[b]), (H, W), chunk=g))
        return jnp.stack(outs).reshape(B, g * u, 7, 7, C)

    _check(feat, out, grad, proj, jax_fwd)


def test_whole_map_matches_exact_gather():
    feat, rrois = _feat(5), _rrois(np.random.RandomState(6))
    out, grad, proj = _port(feat, rrois)

    def jax_fwd(f):
        return jnp.stack([roi_align_rotated(f[b], jnp.asarray(rrois[b])) for b in range(B)])

    _check(feat, out, grad, proj, jax_fwd)


def test_pallas_window_matches_pallas_kernel_interpreted():
    feat, rrois = _feat(8), _rrois(np.random.RandomState(9), n=7)
    clamp = rr.pallas_window_clamp(torch.from_numpy(rrois), (H, W))
    out, grad, proj = _port(feat, rrois, clamp)

    def jax_fwd(f):
        return roi_align_rotated_pallas(f, jnp.asarray(rrois), chunk=8, interpret=True)

    _check(feat, out, grad, proj, jax_fwd)


def test_bf16_offsets_difference_from_xla_path():
    """In bf16 the XLA path builds the sample offsets (and weights) in bf16;
    the port, like the Pallas kernel it replaces, in f32. At MIL shapes
    (per-roi 16-cell windows, boxes of 4-60 px) the two bf16 outputs differ
    by up to 8.6e-2 x max|feat| here (ROADMAP.md queue 3): the port stays
    within one bf16 rounding of the f32 pool of the same bf16 map, the XLA
    path moves its samples by the bf16 rounding of the offsets."""
    feat32 = _feat(10)
    featb = jnp.asarray(feat32).astype(jnp.bfloat16)
    feat_r = np.array(featb.astype(jnp.float32))              # the bf16 map, in f32
    rrois = _rrois(np.random.RandomState(11), n=60)[:, :60]   # MIL-sized boxes only
    clamp = rr.roi_window_clamp(torch.from_numpy(rrois), (H, W), 16)
    port = rr.roi_align_rotated(torch.from_numpy(feat_r).to(torch.bfloat16),
                                torch.from_numpy(rrois), clamp).float().numpy()
    xla = np.stack([np.asarray(roi_align_rotated_matmul(featb[b], jnp.asarray(rrois[b]),
                                                        window=16).astype(jnp.float32))
                    for b in range(B)])
    exact = rr.roi_align_rotated(torch.from_numpy(feat_r), torch.from_numpy(rrois),
                                 clamp).numpy()
    scale = float(np.abs(feat_r).max())
    port_err = float(np.abs(port - exact).max()) / scale
    xla_err = float(np.abs(xla - exact).max()) / scale
    diff = float(np.abs(port - xla).max()) / scale
    print(f"bf16 max|port - xla| / max|feat| = {diff:.3e}; vs the f32 pool: "
          f"port {port_err:.3e}, xla {xla_err:.3e}")
    assert port_err <= 2 ** -8
    assert 2 ** -8 < diff < 0.15
    assert xla_err > 10 * port_err


def test_dispatcher_takes_plain_path_on_cpu():
    rr.reset_launch_counts()
    feat = torch.from_numpy(_feat(12)).requires_grad_(True)
    rrois = torch.from_numpy(_rrois(np.random.RandomState(13), n=5))
    out = rr.roi_align_rotated(feat, rrois)
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  rr.roi_align_rotated_plain(feat, rrois).detach().numpy())
    assert rr.launch_counts() == {"fwd": 0, "bwd": 0, "bwd_atomic": 0}


@pytest.mark.parametrize("channels", [36, 64], ids=["c36", "c64"])
def test_plain_path_takes_any_channel_count(channels):
    """On the CPU the dispatcher takes any C (the card's kernels want a
    multiple of 8): each channel is pooled on its own, so the first C
    channels of a wider map pool to the same values, and no counter moves."""
    rr.reset_launch_counts()
    wide = torch.from_numpy(np.random.RandomState(15).randn(B, H, W, 72).astype(np.float32))
    rrois = torch.from_numpy(_rrois(np.random.RandomState(16), n=7))
    clamp = rr.roi_window_clamp(rrois, (H, W), 6).contiguous()
    out = rr.roi_align_rotated(wide[..., :channels].contiguous(), rrois, clamp)
    assert out.shape == (B, rrois.shape[1], 7, 7, channels)
    np.testing.assert_array_equal(out.numpy(),
                                  rr.roi_align_rotated(wide, rrois, clamp)[..., :channels].numpy())
    assert rr.launch_counts() == {"fwd": 0, "bwd": 0, "bwd_atomic": 0}


def test_clamp_helpers_match_the_reference_origins():
    """Window origins of roi_window_clamp and pallas_window_clamp against the
    JAX formulas (roi_align.py:778-779, rroi_pallas.py:241-244)."""
    rrois = _rrois(np.random.RandomState(14))
    cx, cy = rrois[..., 0] / 8, rrois[..., 1] / 8
    per_roi = rr.roi_window_clamp(torch.from_numpy(rrois), (H, W), 16).numpy()
    np.testing.assert_array_equal(per_roi[..., 0], np.clip(np.floor(cy - 8), 0, H - 16))
    np.testing.assert_array_equal(per_roi[..., 2], np.clip(np.floor(cx - 8), 0, W - 16))
    np.testing.assert_array_equal(per_roi[..., 1], per_roi[..., 0] + 15)
    pal = rr.pallas_window_clamp(torch.from_numpy(rrois), (H, W)).numpy()
    wp = -(-W // 8) * 8
    np.testing.assert_array_equal(pal[..., 2], np.clip(np.floor(cx - 8), 0, wp - 32) // 8 * 8)
    np.testing.assert_array_equal(pal[..., 3], np.minimum(pal[..., 2] + 31, W - 1))
    np.testing.assert_array_equal(pal[..., 1], np.minimum(pal[..., 0] + 15, H - 1))


@pytest.mark.parametrize("bad", ["rrois_grad", "rrois_shape", "rrois_dtype", "clamp_dtype",
                                 "clamp_shape", "feat_dtype"])
def test_dispatcher_rejects_bad_inputs(bad):
    feat = torch.zeros(B, H, W, C)
    rrois = torch.zeros(B, 3, 5)
    clamp = None
    if bad == "rrois_grad":
        rrois.requires_grad_(True)
    elif bad == "rrois_shape":
        rrois = torch.zeros(B, 3, 4)
    elif bad == "rrois_dtype":
        rrois = rrois.double()
    elif bad == "clamp_dtype":
        clamp = torch.zeros(B, 3, 4, dtype=torch.int64)
    elif bad == "clamp_shape":
        clamp = torch.zeros(B, 2, 4, dtype=torch.int32)
    else:
        feat = feat.half()
    with pytest.raises((ValueError, TypeError)):
        rr.roi_align_rotated(feat, rrois, clamp)
