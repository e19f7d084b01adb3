"""The port's HBB inference (point_teacher_torch.inference) against the JAX
package's on the CPU, from the same numpy inputs and weights.

sigmoid differs between the packages in the last bit (the port rounds an
f64 sigmoid, which the card and the CPU agree on; XLA's f32 one is an ulp
off on ~30% of inputs), so a chain from logits is held as matched sets:
the same valid count; the valid rows in JAX's order, where consecutive
scores that lie within the tie tolerance form a group whose rows may come
in another order and are matched as a set (label equal, box and score
within the tolerance); the nms_pre candidates equal but for points whose
ranking key ties the last one kept. Each test prints its counts of such
cases (pytest -rP shows them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_teacher_tpu import inference as jinf
from point_teacher_tpu.data import pipeline as jpipe
from point_teacher_tpu.ops.boxes import grid_points as jgrid
from point_teacher_tpu.train.config import InferenceCfg as JaxCfg
from point_teacher_torch import inference as pinf
from point_teacher_torch.data import pipeline as ppipe
from point_teacher_torch.models.detector import StudentFCOS
from point_teacher_torch.ops.boxes import grid_points
from point_teacher_torch.ops.nms import stable_topk
from point_teacher_torch.train.config import InferenceCfg
from point_teacher_torch.utils.jax_weights import load_jax_params
from test_torch_models import IMG, NUM_CLASSES, random_flax_params

# the full-width decode: 100 x 100 points at stride 8, 8 classes
FULL, FULL_C = 800, 8
ULP2 = 2 * 2.0 ** -23      # two ulps, relative
MODEL_TOL = 1e-4            # forward in f32 by two libraries (test_torch_models' bound)


def match_dets(got, want, rtol, tie, atol=0.0, width=4):
    """Assert (dets [N, width + 1], labels [N], valid [N]) of the port match
    JAX's as the module docstring says, with boxes (the first `width`
    columns: 4, or 5 for rotated boxes) and scores (the last column) at
    rtol (+ atol for boxes) and groups of consecutive JAX scores within
    `tie` (relative). The padding rows must be invalid with label -1 in
    both. Returns the number of groups of more than one row."""
    gd, gl, gv = got
    wd, wl, wv = (np.asarray(x) for x in want)
    n = int(wv.sum())
    assert int(gv.sum()) == n
    assert wv[:n].all() and gv[:n].all(), "valid rows come first"
    assert (gl[n:] == -1).all() and (wl[n:] == -1).all()
    np.testing.assert_allclose(gd[:n, width], wd[:n, width], rtol=rtol)
    cuts = np.nonzero(wd[:n - 1, width] - wd[1:n, width] > tie * wd[:n - 1, width])[0] + 1
    groups = 0
    for a, b in zip(np.r_[0, cuts], np.r_[cuts, n]):
        if b - a == 1:
            assert gl[a] == wl[a], f"row {a}: label {gl[a]} != {wl[a]}"
            np.testing.assert_allclose(gd[a, :width], wd[a, :width], rtol=rtol, atol=atol)
            continue
        groups += 1
        free = list(range(a, b))
        for j in range(a, b):
            err = [np.abs(gd[i, :width] - wd[j, :width]).max() if gl[i] == wl[j] else np.inf
                   for i in free]
            i = free.pop(int(np.argmin(err)))
            assert gl[i] == wl[j]
            np.testing.assert_allclose(gd[i, :width], wd[j, :width], rtol=rtol, atol=atol)
    return groups


# --------------------------------------------------------------------------
# the decode + NMS chain at full width, from random head outputs
# --------------------------------------------------------------------------

def _head_outputs(seed):
    """Random head outputs of one 800 px image: logits of which ~90% pass
    score_thr, distances of 2-20 px (neighbours overlap)."""
    r = np.random.RandomState(seed)
    p = (FULL // 8) ** 2
    return ((r.randn(p, FULL_C) * 1.5 - 1.0).astype(np.float32),
            r.uniform(2, 20, (p, 4)).astype(np.float32),
            r.randn(p).astype(np.float32))


@pytest.fixture(scope="module")
def jax_chain():
    """JAX's get_bboxes_single, one jit per (img_shape given, rescale)."""
    pts = jgrid(FULL // 8, FULL // 8, 8)
    fns = {}

    def run(cls, bb, ct, sf, shape, rescale):
        key = (shape is None, rescale)
        if key not in fns:
            fns[key] = jax.jit(lambda c, b, t, s, h: jinf.get_bboxes_single(
                c, b, t, pts, (FULL, FULL), s, JaxCfg(), rescale=rescale, img_shape=h))
        return [np.asarray(x) for x in fns[key](cls, bb, ct, sf, shape)]

    return run


@pytest.mark.parametrize("img_shape,rescale", [(None, True), ((600, 700), False)])
def test_get_bboxes_single_full_width_matches_jax(jax_chain, img_shape, rescale):
    cls, bb, ct = _head_outputs(0)
    sf = np.asarray([0.8, 0.75, 0.8, 0.75], np.float32)
    shape = None if img_shape is None else np.asarray(img_shape, np.float32)
    want = jax_chain(cls, bb, ct, sf, shape, rescale)
    got = [x.numpy() for x in pinf.get_bboxes_single(
        torch.from_numpy(cls), torch.from_numpy(bb), torch.from_numpy(ct),
        grid_points(FULL // 8, FULL // 8, 8), (FULL, FULL), torch.from_numpy(sf),
        InferenceCfg(), rescale=rescale,
        img_shape=None if shape is None else torch.from_numpy(shape))]

    # the nms_pre cut: equal but for keys that tie the last one kept
    jkey = np.asarray((jax.nn.sigmoid(cls) * jax.nn.sigmoid(ct)[:, None]).max(-1))
    _, jtop = jax.lax.top_k(jnp.asarray(jkey), 3000)
    pkey = (pinf.score_sigmoid(torch.from_numpy(cls))
            * pinf.score_sigmoid(torch.from_numpy(ct))[:, None]).amax(-1)
    _, ptop = stable_topk(pkey, 3000)
    cut_diff = set(np.asarray(jtop).tolist()) ^ set(ptop.numpy().tolist())
    last = jkey[np.asarray(jtop)[-1]]
    assert all(abs(jkey[i] - last) <= ULP2 * last for i in cut_diff), cut_diff

    n_valid = int(want[2].sum())
    assert n_valid == 3000          # the buffer fills: 6 chunks of candidates
    groups = match_dets(got, want, rtol=1e-6, tie=ULP2)
    ulp_scores = int((got[0][:n_valid, 4] != want[0][:n_valid, 4]).sum())
    print(f"nms_pre cut differences {len(cut_diff)}; score tie groups {groups}; "
          f"scores differing in the last bits {ulp_scores} of {n_valid}")
    if img_shape is not None:
        lim = np.asarray([700, 600, 700, 600]) / (sf if rescale else 1)
        assert (got[0][:n_valid, :4] <= lim * (1 + 1e-6)).all()


def test_distance2bbox_clamp_default_leaves_callers_unchanged():
    """max_shape None is the plain decode, bit for bit; the clamp is JAX's."""
    from point_teacher_tpu.ops.boxes import distance2bbox as jdecode
    from point_teacher_torch.ops.boxes import distance2bbox

    r = np.random.RandomState(1)
    pts = r.uniform(-20, 120, (50, 2)).astype(np.float32)
    dist = r.uniform(0, 40, (50, 4)).astype(np.float32)
    for shape in (None, (90, 100)):
        want = np.asarray(jdecode(jnp.asarray(pts), jnp.asarray(dist), max_shape=shape))
        got = distance2bbox(torch.from_numpy(pts), torch.from_numpy(dist), shape).numpy()
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the model's inference at 64 px
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The small model of test_torch_models in both packages, its classifier
    bias set to 0 so that most points pass score_thr."""
    jmodel, params = random_flax_params()
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["bbox_head"]["conv_cls"]["bias"][:] = 0.0
    port = StudentFCOS(num_classes=NUM_CLASSES, dtype=torch.float32)
    load_jax_params(port, params)
    return jmodel, params, port


def _images(seed, n=2, h=IMG, w=IMG):
    return np.random.RandomState(seed).uniform(0, 255, (n, h, w, 3)).astype(np.float32)


def test_build_inference_fn_matches_jax(pair):
    jmodel, params, port = pair
    imgs = _images(2)
    sf = np.asarray([[0.8, 0.75, 0.8, 0.75], [1.0, 1.0, 1.0, 1.0]], np.float32)
    shapes = np.asarray([[60, 64], [64, 48]], np.float32)
    want = jinf.build_inference_fn(jmodel, JaxCfg(), IMG)(params, imgs, sf, shapes)
    got = [x.numpy() for x in pinf.build_inference_fn(InferenceCfg(), IMG)(
        port, torch.from_numpy(imgs), torch.from_numpy(sf), torch.from_numpy(shapes))]
    groups = 0
    for b in range(2):
        assert int(got[2][b].sum()) > 10
        groups += match_dets([x[b] for x in got], [np.asarray(x)[b] for x in want],
                             rtol=MODEL_TOL, tie=MODEL_TOL, atol=1e-3)
    print(f"score tie groups {groups}")


def test_map_back_boxes_matches_jax():
    r = np.random.RandomState(5)
    boxes = r.uniform(-10, 80, (3, 40, 4)).astype(np.float32)
    shapes = np.asarray([[60, 52], [64, 64], [30, 41]], np.float32)
    sf = r.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    flipped = np.asarray([True, False, True])
    got = pinf.map_back_boxes(torch.from_numpy(boxes), torch.from_numpy(shapes),
                              torch.from_numpy(sf), torch.from_numpy(flipped)).numpy()
    for b in range(3):
        want = jinf.map_back_boxes(jnp.asarray(boxes[b]), jnp.asarray(shapes[b]),
                                   jnp.asarray(sf[b]), jnp.asarray(flipped[b]))
        np.testing.assert_array_equal(got[b], np.asarray(want))


def _views(pipe, img, scales, flip, to):
    return [{k: to(v) for k, v in view.items()} for view in pipe.make_tta_views(img, scales, flip)]


def test_single_view_tta_equals_simple_test(pair):
    """One unflipped view at the canvas size gives the simple test's
    detections, bit for bit."""
    _, _, port = pair
    img = _images(3, n=1, h=52)[0]
    views = _views(ppipe, img, (IMG,), False, torch.from_numpy)
    cfg = InferenceCfg(nms_pre=200, max_per_img=50)
    tta = pinf.build_tta_inference_fn(cfg, [IMG])(port, views)
    v = views[0]
    simple = pinf.build_inference_fn(cfg, IMG)(port, v["image"], v["scale_factor"],
                                               v["img_shape"])
    assert int(simple[2].sum()) > 0
    for a, b in zip(tta, simple):
        assert torch.equal(a, b)


def test_multiscale_flip_tta_matches_jax(pair):
    """Scales (64, 32) with flip: 4 views, (2 x 64 + 2 x 16 points) x 4
    classes merged by one NMS; the 32 px views are resized by PIL in both
    packages."""
    jmodel, params, port = pair
    img = _images(4, n=1)[0]
    scales = (IMG, IMG // 2)
    canvases = [s for s in scales for _ in range(2)]
    jviews = _views(jpipe, img, scales, True, jnp.asarray)
    pviews = _views(ppipe, img, scales, True, torch.from_numpy)
    for jv, pv in zip(jviews, pviews):
        for k in jv:
            np.testing.assert_array_equal(pv[k].numpy(), np.asarray(jv[k]))
    want = jinf.build_tta_inference_fn(jmodel, JaxCfg(), canvases)(params, jviews)
    got = [x.numpy() for x in pinf.build_tta_inference_fn(InferenceCfg(), canvases)(
        port, pviews)]
    assert int(got[2][0].sum()) > 10
    groups = match_dets([x[0] for x in got], [np.asarray(x)[0] for x in want],
                        rtol=MODEL_TOL, tie=MODEL_TOL, atol=1e-3)
    print(f"score tie groups {groups}")
