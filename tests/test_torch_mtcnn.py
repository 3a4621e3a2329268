"""The port's MTCNN (tell_tpu_torch/models/backbones/mtcnn.py) against
tell_tpu's on the CPU: P/R/O-net on the same inputs, the ceil-mode pools
at every pyramid size, the box math, nms_mask ("union" and "min", with
ties), the pyramid, the whole detect_faces and extract_faces, and the
converter.

Weights are tell_tpu's init_mtcnn carried across, with the face logit's
bias of each net raised by FACE_BIAS: at random init almost no box passes
the 0.6 / 0.7 / 0.7 thresholds otherwise. The canvas is 96 px (five
pyramid levels). Tolerances: the nets' outputs within 1e-5 of their
largest value; on equal inputs the box logic exactly; through the whole
cascade equal valid masks and orders, probabilities within PROB_TOL and
boxes within BOX_TOL px (a box moves its next stage's crop, so the nets'
1e-5 reaches the last stage amplified). Where faces tie (a flat canvas,
a patch twice), their areas are equal only up to the last bits each
library's regression leaves, so the order among faces whose areas lie
within AREA_TIE of each other may differ: those rows are held equal as a
set (with every face returned, max_faces 64, so that no tie group
straddles the cut), and every stage before the area sort keeps its ties
exactly. The 160 px face crops within CROP_REL of their largest value:
a crop's sample positions come from translations of up to ~1e3 px, whose
fp32 rounding (~6e-5 px) moves a noise image's pixels by up to ~1e-4 of
their range."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.models.backbones import mtcnn as jm
from tell_tpu_torch.bridge import init_mtcnn, to_numpy, to_torch
from tell_tpu_torch.models.backbones import mtcnn as tm
from tests import tower_writers

torch.set_num_threads(2)
REL = 1e-5
BOX_TOL = 0.02
PROB_TOL = 1e-4
AREA_TIE = 1e-4      # relative
CROP_REL = 1e-4
FACE_BIAS = 3.0
CANVAS = 96


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def nets():
    tree = jax.tree.map(np.asarray, jax.jit(jm.init_mtcnn)(
        jax.random.PRNGKey(0)))
    for net, name in (("pnet", "conv4_1"), ("rnet", "dense5_1"),
                      ("onet", "dense6_1")):
        w, b = tree[net][name]
        tree[net][name] = (w, b + np.float32([0.0, FACE_BIAS]))
    return tree, tm.prepare_mtcnn(to_torch(tree, "cpu"))


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def test_init_shapes_equal_tell_tpu():
    want = jax.eval_shape(jm.init_mtcnn, jax.random.PRNGKey(0))
    got = to_numpy(init_mtcnn(torch.Generator().manual_seed(0)))
    assert jax.tree.map(lambda a: a.shape, want) == \
        jax.tree.map(lambda a: a.shape, got)


def test_pnet_on_a_pyramid_level_equals_tell_tpu(nets):
    tree, tt = nets
    img = np.random.default_rng(0).uniform(0, 255, (CANVAS, CANVAS, 3))
    x = ((img - 127.5) * 0.0078125).astype(np.float32)
    for scale in jm.pyramid_scales(CANVAS, CANVAS, 20, 0.709)[:2]:
        hs = int(CANVAS * scale + 1)
        xi = np.asarray(jax.image.resize(jnp.asarray(x), (hs, hs, 3),
                                         "linear", antialias=True))[None]
        reg, prob = jax.jit(jm.pnet_forward)(tree["pnet"], xi)
        treg, tprob = tm.pnet_forward(tt["pnet"], _nchw(xi))
        assert treg.shape == reg.shape and tprob.shape == prob.shape
        assert _rel_err(treg, reg) <= REL and _rel_err(tprob, prob) <= REL


def test_rnet_onet_on_the_same_crops_equal_tell_tpu(nets):
    tree, tt = nets
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (CANVAS, CANVAS, 3)).astype(np.float32)
    xy = rng.uniform(-10, 70, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (6, 1))],
                           1).astype(np.float32)
    crop = jax.jit(jm._crop_resize, static_argnums=2)
    c24 = np.asarray(crop(jnp.asarray(x), jnp.asarray(boxes), 24))
    c48 = np.asarray(crop(jnp.asarray(x), jnp.asarray(boxes), 48))
    for want, got in ((jax.jit(jm.rnet_forward)(tree["rnet"], c24),
                       tm.rnet_forward(tt["rnet"], _nchw(c24))),
                      (jax.jit(jm.onet_forward)(tree["onet"], c48),
                       tm.onet_forward(tt["onet"], _nchw(c48)))):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert g.shape == w.shape
            assert _rel_err(g, w) <= REL


@pytest.mark.parametrize("canvas", [416, CANVAS])
def test_ceil_maxpool_sizes_at_every_pyramid_level(canvas):
    """torch's ceil-mode pools give tell_tpu's -inf-padded window counts
    at every level of the pyramid, for each pool of the three nets."""
    for scale in jm.pyramid_scales(canvas, canvas, 20, 0.709):
        hs = int(canvas * scale + 1)
        for n, k, s in ((hs - 2, 2, 2), (22, 3, 2), (46, 3, 2), (20, 3, 2),
                        (8, 2, 2), (hs - 3, 3, 2)):
            want = jax.eval_shape(lambda v: jm._ceil_maxpool(v, k, s),
                                  jnp.zeros((1, n, n + 1, 2))).shape
            got = tm._ceil_maxpool(torch.zeros(1, 2, n, n + 1), k, s).shape
            assert (got[2], got[3]) == (want[1], want[2])


def test_ceil_maxpool_values_equal_tell_tpu():
    x = np.random.default_rng(2).normal(size=(1, 23, 18, 4)).astype(
        np.float32)
    for k, s in ((2, 2), (3, 2)):
        want = np.asarray(jm._ceil_maxpool(jnp.asarray(x), k, s))
        got = tm._ceil_maxpool(_nchw(x), k, s).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)


def test_box_math_and_pyramid_equal_tell_tpu():
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0, 100, (20, 4)).astype(np.float32)
    reg = rng.normal(0, 0.2, (20, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.bbreg(torch.from_numpy(boxes), torch.from_numpy(reg)).numpy(),
        np.asarray(jm.bbreg(jnp.asarray(boxes), jnp.asarray(reg))))
    np.testing.assert_array_equal(
        tm.rerec(torch.from_numpy(boxes)).numpy(),
        np.asarray(jm.rerec(jnp.asarray(boxes))))
    for h, w, m in ((416, 416, 20), (96, 96, 20), (300, 200, 40),
                    (12, 50, 20)):
        assert tm.pyramid_scales(h, w, m, 0.709) == \
            jm.pyramid_scales(h, w, m, 0.709)


@pytest.mark.parametrize("method", ["union", "min"])
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_mask_equals_tell_tpu_with_ties(method, seed):
    """Boxes on a coarse grid with scores from four values (ties across
    overlapping boxes), some invalid: the same keep mask."""
    rng = np.random.default_rng(seed)
    n = 200
    xy = rng.integers(0, 10, (n, 2)) * 6.0
    boxes = np.concatenate([xy, xy + rng.integers(2, 5, (n, 1)) * 6.0],
                           1).astype(np.float32)
    scores = rng.choice([0.5, 0.7, 0.9, 0.95], n).astype(np.float32)
    valid = rng.random(n) < 0.85
    for thresh in (0.5, 0.7):
        want = jax.jit(lambda b, s, v: jm.nms_mask(b, s, v, thresh, method))(
            boxes, scores, valid)
        got = tm.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid), thresh, method)
        assert 0 < np.asarray(want).sum() < valid.sum()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _jax_detect(max_faces):
    return jax.jit(lambda p, i: jm.detect_faces(p, i, jm.MTCNNConfig(
        max_faces=max_faces)))


def _detect_both(tree, tt, img, max_faces=4):
    want = [np.asarray(a) for a in _jax_detect(max_faces)(
        tree, jnp.asarray(img))]
    got = [a.numpy() for a in tm.detect_faces(
        tt, torch.from_numpy(img), tm.MTCNNConfig(max_faces=max_faces))]
    return want, got


def _same_detections(want, got, ties=False):
    """Equal valid masks; each valid row's box and probability within
    tolerance of tell_tpu's at the same position, or with `ties` of a row
    whose area is within AREA_TIE of its own (returns the rows that moved)."""
    wb, wp, wv = want
    gb, gp, gv = got
    np.testing.assert_array_equal(gv, wv)
    area = (wb[:, 2] - wb[:, 0]) * (wb[:, 3] - wb[:, 1])
    moved = []
    for i in np.flatnonzero(wv):
        same = (np.abs(gb[i] - wb[i]).max() <= BOX_TOL
                and abs(gp[i] - wp[i]) <= PROB_TOL)
        if same:
            continue
        assert ties, f"face {i}: {gb[i]} {gp[i]} against {wb[i]} {wp[i]}"
        match = [j for j in np.flatnonzero(wv)
                 if np.abs(gb[i] - wb[j]).max() <= BOX_TOL
                 and abs(gp[i] - wp[j]) <= PROB_TOL
                 and abs(area[j] - area[i]) <= AREA_TIE * abs(area[i])]
        assert match, f"face {i}: {gb[i]} matches no tied face of tell_tpu's"
        moved.append(i)
    return moved


def test_detect_faces_and_extract_faces_equal_tell_tpu(nets):
    tree, tt = nets
    img = np.random.default_rng(4).uniform(0, 255, (CANVAS, CANVAS, 3)
                                           ).astype(np.float32)
    want, got = _detect_both(tree, tt, img)
    assert want[2].sum() >= 2
    _same_detections(want, got)
    # by area, largest first
    area = (got[0][:, 2] - got[0][:, 0]) * (got[0][:, 3] - got[0][:, 1])
    assert (np.diff(area[got[2]]) <= 0).all()
    # the 160 x 160 prewhitened crops of the same boxes
    faces = jax.jit(jm.extract_faces)(jnp.asarray(img), jnp.asarray(got[0]))
    mine = tm.extract_faces(torch.from_numpy(img), torch.from_numpy(got[0]))
    assert mine.shape == (4, 160, 160, 3)
    assert _rel_err(mine, faces) <= CROP_REL


@pytest.mark.parametrize("kind", ["grey", "twins"])
def test_detect_faces_ties_equal_tell_tpu(nets, kind):
    """A flat grey canvas (every PNet cell of a level ties, as in the
    letterbox's bands) and a canvas holding one patch twice: equal valid
    masks and the same order among equal scores."""
    tree, tt = nets
    img = np.full((CANVAS, CANVAS, 3), 128.0, np.float32)
    if kind == "twins":
        patch = np.random.default_rng(5).uniform(0, 255, (32, 32, 3))
        img[16:48, 8:40] = patch
        img[16:48, 56:88] = patch
    want, got = _detect_both(tree, tt, img, max_faces=64)
    assert 1 <= want[2].sum() < 64
    moved = _same_detections(want, got, ties=True)
    assert len(moved) < want[2].sum()


def test_convert_mtcnn_equals_tell_tpu(nets, tmp_path):
    tree, _ = nets
    sds = tower_writers.mtcnn_states(tree)
    want = jm.convert_mtcnn(*[{k: v.numpy() for k, v in sd.items()}
                              for sd in sds])
    got = tm.convert_mtcnn(*sds)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, np.asarray(w))
    # and back to the tree the sds were written from
    for (_, g), (_, t) in zip(flat_g,
                              jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(g, t)
    assert math.isclose(got["pnet"]["conv4_1"][1][1], FACE_BIAS, rel_tol=0)
    # through convert_towers --mtcnn and the loader serve uses
    from tell_tpu_torch.tools import convert_towers
    paths = []
    for name, sd in zip(("pnet", "rnet", "onet"), sds):
        paths.append(str(tmp_path / f"{name}.pt"))
        torch.save(sd, paths[-1])
    assert convert_towers.main(["--out", str(tmp_path / "towers"),
                                "--mtcnn", *paths]) == 0
    loaded = tm.load_mtcnn(str(tmp_path / "towers" / "mtcnn"), "cpu")
    want = tm.prepare_mtcnn(to_torch(got, "cpu"))
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(to_numpy(loaded)),
            jax.tree_util.tree_leaves_with_path(to_numpy(want))):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
