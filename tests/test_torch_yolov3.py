"""The port's YOLOv3 (tell_tpu_torch/models/backbones/yolov3.py) against
tell_tpu's on the CPU: the module defs and the cfg parser, the forward on
tell_tpu's weights carried across, darknet's .weights reader, the fixed
NMS with classes and ties, and the tree's int keys through to_torch and
torch.save.

A reduced cfg (two heads of 4 classes, a shortcut, the SPP max-pools, a
route to an earlier layer, the upsample) on a 64 px canvas keeps it
small. Tolerances: the decoded detections within 1e-5 of their largest
value (fp32 convs of two libraries); the box logic on equal inputs
exactly: equal valid masks, scores, boxes and top-k orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.models.backbones import yolov3 as jy
from tell_tpu_torch.bridge import init_yolov3, to_numpy, to_torch
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.models.backbones import yolov3 as ty
from tests import tower_writers

torch.set_num_threads(2)
REL = 1e-5
SMALL_CFG = """
[net]
width=64
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
activation=leaky
[shortcut]
from=-3
activation=linear
[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
activation=leaky
[maxpool]
size=5
stride=1
[route]
layers=-2
[maxpool]
size=9
stride=1
[route]
layers=-1,-3
[convolutional]
size=1
stride=1
filters=27
activation=linear
[yolo]
mask=6,7,8
anchors=10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326
classes=4
[route]
layers=5
[upsample]
stride=2
[route]
layers=-1,4
[convolutional]
size=1
stride=1
filters=27
activation=linear
[yolo]
mask=0,1,2
classes=4
"""


def _small_defs():
    return jy.parse_darknet_cfg(SMALL_CFG)


def _jax_tree(defs, seed=0):
    """tell_tpu's init with its batch-norm scales drawn in 0.3-0.6, so the
    activations stay of order 1 (numpy leaves)."""
    return bn_scaled(jax.tree.map(np.asarray, jax.jit(
        lambda r: jy.init_yolov3(r, defs))(jax.random.key(
            seed, impl="unsafe_rbg"))), seed)


def bn_scaled(tree, seed):
    """The tree with batch-norm scales in 0.3-0.6, small biases and head
    biases N(0.5, 0.5) drawn from `seed` (a few detections pass conf 0.3
    at random init)."""
    rng = np.random.default_rng(seed)
    for p in tree["convs"].values():
        if "scale" in p:
            p["scale"] = rng.uniform(0.3, 0.6, p["scale"].shape).astype(
                np.float32)
            p["bias"] = rng.normal(0, 0.05, p["bias"].shape).astype(
                np.float32)
        else:   # the heads: objectness and classes above 0.5 on the whole
            p["b"] = rng.normal(0.5, 0.5, p["b"].shape).astype(np.float32)
    return tree


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_module_defs_and_parser_equal_tell_tpu():
    assert ty.yolov3_spp_module_defs() == jy.yolov3_spp_module_defs()
    assert ty.yolov3_spp_module_defs(20) == jy.yolov3_spp_module_defs(20)
    assert ty.parse_darknet_cfg(SMALL_CFG) == _small_defs()
    census = {}
    for d in ty.yolov3_spp_module_defs():
        census[d["type"]] = census.get(d["type"], 0) + 1
    assert census == {"convolutional": 76, "shortcut": 23, "route": 7,
                      "maxpool": 3, "upsample": 2, "yolo": 3}


@pytest.mark.parametrize("which", ["small", "spp"])
def test_init_shapes_equal_tell_tpu(which):
    defs = _small_defs() if which == "small" else jy.yolov3_spp_module_defs()
    want = jax.eval_shape(lambda r: jy.init_yolov3(r, defs),
                          jax.random.PRNGKey(0))
    got = to_numpy(init_yolov3(torch.Generator().manual_seed(0), defs))
    assert got["convs"].keys() == want["convs"].keys()
    for i, p in want["convs"].items():
        assert {k: v.shape for k, v in p.items()} == \
            {k: v.shape for k, v in got["convs"][i].items()}


def test_forward_equals_tell_tpu():
    defs = _small_defs()
    tree = _jax_tree(defs)
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, v: jy.yolov3_forward(p, defs, v))(tree, x)
    got = ty.yolov3_forward(ty.prepare_yolov3(to_torch(tree, "cpu")), defs,
                            torch.from_numpy(x))
    assert got.shape == want.shape == (2, 3 * (16 * 16 + 32 * 32), 9)
    assert np.isfinite(got.numpy()).all()
    assert _rel_err(got, want) <= REL
    # the anchor-major row order: row 0 is anchor 6's cell (0, 0) of the
    # 16 x 16 head, row 256 anchor 7's
    np.testing.assert_allclose(got[0, [0, 256, 512]].numpy(),
                               np.asarray(want)[0, [0, 256, 512]],
                               rtol=REL, atol=REL)


def _write_weights(path, defs, version, seed=0):
    rng = np.random.default_rng(seed)
    parts = []
    channels = ty.channel_plan(defs)
    for i, d in enumerate(defs):
        if d["type"] != "convolutional":
            continue
        cin, cout, k = channels[i], d["filters"], d["size"]
        if d.get("bn", True):
            parts.append(rng.uniform(0.1, 0.5, 4 * cout))  # b, w, mean, var
        else:
            parts.append(rng.uniform(-0.1, 0.1, cout))
        parts.append(rng.normal(0, (k * k * cin) ** -0.5, cout * k * k * cin))
    tower_writers.write_darknet_weights(path, parts, version, seen=123)


@pytest.mark.parametrize("version", [(0, 2, 5), (0, 1, 0)])
def test_load_darknet_weights_equals_tell_tpu(tmp_path, version):
    """The header's "seen" count (int64 from version 0.2, int32 before) and
    darknet's BN folding: the trees are equal bit for bit."""
    defs = _small_defs()
    path = str(tmp_path / "small.weights")
    _write_weights(path, defs, version)
    want = jax.tree.map(np.asarray, jy.load_darknet_weights(defs, path))
    got = ty.load_darknet_weights(defs, path)
    assert got["convs"].keys() == want["convs"].keys()
    for i, p in want["convs"].items():
        assert p.keys() == got["convs"][i].keys()
        for k, v in p.items():
            np.testing.assert_array_equal(got["convs"][i][k], v)
    # a cfg that does not use the file's weights up is refused
    with pytest.raises(ValueError, match="weights"):
        ty.load_darknet_weights(defs[:-6], path)


def test_convert_towers_writes_the_yolo_tower_serve_loads(tmp_path):
    """convert_towers --yolo-cfg/--yolo-weights writes the tree that
    load_darknet_weights reads, and load_yolov3 reads it back bit for
    bit."""
    from tell_tpu_torch.tools import convert_towers
    cfg, weights = tmp_path / "small.cfg", tmp_path / "small.weights"
    cfg.write_text(SMALL_CFG)
    _write_weights(str(weights), _small_defs(), (0, 2, 5))
    assert convert_towers.main(["--out", str(tmp_path / "towers"),
                                "--yolo-cfg", str(cfg), "--yolo-weights",
                                str(weights)]) == 0
    got = ty.load_yolov3(str(tmp_path / "towers" / "yolov3"), "cpu")
    want = ty.prepare_yolov3(to_torch(ty.load_darknet_weights(
        _small_defs(), str(weights)), "cpu"))
    for i, p in want["convs"].items():
        for k, v in p.items():
            assert torch.equal(got["convs"][i][k], v)
    with pytest.raises(SystemExit):
        convert_towers.main(["--out", str(tmp_path), "--yolo-cfg",
                             str(cfg)])


def test_int_keys_survive_to_torch_and_torch_save(tmp_path):
    defs = _small_defs()
    tree = to_torch(_jax_tree(defs), "cpu")
    assert all(isinstance(k, int) for k in tree["convs"])
    (tmp_path / "yolov3").mkdir()
    torch.save(tree, tmp_path / "yolov3" / "state.pt")
    back = torch.load(tmp_path / "yolov3" / "state.pt", weights_only=True)
    assert back["convs"].keys() == tree["convs"].keys()
    loaded = ty.load_yolov3(str(tmp_path / "yolov3"), "cpu")
    x = torch.rand(1, 64, 64, 3)
    assert torch.equal(ty.yolov3_forward(loaded, defs, x),
                       ty.yolov3_forward(ty.prepare_yolov3(tree), defs, x))
    (tmp_path / "orbax" / "yolov3").mkdir(parents=True)
    with pytest.raises(NotPortedError, match="no state.pt.*--yolo-cfg"):
        ty.load_yolov3(str(tmp_path / "orbax" / "yolov3"), "cpu")


def _tied_dets(seed, n=600, nc=2):
    """Detections on a coarse grid: many equal scores (ties across
    classes and positions), overlapping boxes, rows under the threshold."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, nc + 5), np.float32)
    d[:, :2] = rng.integers(0, 6, (n, 2)) * 8.0 + 20
    d[:, 2:4] = rng.integers(3, 5, (n, 2)) * 8.0
    d[:, 4] = rng.choice([0.2, 0.5, 0.75, 1.0], n)
    d[:, 5:] = rng.choice([0.0, 0.5, 0.8, 1.0], (n, nc))
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_fixed_equals_tell_tpu_with_classes_and_ties(seed):
    d = _tied_dets(seed)
    nms = jax.jit(lambda v: jy.nms_fixed(v, 0.3, 0.6, max_det=256))
    want = [np.asarray(a) for a in nms(jnp.asarray(d))]
    got = [a.numpy() for a in ty.nms_fixed(torch.from_numpy(d), 0.3, 0.6,
                                           max_det=256)]
    assert 0 < want[2].sum() < 256
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_nms_fixed_on_the_forwards_detections_equals_tell_tpu():
    defs = _small_defs()
    tree = _jax_tree(defs, seed=3)
    x = np.random.default_rng(4).uniform(size=(1, 64, 64, 3)).astype(
        np.float32)
    dets = ty.yolov3_forward(ty.prepare_yolov3(to_torch(tree, "cpu")), defs,
                             torch.from_numpy(x))[0]
    want = [np.asarray(a) for a in jax.jit(
        lambda v: jy.nms_fixed(v, 0.3, 0.6, max_det=64))(dets.numpy())]
    got = [a.numpy() for a in ty.nms_fixed(dets, 0.3, 0.6, max_det=64)]
    # rows kept, and rows over the threshold suppressed
    assert want[2].sum() >= 1 and (want[1][~want[2]] > 0).any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _greedy_loop(over, alive):
    keep = np.ones(len(alive), bool)
    for i in range(len(alive)):
        if keep[i] and alive[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    return keep & alive


@pytest.mark.parametrize("n,p", [(1, 0.5), (7, 0.3), (64, 0.05),
                                 (256, 0.02), (300, 0.5)])
def test_greedy_keep_equals_the_sequential_loop(n, p):
    rng = np.random.default_rng(n)
    over = rng.random((n, n)) < p
    alive = rng.random(n) < 0.8
    got = ty.greedy_keep(torch.from_numpy(over), torch.from_numpy(alive))
    np.testing.assert_array_equal(got.numpy(), _greedy_loop(over, alive))
    # a chain: each row overlaps only the next, so every other one is kept
    chain = np.eye(n, k=1, dtype=bool)
    got = ty.greedy_keep(torch.from_numpy(chain), torch.ones(n, dtype=bool))
    np.testing.assert_array_equal(got.numpy(),
                                  _greedy_loop(chain, np.ones(n, bool)))
