"""The port's FaceNet (tell_tpu_torch/models/backbones/facenet.py) against
tell_tpu's on the CPU: InceptionResnetV1 on tell_tpu's weights carried
across, at repeats (1, 1, 1) (every block kind once; the full tower only
repeats them), facenet-pytorch's state dict through both converters, and
the tower loaded from a towers directory.

Tolerances: the L2-normalised embeddings within 1e-5 (fp32 convs of two
libraries); the converters' trees bit for bit (the same numpy
operations)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.models.backbones import facenet as jf
from tell_tpu_torch.bridge import init_facenet, to_numpy, to_torch
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.models.backbones import facenet as tf
from tests import tower_writers

torch.set_num_threads(2)
TOL = 1e-5
SMALL = (1, 1, 1)


def _bn_scaled(tree, seed):
    """Batch-norm scales of a trained tower's order (0.3-0.6), so the
    residual sums stay of order 1 (numpy leaves)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if "scale" in node:
                c = node["scale"].shape
                return {**node,
                        "scale": rng.uniform(0.3, 0.6, c).astype(np.float32),
                        "bias": rng.normal(0, 0.05, c).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(tree)


@pytest.fixture(scope="module")
def tree():
    cfg = jf.FaceNetConfig(repeats=SMALL)
    return _bn_scaled(jax.tree.map(np.asarray, jax.jit(
        lambda r: jf.init_facenet(r, cfg))(jax.random.PRNGKey(0))), 0)


@pytest.mark.parametrize("repeats", [SMALL, (5, 10, 5)])
def test_init_shapes_equal_tell_tpu(repeats):
    cfg = jf.FaceNetConfig(repeats=repeats)
    want = jax.eval_shape(lambda r: jf.init_facenet(r, cfg),
                          jax.random.PRNGKey(0))
    got = to_numpy(init_facenet(torch.Generator().manual_seed(0),
                                tf.FaceNetConfig(repeats=repeats)))
    assert jax.tree.map(lambda a: a.shape, want) == \
        jax.tree.map(lambda a: a.shape, got)


def test_forward_equals_tell_tpu(tree):
    x = np.random.default_rng(1).uniform(-1, 1, (3, 160, 160, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, v: jf.facenet_forward(
        p, jf.FaceNetConfig(), v))(tree, jnp.asarray(x)))
    got = tf.facenet_forward(tf.prepare_facenet(to_torch(tree, "cpu")),
                             torch.from_numpy(x)).numpy()
    assert got.shape == (3, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # rows are independent: one crop alone gives its row of the batch
    one = tf.facenet_forward(tf.prepare_facenet(to_torch(tree, "cpu")),
                             torch.from_numpy(x[1:2])).numpy()
    np.testing.assert_allclose(one[0], got[1], atol=TOL, rtol=0)


def test_convert_facenet_equals_tell_tpu(tree, tmp_path):
    sd = tower_writers.facenet_pytorch_state(
        tree, np.random.default_rng(2))
    cfg = jf.FaceNetConfig(repeats=SMALL)
    want = jf.convert_facenet({k: v.numpy() for k, v in sd.items()}, cfg)
    got = tf.convert_facenet(sd, tf.FaceNetConfig(repeats=SMALL))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the converted tower through a towers directory, as serve loads it
    (tmp_path / "facenet").mkdir()
    torch.save(to_torch(got, "cpu"), tmp_path / "facenet" / "state.pt")
    x = torch.rand(2, 160, 160, 3) * 2 - 1
    loaded = tf.load_facenet(str(tmp_path / "facenet"), "cpu")
    assert torch.equal(tf.facenet_forward(loaded, x), tf.facenet_forward(
        tf.prepare_facenet(to_torch(got, "cpu")), x))
    (tmp_path / "orbax" / "facenet").mkdir(parents=True)
    with pytest.raises(NotPortedError, match="no state.pt.*--facenet"):
        tf.load_facenet(str(tmp_path / "orbax" / "facenet"), "cpu")


def test_convert_towers_writes_the_facenet_tower_serve_loads(tmp_path):
    """convert_towers --facenet on a full-size facenet-pytorch state dict
    (the port's random init, repeats 5/10/5): load_facenet reads back
    convert_facenet's tree bit for bit."""
    from tell_tpu_torch.bridge import tree_leaves, tree_map
    from tell_tpu_torch.tools import convert_towers
    tree = to_numpy(init_facenet(torch.Generator().manual_seed(4),
                                 tf.FaceNetConfig()))
    sd = tower_writers.facenet_pytorch_state(
        tree, np.random.default_rng(2))
    torch.save(sd, tmp_path / "facenet.pt")
    assert convert_towers.main(["--out", str(tmp_path / "towers"),
                                "--facenet",
                                str(tmp_path / "facenet.pt")]) == 0
    got = tf.load_facenet(str(tmp_path / "towers" / "facenet"), "cpu")
    want = tf.prepare_facenet(to_torch(tf.convert_facenet(
        sd, tf.FaceNetConfig()), "cpu"))
    assert all(tree_leaves(tree_map(torch.equal, got, want)))
