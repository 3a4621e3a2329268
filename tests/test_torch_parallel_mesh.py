"""The port's rank grid and sharding rules (tell_tpu_torch/parallel/mesh.py)
against tell_tpu.parallel.mesh.

The rule table gives, leaf for leaf, the spec tell_tpu's
param_sharding_rules gives on the flagship's, expt 10's and expt 12's
param trees (shapes only: jax.eval_shape, and meta tensors on the port's
side), over a mesh with a "model" axis of 2 and of 3 (where the
divisibility fallback replicates). make_mesh and batch_sharding raise
tell_tpu's messages, and shard_params keeps a rank's slice of each leaf
that the rules shard over "model".
"""
import jax
import numpy as np
import pytest
import torch

from tell_tpu.config import small_test_config as j_small_config
from tell_tpu.config_io import load_experiment as j_load
from tell_tpu.parallel import batch_sharding as j_batch_sharding
from tell_tpu.parallel import make_mesh as j_make_mesh
from tell_tpu.parallel import param_sharding_rules as j_rules
from tell_tpu_torch.parallel import (Mesh, batch_sharding, make_mesh,
                                     param_sharding_rules, shard_params)
from tell_tpu_torch.bridge import tree_leaves_with_path
from tell_tpu_torch.parallel.mesh import check_mesh_size

EXPTS = {"flagship": "expt/nytimes/9_transformer_objects.yaml",
         "expt10": "expt/nytimes/10_vit_modern.yaml",
         "expt12": "expt/nytimes/12_moe_modern.yaml"}


def _shapes(name):
    """(tell_tpu's abstract param tree, the port's meta-tensor tree) of
    an experiment's model."""
    from tell_tpu.models.registry import get_model
    exp = j_load(EXPTS[name])
    ad = get_model(exp.model_type, exp.model)
    abstract = jax.eval_shape(lambda r: ad.init(r, ad.config),
                              jax.random.PRNGKey(0))
    meta = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"),
                        abstract)
    return abstract, meta


@pytest.mark.parametrize("name", sorted(EXPTS))
@pytest.mark.parametrize("n_model", [2, 3])
def test_rule_table_equals_tell_tpu_leaf_for_leaf(name, n_model):
    abstract, meta = _shapes(name)
    jmesh = j_make_mesh(n_data=1, n_model=n_model)
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): tuple(s.spec)
            for p, s in jax.tree_util.tree_leaves_with_path(
                j_rules(abstract, jmesh))}
    got = param_sharding_rules(meta, Mesh((1, n_model), ("data", "model")))
    assert set(got) == set(want)
    assert got == want
    # the rules shard something on every model family
    assert any(s for s in got.values())


def test_make_mesh_and_shard_params_errors():
    mesh = make_mesh()                   # one process: the 1x1 grid
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError) as port:
        make_mesh(n_data=2)
    with pytest.raises(AssertionError) as ref:
        j_make_mesh(n_data=9, n_model=1)
    assert str(port.value) == "mesh 2x1 needs 2 devices, have 1"
    assert str(ref.value) == "mesh 9x1 needs 9 devices, have 8"
    check_mesh_size(2, 1, 2)
    with pytest.raises(ValueError, match="mesh 4x2 needs 8 devices, have 3"):
        check_mesh_size(4, 2, 3)
    params = {"w": torch.ones(2)}
    assert shard_params(params, mesh) is params
    # a "model" axis of 2 (this process is rank 0 of the grid): the
    # rules' leaves cut to their first slice, the rest whole
    tree = {"layers": [{"fc1": {"v": torch.arange(8.).reshape(2, 4)},
                        "fc2": {"v": torch.arange(8.).reshape(4, 2)},
                        "norm": {"scale": torch.ones(3)}}]}
    cut = shard_params(tree, Mesh((1, 2), ("data", "model")))
    lp = cut["layers"][0]
    assert torch.equal(lp["fc1"]["v"], tree["layers"][0]["fc1"]["v"][:, :2])
    assert torch.equal(lp["fc2"]["v"], tree["layers"][0]["fc2"]["v"][:2])
    assert lp["norm"]["scale"] is tree["layers"][0]["norm"]["scale"]


def test_batch_sharding_rows_and_error_equal_tell_tpu():
    mesh = Mesh((2, 1), ("data", "model"))     # this process is rank 0
    batch = {"caption_ids": np.arange(12).reshape(6, 2),
             "article_mask": np.zeros((6, 3), bool), "n": np.float32(2)}
    rows = batch_sharding(mesh, batch)
    assert np.array_equal(rows["caption_ids"], batch["caption_ids"][:3])
    assert rows["article_mask"].shape == (3, 3) and rows["n"] == 2
    bad = {"caption_ids": np.zeros((6, 2)), "obj": np.zeros((5, 2))}
    with pytest.raises(ValueError) as port:
        batch_sharding(mesh, bad)
    with pytest.raises(ValueError) as ref:
        j_batch_sharding(j_make_mesh(n_data=2, n_model=1,
                                     devices=jax.devices()[:2]), bad)
    assert str(port.value) == str(ref.value)
    assert "'data' mesh axis (2)" in str(port.value)


def test_small_config_params_have_rules():
    """The port's own init tree (small_test_config) has tell_tpu's leaf
    paths, so the table reaches every leaf."""
    from tell_tpu.models.captioner import init_captioner as j_init
    from tell_tpu_torch.bridge import init_captioner
    from tell_tpu_torch.config import small_test_config
    tree = init_captioner(torch.Generator().manual_seed(0),
                          small_test_config())
    jtree = jax.eval_shape(lambda r: j_init(r, j_small_config()),
                           jax.random.PRNGKey(0))
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    jpaths = [jax.tree_util.keystr(p, simple=True, separator="/")
              for p, _ in jax.tree_util.tree_leaves_with_path(jtree)]
    assert sorted(paths) == sorted(jpaths)
    specs = param_sharding_rules(tree, Mesh((1, 2), ("data", "model")))
    assert specs["decoder/layers/0/attn/image/q_proj/w"] == (None, "model")
    assert specs["decoder/layers/0/fc2/v"] == ("model", None)


def test_llm_pp_sharding_equals_tell_tpu():
    """The pipelined LM's layout: the layer stack's stage dim on "pipe",
    the rest replicated, leaf for leaf as tell_tpu's llm_pp_sharding."""
    from jax.sharding import Mesh as JMesh
    from tell_tpu.models import llm_decoder as J
    from tell_tpu_torch.models.llm_decoder import (llm_pp_sharding,
                                                   stack_llm_layers)
    abstract, meta = _shapes("expt10")
    jstacked = jax.eval_shape(lambda p: J.stack_llm_layers(p, 2), abstract)
    jmesh = JMesh(np.array(jax.devices()[:2]), ("pipe",))
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): tuple(s.spec)
            for p, s in jax.tree_util.tree_leaves_with_path(
                J.llm_pp_sharding(jstacked, jmesh))}
    assert llm_pp_sharding(stack_llm_layers(meta, 2)) == want
