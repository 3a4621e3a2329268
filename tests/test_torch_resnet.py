"""The port's ResNet tower against tell_tpu's: the config, the forward
(grid and pooled) on the same weights, the torchvision converter, the
random init's tree, and the TF32 switch left as it was found.

Tolerance: fp32 throughout; the grid and pooled outputs within
atol 1e-5 + rtol 1e-5 of tell_tpu's (two conv libraries summing in other
orders), the converted trees exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.models.backbones import resnet as jr
from tell_tpu_torch.bridge import init_resnet, to_numpy, to_torch
from tell_tpu_torch.models.backbones import resnet as tr

TOL = dict(atol=1e-5, rtol=1e-5)
CONFIGS = {"tiny": ((1, 1, 1, 1), 8), "resnet50_w4": ((3, 4, 6, 3), 4)}


def _jcfg(name):
    blocks, width = CONFIGS[name]
    return jr.ResNetConfig(blocks, width)


def _tcfg(name):
    blocks, width = CONFIGS[name]
    return tr.ResNetConfig(blocks, width)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def torchvision_state_dict(cfg, seed=0, dtype=np.float32):
    """A torchvision-named ResNet state dict from a seed (conv weights
    OIHW, batch norm with non-trivial statistics)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cin, cout, k):
        sd[name + ".weight"] = (rng.normal(size=(cout, cin, k, k))
                                * (2.0 / (k * k * cout)) ** 0.5).astype(dtype)

    def bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.5, 1.5, c).astype(dtype)
        sd[name + ".bias"] = rng.normal(scale=0.1, size=c).astype(dtype)
        sd[name + ".running_mean"] = rng.normal(scale=0.1, size=c).astype(dtype)
        sd[name + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(dtype)
        sd[name + ".num_batches_tracked"] = np.asarray(0, np.int64)

    w = cfg.width
    conv("conv1", 3, w, 7)
    bn("bn1", w)
    cin = w
    for s, n in enumerate(cfg.block_counts):
        planes = w * 2 ** s
        for b in range(n):
            pre = f"layer{s + 1}.{b}."
            conv(pre + "conv1", cin, planes, 1)
            bn(pre + "bn1", planes)
            conv(pre + "conv2", planes, planes, 3)
            bn(pre + "bn2", planes)
            conv(pre + "conv3", planes, planes * 4, 1)
            bn(pre + "bn3", planes * 4)
            if b == 0:
                conv(pre + "downsample.0", cin, planes * 4, 1)
                bn(pre + "downsample.1", planes * 4)
            cin = planes * 4
    return sd


def test_config_equals_tell_tpus():
    for make in ("resnet152", "resnet50"):
        a, b = getattr(jr.ResNetConfig, make)(), getattr(tr.ResNetConfig,
                                                         make)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.out_dim == b.out_dim == 2048
    assert ([f.name for f in dataclasses.fields(jr.ResNetConfig)]
            == [f.name for f in dataclasses.fields(tr.ResNetConfig)])
    assert dataclasses.asdict(jr.ResNetConfig()) == dataclasses.asdict(
        tr.ResNetConfig())


@pytest.mark.parametrize("name,size", [("tiny", 64), ("tiny", 67),
                                       ("resnet50_w4", 64)])
@pytest.mark.parametrize("pool", [False, True])
def test_forward_equals_tell_tpu(name, size, pool):
    jcfg, tcfg = _jcfg(name), _tcfg(name)
    # the port's init (tell_tpu's tree; drawing it through jax.random op by
    # op on the CPU takes seconds)
    params = to_numpy(init_resnet(torch.Generator().manual_seed(3), tcfg))
    # non-trivial folded batch norm, scaled as a trained tower's keeps the
    # activations of order 1
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (x * rng.uniform(0.3, 0.6, x.shape).astype(np.float32)
                         if "scale" in jax.tree_util.keystr(path)
                         else x + rng.normal(scale=0.05, size=x.shape)
                         .astype(np.float32)
                         if "bias" in jax.tree_util.keystr(path) else x),
        params)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jr.resnet_forward, static_argnums=(1, 3))(
        params, jcfg, jnp.asarray(x), pool))
    with torch.no_grad():
        tp = to_torch(params, "cpu")
        got = tr.resnet_forward(tr.prepare_resnet(tp), tcfg,
                                torch.from_numpy(x), pool=pool)
        # the forward takes the prepared layout only: the HWIO tree's stem
        # conv does not fit the input
        with pytest.raises(RuntimeError):
            tr.resnet_forward(tp, tcfg, torch.from_numpy(x), pool=pool)
    assert got.shape == want.shape
    assert 0.1 < np.abs(want).max() < 50
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_preprocess_image_equals_tell_tpu():
    img = np.random.default_rng(0).uniform(0, 1, (2, 5, 7, 3)).astype(
        np.float32)
    want = np.asarray(jr.preprocess_image(jnp.asarray(img)))
    got = tr.preprocess_image(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["tiny", "resnet50_w4"])
def test_converter_tree_exactly_equal(name):
    sd = torchvision_state_dict(_tcfg(name), seed=2)
    want = _numpy_tree(jr.convert_torchvision_resnet(sd, _jcfg(name)))
    got = tr.convert_torchvision_resnet(
        {k: torch.from_numpy(v) for k, v in sd.items()}, _tcfg(name))
    assert (jax.tree_util.tree_structure(want)
            == jax.tree_util.tree_structure(got))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_init_resnet152_has_tell_tpus_tree_and_shapes():
    want = jax.eval_shape(lambda k: jr.init_resnet(k, jr.ResNetConfig()),
                          jax.random.PRNGKey(0))
    got = init_resnet(torch.Generator().manual_seed(0),
                      tr.ResNetConfig.resnet152())
    assert (jax.tree_util.tree_structure(want)
            == jax.tree_util.tree_structure(
                jax.tree.map(lambda x: 0, got)))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    conv = got["stages"][2][0]["conv2"]
    assert abs(conv.std().item() - (2.0 / (9 * 256)) ** 0.5) < 2e-3
    bn = got["stages"][0][0]["bn1"]
    assert torch.equal(bn["scale"], torch.ones(64))
    assert torch.equal(bn["bias"], torch.zeros(64))


@pytest.mark.parametrize("flag", [True, False])
def test_forward_leaves_tf32_switch_as_found(flag):
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = flag
    try:
        cfg = _tcfg("tiny")
        params = tr.prepare_resnet(
            init_resnet(torch.Generator().manual_seed(0), cfg))
        seen = []
        real = tr.F.conv2d

        def spy(*a, **k):
            seen.append(torch.backends.cudnn.allow_tf32)
            return real(*a, **k)

        tr.F.conv2d = spy
        try:
            tr.resnet_forward(params, cfg, torch.zeros(1, 32, 32, 3))
        finally:
            tr.F.conv2d = real
        assert seen and not any(seen)        # every conv ran in fp32
        assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = before
