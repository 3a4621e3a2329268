"""tell_tpu_torch.models.backbones.vit (ViT-L/16, the modern family's
image tower) against tell_tpu.models.backbones.vit on the CPU.

tell_tpu's init_vit makes the weights (carried across with
bridge.to_torch), numpy seeds the NHWC images. vit_encode within
FEATURE_REL_TOL (1e-5 of the largest token) at a small config
(image 32, patch 8, dim 48) and at ViTConfig.tiny(); patchify equal to
tell_tpu's and to a strided conv; convert_hf_vit on a HuggingFace-named
state dict the test writes itself (no transformers), bare and
"vit."-prefixed, torch or numpy, equal to tell_tpu's conversion and
running equal to it; bridge.init_vit's tree shaped as tell_tpu's; and
modern_encode_contexts' article (RoBERTa's final hidden state) and image
(the ViT's tokens) within 1e-5 of tell_tpu's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.models.backbones import vit as jvit
from tell_tpu_torch.bridge import init_vit, to_torch, tree_leaves
from tell_tpu_torch.models.backbones import vit as pvit

torch.set_num_threads(2)
FEATURE_REL_TOL = 1e-5
SMALL = dict(image_size=32, patch_size=8, dim=48, num_layers=3, num_heads=4,
             ffn_dim=96)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _encode_both(jcfg, pcfg, seed, B=2):
    params = jvit.init_vit(jax.random.PRNGKey(seed), jcfg)
    imgs = np.random.default_rng(seed).normal(
        size=(B, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jvit.vit_encode(p, jcfg, x))(
        params, jnp.asarray(imgs))
    got = pvit.vit_encode(to_torch(jax.tree.map(np.asarray, params), "cpu"),
                          pcfg, torch.from_numpy(imgs))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("which", ["small", "tiny"])
def test_vit_encode_equals_jax(which):
    if which == "small":
        jcfg, pcfg = jvit.ViTConfig(**SMALL), pvit.ViTConfig(**SMALL)
    else:
        jcfg, pcfg = jvit.ViTConfig.tiny(), pvit.ViTConfig.tiny()
    assert pcfg == pvit.ViTConfig(**{f: getattr(jcfg, f) for f in (
        "image_size", "patch_size", "dim", "num_layers", "num_heads",
        "ffn_dim", "ln_eps")})
    got, want = _encode_both(jcfg, pcfg, 0 if which == "small" else 1)
    assert got.shape == want.shape == (2, pcfg.num_tokens, pcfg.dim)
    assert _rel(got, want) <= FEATURE_REL_TOL


def test_config_and_patchify_order():
    large = pvit.ViTConfig.large()
    assert (large.grid, large.num_tokens, large.dim, large.ln_eps) == (
        14, 197, 1024, 1e-12)
    rng = np.random.default_rng(2)
    P, D = 4, 6
    imgs = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    got = pvit.patchify(torch.from_numpy(imgs), P).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jvit.patchify(imgs, P)))
    # (row, col, channel) flattening == a strided conv with the weight
    # permuted (2, 3, 1, 0)
    w = rng.normal(size=(D, 3, P, P)).astype(np.float32)
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(imgs).permute(0, 3, 1, 2), torch.from_numpy(w),
        stride=P).flatten(2).transpose(1, 2).numpy()
    np.testing.assert_allclose(got @ w.transpose(2, 3, 1, 0).reshape(-1, D),
                               conv, atol=1e-5)


def _hf_state(seed, cfg, prefix=""):
    """A HuggingFace ViTModel state dict of cfg's shapes, by its key names
    and layouts ([out, in] dense weights, a [D, 3, P, P] conv)."""
    rng = np.random.default_rng(seed)
    D, F, P = cfg.dim, cfg.ffn_dim, cfg.patch_size
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    sd = {"embeddings.cls_token": r(1, 1, D),
          "embeddings.position_embeddings": r(1, cfg.num_tokens, D),
          "embeddings.patch_embeddings.projection.weight": r(D, 3, P, P),
          "embeddings.patch_embeddings.projection.bias": r(D),
          "layernorm.weight": r(D), "layernorm.bias": r(D)}
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}."
        for name, (o, n) in {"attention.attention.query": (D, D),
                             "attention.attention.key": (D, D),
                             "attention.attention.value": (D, D),
                             "attention.output.dense": (D, D),
                             "intermediate.dense": (F, D),
                             "output.dense": (D, F)}.items():
            sd[pre + name + ".weight"] = r(o, n)
            sd[pre + name + ".bias"] = r(o)
        for ln in ("layernorm_before", "layernorm_after"):
            sd[pre + ln + ".weight"] = r(D)
            sd[pre + ln + ".bias"] = r(D)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix,as_torch", [("", True), ("vit.", False)])
def test_convert_hf_vit_equals_jax(prefix, as_torch):
    jcfg, pcfg = jvit.ViTConfig(**SMALL), pvit.ViTConfig(**SMALL)
    sd = _hf_state(3, pcfg, prefix)
    if prefix:    # ViTForImageClassification's head rides along
        sd["classifier.weight"] = np.zeros((10, pcfg.dim), np.float32)
    want = jvit.convert_hf_vit(sd, jcfg)
    got = pvit.convert_hf_vit(
        {k: torch.from_numpy(v) for k, v in sd.items()} if as_torch else sd,
        pcfg)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, np.asarray(w))
    imgs = np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    ours = pvit.vit_encode(to_torch(got, "cpu"), pcfg,
                           torch.from_numpy(imgs)).numpy()
    theirs = np.asarray(jvit.vit_encode(want, jcfg, jnp.asarray(imgs)))
    assert _rel(ours, theirs) <= FEATURE_REL_TOL
    with pytest.raises(KeyError):
        pvit.convert_hf_vit({}, pcfg)


def test_init_vit_is_shaped_as_jax():
    jcfg, pcfg = jvit.ViTConfig(**SMALL), pvit.ViTConfig(**SMALL)
    want = jax.eval_shape(lambda k: jvit.init_vit(k, jcfg),
                          jax.random.PRNGKey(0))
    got = init_vit(torch.Generator().manual_seed(0), pcfg)
    paths = [p for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape), got))] == paths
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(
        lambda s: tuple(s.shape), want)
    assert len(tree_leaves(got)) == len(jax.tree.leaves(want))


def test_modern_encode_contexts_equals_jax():
    """The article is RoBERTa's final hidden state (no layer sum), the
    image the ViT's tokens, each within 1e-5 of tell_tpu's (the towers
    from the port's initialisers, carried to tell_tpu as numpy)."""
    from tell_tpu.config import ContextSpec as JSpec
    from tell_tpu.models import llm_decoder as J
    from tell_tpu.models.backbones.roberta import RobertaConfig as JR
    from tell_tpu_torch.bridge import init_roberta, to_numpy
    from tell_tpu_torch.config import ContextSpec, LLMConfig
    from tell_tpu_torch.models import llm_decoder as P
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    contexts = (("image", 16, 5), ("article", 12, 30))
    jcfg = J.LLMConfig(contexts=tuple(JSpec(*c) for c in contexts))
    pcfg = LLMConfig(contexts=tuple(ContextSpec(*c) for c in contexts))
    rfields = dict(vocab_size=300, dim=12, num_layers=1, num_heads=2,
                   ffn_dim=24, max_positions=20)
    vfields = dict(image_size=32, patch_size=16, dim=16, num_layers=1,
                   num_heads=2, ffn_dim=32)
    g = torch.Generator().manual_seed(3)
    pfrozen = {"roberta": init_roberta(g, RobertaConfig(**rfields)),
               "roberta_cfg": RobertaConfig(**rfields),
               "vit": init_vit(g, pvit.ViTConfig(**vfields)),
               "vit_cfg": pvit.ViTConfig(**vfields)}
    jfrozen = {"roberta": to_numpy(pfrozen["roberta"]),
               "roberta_cfg": JR(**rfields),
               "vit": to_numpy(pfrozen["vit"]),
               "vit_cfg": jvit.ViTConfig(**vfields)}
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 300, (2, 30))    # two windows past 20 positions
    ids[1, 20:] = 1
    image = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda r, v, i, x: J.modern_encode_contexts(
        {**jfrozen, "roberta": r, "vit": v}, jcfg,
        {"context_ids": i, "image": x}))(
        jfrozen["roberta"], jfrozen["vit"], jnp.asarray(ids),
        jnp.asarray(image))
    got = P.modern_encode_contexts(pfrozen, pcfg, {
        "context_ids": torch.from_numpy(ids),
        "image": torch.from_numpy(image)})
    for key in ("article", "image_grid"):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    np.testing.assert_array_equal(got["article_mask"].numpy(),
                                  np.asarray(want["article_mask"]))
