"""The pointer family (tell_tpu_torch.ops.self_attention and
tell_tpu_torch.models.pointer, expts a1-a3) against tell_tpu's on the CPU.

tests/test_pointer.py's small faces configuration: small_test_config's
decoder (E=64, 4 heads, vocab 500 in bands 50/200/500, kernel sizes 3
and 5) over the image (9 x 32), article (16 x 24) and faces (4 x 16)
contexts, gen_len 8, copy-attention dropout 0; weigh_bert on (three
hidden layers mixed, by bert_weight for the decoder and bert_weight_2 for
the copy head) and off (the article's final state). tell_tpu's
initialisers make the weights, carried across with bridge.to_torch; the
port's init_pointer makes the same tree. Held, fp32, at 1e-5: the gated
self-attention, full and incremental (step 0's attention exactly 0), the
copy attention's probabilities with padded keys, the copy targets'
masses, and pointer_generate's five outputs, greedy (ids equal; never a
copy without proper tokens).
pointer_loss is held in tests/test_torch_pointer_loss.py (v1) and
tests/test_torch_pointer_v2.py (v2, and pointer_generate sampled among
the top 3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu import config as JC
from tell_tpu.models import pointer as J
from tell_tpu.ops import self_attention as JS
from tell_tpu_torch import config as PC
from tell_tpu_torch.bridge import (init_copy_attention, init_gated_linear,
                                   init_pointer, to_torch, tree_map)
from tell_tpu_torch.models import pointer as P
from tell_tpu_torch.ops import self_attention as PS

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B, T, S = 2, 10, 16


def configs(version=1, weigh_bert=True, **over):
    """(tell_tpu's PointerConfig, the port's) at the small faces config."""
    out = []
    for C, M in ((JC, J), (PC, P)):
        cap = C.small_test_config()
        cap = dataclasses.replace(
            cap, decoder=dataclasses.replace(
                cap.decoder, contexts=cap.decoder.contexts[:3]),
            **{"gen_len": 8, "weigh_bert": weigh_bert, **over})
        out.append(M.PointerConfig(captioner=cap, copy_loss_version=version,
                                   attn_dropout=0.0))
    return tuple(out)


def make_batch(cfg, seed=0, kind="entities"):
    """tests/test_pointer.py's batch (entities 1 and 2 planted in the
    caption, proper positions 5 and 7), with kind "none" (no entity
    token), "repeated" (proper ids repeated across positions, a padded
    article tail, a padded caption, an entity index of 25) or
    "entities"."""
    rng = np.random.default_rng(seed)
    cap_cfg = cfg.captioner
    d = cap_cfg.decoder
    caption = rng.integers(4, d.vocab_size, (B, T))
    caption[:, 0], caption[:, -1] = d.bos_id, d.eos_id
    context_ids = rng.integers(4, d.vocab_size, (B, S))
    caption[:, 2] = context_ids[0, 5]
    cap_masks = np.zeros((B, T), np.int32)
    cap_masks[:, 2], cap_masks[:, 3] = 1, 2
    proper = np.zeros((B, S), np.int32)
    proper[:, 5], proper[:, 7] = 1, 2
    mask = np.zeros((B, S), bool)
    if kind == "none":
        cap_masks[:] = 0
    elif kind == "repeated":
        context_ids[:, 9] = context_ids[:, 5]       # an entity twice
        context_ids[1, 11] = context_ids[1, 7]
        proper[:, 9], proper[1, 11] = 1, 2
        caption[1, 4] = context_ids[1, 7]
        cap_masks[1, 4] = 2
        caption[0, 6], cap_masks[0, 6] = context_ids[0, 3], 25
        proper[0, 3] = 25                           # an index past 24
        context_ids[1, 13:], proper[1, 13:], mask[1, 13:] = 1, -1, True
        caption[1, 7], caption[1, 8:] = d.eos_id, d.pad_id
        cap_masks[1, 8:] = -1
    art = d.context("article")
    batch = {"caption_ids": caption.astype(np.int32),
             "caption_copy_masks": cap_masks,
             "context_ids": context_ids.astype(np.int32),
             "proper_masks": proper,
             "image_grid": rng.normal(size=(B, 9, 32)).astype(np.float32),
             "article_mask": mask,
             "face_embeds": rng.normal(size=(B, 4, 16)).astype(np.float32)}
    if cap_cfg.weigh_bert:
        batch["article_hiddens"] = rng.normal(
            size=(B, S, cap_cfg.num_bert_layers, art.kv_dim)
        ).astype(np.float32)
    else:
        batch["article"] = rng.normal(size=(B, S, art.kv_dim)
                                      ).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_init():
    return jax.jit(J.init_pointer, static_argnums=1)


def jax_params(seed, weigh_bert=True) -> dict:
    """tell_tpu's init_pointer (jitted once) at weigh_bert on; off takes
    the same tree without bert_weight and bert_weight_2 (the tree
    tell_tpu's init makes then)."""
    p = dict(_jax_init()(jax.random.PRNGKey(seed), configs(1)[0]))
    if not weigh_bert:
        p.pop("bert_weight_2")
        p["captioner"] = {k: v for k, v in p["captioner"].items()
                          if k != "bert_weight"}
    return p


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _t(jparams):
    return to_torch(jax.tree.map(np.asarray, jparams), "cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **(tol or TOL))


def _shapes(tree, j=False):
    if j:
        return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree)
    return tree_map(lambda x: (tuple(x.shape), str(x.dtype)[6:]), tree)


@pytest.mark.parametrize("weigh_bert", [True, False])
def test_init_makes_tell_tpus_tree(weigh_bert):
    jcfg, pcfg = configs(weigh_bert=weigh_bert)
    g = torch.Generator().manual_seed(0)
    got = _shapes(init_pointer(g, pcfg))
    assert got == _shapes(jax.eval_shape(
        lambda: J.init_pointer(jax.random.PRNGKey(0), jcfg)), True)
    assert _shapes(jax_params(0, weigh_bert), True) == got
    assert ("bert_weight_2" in got) is weigh_bert
    for bias in (True, False):
        assert _shapes(init_gated_linear(g, 8, 6, bias)) == _shapes(
            jax.eval_shape(lambda: JS.init_gated_linear(
                jax.random.PRNGKey(0), 8, 6, bias=bias)), True)
    assert _shapes(init_copy_attention(g, 64, 24)) == _shapes(
        jax.eval_shape(lambda: JS.init_copy_attention(
            jax.random.PRNGKey(0), 64, 24)), True)


def test_gated_linear_equals_jax():
    jp = JS.init_gated_linear(jax.random.PRNGKey(3), 12, 8)
    x = np.random.default_rng(0).normal(size=(3, 5, 12)).astype(np.float32)
    _close(PS.gated_linear(_t(jp), torch.from_numpy(x)),
           jax.jit(JS.gated_linear)(jp, jnp.asarray(x)))


def test_self_attention_full_and_incremental_equal_jax():
    jp = JS.init_self_attention(jax.random.PRNGKey(0), 64)
    tp = _t(jp)
    j_attn = jax.jit(JS.self_attention, static_argnums=2)
    x = np.random.default_rng(1).normal(size=(2, 6, 64)).astype(np.float32)
    want = j_attn(jp, jnp.asarray(x), 4)
    got = PS.self_attention(tp, torch.from_numpy(x), 4)
    _close(got, want)
    # step 0 sees only the prepended zero column: its attention is 0
    q = torch.from_numpy(x)
    attn = PS._attend_strict_causal(q, q, q, 4, 0)
    assert (attn[:, 0] == 0).all() and (attn[:, 1:] != 0).any()
    # the incremental form over a history with unfilled rows
    G = 8
    hist = torch.zeros(2, G, 64)
    jhist = jnp.zeros((2, G, 64))
    for t in range(6):
        hist[:, t] = q[:, t]
        jhist = jhist.at[:, t].set(x[:, t])
        valid = (np.arange(G) <= t)[None].repeat(2, 0)
        step_want = j_attn(jp, jnp.asarray(x[:, t:t + 1]), 4, t, jhist,
                           jnp.asarray(valid))
        step_got = PS.self_attention(tp, q[:, t:t + 1], 4, q_offset=t,
                                     kv=hist,
                                     kv_valid=torch.from_numpy(valid))
        _close(step_got, step_want)
        _close(step_got[:, 0], want[:, t])


def test_copy_attention_scores_with_pads_equal_jax():
    jp = JS.init_copy_attention(jax.random.PRNGKey(0), 64, 24)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 5, 64)).astype(np.float32)
    k = rng.normal(size=(2, 11, 24)).astype(np.float32)
    mask = np.zeros((2, 11), bool)
    mask[:, 9:], mask[1, 4] = True, True
    want = JS.copy_attention_scores(jp, jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(mask), num_heads=4)
    tp = _t(jp)
    keys = PS.copy_attention_keys(tp, torch.from_numpy(k))
    assert keys.shape == (2, 13, 64)
    got = PS.copy_attention_scores(tp, torch.from_numpy(q), keys,
                                   torch.from_numpy(mask), num_heads=4)
    assert got.shape == (2, 5, 13) and got.dtype == torch.float32
    _close(got, want)
    assert float(got[:, :, 9:11].abs().max()) == 0.0
    assert float(got[1, :, 4].abs().max()) == 0.0
    # bf16 queries: fp32 probabilities, as tell_tpu's
    tp16 = tree_map(lambda x: x.bfloat16(), tp)
    assert PS.copy_attention_scores(
        tp16, torch.from_numpy(q).bfloat16(), PS.copy_attention_keys(
            tp16, torch.from_numpy(k).bfloat16()),
        num_heads=4).dtype == torch.float32


def test_copy_target_probs_equal_jax():
    rng = np.random.default_rng(0)
    L, V = 5, 40
    attn = rng.random((B, L, S)).astype(np.float32)
    ids = rng.integers(0, V, (B, S))
    proper = rng.random((B, S)) > 0.4
    targets = rng.integers(0, V, (B, L))
    targets[0, 1] = ids[0][proper[0]][0]
    want = J._copy_target_probs(jnp.asarray(attn * proper[:, None]),
                                jnp.asarray(ids), jnp.asarray(proper),
                                jnp.asarray(targets))
    got = P._copy_target_probs(torch.from_numpy(attn * proper[:, None]),
                               torch.from_numpy(ids),
                               torch.from_numpy(proper),
                               torch.from_numpy(targets))
    _close(got, want)
    assert float(got[0, 1]) > 0


@functools.lru_cache(maxsize=None)
def _jax_generate(jcfg):
    return jax.jit(lambda p, b: J.pointer_generate(p, jcfg, b))


def _generate_pair(pcfg, jcfg, seed, copy_bias=0.5):
    """The same weights in both packages, the entity head's bias raised
    by copy_bias so that both branches run, and a batch with repeated
    proper ids."""
    jp = jax_params(seed, jcfg.captioner.weigh_bert)
    jp["entity_fc"] = {**jp["entity_fc"]}
    jp["entity_fc"]["b"] = jnp.asarray([0.0, copy_bias], jnp.float32)
    return jp, _t(jp), make_batch(pcfg, seed=seed, kind="repeated")


@pytest.mark.parametrize("weigh_bert", [True, False])
def test_pointer_generate_greedy_equals_jax(weigh_bert):
    jcfg, pcfg = configs(1, weigh_bert)
    seen_copy = False
    for seed in (0, 1):
        jp, tp, batch = _generate_pair(pcfg, jcfg, seed)
        batch.pop("caption_ids")
        want = _jax_generate(jcfg)(jp, _jb(batch))
        with torch.inference_mode():
            got = P.pointer_generate(tp, pcfg, _tb(batch))
        for key in ("token_ids", "should_copy", "finished"):
            assert np.array_equal(got[key].numpy(), np.asarray(want[key])), \
                key
        _close(got["log_probs"], want["log_probs"])
        _close(got["copy_probs"], want["copy_probs"])
        copies = got["should_copy"].numpy()
        seen_copy |= copies.any()
        # a copy emits a proper context token, at most once a row
        toks = got["token_ids"][:, 1:].numpy()
        for b in range(B):
            proper = batch["context_ids"][b][batch["proper_masks"][b] >= 1]
            assert set(toks[b][copies[b]]) <= set(proper.tolist())
            assert len(set(toks[b][copies[b]])) == copies[b].sum()
        assert (got["copy_probs"].numpy()[~copies] == 0).all()
    assert seen_copy


def test_pointer_generate_without_entities_never_copies():
    jcfg, pcfg = configs(1)
    jp, tp, batch = _generate_pair(pcfg, jcfg, 0, copy_bias=5.0)
    batch["proper_masks"] = np.zeros_like(batch["proper_masks"])
    want = _jax_generate(jcfg)(jp, _jb(batch))
    with torch.inference_mode():
        got = P.pointer_generate(tp, pcfg, _tb(batch))
    assert not got["should_copy"].any()
    assert np.array_equal(got["token_ids"].numpy(),
                          np.asarray(want["token_ids"]))
