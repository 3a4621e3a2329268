"""tell_tpu_torch.ops.moe against tell_tpu.ops.moe on the CPU, and expt
12's MoE form of the modern LM against tell_tpu's.

tell_tpu's init_moe_ffn makes the weights (carried across with
bridge.to_torch), numpy seeds the tokens. moe_ffn's output within 1e-4
and its aux loss at full capacity (nothing dropped, also against
moe_ffn_dense_reference), with capacity drops (GShard's priority: choice
0 of every token before any choice 1), with pads (a pad takes no slot and
gets zero), at top-1 (the raw gate), with one expert, and on routing ties
(the first expert wins). The MoE decoder (8 experts, top-2, GQA): greedy
and beam 5 ids equal to tell_tpu's, log-probs and scores within 1e-4, and
a row's caption the same alone and in a batch of 8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.config import ContextSpec as JSpec
from tell_tpu.models import llm_decoder as J
from tell_tpu.ops import moe as jmoe
from tell_tpu_torch.bridge import init_llm_decoder, to_torch
from tell_tpu_torch.config import ContextSpec, LLMConfig
from tell_tpu_torch.models import llm_decoder as P
from tell_tpu_torch.ops import moe as pmoe

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
# tell_tpu's functions compiled whole (its eager einsums compile op by op)
J_MOE = jax.jit(jmoe.moe_ffn, static_argnames=("top_k", "capacity_factor"))
J_DENSE = jax.jit(jmoe.moe_ffn_dense_reference, static_argnames=("top_k",))


def _pair(seed, d=12, f=16, e=4, n=24):
    params = jmoe.init_moe_ffn(jax.random.PRNGKey(seed), d, f, e)
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return params, to_torch(jax.tree.map(np.asarray, params), "cpu"), x


def _check(jparams, pparams, x, **kw):
    jmask = kw.pop("token_mask", None)
    want, waux = J_MOE(jparams, jnp.asarray(x), **kw,
                       token_mask=None if jmask is None
                       else jnp.asarray(jmask))
    got, gaux = pmoe.moe_ffn(pparams, torch.from_numpy(x), **kw,
                             token_mask=None if jmask is None
                             else torch.from_numpy(jmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    return got.numpy()


def test_full_capacity_equals_jax_and_the_dense_reference():
    jp, pp, x = _pair(0)
    out = _check(jp, pp, x, top_k=2, capacity_factor=4.0)
    np.testing.assert_allclose(
        out, pmoe.moe_ffn_dense_reference(pp, torch.from_numpy(x)).numpy(),
        **TOL)
    np.testing.assert_allclose(
        pmoe.moe_ffn_dense_reference(pp, torch.from_numpy(x)).numpy(),
        np.asarray(J_DENSE(jp, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (2, 0.5), (1, 1.0),
                                      (1, 1 / 6)])
def test_capacity_drops_equal_jax(top_k, cf):
    """Pairs past an expert's capacity drop as tell_tpu's do: some rows
    lose a choice, some get nothing."""
    jp, pp, x = _pair(1, n=30)
    out = _check(jp, pp, x, top_k=top_k, capacity_factor=cf)
    dense = pmoe.moe_ffn_dense_reference(pp, torch.from_numpy(x),
                                         top_k).numpy()
    assert not np.allclose(out, dense)


def test_pads_take_no_capacity_and_get_zero():
    jp, pp, x = _pair(2, n=20)
    mask = np.ones(20, bool)
    mask[[0, 3, 4, 11, 19]] = False
    x[~mask] = x[0]                    # identical pads route together
    out = _check(jp, pp, x, top_k=2, capacity_factor=1.0, token_mask=mask)
    assert np.all(out[~mask] == 0)


def test_top1_one_expert_and_routing_ties():
    jp, pp, x = _pair(3, e=3, n=10)
    _check(jp, pp, x, top_k=1, capacity_factor=3.0)
    jp1, pp1, x1 = _pair(4, e=1, n=10)
    out = _check(jp1, pp1, x1, top_k=2, capacity_factor=1.0)
    np.testing.assert_allclose(
        out, pmoe.moe_ffn_dense_reference(pp1, torch.from_numpy(x1),
                                          1).numpy(), **TOL)
    # a zero router: every expert ties, the lowest ids win, as jnp.argmax
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    pp["router"]["w"] = torch.zeros_like(pp["router"]["w"])
    _check(jp, pp, x, top_k=2, capacity_factor=3.0)
    _, chosen, gate = pmoe._route(pp, torch.from_numpy(x), 2)
    assert chosen.tolist() == [[0] * 10, [1] * 10]
    assert torch.allclose(gate, torch.full((10, 2), 0.5))


FIELDS = dict(vocab_size=97, dim=32, num_layers=2, num_heads=4,
              num_kv_heads=2, ffn_dim=24, dropout=0.0, attention_dropout=0.0,
              max_target_positions=16, gen_len=5, moe_experts=8, moe_top_k=2)
CONTEXTS = (("image", 8, 3), ("article", 8, 5), ("faces", 4, 2),
            ("obj", 8, 3))


def _batch(B, seed=7):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    faces = f(B, 2, 4)
    faces[::2, 1] = np.nan
    return {"image_grid": f(B, 3, 8), "article": f(B, 5, 8),
            "article_mask": np.arange(5)[None] >= (np.arange(B) % 5 + 1)[
                :, None],
            "face_embeds": faces, "obj_embeds": f(B, 3, 8)}


def test_moe_decoder_equals_jax():
    """Expt 12's form: greedy and beam 5 against tell_tpu's."""
    jcfg = J.LLMConfig(**FIELDS, contexts=tuple(JSpec(*c) for c in CONTEXTS))
    pcfg = LLMConfig(**FIELDS, contexts=tuple(ContextSpec(*c)
                                              for c in CONTEXTS))
    jp = J.init_llm_decoder(jax.random.PRNGKey(9), jcfg)
    assert jp["layers"][0]["ffn"]["w1"].shape == (8, 32, 24)
    pp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jax.jit(lambda p, b: J.llm_generate(p, jcfg, b))(jp, jb)
    got = P.llm_generate(pp, pcfg, pb)
    np.testing.assert_array_equal(got["token_ids"].numpy(),
                                  np.asarray(want["token_ids"]))
    np.testing.assert_allclose(got["log_probs"].numpy(),
                               np.asarray(want["log_probs"]), **TOL)
    want = jax.jit(lambda p, b: J.llm_beam_search(p, jcfg, b, beam_size=5))(
        jp, jb)
    got = P.llm_beam_search(pp, pcfg, pb, beam_size=5)
    np.testing.assert_array_equal(got["token_ids"].numpy(),
                                  np.asarray(want["token_ids"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), **TOL)


def test_moe_caption_is_the_same_alone_and_in_a_batch_of_8():
    """Decoding runs the MoE at capacity_factor = moe_experts: no row is
    dropped, so a caption does not depend on its batch-mates."""
    cfg = LLMConfig(**FIELDS, contexts=tuple(ContextSpec(*c)
                                             for c in CONTEXTS))
    params = init_llm_decoder(torch.Generator().manual_seed(11), cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(8, seed=12).items()}
    full = P.llm_generate(params, cfg, batch)
    beams = P.llm_beam_search(params, cfg, batch, beam_size=5)
    for i in (0, 5):
        solo = {k: v[i:i + 1] for k, v in batch.items()}
        np.testing.assert_array_equal(
            P.llm_generate(params, cfg, solo)["token_ids"][0].numpy(),
            full["token_ids"][i].numpy())
        np.testing.assert_array_equal(
            P.llm_beam_search(params, cfg, solo, beam_size=5)[
                "token_ids"][0].numpy(), beams["token_ids"][i].numpy())
    # the same rows at training capacity would compete: tell_tpu's
    # capacity rule drops pairs here
    x = torch.randn(40, 32, generator=torch.Generator().manual_seed(13))
    lp = params["layers"][0]["ffn"]
    assert not torch.allclose(
        pmoe.moe_ffn(lp, x, 2, capacity_factor=0.5)[0],
        pmoe.moe_ffn(lp, x, 2, capacity_factor=8.0)[0])
    assert dataclasses.replace(cfg, moe_experts=None).moe_experts is None
