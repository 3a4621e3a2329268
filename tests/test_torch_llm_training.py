"""The modern family's training side (tell_tpu_torch.models.llm_decoder:
llm_forward, llm_xent, llm_loss) against tell_tpu.models.llm_decoder on
the CPU.

tell_tpu's init_llm_decoder makes the weights (carried across with
bridge.to_torch), numpy seeds make the contexts and captions (pads at the
end of some rows), at tests/test_torch_llm_decoder.py's small config with
a 300-word vocabulary streamed in chunks of 128 (two whole chunks and a
ragged one of 44). Held, with GQA (4 heads over 2 K/V heads) and MHA:
the deterministic features within 1e-4; llm_xent's sum and size (pad
targets excluded) within 1e-5 relative, and equal to a full log_softmax;
llm_loss within 1e-5 relative and every gradient leaf within 1e-4
relative L2 of jax.value_and_grad's. Dropout: the loss at one (seed,
step) generator drawn twice is the same, another step's differs, and
with the rates at 0 it equals the deterministic loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.models import llm_decoder as J
from tell_tpu_torch.bridge import to_torch, tree_leaves, tree_map
from tell_tpu_torch.models import llm_decoder as P
from tell_tpu_torch.training.trainer import step_generator
from tests.test_torch_llm_decoder import both, configs, make_batch

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
TRAIN = dict(vocab_size=300, loss_vocab_chunk=128)


def _captions(B=3, T=9, seed=3, vocab=300):
    rng = np.random.default_rng(seed)
    cap = rng.integers(3, vocab, size=(B, T)).astype(np.int32)
    cap[:, 0] = 0
    cap[1, 6] = 2
    cap[1, 7:] = 1                      # pads: no target, no MoE slot
    cap[2, 4] = 2
    cap[2, 5:] = 1
    return cap


def train_batch(B=3, T=9, seed=1):
    batch = make_batch(seed, B)
    batch["caption_ids"] = _captions(B, T, seed + 2)
    return batch


def rel_l2(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want))
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def jax_loss_and_grads(jcfg, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: J.llm_loss(p, jcfg, b), has_aux=True))(params, jb)
    return float(loss), aux, jax.tree.leaves(grads)


def port_loss_and_grads(pcfg, params, batch, gen=None, deterministic=True):
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(),
                  to_torch(jax.tree.map(np.asarray, params), "cpu"))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, aux = P.llm_loss(tp, pcfg, tb, gen, deterministic)
    loss.backward()
    return loss.item(), aux, [t.grad for t in tree_leaves(tp)]


@pytest.mark.parametrize("kv_heads", [2, None], ids=["gqa", "mha"])
def test_forward_features_equal_jax(kv_heads):
    jcfg, pcfg = configs(num_kv_heads=kv_heads, **TRAIN)
    params = J.init_llm_decoder(jax.random.PRNGKey(4), jcfg)
    batch = train_batch()
    (jp, jb), (tp, tb) = both(params, batch)
    ids = batch["caption_ids"][:, :-1]
    want, _ = J.llm_forward(jp, jcfg, jnp.asarray(ids),
                            J._build_contexts(jp, jcfg, jb))
    got, aux = P.llm_forward(tp, pcfg, torch.from_numpy(ids),
                             P._build_contexts(tp, pcfg, tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(aux) == pcfg.num_layers and all(float(a) == 0 for a in aux)


def test_xent_streams_the_ragged_chunk_and_drops_pad_targets():
    jcfg, pcfg = configs(**TRAIN)
    params = J.init_llm_decoder(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(20, jcfg.dim)).astype(np.float32)
    targets = rng.integers(0, 300, size=20).astype(np.int32)
    targets[[3, 11]] = 1                       # pads
    targets[[5, 6]] = [299, 256]               # in the ragged last chunk
    want_sum, want_size = J.llm_xent(params, jcfg, jnp.asarray(feats),
                                     jnp.asarray(targets))
    tp = to_torch(jax.tree.map(np.asarray, params), "cpu")
    got_sum, got_size = P.llm_xent(tp, pcfg, torch.from_numpy(feats),
                                   torch.from_numpy(targets))
    assert int(got_size) == int(want_size) == 18
    np.testing.assert_allclose(float(got_sum), float(want_sum),
                               rtol=LOSS_RTOL)
    # the chunked sum is the full log_softmax's
    logp = torch.log_softmax(torch.from_numpy(feats) @ tp["tok_embed"].T,
                             dim=-1)
    full = -logp.gather(1, torch.from_numpy(targets).long()[:, None])[:, 0]
    keep = torch.from_numpy(targets) != 1
    np.testing.assert_allclose(float(got_sum), float(full[keep].sum()),
                               rtol=LOSS_RTOL)
    assert -(-pcfg.vocab_size // pcfg.loss_vocab_chunk) == 3


@pytest.mark.parametrize("kv_heads", [2, None], ids=["gqa", "mha"])
def test_loss_and_every_gradient_equal_jax(kv_heads):
    jcfg, pcfg = configs(num_kv_heads=kv_heads, **TRAIN)
    params = J.init_llm_decoder(jax.random.PRNGKey(7), jcfg)
    batch = train_batch(seed=8)
    jl, jaux, jg = jax_loss_and_grads(jcfg, params, batch)
    pl, paux, pg = port_loss_and_grads(pcfg, params, batch)
    assert int(paux["sample_size"]) == int(jaux["sample_size"]) == 18
    assert "moe_aux" not in paux
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert len(pg) == len(jg)
    errs = [rel_l2(g, j) for g, j in zip(pg, jg)]
    assert max(errs) <= GRAD_REL_L2, (int(np.argmax(errs)), max(errs))


def test_dropout_is_a_pure_function_of_seed_and_step():
    jcfg, pcfg = configs(**TRAIN)
    drop = dataclasses.replace(pcfg, dropout=0.3, attention_dropout=0.2)
    params = J.init_llm_decoder(jax.random.PRNGKey(9), jcfg)
    batch = train_batch(seed=10)
    det, _, _ = port_loss_and_grads(pcfg, params, batch)
    a, _, ga = port_loss_and_grads(drop, params, batch,
                                   step_generator(0, 5, "cpu"), False)
    b, _, gb = port_loss_and_grads(drop, params, batch,
                                   step_generator(0, 5, "cpu"), False)
    c, _, _ = port_loss_and_grads(drop, params, batch,
                                  step_generator(0, 6, "cpu"), False)
    assert a == b and all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert a != c and a != det
    off, _, _ = port_loss_and_grads(pcfg, params, batch,
                                    step_generator(0, 5, "cpu"), False)
    np.testing.assert_allclose(off, det, rtol=1e-6)
