"""The LSTM family (tell_tpu_torch.models.lstm_decoder, expts 1 and 3)
against tell_tpu.models.lstm_decoder on the CPU.

small_test_config's decoder (E=64, vocab 500 in bands 50/200/500, 4 LSTM
layers whatever kernel_sizes says) over the flattened contexts (image
9 x 32, article 16 x 24), gen_len 8. tell_tpu's init_lstm_captioner makes
the weights (carried across with bridge.to_torch); the port's
init_lstm_captioner makes the same tree (keys, shapes, dtypes). numpy
seeds make the features and the captions (pads at the end of two rows).
Held, with weigh_bert on (25 hidden layers mixed) and off: the
teacher-forced features within 1e-4, lstm_captioner_loss within 1e-5
relative and every gradient leaf within 1e-4 relative L2; greedy ids
equal, log-probs within 1e-4 and the need_weights maps within 1e-4;
fused top-k (kernel E's plain version here) the same ids. In bf16, the
train step's cast of params and batch on both sides (h and c cast to
bf16 every step): the loss within BF16_RTOL of tell_tpu's bf16 loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu import config as JC
from tell_tpu.models import lstm_decoder as J
from tell_tpu_torch import config as PC
from tell_tpu_torch.bridge import (init_lstm_captioner, to_torch,
                                   tree_leaves, tree_map)
from tell_tpu_torch.models import lstm_decoder as P
from tell_tpu_torch.training.train_step import cast_tree
from tests.test_torch_llm_training import rel_l2

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
# bf16 on both sides: the same casts, the products summed in another
# order and rounded to bf16 at other points (the port's linear rounds its
# product before the bias, tell_tpu's after); at most 7.9e-5 relative
# over four seeds, against 3.9e-3 for one bf16 ulp of a 12-bit loss
BF16_RTOL = 1e-3
FLAT = (("image", 32, 9), ("article", 24, 16))


def configs(weigh_bert: bool, **over):
    """(tell_tpu's CaptionerConfig, the port's) for the LSTM."""
    out = []
    for C in (JC, PC):
        base = C.small_test_config()
        dec = dataclasses.replace(
            base.decoder, contexts=tuple(C.ContextSpec(*c) for c in FLAT))
        out.append(dataclasses.replace(base, decoder=dec,
                                       weigh_bert=weigh_bert,
                                       num_bert_layers=25, gen_len=8,
                                       **over))
    return tuple(out)


def make_batch(cfg, seed=0, B=3, T=10):
    rng = np.random.default_rng(seed)
    d = cfg.decoder
    cap = rng.integers(3, d.vocab_size, size=(B, T)).astype(np.int32)
    cap[:, 0] = d.bos_id
    cap[1, 6], cap[1, 7:] = d.eos_id, d.pad_id
    cap[2, 3], cap[2, 4:] = d.eos_id, d.pad_id
    mask = np.arange(16)[None] >= np.array([16, 11, 5])[:B, None]
    batch = {"caption_ids": cap, "article_mask": mask,
             "image_grid": rng.normal(size=(B, 9, 32)).astype(np.float32)}
    if cfg.weigh_bert:
        batch["article_hiddens"] = rng.normal(
            size=(B, 16, cfg.num_bert_layers, 24)).astype(np.float32)
    else:
        batch["article"] = rng.normal(size=(B, 16, 24)).astype(np.float32)
    return batch


def _params(jcfg, seed):
    return J.init_lstm_captioner(jax.random.PRNGKey(seed), jcfg)


def _tparams(jparams, grad=False):
    tp = to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    return tree_map(lambda t: t.requires_grad_(), tp) if grad else tp


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("weigh_bert", [True, False])
def test_init_makes_tell_tpus_tree(weigh_bert):
    jcfg, pcfg = configs(weigh_bert)
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        _params(jcfg, 0))
    got = tree_map(lambda x: (tuple(x.shape), str(x.dtype)[6:]),
                   init_lstm_captioner(torch.Generator().manual_seed(0),
                                       pcfg))
    assert got == want
    assert len(got["decoder"]["lstm"]["cells"]) == 4
    assert got["decoder"]["layers"] == []


@pytest.mark.parametrize("weigh_bert", [True, False])
def test_forward_loss_and_gradients_equal_jax(weigh_bert):
    jcfg, pcfg = configs(weigh_bert)
    jparams = _params(jcfg, 1)
    batch = make_batch(pcfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # the teacher-forced features
    from tell_tpu.models.captioner import build_contexts as j_contexts
    from tell_tpu_torch.models.captioner import build_contexts
    ids = batch["caption_ids"][:, :-1]
    want = J.lstm_decoder_forward(jparams["decoder"], jcfg.decoder,
                                  jnp.asarray(ids),
                                  j_contexts(jparams, jcfg, jb))
    tp = _tparams(jparams)
    got = P.lstm_decoder_forward(tp["decoder"], pcfg.decoder,
                                 torch.from_numpy(ids),
                                 build_contexts(tp, pcfg, _tb(batch)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the loss and every gradient
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: J.lstm_captioner_loss(p, jcfg, b), has_aux=True))(
            jparams, jb)
    tp = _tparams(jparams, grad=True)
    loss, aux = P.lstm_captioner_loss(tp, pcfg, _tb(batch))
    loss.backward()
    assert int(aux["sample_size"]) == int(jaux["sample_size"]) == 18
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    errs = [rel_l2(t.grad, j) for t, j in zip(tleaves, jleaves)]
    assert max(errs) <= GRAD_REL_L2, (int(np.argmax(errs)), max(errs))


@pytest.mark.parametrize("weigh_bert", [True, False])
def test_greedy_ids_and_maps_equal_jax(weigh_bert):
    jcfg, pcfg = configs(weigh_bert)
    jparams = _params(jcfg, 3)
    batch = make_batch(pcfg, seed=4)
    batch.pop("caption_ids")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, b: J.lstm_generate(p, jcfg, b,
                                                need_weights=True))(
        jparams, jb)
    tp = _tparams(jparams)
    with torch.inference_mode():
        got = P.lstm_generate(tp, pcfg, _tb(batch), need_weights=True)
        plain = P.lstm_generate(tp, pcfg, _tb(batch))
        fused = P.lstm_generate(tp, pcfg, _tb(batch), fused_topk=True)
    np.testing.assert_array_equal(got["token_ids"].numpy(),
                                  np.asarray(want["token_ids"]))
    np.testing.assert_allclose(got["log_probs"].numpy(),
                               np.asarray(want["log_probs"]), **TOL)
    assert set(got["attns"]) == set(want["attns"]) == {"image", "article"}
    for name, a in got["attns"].items():
        assert a.shape == want["attns"][name].shape
        np.testing.assert_allclose(a.numpy(), np.asarray(want["attns"][name]),
                                   **TOL)
    np.testing.assert_array_equal(got["finished"].numpy(),
                                  np.asarray(want["finished"]))
    for out in (plain, fused):
        np.testing.assert_array_equal(out["token_ids"].numpy(),
                                      got["token_ids"].numpy())
    # finished rows emit pads at log-prob 0
    ids, lps = got["token_ids"][:, 1:], got["log_probs"]
    for r in range(ids.shape[0]):
        eos = (ids[r] == pcfg.decoder.eos_id).nonzero()
        if len(eos):
            e = int(eos[0])
            assert bool((ids[r, e + 1:] == pcfg.decoder.pad_id).all())
            assert bool((lps[r, e + 1:] == 0).all())


def test_bf16_loss_within_a_bf16_tolerance_of_jax():
    jcfg, pcfg = configs(False, compute_dtype="bfloat16")
    jparams = _params(jcfg, 5)
    batch = make_batch(pcfg, seed=6)

    def j_bf16(tree):
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                            if x.dtype == jnp.float32 else x, tree)

    jl, _ = jax.jit(lambda p, b: J.lstm_captioner_loss(j_bf16(p), jcfg,
                                                       j_bf16(b)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = cast_tree(_tparams(jparams), "bfloat16")
    loss, _ = P.lstm_captioner_loss(tp, pcfg,
                                    cast_tree(_tb(batch), "bfloat16"))
    fp32, _ = P.lstm_captioner_loss(_tparams(jparams), pcfg, _tb(batch))
    np.testing.assert_allclose(loss.float().item(), float(jl),
                               rtol=BF16_RTOL)
    # the bf16 run is not the fp32 one
    assert loss.float().item() != fp32.item()
