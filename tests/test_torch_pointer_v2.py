"""pointer_loss v2 (transformer_pointer_2, expts a2 and a3: the
reduced-vocabulary cross entropy, its normaliser from _count_unique and
the distinct proper tokens per row) against tell_tpu's on the CPU, held
as tests/test_torch_pointer_loss.py holds v1; and pointer_generate
sampled among the top 3 at tests/test_torch_pointer.py's configuration.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu_torch.models import pointer as P
from tests.test_torch_pointer import (B, TOL, _generate_pair, _jb, _tb,
                                      configs)
from tests.test_torch_pointer_loss import KINDS, check_loss_and_gradients

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("weigh_bert", [True, False])
def test_pointer_loss_v2_and_gradients_equal_jax(weigh_bert, kind):
    check_loss_and_gradients(2, weigh_bert, kind)


def test_pointer_generate_sampled_within_jax_top_k():
    """sampling_topk 3: each generated (not copied) id lies within
    tell_tpu's exact top 3 at its step along the port's own prefix, its
    log-prob within 1e-5 of tell_tpu's there; the copy steps hold the
    greedy rule (a proper context token, each at most once a row)."""
    from tell_tpu.models.captioner import build_contexts
    from tell_tpu.models.decoder import decoder_forward, decoder_log_probs
    jcfg, pcfg = configs(1, sampling_topk=3, sampling_temp=1.0)
    jp, tp, batch = _generate_pair(pcfg, jcfg, 1)
    with torch.inference_mode():
        got = P.pointer_generate(tp, pcfg, _tb(batch),
                                 gen=torch.Generator().manual_seed(5))
    ids = got["token_ids"].numpy()
    cap = jp["captioner"]
    dcfg = jcfg.captioner.decoder

    @jax.jit
    def log_probs(cap, ids, batch):
        feats, _ = decoder_forward(cap["decoder"], dcfg, ids,
                                   build_contexts(cap, jcfg.captioner,
                                                  batch))
        return decoder_log_probs(cap["decoder"], dcfg, feats)

    lp = np.asarray(log_probs(cap, jnp.asarray(ids[:, :-1]), _jb(batch)))
    copies = got["should_copy"].numpy()
    live = ids[:, 1:] != dcfg.pad_id
    n = 0
    for b in range(B):
        for t in range(jcfg.captioner.gen_len):
            if copies[b, t] or not live[b, t]:
                continue
            top = np.argsort(-lp[b, t], kind="stable")[:3]
            assert ids[b, t + 1] in top
            np.testing.assert_allclose(float(got["log_probs"][b, t]),
                                       lp[b, t, ids[b, t + 1]], **TOL)
            n += 1
    assert n > 0
    for b in range(B):
        proper = batch["context_ids"][b][batch["proper_masks"][b] >= 1]
        emitted = ids[b, 1:][copies[b]]
        assert set(emitted) <= set(proper.tolist())
        assert len(set(emitted)) == len(emitted)
