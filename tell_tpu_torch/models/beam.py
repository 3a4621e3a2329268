"""Batched fixed-shape beam search (counterpart of tell_tpu/models/beam.py,
in its default mode: fused reorder and parent-pointer backtracking).

* Context K/V are per batch element and shared by its beams; only the
  per-row conv windows follow the beams, and the previous step's parent
  permutation is applied while the step reads them (fused reorder).
* A finished beam keeps a single <pad> continuation at log-prob 0, so the
  search stays fixed-shape and a finished hypothesis keeps its score.
* Step 0 starts from scores [0, -1e9, ...] so identical beams don't
  duplicate.
* The loop records only (parent, token) per step; paths are rebuilt once
  at the end by walking the ancestry backwards, best beam first.
* jax.lax.top_k breaks ties toward the lower index and jnp.argsort is
  stable; the port uses a stable descending sort for both, so tied
  candidates (the -1e9 start, finished beams) resolve as in JAX.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config import CaptionerConfig
from ..ops.common import top_k
from .captioner import _decode_setup
from .decoder import decode_levers, decoder_step, decoder_top_k


def beam_select(scores, finished, lengths, cand_lp, cand_ids, fin_lp,
                pad_id: int, eos_id: int, frozen=None):
    """One beam step's selection over [B, K] beams: each beam's K
    candidates (cand_lp, cand_ids [B*K, K]) extend its score, a frozen beam
    (default: a finished one) keeps a single <pad> at fin_lp (0, then
    -inf), and the K best of the K*K totals survive. Returns (scores,
    parent, tokens, finished, lengths), each [B, K]; tokens is <pad> under
    a frozen parent, finished is the parent's flag or an <eos> token, and
    lengths counts the tokens emitted before freezing."""
    B, K = scores.shape
    if frozen is None:
        frozen = finished
    cand_lp = torch.where(frozen[:, :, None], fin_lp,
                          cand_lp.reshape(B, K, K))
    cand_ids = torch.where(frozen[:, :, None], pad_id,
                           cand_ids.reshape(B, K, K))
    total = scores[:, :, None] + cand_lp                          # [B,K,K]
    scores, top_flat = top_k(total.reshape(B, K * K), K)
    parent = top_flat // K                                        # [B, K]
    tok = torch.gather(cand_ids.reshape(B, K * K), 1, top_flat)
    was_frozen = torch.gather(frozen, 1, parent)
    finished = torch.gather(finished, 1, parent) | (tok == eos_id)
    lengths = torch.gather(lengths, 1, parent) + (~was_frozen).long()
    return (scores, parent, torch.where(was_frozen, pad_id, tok), finished,
            lengths)


def length_normalised(scores, lengths, length_penalty: float):
    """Scores ranked under the length penalty ((5 + length) / 6) ** lp
    (none at lp <= 0). Torch tensors or numpy arrays; lengths as floats of
    the scores' dtype."""
    if length_penalty <= 0:
        return scores
    return scores / ((5.0 + lengths) / 6.0) ** length_penalty


def beam_search_core(step_fn: Callable, state0, B: int, K: int,
                     gen_len: int, bos_id: int, eos_id: int, pad_id: int,
                     device: torch.device, length_penalty: float = 0.0,
                     early_stop: bool = True,
                     finished0: torch.Tensor | None = None) -> dict:
    """Model-agnostic fixed-shape beam search.

    step_fn(tokens [B*K], state, row_gather [B*K]) -> (cand_lp [B*K, K]
    per-beam top-K next-token log-probs, cand_ids [B*K, K], new_state),
    applying row_gather (the previous step's flat parents) to its per-row
    state as it reads it.

    Returns {"token_ids": [B, K, gen_len+1] best-first, "scores": [B, K]
    (length-normalised when length_penalty > 0), "finished": [B, K]}.
    early_stop ends the loop once every beam of every row has finished;
    finished0 [B] marks rows (serving filler) finished from step 0."""
    tokens = torch.full((B, K), bos_id, dtype=torch.long, device=device)
    scores = torch.tensor([0.0] + [-1e9] * (K - 1),
                          device=device).repeat(B, 1)
    if finished0 is None:
        finished = torch.zeros(B, K, dtype=torch.bool, device=device)
    else:
        finished = finished0[:, None].expand(B, K).clone()
    lengths = torch.zeros(B, K, dtype=torch.long, device=device)
    # steps never run (early exit) backtrack as identity + <pad>
    parents_buf = torch.arange(K, device=device).expand(gen_len, B, K
                                                        ).clone()
    toks_buf = torch.full((gen_len, B, K), pad_id, dtype=torch.long,
                          device=device)
    fin_lp = torch.full((K,), float("-inf"), device=device)
    fin_lp[0] = 0.0
    row_base = torch.arange(B, device=device)[:, None] * K
    prev_parent = torch.arange(B * K, device=device)
    state = state0
    for t in range(gen_len):
        if early_stop and bool(finished.all()):
            break
        cand_lp, cand_ids, state = step_fn(tokens.reshape(B * K), state,
                                           prev_parent)
        scores, parent, tokens, finished, lengths = beam_select(
            scores, finished, lengths, cand_lp, cand_ids, fin_lp, pad_id,
            eos_id)
        parents_buf[t] = parent
        toks_buf[t] = tokens
        prev_parent = (parent + row_base).reshape(B * K)

    ranked = length_normalised(scores, lengths.float(), length_penalty)
    order = torch.argsort(-ranked, dim=1, stable=True)
    # backtrack: seeding the ancestry walk with `order` rebuilds the paths
    # best-first
    idx = order
    toks_fwd = [None] * gen_len
    for t in reversed(range(gen_len)):
        toks_fwd[t] = torch.gather(toks_buf[t], 1, idx)
        idx = torch.gather(parents_buf[t], 1, idx)
    seed = torch.full((B, K, 1), bos_id, dtype=torch.long, device=device)
    return {
        "token_ids": torch.cat([seed, torch.stack(toks_fwd, dim=2)], dim=2),
        "scores": torch.gather(ranked, 1, order),
        "finished": torch.gather(finished, 1, order),
    }


def beam_search(params: dict, cfg: CaptionerConfig, batch: dict,
                beam_size: int = 5, length_penalty: float = 0.0,
                early_stop: bool = True, kv_cache: str = "fp",
                fused_topk: bool = False, dec8: bool = False,
                dec8_sm: bool = False, merged_vocab: bool = False) -> dict:
    """Flagship-captioner beam decode (see beam_search_core). A `row_live`
    bool vector in the batch marks filler rows as finished from step 0.
    kv_cache, fused_topk, dec8, dec8_sm and merged_vocab are the decode
    numerics levers (see captioner.generate), their tables built once."""
    dcfg = cfg.decoder
    K = beam_size
    B, device, state, _ = _decode_setup(params, cfg, batch, beam=K,
                                        kv_cache=kv_cache)
    lev = decode_levers(params["decoder"], dcfg, dec8, dec8_sm, merged_vocab)

    def step_fn(tokens, dyn, row_gather):
        feats, new_state = decoder_step(params["decoder"], dcfg, tokens, dyn,
                                        row_gather=row_gather,
                                        quant=lev["step_quant"])
        cand_lp, cand_ids = decoder_top_k(params["decoder"], dcfg, feats, K,
                                          fused_topk, lev["vocab_table"],
                                          lev["quant_sm"])
        return cand_lp, cand_ids, new_state

    finished0 = ~batch["row_live"] if "row_live" in batch else None
    return beam_search_core(step_fn, state, B, K, cfg.gen_len, dcfg.bos_id,
                            dcfg.eos_id, dcfg.pad_id, device,
                            length_penalty, early_stop, finished0)
