"""Continuous-batching beam-decode engine (counterpart of tell_tpu/serving/
engine.py's DecodeEngine, for the flagship captioner on one device).

The engine keeps ONE resident fixed-shape beam-search state with `slots`
request slots; requests join and leave at chunk boundaries:

* admissions coalesce: up to `admit_batch` queued requests are encoded
  into context K/V in one pass (padded to a power-of-two ladder by
  duplicating the last request: same slot id, same rows, so the order of
  the duplicate writes does not matter) and written into their slot rows
  in place with index_copy_ (what JAX's buffer donation gives it);
* a chunk advances every slot by `chunk_steps` beam-search steps: the
  selection of models/beam.py (beam_select, shared with the one-shot
  search) with a per-slot step counter `t` feeding per-row positions;
* a finished slot freezes (its only candidate is a zero-cost <pad>, and
  `t` stops at gen_len), so it is inert: the chunk runs all its steps
  rather than reading "all done" on the host each step (JAX's while_loop
  exits early; the results are the same), and "done" is read only from
  the harvest report;
* harvest is pipelined: each chunk packs its bookkeeping into two report
  tensors whose device-to-host copies go to pinned memory with
  non_blocking=True behind a recorded CUDA event; the host reads a report
  once its event has completed, up to `max_lag` chunks later. A per-slot
  admission generation keeps a report that predates a slot's re-admission
  from resolving the new request.

The model enters through tell_tpu's hooks: _zero_batch, _model_init,
_encode_kv, _dyn_reset, _model_step and _dyn_reorder. DecodeEngine fills
them for the flagship (the per-row state is the conv windows);
LLMDecodeEngine for the modern family (the per-row state is the
self-attention K/V caches, and the per-slot step counters are the RoPE
positions and the rows' cache write positions).

Over a list of N devices (tell_tpu's slot-sharded mesh) the S slots lie
in N contiguous shards of S/N: slot i on device i // (S/N). Each shard is
an engine of S/N slots on its device, with the params copied there; the
host loop (one queue, one free list, the admission generations, the
reports) is this engine's and speaks of global slots. An admission
writes each request into its slot's shard, a chunk runs on every shard
that holds a live slot, and the report concatenates the shards' in slot
order. Each shard's work runs with its device current (its launches,
report copy and event on that device's stream). A shard's rows never
meet another's, as in tell_tpu, whose chunk's only cross-device traffic
is the all-done reduction. One host thread drives the shards in turn:
their launches queue without waiting, so the cards run side by side,
but the host's launch time adds up over the shards (PERF.md).

A slot's caption never depends on which other requests share the engine:
tests/test_torch_engine.py and tests/test_torch_modern_serving.py hold
every schedule to the port's one-shot beam searches. The flagship's int8
and merged-table decode levers (dec8, dec8_sm, merged_vocab: tell_tpu's
TELL_TPU_DEC8, _DEC8_SM and _MERGED_VOCAB) are built once, in the step's
constants (the aux), on one device and in every shard, as tell_tpu
closes over them in every chunk.
"""
from __future__ import annotations

import collections
import contextlib
import queue as _queue
import threading
from concurrent.futures import Future

import numpy as np
import torch

from ..bridge import to_torch
from ..models.beam import beam_select, length_normalised
from ..models.captioner import build_contexts
from ..models.decoder import (decode_levers, decoder_step, decoder_top_k,
                              init_decode_state, precompute_context_kv_cat)
from ..models.llm_decoder import (_build_contexts, init_llm_decode_state,
                                  llm_decoder_step, tied_top_k)

# K/V-cache leaves that carry no slot axis: admissions leave them alone.
# Classified by name, not by shape (a [S] leaf could equal the slot count).
_SHARED_KV = frozenset(("seg", "wq", "bq", "wo", "bo", "ln_s", "ln_b"))


def _on(device: torch.device):
    """The context that makes `device` the current CUDA device, so that
    the work launched inside, and the streams and events it names, are
    that device's (nothing for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _to_host(t: torch.Tensor) -> tuple[torch.Tensor, object]:
    """Start t's copy to the host: (host tensor, CUDA event or None). On
    CUDA the copy goes to pinned memory without blocking, on t's device's
    current stream, and the event is recorded on that stream after it; the
    copy is ordered before any later in-place write to t."""
    if t.device.type != "cuda":
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    stream = torch.cuda.current_stream(t.device)
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(stream)
    return host, event


def _ready(event) -> bool:
    if isinstance(event, list):
        return all(_ready(e) for e in event)
    return event is None or event.query()


def _wait(event) -> None:
    for e in event if isinstance(event, list) else [event]:
        if e is not None:
            e.synchronize()


def _host_array(report) -> np.ndarray:
    """A report's host tensor, or a sharded engine's list of them in
    slot order, as one array."""
    if isinstance(report, list):
        return np.concatenate([r.numpy() for r in report])
    return report.numpy()


class DecodeEngine:
    """Slot-based continuous beam decode for the flagship captioner.

    params: the captioner's param tree, its tensors on `device`; cfg: a
    CaptionerConfig. Feature batches (image_grid, article or
    article_hiddens, article_mask, face_embeds, obj_embeds; leading dim 1;
    numpy or torch) go in through `submit`; a Future resolving to
    {"token_ids": [beam, gen_len+1], "scores": [beam], "finished": [beam]}
    (numpy, best first) comes back: beam_search's result minus the batch
    dim. kv_cache ("fp", "int8", "int4"), fused_topk, dec8, dec8_sm and
    merged_vocab are the decode numerics levers of models/decoder.py. The
    state is fp32, as the flagship serves. device: one device, or a list
    of N over which the slots shard (S/N a device; the params are copied
    to each)."""

    def __init__(self, params: dict, cfg, device, *, slots: int = 8,
                 beam: int = 5, chunk_steps: int = 8,
                 length_penalty: float = 0.0, max_lag: int = 8,
                 admit_batch: int = 16, kv_cache: str = "fp",
                 fused_topk: bool = False, dec8: bool = False,
                 dec8_sm: bool = False, merged_vocab: bool = False,
                 _shard: bool = False):
        if slots < 2 and not _shard:
            raise ValueError("a 1-slot engine is just beam_search")
        self.levers = {"dec8": dec8, "dec8_sm": dec8_sm,
                       "merged_vocab": merged_vocab}
        devices = (list(device) if isinstance(device, (list, tuple))
                   else [device])
        if slots % len(devices):
            raise ValueError(f"engine slots {slots} must divide over the "
                             f"mesh data axis {len(devices)}")
        self._shards, self._last = None, None
        if len(devices) > 1:
            per = slots // len(devices)
            self._shards = []
            for d in map(torch.device, devices):
                with _on(d):
                    self._shards.append(type(self)(
                        to_torch(params, d), cfg, d, slots=per, beam=beam,
                        chunk_steps=chunk_steps,
                        length_penalty=length_penalty, max_lag=max_lag,
                        admit_batch=admit_batch, kv_cache=kv_cache,
                        fused_topk=fused_topk, **self.levers, _shard=True))
        device = devices[0]
        dcfg = self._decode_cfg(cfg)
        if cfg.gen_len > dcfg.max_target_positions:
            raise ValueError(f"gen_len {cfg.gen_len} exceeds "
                             f"max_target_positions "
                             f"{dcfg.max_target_positions}")
        self.cfg, self.dcfg = cfg, dcfg
        self.device = torch.device(device)
        self.params = params
        self.slots, self.beam = slots, beam
        self.chunk_steps = chunk_steps
        self.length_penalty = length_penalty
        self.kv_cache, self.fused_topk = kv_cache, fused_topk
        if self._shards is None:
            self._init_state()
        # admission bursts coalesce up to this many requests (floored to a
        # power of two, so burst padding and warm() meet the same sizes)
        cap = max(1, min(slots, admit_batch))
        self._admit_cap = 1 << (cap.bit_length() - 1)

        self.max_lag = max_lag
        self.free: list[int] = list(range(slots))
        self.pending: dict[int, Future] = {}
        self.queue: "_queue.Queue[tuple[dict, Future]]" = _queue.Queue()
        self.stats = {"requests": 0, "chunks": 0}
        self._poisoned: BaseException | None = None
        self._lock = threading.Lock()
        # submit() must not wait behind tick(); poison() takes both locks
        # (_lock first), so a put can never land after poison() drained
        self._submit_lock = threading.Lock()
        # per-slot admission generation + in-flight reports, oldest first:
        # (report_i, report_f, event, gen-at-chunk-time)
        self._gen = np.zeros(slots, np.int64)
        self._reports: collections.deque = collections.deque()

    def _init_state(self) -> None:
        """The resident state of every slot, on the device."""
        dcfg = self.dcfg
        B, K, L = self.slots, self.beam, self.cfg.gen_len
        with torch.inference_mode():
            # slots start empty: zero contexts, every slot finished
            self._aux, kv, dyn = self._model_init()
            dev = self.device
            self.state = {
                "kv": kv, **dyn,
                "t": torch.full((B,), L, dtype=torch.long, device=dev),
                "tokens": torch.full((B, K), dcfg.bos_id, dtype=torch.long,
                                     device=dev),
                "scores": torch.zeros(B, K, device=dev),
                "finished": torch.ones(B, K, dtype=torch.bool, device=dev),
                "lengths": torch.zeros(B, K, dtype=torch.long, device=dev),
                "paths": torch.full((B, K, L + 1), dcfg.pad_id,
                                    dtype=torch.long, device=dev),
            }
            self._scores0 = torch.tensor([0.0] + [-1e9] * (K - 1),
                                         device=dev)
            self._paths0 = torch.full((K, L + 1), dcfg.pad_id,
                                      dtype=torch.long, device=dev)
            self._paths0[:, 0] = dcfg.bos_id
            self._fin_lp = torch.full((K,), float("-inf"), device=dev)
            self._fin_lp[0] = 0.0
            self._row_base = torch.arange(B, device=dev)[:, None] * K
            self._positions = torch.arange(L + 1, device=dev)

    # ------------------------------------------------------------------
    # model hooks (the flagship captioner; LLMDecodeEngine overrides)
    # ------------------------------------------------------------------

    def _decode_cfg(self, cfg):
        """The config that carries the vocabulary ids and the contexts."""
        return cfg.decoder

    def _model_init(self) -> tuple[dict, list, dict]:
        """(constants of the step, the zero-context K/V, the per-row
        dynamic state) for every slot."""
        contexts0 = build_contexts(self.params, self.cfg, self._zero_batch())
        dstate = init_decode_state(self.params["decoder"], self.dcfg,
                                   contexts0, self.slots, beam=self.beam,
                                   kv_cache=self.kv_cache)
        aux = {"embed_table": dstate["embed_table"],
               **decode_levers(self.params["decoder"], self.dcfg,
                               **self.levers)}
        return aux, dstate["kv"], {"conv": dstate["conv"]}

    def _encode_kv(self, batchN: dict) -> list:
        """N requests' features (leading dim N) -> their context K/V."""
        contexts = build_contexts(self.params, self.cfg, batchN)
        return precompute_context_kv_cat(self.params["decoder"], self.dcfg,
                                         contexts, beam=self.beam,
                                         kv_cache=self.kv_cache)

    def _dyn_reset(self, bs: torch.Tensor) -> None:
        """Zero slots bs's rows of the per-row state, in place."""
        for buf in self.state["conv"]:
            buf.view(self.slots, self.beam, *buf.shape[1:]).index_fill_(
                0, bs, 0)

    def _model_step(self, step_rows: torch.Tensor) -> tuple:
        """One decode step over every row at positions step_rows [B*K] ->
        (candidate log-probs [B*K, K], ids [B*K, K], new dynamic state)."""
        st, K = self.state, self.beam
        dyn = {"kv": st["kv"], "conv": st["conv"],
               "embed_table": self._aux["embed_table"], "step": step_rows}
        aux = self._aux
        feats, dstate = decoder_step(self.params["decoder"], self.dcfg,
                                     st["tokens"].reshape(-1), dyn,
                                     quant=aux["step_quant"])
        cand_lp, cand_ids = decoder_top_k(self.params["decoder"], self.dcfg,
                                          feats, K, self.fused_topk,
                                          aux["vocab_table"], aux["quant_sm"])
        return cand_lp, cand_ids, {"conv": dstate["conv"]}

    def _dyn_reorder(self, dyn: dict, flat: torch.Tensor) -> dict:
        """The per-row state under the flat beam parents [B*K] (each within
        its slot)."""
        return {"conv": [buf[flat] for buf in dyn["conv"]]}

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------

    def _zero_batch(self) -> dict:
        """Empty contexts for every slot (articles all padding); the
        article enters as mixed features, which build_contexts takes."""
        B, dev = self.slots, self.device
        batch = {}
        for spec in self.dcfg.contexts:
            z = torch.zeros(B, spec.max_len, spec.kv_dim, device=dev)
            if spec.name == "image":
                batch["image_grid"] = z
            elif spec.name == "article":
                batch["article"] = z
                batch["article_mask"] = torch.ones(B, spec.max_len,
                                                   dtype=torch.bool,
                                                   device=dev)
            elif spec.name == "faces":
                batch["face_embeds"] = z
            elif spec.name == "obj":
                batch["obj_embeds"] = z
        return batch

    def _admit(self, batchN: dict, bs: torch.Tensor) -> None:
        """Encode N requests' features into context K/V and write them,
        with fresh beam bookkeeping, into slots `bs` [N], in place (over
        shards: each request into its slot's shard)."""
        if self._shards is not None:
            per = self.slots // len(self._shards)
            for j, shard in enumerate(self._shards):
                rows = (bs // per == j).nonzero()[:, 0]
                if len(rows):
                    with _on(shard.device):
                        shard._admit(
                            {k: v[rows].to(shard.device)
                             for k, v in batchN.items()},
                            (bs[rows] % per).to(shard.device))
            return
        st = self.state
        for full, new in zip(st["kv"], self._encode_kv(batchN)):
            for name, leaf in full.items():
                if name not in _SHARED_KV:
                    leaf.index_copy_(0, bs, new[name].to(leaf.dtype))
        self._dyn_reset(bs)
        N = bs.shape[0]
        st["t"].index_fill_(0, bs, 0)
        st["tokens"].index_fill_(0, bs, self.dcfg.bos_id)
        st["scores"].index_copy_(0, bs, self._scores0.repeat(N, 1))
        st["finished"].index_fill_(0, bs, False)
        st["lengths"].index_fill_(0, bs, 0)
        st["paths"].index_copy_(0, bs, self._paths0.repeat(N, 1, 1))

    def _step(self) -> None:
        """One beam step over all slots: models/beam.py's beam_select with a
        per-slot step counter. No host synchronisation (but the MoE's one a
        layer, ops/moe.py)."""
        dcfg, st = self.dcfg, self.state
        B, K, L = self.slots, self.beam, self.cfg.gen_len
        t, finished = st["t"], st["finished"]
        # a slot at the length cap freezes exactly like a finished beam
        eff_finished = finished | (t >= L)[:, None]
        cand_lp, cand_ids, dyn = self._model_step(t.repeat_interleave(K))
        top_scores, parent, tok, new_finished, new_lengths = beam_select(
            st["scores"], finished, st["lengths"], cand_lp, cand_ids,
            self._fin_lp, dcfg.pad_id, dcfg.eos_id, frozen=eff_finished)
        # write at per-slot position t+1 (past the cap nothing matches)
        write = self._positions[None, None, :] == (t + 1)[:, None, None]
        paths = torch.gather(st["paths"], 1,
                             parent[:, :, None].expand(-1, -1, L + 1))
        flat = (parent + self._row_base).reshape(B * K)
        st.update({
            **self._dyn_reorder(dyn, flat),
            "t": torch.clamp(t + 1, max=L), "tokens": tok,
            "scores": top_scores, "finished": new_finished,
            "lengths": new_lengths,
            "paths": torch.where(write, tok[:, :, None], paths),
        })

    def _chunk(self) -> tuple:
        """chunk_steps steps, then the packed report, copied to the host
        asynchronously: (report_i, report_f, event). Over shards, each
        shard that holds a live slot runs its chunk; the others' rows of
        the report (no pending slot reads them) are their last ones, and
        the three are lists in shard order."""
        if self._shards is not None:
            per = self.slots // len(self._shards)
            live = {b // per for b in self.pending}
            parts = []
            for j, shard in enumerate(self._shards):
                if j in live or shard._last is None:
                    with _on(shard.device):
                        shard._last = shard._chunk()
                parts.append(shard._last)
            return tuple(list(x) for x in zip(*parts))
        for _ in range(self.chunk_steps):
            self._step()
        st, B = self.state, self.slots
        report_i = torch.cat(
            [st["t"][:, None], st["finished"].long(), st["lengths"],
             st["paths"].reshape(B, -1)], dim=1)
        host_i, _ = _to_host(report_i)
        host_f, event = _to_host(st["scores"])
        return host_i, host_f, event

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------

    def warm(self, batch1: dict) -> None:
        """Drive every admission-ladder size + a chunk through the
        production path (submit that many copies of batch1 in one burst,
        drain), so first launches, allocator growth and cuBLAS handles
        happen before traffic. Must be called before serving."""
        if self.pending or not self.queue.empty():
            raise RuntimeError("warm() must run before traffic")
        rung = 1
        while True:
            futs = [self.submit(batch1) for _ in range(rung)]
            self.run_until_drained()
            for f in futs:
                f.result(timeout=900)
            if rung >= self._admit_cap:
                break
            rung = min(rung * 2, self._admit_cap)

    def submit(self, batch1: dict) -> Future:
        """batch1: feature dict with leading dim 1 (one request)."""
        fut: Future = Future()
        with self._submit_lock:
            if self._poisoned is not None:
                fut.set_exception(self._poisoned)
                return fut
            self.queue.put((batch1, fut))
            self.stats["requests"] += 1
        return fut

    def poison(self, exc: BaseException) -> None:
        """Fail every pending and queued request now (the tick loop died),
        and every later submit."""
        with self._lock, self._submit_lock:
            self._poisoned = exc
            for fut in self.pending.values():
                if not fut.done():
                    fut.set_exception(exc)
            self.pending.clear()
            while not self.queue.empty():
                try:
                    _, fut = self.queue.get_nowait()
                except _queue.Empty:
                    break
                if not fut.done():
                    fut.set_exception(exc)

    def _admit_queued(self) -> None:
        while self.free and not self.queue.empty():
            grabbed = []          # (slot, batch1, fut)
            while self.free and len(grabbed) < self._admit_cap:
                try:
                    batch1, fut = self.queue.get_nowait()
                except _queue.Empty:
                    break
                grabbed.append((self.free.pop(), batch1, fut))
            if not grabbed:
                return
            n = len(grabbed)
            padded = 1
            while padded < n:
                padded *= 2
            bs = [b for b, _, _ in grabbed]
            reqs = [r for _, r, _ in grabbed]
            if padded > n:   # pad to the ladder by duplicating the last
                bs += [bs[-1]] * (padded - n)
                reqs += [reqs[-1]] * (padded - n)
            batchN = {k: torch.cat([torch.as_tensor(r[k]).to(self.device)
                                    for r in reqs])
                      for k in reqs[0]}
            # pending first: if the admission raises, poison() fails these
            for b, _, fut in grabbed:
                self._gen[b] += 1
                self.pending[b] = fut
            self._admit(batchN, torch.tensor(bs, device=self.device))

    def _harvest_report(self, report_i, report_f, gen) -> None:
        """Resolve futures from one report that reached the host. `gen`:
        the slots' admission generations at the report's chunk; a slot
        re-admitted since is skipped."""
        K, L = self.beam, self.cfg.gen_len
        ri = _host_array(report_i)
        scores_all = _host_array(report_f).astype(np.float32)
        t = ri[:, 0]
        fin = ri[:, 1:1 + K].astype(bool)
        lengths_all = ri[:, 1 + K:1 + 2 * K]
        paths_all = ri[:, 1 + 2 * K:].reshape(self.slots, K, L + 1)
        done = fin.all(axis=1) | (t >= L)
        for b in [b for b in self.pending
                  if done[b] and gen[b] == self._gen[b]]:
            fut = self.pending.pop(b)
            ranked = length_normalised(
                scores_all[b], lengths_all[b].astype(np.float32),
                self.length_penalty)
            order = np.argsort(-ranked, kind="stable")
            fut.set_result({"token_ids": paths_all[b][order],
                            "scores": ranked[order],
                            "finished": fin[b][order]})
            self.free.append(b)

    def _drain_reports(self, block_first: bool = False) -> None:
        """Harvest every report that reached the host; block_first waits
        for the oldest (bounds the pipeline, flushes at drain time)."""
        while self._reports:
            report_i, report_f, event, gen = self._reports[0]
            if not block_first and not _ready(event):
                return
            _wait(event)
            self._reports.popleft()
            self._harvest_report(report_i, report_f, gen)
            block_first = False

    def tick(self) -> bool:
        """Harvest arrived reports -> admit -> chunk (async report copy).
        Returns True while any slot, report or queued request is in
        flight."""
        with self._lock, torch.inference_mode():
            self._drain_reports()
            if not self.pending:
                # every future is resolved; reports in flight settle nothing
                self._reports.clear()
            self._admit_queued()
            if self.pending:
                self._reports.append((*self._chunk(), self._gen.copy()))
                self.stats["chunks"] += 1
                if len(self._reports) > self.max_lag:
                    self._drain_reports(block_first=True)
                    # the blocking drain may have freed slots: refill them
                    self._admit_queued()
            # queued requests are in-flight work too: the backpressure
            # drain can settle every report while the queue still holds
            # requests
            return (bool(self.pending) or bool(self._reports)
                    or not self.queue.empty())

    def run_until_drained(self) -> None:
        """Tick until the queue, the slots and the reports are empty."""
        while not self.queue.empty() or self.pending or self._reports:
            if not self.tick():
                break


class LLMDecodeEngine(DecodeEngine):
    """The engine for the modern family (models/llm_decoder.py;
    tell_tpu/serving/engine.py's LLMDecodeEngine): the same slot and beam
    bookkeeping, with the self-attention K/V caches [B*K, gen_len + 1, KV,
    hd] as the per-row state and the per-slot step counters as the RoPE
    positions and the rows' cache write positions (the step's per-row
    path). params: the LM's tree on `device`; cfg: an LLMConfig; requests
    carry image_grid, article, article_mask, face_embeds and obj_embeds
    (leading dim 1). kv_cache is the contexts' K/V numerics lever; the
    tied head has no fused top-k and the modern family none of the int8
    decode levers (the adapter's check_levers refuses them for the
    service), so the step never reads fused_topk, and the levers raise
    here."""

    def _decode_cfg(self, cfg):
        return cfg

    def _model_init(self) -> tuple[dict, list, dict]:
        on = [k for k, v in self.levers.items() if v]
        if on:
            raise ValueError(f"{on}: the modern family's decode has none of "
                             "the flagship's int8 and merged-table levers")
        contexts0 = _build_contexts(self.params, self.cfg,
                                    self._zero_batch())
        dstate = init_llm_decode_state(self.params, self.cfg, contexts0,
                                       self.slots, beam=self.beam,
                                       kv_cache=self.kv_cache)
        return {}, dstate["kv"], {"self_kv": dstate["self_kv"]}

    def _encode_kv(self, batchN: dict) -> list:
        contexts = _build_contexts(self.params, self.cfg, batchN)
        return precompute_context_kv_cat(self.params, self.cfg, contexts,
                                         beam=self.beam,
                                         kv_cache=self.kv_cache)

    def _dyn_reset(self, bs: torch.Tensor) -> None:
        for cache in self.state["self_kv"]:
            for buf in cache.values():
                buf.view(self.slots, self.beam, *buf.shape[1:]).index_fill_(
                    0, bs, 0)

    def _model_step(self, step_rows: torch.Tensor) -> tuple:
        st = self.state
        feats, dstate, _ = llm_decoder_step(
            self.params, self.cfg, st["tokens"].reshape(-1),
            {"self_kv": st["self_kv"], "kv": st["kv"], "step": step_rows})
        cand_lp, cand_ids = tied_top_k(self.params, self.cfg, feats,
                                       self.beam)
        return cand_lp, cand_ids, {"self_kv": dstate["self_kv"]}

    def _dyn_reorder(self, dyn: dict, flat: torch.Tensor) -> dict:
        return {"self_kv": [{n: c[n][flat] for n in ("k", "v")}
                            for c in dyn["self_kv"]]}
