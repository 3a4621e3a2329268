"""HTTP caption service (counterpart of tell_tpu/serving/server.py).

POST /caption takes token ids (`context_ids`) or, when the service was
given a tokenizer, text (`context`) or a scraped article (`sections`,
`title` and `image_position`: the location-aware window around the image,
as tell_tpu builds it), plus optional precomputed image grid, face and
object features; GET /status and /healthz report on the service, GET
/metrics gives /status's counters as Prometheus text, GET / serves the demo
page (demo/index.html of the repository), POST /scrape fetches and sections
an article URL (serving/extractor.py) and POST /shutdown stops the server.
serving/client.py is the client. Two decode modes:

* micro-batch (engine_slots=0): a MicroBatcher packs up to max_batch
  requests at the smallest article bucket that holds them (a quarter, a
  half or all of article_len), pads the batch with filler rows (row_live
  = False), runs the RoBERTa encode and greedy generate, and answers each
  request with its token ids;
* engine (engine_slots > 0): an EncodeBatcher coalesces concurrent
  requests' article encodes (the 25 hidden layers mixed in before
  admission), and a resident continuous-batching DecodeEngine runs beam
  search; with engine_buckets, one engine per article width (128/256/512
  for a 512-token article, 512/1024/2048 for the long-article
  configuration's 2048), each request routed to the smallest that fits.
  The answer is the best beam, its score and the other beams.

kv_cache ("fp", "int8", "int4") and fused_topk are the decode numerics
levers (tell_tpu's TELL_TPU_KV8 / TELL_TPU_KV4 / TELL_TPU_TOPK, off by
default as off the TPU); numerics_ab() measures each one's teacher-forced
agreement with the fp path, and that of the tanh-GELU encode.

need_attention adds the demo's attention payload to each answer: per-step
maps of the first layer per context ("attns") merged into words
(serving/word_attention.py). Micro-batch mode records them in
generate(need_weights=True); engine mode replays the winning caption
teacher-forced (replay_attention), off the engine's hot path.

A request may carry its photo instead of its image grid: `image_b64` (an
encoded JPEG), `image` (an [H, W, 3] list) or, from the scrape flow,
`sections[image_position].image_data` (base64). With a ResNet-152 among the
service's towers, VisionPipeline (serving/vision.py) decodes, crops and
embeds it on the device while the micro-batch is packed; a photo that does
not decode fails its own request only. Face and object rows still come
with the request (their towers are not ported: ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue as _queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..bridge import to_torch
from ..config import CaptionerConfig, with_article_len
from ..data.readers import assemble_location_aware
from ..models.backbones.roberta import RobertaEncoder
from ..models.captioner import (Captioner, encode_contexts,
                                weighted_layer_sum)
from . import extractor
from .batcher import MicroBatcher
from .encode_batcher import EncodeBatcher
from .engine import DecodeEngine
from .vision import VisionPipeline
from .word_attention import merge_word_attentions

log = logging.getLogger("tell_tpu_torch.serving")

DEMO_PAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "demo", "index.html")


class CaptionService:
    """Model worker: raw requests -> captions.

    params: the captioner's param tree (numpy or torch leaves); roberta: a
    RobertaEncoder; device: where the model runs (explicit, no default).
    tokenizer: optional, a RobertaTokenizer (or anything with
    encode(text, max_len=...), decode(ids) and a ByteBPE in .bpe), used
    for requests that carry text or sections, to add a "caption" string to
    the answers, and by need_attention (which needs one) to merge the maps
    into words.

    article_len: the article tokens a request keeps; None takes the
    article context's max_len (512 without an article context), as
    tell_tpu's service does. The engine buckets are a quarter, a half and
    all of it.

    engine_slots > 0 serves through the continuous-batching engine
    (engine_beam beams, engine_length_penalty; engine_buckets: one engine
    per article width); encode_batch caps the rows of one batched article
    encode in front of it. need_attention adds the attention payload to
    every answer. towers: the frozen vision towers ({"resnet": load_tower's
    or prepare_resnet's tree, "resnet_cfg": ResNetConfig}), which give
    raw-image requests their grid."""

    def __init__(self, params: dict, roberta: RobertaEncoder,
                 cfg: CaptionerConfig, device, tokenizer=None,
                 max_batch: int = 8, article_len: int | None = None,
                 engine_slots: int = 0, engine_beam: int = 5,
                 engine_length_penalty: float = 0.0,
                 engine_buckets: bool = False, encode_batch: int = 8,
                 kv_cache: str = "fp",
                 fused_topk: bool = False, need_attention: bool = False,
                 towers: dict | None = None):
        if need_attention and tokenizer is None:
            raise ValueError("need_attention merges the maps into words "
                             "and needs a tokenizer")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = Captioner(to_torch(params, self.device), cfg)
        self.roberta = roberta.to(self.device)
        self.tokenizer = tokenizer
        self.need_attention = need_attention
        self.max_batch = max_batch
        dcfg = cfg.decoder
        if article_len is None:
            article_len = next((c.max_len for c in dcfg.contexts
                                if c.name == "article"), 512)
        self.article_len = article_len
        self.kv_cache, self.fused_topk = kv_cache, fused_topk
        self._article_buckets = tuple(sorted(
            {max(16, article_len // 4), max(16, article_len // 2),
             article_len}))  # 512 -> (128, 256, 512)
        self.ab_report: dict | None = None

        def spec_of(name):
            if any(c.name == name for c in dcfg.contexts):
                c = dcfg.context(name)
                return (c.max_len, c.kv_dim)
            return (0, 0)

        self._spec = {"faces": spec_of("faces"), "obj": spec_of("obj"),
                      "image": spec_of("image")}
        self.vision = VisionPipeline(
            to_torch(towers or {}, self.device),
            wanted={k: n for k, (n, _) in self._spec.items()})
        self.batcher = MicroBatcher(self._run, max_batch=max_batch)
        self._close_lock = threading.Lock()
        self._closed = False
        self.engine = None
        if engine_slots:
            self._start_engines(engine_slots, engine_beam,
                                engine_length_penalty, engine_buckets,
                                encode_batch)

    def _start_engines(self, slots: int, beam: int, length_penalty: float,
                       buckets: bool, encode_batch: int) -> None:
        widths = self._article_buckets if buckets else (self.article_len,)
        params = self.model.tree()
        self.engines = {
            w: DecodeEngine(params, with_article_len(self.cfg, w),
                            self.device, slots=slots, beam=beam,
                            length_penalty=length_penalty,
                            kv_cache=self.kv_cache,
                            fused_topk=self.fused_topk)
            for w in widths}
        self.engine = self.engines[max(widths)]
        self.enc_batchers = {
            w: EncodeBatcher(self._encode_many, self.engines[w].submit,
                             max_batch=max(1, encode_batch))
            for w in widths}
        self._eng_stop = threading.Event()
        self._eng_thread = threading.Thread(target=self._tick_loop,
                                            daemon=True)
        self._eng_thread.start()

    def _tick_loop(self) -> None:
        engines = list(self.engines.values())
        while not self._eng_stop.is_set():
            try:
                live = [e.tick() for e in engines]
            except Exception as e:  # noqa: BLE001 - fail pending requests
                # fast: a dead tick loop must not leave clients hanging
                log.exception("engine tick loop died")
                for eng in engines:
                    eng.poison(e)
                return
            if not any(live):
                time.sleep(0.002)

    def _encode_many(self, batch: dict) -> dict:
        """Numpy payload rows -> features on the device: the RoBERTa
        encode with the hidden layers mixed in (weighted_layer_sum), so only
        [n, S, 1024] article features reach admission."""
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v).to(self.device)
                  for k, v in batch.items()}
            out = encode_contexts(self.roberta.frozen(), self.cfg, tb)
            if "article_hiddens" in out:
                out["article"] = weighted_layer_sum(
                    self.model.tree(), out.pop("article_hiddens"))
            out.pop("context_ids")
        return out

    def _sections_text(self, req: dict) -> str:
        """tell_tpu's location-aware window over scraped sections
        (serving/server.py::_context_text): the title, the first
        paragraph, then paragraphs alternately before and after the image
        at image_position until article_len - 2 BPE tokens."""
        try:
            article = {
                "parsed_section": [
                    {"type": sec.get("type", "paragraph"),
                     "text": sec.get("text", "")}
                    for sec in req["sections"]],
                "headline": {"main": req.get("title", "")},
            }
            pos = int(req.get("image_position", 0))
            paragraphs, _ = assemble_location_aware(
                article, pos, lambda t: len(self.tokenizer.bpe.encode(t)),
                budget=self.article_len - 2)
        except (AttributeError, IndexError, KeyError, TypeError) as e:
            raise ValueError(f"bad sections: {e!r}") from e
        return "\n".join(paragraphs).strip()

    def _request_ids(self, req: dict) -> np.ndarray:
        """The article's token ids: context_ids as given, or the
        tokenizer's ids for context text or for the sections' window;
        truncated to article_len."""
        if "context_ids" in req:
            ids = np.asarray(req["context_ids"]).reshape(-1)
            if ids.size and ids.dtype.kind not in "iu":
                raise ValueError("context_ids must be integers")
            vocab = self.roberta.cfg.vocab_size
            if ids.size and (ids.min() < 0 or ids.max() >= vocab):
                raise ValueError(f"context_ids outside [0, {vocab})")
            return ids[: self.article_len].astype(np.int64)
        if "context" in req or "sections" in req:
            if self.tokenizer is None:
                raise ValueError("text context needs a tokenizer; send "
                                 "context_ids")
            text = (req["context"] if "context" in req
                    else self._sections_text(req))
            return np.asarray(self.tokenizer.encode(
                text, max_len=self.article_len), np.int64)
        return np.zeros(0, np.int64)

    @staticmethod
    def _request_image(req: dict) -> dict:
        """The request with its photo where VisionPipeline looks: the scrape
        flow ships it as sections[image_position].image_data (base64);
        direct requests use image / image_b64. A position past the sections
        means no photo; a section that is not a dict raises, and _pack
        reports a bad request image, as tell_tpu's does."""
        if "image" in req or "image_b64" in req:
            return req
        if "sections" in req:
            try:
                pos = int(req.get("image_position", 0))
                data = req["sections"][pos].get("image_data")
            except (IndexError, TypeError, ValueError):
                data = None
            if data:
                return {**req, "image_b64": data}
        return req

    def _pack(self, requests: list[dict], bucketed: bool = False
              ) -> tuple[dict, list]:
        """Returns (numpy batch, errors): errors[i] is None or a message
        for request i. A malformed request degrades to an empty context of
        its own instead of failing the batch it shares: a photo that does
        not decode or embed keeps only the request's `context` text, as
        tell_tpu's does. The article ids are article_len wide, or with
        `bucketed` the smallest article bucket that holds the longest
        one."""
        B = len(requests)
        errors: list = [None] * B
        prepped = []
        for i, req in enumerate(requests):
            try:
                req = self._request_image(req)
                if "image" in req or "image_b64" in req:
                    req = {**req, **self.vision.process(req)}
            except Exception as e:  # noqa: BLE001 - reported per request
                errors[i] = f"bad request image: {e}"
                req = {"context": req["context"]} if "context" in req else {}
            prepped.append(req)
        requests = prepped
        all_toks = []
        for i, req in enumerate(requests):
            try:
                all_toks.append(self._request_ids(req))
            except ValueError as e:
                errors[i] = errors[i] or f"bad context: {e}"
                all_toks.append(np.zeros(0, np.int64))
        width = self.article_len
        if bucketed:
            longest = max(len(t) for t in all_toks)
            width = next(w for w in self._article_buckets if longest <= w)
        ids = np.full((B, width), self.roberta.cfg.pad_id, np.int64)
        for i, toks in enumerate(all_toks):
            ids[i, : len(toks)] = toks
        batch = {"context_ids": ids}
        n_img, img_dim = self._spec["image"]
        if n_img:
            grids = np.zeros((B, n_img, img_dim), np.float32)
            for i, req in enumerate(requests):
                if "image_grid" in req:
                    try:
                        grids[i] = np.asarray(req["image_grid"], np.float32)
                    except (ValueError, TypeError) as e:
                        errors[i] = f"bad image_grid: {e}"
            batch["image_grid"] = grids
        for name, key in (("faces", "face_embeds"), ("obj", "obj_embeds")):
            n, dim = self._spec[name]
            if n == 0:
                continue
            em = np.full((B, n, dim), np.nan, np.float32)
            for i, req in enumerate(requests):
                try:
                    v = np.asarray(req.get(key, []), np.float32)
                    if v.size:
                        k = min(n, v.shape[0])
                        em[i, :k] = v[:k]
                except (ValueError, TypeError, IndexError) as e:
                    errors[i] = f"bad {key}: {e}"
            batch[key] = em
        return batch, errors

    def _run(self, requests: list[dict]) -> list[dict]:
        n = len(requests)
        # filler rows keep one decode shape; they start finished, so the
        # early exit tracks the real requests only
        padded = requests + [{}] * (self.max_batch - n)
        # the smallest article bucket that holds the micro-batch: pad
        # columns are masked, so the captions are the ones packed at
        # article_len, with fewer RoBERTa windows and decode columns
        batch, errors = self._pack(padded, bucketed=True)
        batch["row_live"] = np.arange(self.max_batch) < n
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v).to(self.device)
                  for k, v in batch.items()}
            enc = encode_contexts(self.roberta.frozen(), self.cfg, tb)
            out = self.model.generate(enc, need_weights=self.need_attention)
            token_ids = out["token_ids"][:n].cpu().numpy()
            if self.need_attention:    # layer 0: {name: [T, B, 1, S']}
                layer0 = {name: a[:, :n, 0].cpu().numpy()
                          for name, a in out["attns"][0].items()}
        results = []
        for i in range(n):
            r = {"token_ids": token_ids[i].tolist()}
            if self.tokenizer is not None:
                r["caption"] = self.tokenizer.decode(token_ids[i])
            if errors[i]:
                r["error"] = errors[i]
            if self.need_attention:
                r.update(self._attention_payload(
                    token_ids[i], {k: a[:, i] for k, a in layer0.items()},
                    batch["context_ids"][i]))
            results.append(r)
        return results

    def _attention_payload(self, token_ids: np.ndarray, maps: dict,
                           context_ids: np.ndarray) -> dict:
        """One answer's "attns" ({context: [T, S'] per-step maps}) and
        their word merge (caption_words, word_attns, article_words). The
        trailing bias/zero columns are derived from the true source
        lengths: each context's capacity, the article's packed width."""
        lens = {c.name: c.max_len for c in self.cfg.decoder.contexts}
        lens["article"] = len(context_ids)
        payload = {"attns": {k: a.tolist() for k, a in maps.items()}}
        payload.update(merge_word_attentions(
            self.tokenizer, token_ids, maps, context_ids=context_ids,
            eos_id=self.cfg.decoder.eos_id, source_lens=lens))
        return payload

    def replay_payload(self, enc: dict, token_ids: np.ndarray,
                       context_ids: np.ndarray) -> dict:
        """The attention payload of a known caption on one request's
        encoded features `enc` (leading dim 1): replay_attention, teacher-
        forced in the service's K/V cache numerics (the engine's path)."""
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(token_ids)[None],
                                  device=self.device)
            feats = {k: torch.as_tensor(v).to(self.device)
                     for k, v in enc.items()}
            maps = self.model.replay_attention(feats, ids, self.kv_cache)[0]
            maps = {k: a[:, 0, 0].cpu().numpy() for k, a in maps.items()}
        return self._attention_payload(np.asarray(token_ids), maps,
                                       context_ids)

    def caption(self, request: dict) -> dict:
        if self.engine is not None:
            return self._caption_continuous(request)
        return self.batcher(request)

    def _caption_continuous(self, request: dict) -> dict:
        """Engine path: this request's encode joins a batched encode, its
        features join the resident engine at the next chunk boundary; the
        answer is the best beam, its score and the other beams."""
        batch, errors = self._pack([request],
                                   bucketed=len(self.engines) > 1)
        if errors[0]:   # don't spend a decode slot on an empty context
            return {"token_ids": [], "score": 0.0, "error": errors[0]}
        width = batch["context_ids"].shape[1]
        eng_fut, enc1 = self.enc_batchers[width](batch)
        out = eng_fut.result(timeout=600)
        result = self._answer(out["token_ids"][0], out["scores"][0])
        result["alternatives"] = [self._answer(t, s) for t, s in
                                  zip(out["token_ids"][1:],
                                      out["scores"][1:])]
        if self.need_attention:
            result.update(self.replay_payload(
                enc1, out["token_ids"][0], batch["context_ids"][0]))
        return result

    def _answer(self, token_ids: np.ndarray, score) -> dict:
        r = {"token_ids": token_ids.tolist(), "score": float(score)}
        if self.tokenizer is not None:
            r["caption"] = self.tokenizer.decode(token_ids)
        return r

    def warmup(self) -> dict:
        """Drive dummy requests through the decode path before traffic, so
        first launches, allocator growth and cuBLAS handles happen then:
        in engine mode every encode ladder size, one request through each
        engine's batcher and every admission size; in micro-batch mode one
        full micro-batch at each article bucket. Returns {"widths",
        "seconds"}."""
        t0 = time.perf_counter()
        dummy = {"context_ids": [0, 2]}
        if self.engine is None:
            for w in self._article_buckets:
                self._run([{"context_ids": [0] + [3] * (w - 2) + [2]}])
            return {"widths": list(self._article_buckets),
                    "seconds": time.perf_counter() - t0}
        for w, batcher in sorted(self.enc_batchers.items()):
            batch, _ = self._pack([dummy])
            batch["context_ids"] = batch["context_ids"][:, :w]
            for size in batcher.warmup_sizes():
                self._encode_many({k: np.repeat(v, size, axis=0)
                                   for k, v in batch.items()})
            eng_fut, enc1 = batcher(batch)
            eng_fut.result(timeout=600)
            self.engines[w].warm(enc1)
        return {"widths": sorted(self.enc_batchers),
                "seconds": time.perf_counter() - t0}

    def numerics_ab(self, requests: list[dict] | None = None) -> dict:
        """The numerics gate: greedy tokens on the fp path (fp K/V cache,
        exact top-k, the erf-GELU encode), then each lever's teacher-forced
        top-1 agreement with them through predict_forced (no greedy
        cascade): the int8 cache (kv8_token_agreement, tell_tpu's gate),
        the int4 cache, the fused top-k, and the tanh-GELU encode
        (fast_gelu_token_agreement: the fp decode over features the
        tower encoded with the tanh GELU). Counted over the live (non-pad)
        target tokens of `requests` (default: one canned request) at full
        article width. The result also lands in /status under
        "numerics_ab"."""
        t0 = time.perf_counter()
        if requests is None:
            requests = [{"context": "the mayor spoke in the city today"}
                        if self.tokenizer is not None else
                        {"context_ids": [0] + list(range(100, 140)) + [2]}]
        batch, errors = self._pack(requests)
        bad = [e for e in errors if e]
        if bad:
            raise ValueError(f"numerics_ab: bad request: {bad[0]}")
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v).to(self.device)
                  for k, v in batch.items()}
            frozen = self.roberta.frozen()
            enc, enc_tanh = (encode_contexts(
                {**frozen, "roberta_cfg": dataclasses.replace(
                    frozen["roberta_cfg"], gelu=gelu)}, self.cfg, tb)
                for gelu in ("erf", "tanh"))
            ref = self.model.generate(enc)["token_ids"]
            target = ref[:, 1:]
            live = target != self.cfg.decoder.pad_id
            if not bool(live.any()):
                live = torch.ones_like(live)
            report = {"kv_cache_mode": self.kv_cache,
                      "topk_mode": self._topk_mode(),
                      "gelu_mode": self.roberta.cfg.gelu,
                      "method": "forced_per_step",
                      "tokens": int(live.sum())}
            for key, lever in (
                    ("kv8_token_agreement", {"kv_cache": "int8"}),
                    ("kv4_token_agreement", {"kv_cache": "int4"}),
                    ("fused_topk_token_agreement", {"fused_topk": True})):
                preds = self.model.predict_forced(enc, ref, **lever)
                report[key] = float((preds == target)[live].float().mean())
            preds = self.model.predict_forced(enc_tanh, ref)
            report["fast_gelu_token_agreement"] = float(
                (preds == target)[live].float().mean())
        report["seconds"] = time.perf_counter() - t0
        self.ab_report = report
        return report

    def _topk_mode(self) -> str:
        return "fused" if self.fused_topk else "exact"

    def status(self) -> dict:
        """The /status payload: counters, configuration, numerics modes,
        the engines' stats and the last numerics_ab report."""
        payload = {
            "statistics": self.batcher.stats,
            "config": {
                "max_batch": self.max_batch,
                "article_len": self.article_len,
                "contexts": [c.name for c in self.cfg.decoder.contexts],
                "gen_len": self.cfg.gen_len,
                "device": str(self.device),
                "need_attention": self.need_attention,
                "kv_cache_mode": self.kv_cache,
                "topk_mode": self._topk_mode(),
                "gelu_mode": self.roberta.cfg.gelu,
            },
        }
        if self.ab_report is not None:
            payload["numerics_ab"] = self.ab_report
        if self.engine is not None:
            eng = self.engine
            payload["engine"] = {**eng.stats, "slots": eng.slots,
                                 "beam": eng.beam,
                                 "free_slots": len(eng.free)}
            if len(self.engines) > 1:
                payload["engine_buckets"] = {
                    str(w): {**e.stats, "free_slots": len(e.free)}
                    for w, e in sorted(self.engines.items())}
        return payload

    def close(self, drain_s: float = 60.0) -> None:
        """Stop the service (idempotent). Engine mode: the encode batchers
        stop first, in-flight requests drain (up to drain_s), then the tick
        loop stops and whatever is left fails. Then the micro-batcher
        stops; its queued requests fail."""
        with self._close_lock:
            if self._closed:
                return
            if self.engine is not None:
                for b in self.enc_batchers.values():
                    b.shutdown()
                engines = list(self.engines.values())
                deadline = time.time() + drain_s
                while time.time() < deadline:
                    busy = False
                    for eng in engines:
                        with eng._lock:
                            busy |= bool(eng.pending) \
                                or not eng.queue.empty()
                    if not busy:
                        break
                    time.sleep(0.05)
                self._eng_stop.set()
                self._eng_thread.join(timeout=30)
                leftovers = []
                for eng in engines:
                    with eng._lock:
                        leftovers += list(eng.pending.values())
                        eng.pending.clear()
                        try:
                            while True:
                                leftovers.append(eng.queue.get_nowait()[1])
                        except _queue.Empty:
                            pass
                for fut in leftovers:
                    fut.set_exception(RuntimeError("service closed"))
            self.batcher.shutdown()
            self._closed = True


def metrics_text(service: CaptionService) -> str:
    """The Prometheus text of /status's counters (tell_tpu's /metrics:
    the same names, HELP and TYPE lines, and the engine's three lines when
    an engine runs)."""
    lines = []

    def metric(name, value, help_text, kind="counter"):
        lines.extend((f"# HELP {name} {help_text}", f"# TYPE {name} {kind}",
                      f"{name} {value}"))

    st = service.batcher.stats
    metric("tnt_requests_total", st.get("requests", 0),
           "Caption requests received by the micro-batcher")
    metric("tnt_batches_total", st.get("batches", 0),
           "Decode micro-batches executed")
    metric("tnt_errors_total", st.get("errors", 0), "Requests that failed")
    if service.engine is not None:
        eng = service.engine
        metric("tnt_engine_requests_total", eng.stats["requests"],
               "Requests admitted to the continuous-batching engine")
        metric("tnt_engine_chunks_total", eng.stats["chunks"],
               "Decode chunks executed by the engine")
        metric("tnt_engine_free_slots", len(eng.free),
               "Currently free engine slots", "gauge")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    service: CaptionService = None  # set by serve()

    def log_message(self, fmt, *args):  # quiet
        log.debug(fmt, *args)

    def _send(self, code: int, payload: dict):
        self._send_bytes(code, json.dumps(payload).encode(),
                         "application/json")

    def _send_bytes(self, code: int, body: bytes, content_type: str):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"status": "ok"})
        elif self.path in ("/stats", "/status"):
            self._send(200, self.service.status())
        elif self.path == "/metrics":
            self._send_bytes(200, metrics_text(self.service).encode(),
                             "text/plain; version=0.0.4; charset=utf-8")
        elif self.path in ("/", "/index.html"):
            try:
                with open(DEMO_PAGE, "rb") as f:
                    page = f.read()
            except OSError:
                self._send(404, {"error": "demo page missing"})
                return
            self._send_bytes(200, page, "text/html; charset=utf-8")
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._send(400, {"error": "bad json"})
            return
        if self.path == "/caption":
            if not isinstance(req, dict):
                self._send(400, {"error": "request must be a JSON object"})
                return
            try:
                self._send(200, self.service.caption(req))
            except Exception as e:  # noqa: BLE001 - reported to the client
                log.exception("caption request failed")
                self._send(500, {"error": str(e)})
        elif self.path == "/shutdown":
            self._send(200, {"status": "shutting down"})

            def stop():
                self.server.shutdown()
                self.service.close()

            threading.Thread(target=stop, daemon=True).start()
        elif self.path == "/scrape":
            try:
                self._send(200, extractor.get_urls(req.get("url", "")))
            except extractor.ExtractError as e:
                self._send(422, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - reported to the client
                self._send(502, {"error": f"fetch failed: {e}"})
        else:
            self._send(404, {"error": "not found"})


def serve(service: CaptionService, port: int = 5558, block: bool = True,
          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Serve /caption, /status, /healthz, /metrics, the demo page, /scrape
    and /shutdown. host defaults to loopback: /shutdown is
    unauthenticated. port=0 picks a free port (read
    it from the returned server's server_address). block=False serves from
    a daemon thread and returns at once."""
    handler = type("Handler", (_Handler,), {"service": service})
    httpd = ThreadingHTTPServer((host, port), handler)
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
