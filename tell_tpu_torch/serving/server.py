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

Data-parallel serving (tell_tpu's --mesh-data: batch rows over the
mesh's "data" axis, params and towers replicated): `devices` lists N
devices, each of which holds a replica of the params and the RoBERTa
(one copy where a device repeats); a micro-batch is packed once, its
max_batch rows split evenly over the replicas (max_batch % N == 0, as
tell_tpu checks), each shard encoded and decoded on its device in a
thread of its own, and the answers go out in row order. The vision
towers run in the pack, on the first device. In engine mode the
engine's slots shard over the devices instead (serving/engine.py: S/N
slots a device, as tell_tpu shards them over "data"); the encode runs on
the first device.

kv_cache ("fp", "int8", "int4"), fused_topk, dec8, dec8_sm and
merged_vocab are the decode numerics levers (tell_tpu's TELL_TPU_KV8 /
TELL_TPU_KV4 / TELL_TPU_TOPK / TELL_TPU_DEC8 / _DEC8_SM / _MERGED_VOCAB,
off by default), in micro-batch and engine mode alike, and enc8 the
frozen encoder's (TELL_TPU_ENC8: the RoBERTa quantised to int8 once, at
load); numerics_ab() measures each one's teacher-forced agreement with
the fp path, and that of the tanh-GELU encode.

need_attention adds the demo's attention payload to each answer: per-step
maps of the first layer per context ("attns") merged into words
(serving/word_attention.py). Micro-batch mode records them in
generate(need_weights=True); engine mode replays the winning caption
teacher-forced (replay_attention), off the engine's hot path.

The model is the flagship captioner or, given `adapter` (models/
registry.py's get_model), the modern family (expts 10 and 12): its
micro-batch mode decodes with llm_generate (with need_weights for the
attention payload), its engine mode with LLMDecodeEngine, which refuses
need_attention as tell_tpu's does (no replay for the modern family), and
its article is the tower's final hidden state (modern_encode_contexts);
or the LSTM family (expts 1 and 3), served in micro-batch mode only
(lstm_generate, greedy; its need_weights maps {image, article} [T, B, S]
carry no bias or zero column): the engine refuses it, with tell_tpu's
error; or the pointer family (expts a1-a3), in micro-batch mode only
(pointer_generate, greedy): a request's `entities` (plain strings, or
named-entity dicts with a "text" field) are found in its article text
(entity_occurrences) and give each article token the 1-based index of the
entity it lies in (encode_with_indexed_spans), packed as proper_masks
with -1 at pads; a request without entities, or with context_ids and no
text, never copies. The pointer decode records no attention maps, as in
tell_tpu: with need_attention its answers carry none. A model whose
article context is not the RoBERTa's width (the GloVe experiments' 300-d
article) fails each request, as tell_tpu's service does: neither has a
GloVe encode.

A request may carry its photo instead of its image grid: `image_b64` (an
encoded JPEG), `image` (an [H, W, 3] list) or, from the scrape flow,
`sections[image_position].image_data` (base64). VisionPipeline
(serving/vision.py) decodes it and computes, on the device while the
micro-batch is packed, the contexts its towers give and the request lacks:
the grid (ResNet-152), the faces (MTCNN + FaceNet) and the objects
(YOLOv3-SPP + the pooled ResNet-152). A photo that does not decode, or
fails in a stage, fails its own request only. The image context is the
grid the ResNet gives: a modern model's 197 x 1024 ViT slot does not take
it, and such a request gets a `bad image_grid` error (tell_tpu's
behaviour; the ViT is not on the photo path).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import queue as _queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..bridge import to_torch
from ..config import CaptionerConfig, with_article_len
from ..data.pipeline import entity_occurrences
from ..data.readers import assemble_location_aware
from ..models.backbones.roberta import RobertaEncoder
from ..models.captioner import Captioner, weighted_layer_sum
from ..models.registry import get_model
from ..ops.quant import maybe_quantize_frozen
from . import extractor
from .batcher import MicroBatcher
from .encode_batcher import EncodeBatcher
from .engine import DecodeEngine, LLMDecodeEngine
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
    every answer. towers: the frozen vision towers, each in its forward's
    layout ({"resnet": load_tower's or prepare_resnet's tree, "resnet_cfg":
    ResNetConfig, "mtcnn", "facenet", "yolov3"}: VisionPipeline's frozen
    dict), which give raw-image requests their grid, faces and objects.
    adapter: get_model's adapter of the model family (default: the
    captioner over cfg); its config replaces cfg. devices: the
    replicas' devices for data-parallel micro-batch serving (the first
    is `device`'s place; None: `device` alone). dec8, dec8_sm and
    merged_vocab are the int8 and merged-table decode levers (a family
    refuses those its decode does not read); enc8 quantises the RoBERTa
    to int8 here, once (ops/quant.py's maybe_quantize_frozen)."""

    def __init__(self, params: dict, roberta: RobertaEncoder,
                 cfg: CaptionerConfig, device, tokenizer=None,
                 max_batch: int = 8, article_len: int | None = None,
                 engine_slots: int = 0, engine_beam: int = 5,
                 engine_length_penalty: float = 0.0,
                 engine_buckets: bool = False, encode_batch: int = 8,
                 kv_cache: str = "fp",
                 fused_topk: bool = False, need_attention: bool = False,
                 towers: dict | None = None, adapter=None,
                 devices: list | None = None, dec8: bool = False,
                 dec8_sm: bool = False, merged_vocab: bool = False,
                 enc8: bool = False):
        if need_attention and tokenizer is None:
            raise ValueError("need_attention merges the maps into words "
                             "and needs a tokenizer")
        self.adapter = adapter or get_model("captioner", cfg)
        self.modern = self.adapter.name == "modern"
        self.adapter.check_levers(fused_topk, kv_cache, dec8, dec8_sm,
                                  merged_vocab)
        if engine_slots and not self.adapter.engine:
            raise ValueError("continuous batching serves the captioner and "
                             "modern families only (got adapter "
                             f"{self.adapter.name!r})")
        if self.modern and engine_slots and need_attention:
            raise ValueError("attention replay is captioner-only; drop "
                             "--attention for the modern engine")
        devices = [torch.device(d) for d in devices or [device]]
        if max_batch % len(devices):
            raise ValueError(
                f"max_batch {max_batch} must be divisible by the mesh "
                f"data axis {len(devices)}")
        device = devices[0]
        cfg = self.adapter.config
        self.cfg = cfg
        # the pointer's PointerConfig wraps a captioner's config
        self.cap_cfg = getattr(cfg, "captioner", cfg)
        self.dcfg = getattr(self.cap_cfg, "decoder", self.cap_cfg)
        self.copy_masks = self.adapter.copy_masks
        self.device = torch.device(device)
        # the flagship's params as an nn.Module (.model); the modern and
        # LSTM families decode through their adapters alone
        self.params = to_torch(params, self.device)
        self.model = (Captioner(self.params, cfg)
                      if self.adapter.name == "captioner" else None)
        if self.model is not None:
            self.params = self.model.tree()
        self.roberta = roberta.to(self.device)
        self.enc8 = enc8
        if enc8:
            self.roberta = RobertaEncoder(maybe_quantize_frozen(
                self.roberta.frozen(), True)["roberta"], self.roberta.cfg)
        self.tokenizer = tokenizer
        self.need_attention = need_attention
        self.max_batch = max_batch
        dcfg = self.dcfg
        if article_len is None:
            article_len = next((c.max_len for c in dcfg.contexts
                                if c.name == "article"), 512)
        self.article_len = article_len
        self.kv_cache, self.fused_topk = kv_cache, fused_topk
        self.levers = {"dec8": dec8, "dec8_sm": dec8_sm,
                       "merged_vocab": merged_vocab}
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
        self.devices = devices
        # in engine mode the engine's shards hold the other devices' copy
        self._replicas = self._make_replicas(
            devices[:1] if engine_slots else devices)
        self._pool = (ThreadPoolExecutor(len(self._replicas), "replica")
                      if len(self._replicas) > 1 else None)
        self.batcher = MicroBatcher(self._run, max_batch=max_batch)
        self._close_lock = threading.Lock()
        self._closed = False
        self.engine = None
        if engine_slots:
            self._start_engines(engine_slots, engine_beam,
                                engine_length_penalty, engine_buckets,
                                encode_batch)

    def _make_replicas(self, devices: list) -> list[tuple]:
        """(device, params, frozen RoBERTa) of each of `devices`; a
        device that repeats shares its first replica's tensors."""
        made = {}
        out = []
        for d in devices:
            if d not in made:
                if d == self.device:
                    made[d] = (d, self.params, self.roberta.frozen())
                else:
                    fz = self.roberta.frozen()
                    made[d] = (d, to_torch(self.params, d),
                               {**fz, "roberta": to_torch(fz["roberta"],
                                                          d)})
            out.append(made[d])
        return out

    def _start_engines(self, slots: int, beam: int, length_penalty: float,
                       buckets: bool, encode_batch: int) -> None:
        widths = self._article_buckets if buckets else (self.article_len,)
        params = self.params
        engine = LLMDecodeEngine if self.modern else DecodeEngine
        where = self.devices if len(self.devices) > 1 else self.device
        self.engines = {
            w: engine(params, with_article_len(self.cfg, w),
                            where, slots=slots, beam=beam,
                            length_penalty=length_penalty,
                            kv_cache=self.kv_cache,
                            fused_topk=self.fused_topk, **self.levers)
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

    def _decode_levers(self) -> dict:
        """The service's decode levers as the adapter's generate keywords:
        only those that are on (a family's generate takes none it
        lacks)."""
        on = {"fused_topk": self.fused_topk, **self.levers}
        out = {k: True for k, v in on.items() if v}
        if self.kv_cache != "fp":
            out["kv_cache"] = self.kv_cache
        return out

    def _generate(self, enc: dict, need_weights: bool = False,
                  params: dict | None = None, **levers) -> dict:
        """The model's greedy decode (the adapter's) of encoded features
        (with `params`, a replica's; default the service's); need_weights
        asks for the attention maps where the family's generate records
        them."""
        if need_weights and self.adapter.attention_maps:
            levers["need_weights"] = True
        return self.adapter.generate(params or self.params, self.cfg, enc,
                                     **levers)

    def _encode(self, batch: dict, frozen: dict | None = None) -> dict:
        """The model's frozen-tower encode (the adapter's) of a batch of
        tensors; frozen defaults to the service's RoBERTa. Raises where
        the article context takes features of another width than the
        encode gives (a GloVe model's 300-d article)."""
        out = self.adapter.encode(frozen or self.roberta.frozen(), batch)
        art = out.get("article", out.get("article_hiddens"))
        want = {c.name: c.kv_dim for c in self.dcfg.contexts}.get("article")
        if art is not None and want not in (None, art.shape[-1]):
            raise ValueError(
                f"the article context takes {want}-d features and the "
                f"service's RoBERTa encodes {art.shape[-1]}-d ones (a GloVe "
                "model: the service has no GloVe encode, nor has "
                "tell_tpu's)")
        return out

    def _encode_many(self, batch: dict) -> dict:
        """Numpy payload rows -> features on the device: the RoBERTa
        encode with the hidden layers mixed in (weighted_layer_sum), so only
        [n, S, 1024] article features reach admission."""
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v).to(self.device)
                  for k, v in batch.items()}
            out = self._encode(tb)
            if "article_hiddens" in out:
                out["article"] = weighted_layer_sum(
                    self.params, out.pop("article_hiddens"))
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

    def _request_ids_masks(self, req: dict
                           ) -> tuple[np.ndarray, np.ndarray]:
        """The pointer family's article ids and their proper-noun masks,
        as tell_tpu's _pack makes them: the request's `entities` found in
        its text, one indexed-span encode giving both; without entities
        every mask is 0, and ids sent as context_ids (no text to find an
        entity in) get zero masks."""
        if "context_ids" in req or not ("context" in req
                                         or "sections" in req):
            ids = self._request_ids(req)
            return ids, np.zeros(ids.size, np.int64)
        if self.tokenizer is None:
            raise ValueError("text context needs a tokenizer; send "
                             "context_ids")
        text = (req["context"] if "context" in req
                else self._sections_text(req))
        try:
            ents = [e["text"] if isinstance(e, dict) else str(e)
                    for e in (req.get("entities") or [])]
            spans = entity_occurrences(text, ents)
        except (KeyError, TypeError) as e:
            raise ValueError(f"bad entities: {e!r}") from e
        ids, masks = self.tokenizer.encode_with_indexed_spans(
            text, spans, max_len=self.article_len)
        return np.asarray(ids, np.int64), np.asarray(masks, np.int64)

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
        all_toks, all_masks = [], []
        for i, req in enumerate(requests):
            try:
                toks, pm = (self._request_ids_masks(req) if self.copy_masks
                            else (self._request_ids(req), None))
            except ValueError as e:
                errors[i] = errors[i] or f"bad context: {e}"
                toks = pm = np.zeros(0, np.int64)
            all_toks.append(toks)
            all_masks.append(pm)
        width = self.article_len
        if bucketed:
            longest = max(len(t) for t in all_toks)
            width = next(w for w in self._article_buckets if longest <= w)
        ids = np.full((B, width), self.roberta.cfg.pad_id, np.int64)
        for i, toks in enumerate(all_toks):
            ids[i, : len(toks)] = toks
        batch = {"context_ids": ids}
        if self.copy_masks:
            masks = np.full((B, width), -1, np.int64)
            for i, pm in enumerate(all_masks):
                masks[i, : len(pm)] = pm
            batch["proper_masks"] = masks
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
        if self._pool is None:
            token_ids, layer0 = self._decode_rows(batch, self._replicas[0])
        else:
            k = self.max_batch // len(self._replicas)
            parts = list(self._pool.map(
                lambda i: self._decode_rows(
                    {key: v[i * k:(i + 1) * k] for key, v in batch.items()},
                    self._replicas[i]), range(len(self._replicas))))
            token_ids = np.concatenate([t for t, _ in parts])
            layer0 = (None if parts[0][1] is None else
                      {name: np.concatenate([m[name] for _, m in parts],
                                            axis=1)
                       for name in parts[0][1]})
        token_ids = token_ids[:n]
        maps = layer0 is not None
        results = []
        for i in range(n):
            r = {"token_ids": token_ids[i].tolist()}
            if self.tokenizer is not None:
                r["caption"] = self.tokenizer.decode(token_ids[i])
            if errors[i]:
                r["error"] = errors[i]
            if maps:
                r.update(self._attention_payload(
                    token_ids[i], {k: a[:, i] for k, a in layer0.items()},
                    batch["context_ids"][i]))
            results.append(r)
        return results

    def _decode_rows(self, batch: dict, replica: tuple
                     ) -> tuple[np.ndarray, dict | None]:
        """Encode and decode packed rows on a replica: (token ids, and
        with need_attention the first layer's maps {name: [T, rows, S']},
        else None)."""
        device, params, frozen = replica
        with torch.inference_mode(), (
                torch.cuda.device(device) if device.type == "cuda"
                else contextlib.nullcontext()):
            tb = {k: torch.from_numpy(v).to(device)
                  for k, v in batch.items()}
            enc = self._encode(tb, frozen)
            out = self._generate(enc, need_weights=self.need_attention,
                                 params=params, **self._decode_levers())
            token_ids = out["token_ids"].cpu().numpy()
            if not (self.need_attention and "attns" in out):
                return token_ids, None
            # layer 0 of per-layer {name: [T, B, 1, S']}, or the LSTM's one
            # {name: [T, B, S]}
            attns = out["attns"]
            layer0 = ({name: a[:, :, 0] for name, a in attns[0].items()}
                      if isinstance(attns, list) else attns)
            return token_ids, {k: a.cpu().numpy() for k, a in layer0.items()}

    def _attention_payload(self, token_ids: np.ndarray, maps: dict,
                           context_ids: np.ndarray) -> dict:
        """One answer's "attns" ({context: [T, S'] per-step maps}) and
        their word merge (caption_words, word_attns, article_words). The
        trailing bias/zero columns are derived from the true source
        lengths: each context's capacity, the article's packed width."""
        lens = {c.name: c.max_len for c in self.dcfg.contexts}
        lens["article"] = len(context_ids)
        payload = {"attns": {k: a.tolist() for k, a in maps.items()}}
        payload.update(merge_word_attentions(
            self.tokenizer, token_ids, maps, context_ids=context_ids,
            eos_id=self.dcfg.eos_id, source_lens=lens))
        return payload

    def replay_payload(self, enc: dict, token_ids: np.ndarray,
                       context_ids: np.ndarray) -> dict:
        """The attention payload of a known caption on one request's
        encoded features `enc` (leading dim 1): replay_attention, teacher-
        forced in the service's K/V cache and decode-step numerics (the
        engine's path)."""
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(token_ids)[None],
                                  device=self.device)
            feats = {k: torch.as_tensor(v).to(self.device)
                     for k, v in enc.items()}
            maps = self.model.replay_attention(
                feats, ids, self.kv_cache, self.levers["dec8"])[0]
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
        the int4 cache, the fused top-k, the int8 decode step, the int8
        softmax tables and the merged table (dec8_, dec8_sm_ and
        merged_vocab_token_agreement, where the family's decode reads
        them), the tanh-GELU encode (fast_gelu_token_agreement: the fp
        decode over features the tower encoded with the tanh GELU) and the
        int8 encode (enc8_token_agreement: over features the tower encoded
        in int8, tell_tpu's bench gate; a service built with enc8 holds
        only the int8 tower, so its fp path encodes in int8 already:
        encoder_mode says which). Counted over the live (non-pad)
        target tokens of `requests` (default: one canned request) at full
        article width. The result also lands in /status under
        "numerics_ab". The modern and LSTM families have no teacher-forced
        decode in the port (nor in tell_tpu's service): their levers are
        compared free-running, token by token over the fp path's live
        targets (method "free_running"): the modern family's int8 and
        int4 K/V (it has no fused top-k), the LSTM's fused top-k (it has
        no K/V cache), and both families' tanh-GELU encode."""
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
            enc, enc_tanh = (self._encode(tb, {
                **frozen, "roberta_cfg": dataclasses.replace(
                    frozen["roberta_cfg"], gelu=gelu)})
                for gelu in ("erf", "tanh"))
            enc_int8 = self._encode(tb, maybe_quantize_frozen(frozen, True))
            ref = self._generate(enc)["token_ids"]
            target = ref[:, 1:]
            live = target != self.dcfg.pad_id
            if not bool(live.any()):
                live = torch.ones_like(live)
            report = {"kv_cache_mode": self.kv_cache,
                      "topk_mode": self._topk_mode(),
                      "gelu_mode": self.roberta.cfg.gelu,
                      "encoder_mode": "int8" if self.enc8 else "fp",
                      "method": ("free_running" if self.model is None
                                 else "forced_per_step"),
                      "tokens": int(live.sum())}

            def agreement(features, **lever):
                if self.model is None:
                    preds = self._generate(features,
                                           **lever)["token_ids"][:, 1:]
                else:
                    preds = self.model.predict_forced(features, ref, **lever)
                return float((preds == target)[live].float().mean())

            levers = []
            if self.adapter.kv_cache_levers:
                levers += [("kv8_token_agreement", {"kv_cache": "int8"}),
                           ("kv4_token_agreement", {"kv_cache": "int4"})]
            if self.adapter.fused_topk:
                levers.append(("fused_topk_token_agreement",
                               {"fused_topk": True}))
            if self.adapter.dec8_levers:
                levers += [("dec8_token_agreement", {"dec8": True}),
                           ("dec8_sm_token_agreement", {"dec8_sm": True})]
            if self.adapter.merged_vocab:
                levers.append(("merged_vocab_token_agreement",
                               {"merged_vocab": True}))
            for key, lever in levers:
                report[key] = agreement(enc, **lever)
            report["fast_gelu_token_agreement"] = agreement(enc_tanh)
            report["enc8_token_agreement"] = agreement(enc_int8)
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
                "contexts": [c.name for c in self.dcfg.contexts],
                "gen_len": self.cap_cfg.gen_len,
                "device": str(self.device),
                "devices": [str(d) for d in self.devices],
                "need_attention": self.need_attention,
                "kv_cache_mode": self.kv_cache,
                "topk_mode": self._topk_mode(),
                "gelu_mode": self.roberta.cfg.gelu,
                "encoder_mode": "int8" if self.enc8 else "fp",
                **self.levers,
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
            if self._pool is not None:
                self._pool.shutdown(wait=True)
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
