"""Model-family registry (counterpart of tell_tpu/models/registry.py):
tell_tpu's model_type names mapped onto adapters over the port's model
implementations: the multi-context captioner (transformer_glove is the
captioner over GloVe article features), the pointer models
(transformer_pointer and transformer_pointer_2, expts a1-a3), the modern
LM and the LSTM baseline (baseline_glove, lstm_decoder_flattened).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..config import CaptionerConfig, LLMConfig, VIT_CONTEXTS

@dataclasses.dataclass(frozen=True)
class ModelAdapter:
    name: str
    config: Any                       # the model config object
    init: Callable                    # init(generator, cfg) -> params
    loss: Callable                    # loss(params, cfg, batch, ...)
    loss_e2e: Callable | None         # incl. frozen towers, or None
    generate: Callable                # generate(params, cfg, batch, ...)
    # encode(frozen, batch) -> batch with frozen-tower features added
    encode: Callable | None = None
    # beam(params, cfg, batch, beam_size, ...) -> {"token_ids": [B, K, T]}
    # None = greedy only (tell_tpu decodes the LSTM greedily too)
    beam: Callable | None = None
    # what the family decodes with: the adaptive softmax's fused top-k
    # lever (kernel E), the int8/int4 K/V cache levers, the int8 decode
    # step and softmax tables (dec8, dec8_sm), the merged decode table,
    # and a continuous-batching engine; every family takes enc8 (its
    # article encode is RoBERTa's)
    fused_topk: bool = True
    kv_cache_levers: bool = True
    dec8_levers: bool = True
    merged_vocab: bool = True
    engine: bool = True
    # whether generate takes need_weights (the attention maps); the
    # pointer decode does not, as in tell_tpu, and a service asked for
    # --attention answers its captions without maps
    attention_maps: bool = True
    # whether a request's entities pack proper_masks (the pointer's copy
    # head reads them; tell_tpu's service's _needs_copy_masks)
    copy_masks: bool = False

    def check_levers(self, fused_topk: bool = False,
                     kv_cache: str = "fp", dec8: bool = False,
                     dec8_sm: bool = False,
                     merged_vocab: bool = False) -> None:
        """Refuse, by name, a decode numerics lever the family lacks, as
        tell_tpu's code reads none for it: fused_topk is the adaptive
        softmax's, and the modern family's tied head has none; the LSTM
        attends to its contexts without a K/V cache; dec8 and dec8_sm are
        the flagship decoder's (and its siblings'), merged_vocab also the
        pointer's."""
        if fused_topk and not self.fused_topk:
            raise ValueError("fused_topk is the adaptive softmax's lever; "
                             f"the {self.name} family's tied head has "
                             "none")
        if kv_cache != "fp" and not self.kv_cache_levers:
            raise ValueError(f"kv_cache {kv_cache!r}: the {self.name} "
                             "family keeps no K/V cache")
        for name, on, ok in (("dec8", dec8, self.dec8_levers),
                             ("dec8_sm", dec8_sm, self.dec8_levers),
                             ("merged_vocab", merged_vocab,
                              self.merged_vocab)):
            if on and not ok:
                raise ValueError(f"{name} is the flagship decoder's lever; "
                                 f"the {self.name} family's decode does "
                                 "not read it")


def _captioner(cfg: CaptionerConfig) -> ModelAdapter:
    from ..bridge import init_captioner
    from .beam import beam_search
    from .captioner import (captioner_loss, captioner_loss_e2e,
                            encode_contexts, generate)
    return ModelAdapter(
        name="captioner", config=cfg, init=init_captioner,
        loss=captioner_loss, loss_e2e=captioner_loss_e2e,
        generate=generate,
        encode=lambda frozen, batch: encode_contexts(frozen, cfg, batch),
        beam=beam_search)


def _modern(cfg, vit: bool = False) -> ModelAdapter:
    from ..bridge import init_llm_decoder
    from .llm_decoder import (llm_beam_search, llm_generate, llm_loss,
                              llm_loss_e2e, modern_encode_contexts)
    if isinstance(cfg, CaptionerConfig):
        # a captioner YAML reused: its contexts and token-level ids carry
        # over, and vit swaps the ResNet grid's image spec for ViT-L's
        d = cfg.decoder
        contexts = d.contexts
        if vit and any(c.name == "image" and c.kv_dim == 2048
                       for c in contexts):
            contexts = VIT_CONTEXTS
        cfg = LLMConfig(contexts=contexts, gen_len=cfg.gen_len,
                        vocab_size=d.vocab_size, pad_id=d.pad_id,
                        bos_id=d.bos_id, eos_id=d.eos_id,
                        max_target_positions=d.max_target_positions)
    return ModelAdapter(
        name="modern", config=cfg, init=init_llm_decoder, loss=llm_loss,
        loss_e2e=llm_loss_e2e, generate=llm_generate,
        encode=lambda frozen, batch: modern_encode_contexts(frozen, cfg,
                                                            batch),
        beam=llm_beam_search, fused_topk=False, dec8_levers=False,
        merged_vocab=False)


def _lstm(cfg: CaptionerConfig) -> ModelAdapter:
    """tell_tpu's _lstm adapter: no e2e loss of its own (the Trainer
    builds one from encode + loss), the captioner's encode, greedy or
    top-k sampled decode only."""
    from ..bridge import init_lstm_captioner
    from .captioner import encode_contexts
    from .lstm_decoder import lstm_captioner_loss, lstm_generate
    return ModelAdapter(
        name="lstm", config=cfg, init=init_lstm_captioner,
        loss=lstm_captioner_loss, loss_e2e=None, generate=lstm_generate,
        encode=lambda frozen, batch: encode_contexts(frozen, cfg, batch),
        kv_cache_levers=False, dec8_levers=False, merged_vocab=False,
        engine=False)


def _pointer(cfg: CaptionerConfig, version: int) -> ModelAdapter:
    """tell_tpu's _pointer adapter: PointerConfig over the captioner's
    config, its loss and an e2e loss that encodes through the captioner's
    encode_contexts, greedy (or top-k sampled) decode only, with the K/V
    cache and fused top-k levers; no engine (tell_tpu's service refuses
    one) and no attention maps."""
    from ..bridge import init_pointer
    from .captioner import encode_contexts
    from .pointer import PointerConfig, pointer_generate, pointer_loss
    pcfg = PointerConfig(captioner=cfg, copy_loss_version=version)

    def loss_e2e(params, frozen, c, batch, gen=None, deterministic=True,
                 **kw):
        return pointer_loss(params, c, encode_contexts(frozen, c.captioner,
                                                       batch),
                            gen, deterministic, **kw)

    return ModelAdapter(
        name=f"pointer_v{version}", config=pcfg, init=init_pointer,
        loss=pointer_loss, loss_e2e=loss_e2e, generate=pointer_generate,
        encode=lambda frozen, batch: encode_contexts(frozen, cfg, batch),
        engine=False, attention_maps=False, copy_masks=True,
        dec8_levers=False)


def get_model(model_type: str, cfg) -> ModelAdapter:
    """The adapter of a tell_tpu model_type name over `cfg` (a
    CaptionerConfig, or an LLMConfig for the modern family)."""
    mt = model_type.lower()
    if mt in ("captioner", "transformer_faces_objects", "transformer_faces",
              "transformer_flattened", "transformer_glove"):
        return _captioner(cfg)
    if mt in ("pointer", "transformer_pointer"):
        return _pointer(cfg, 1)
    if mt in ("pointer_2", "transformer_pointer_2"):
        return _pointer(cfg, 2)
    if mt in ("lstm", "baseline_glove", "lstm_decoder_flattened"):
        return _lstm(cfg)
    if mt in ("modern", "transformer_modern"):
        return _modern(cfg)
    if mt == "vit_modern":
        return _modern(cfg, vit=True)
    raise KeyError(f"unknown model_type {model_type!r}")
