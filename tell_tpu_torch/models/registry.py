"""Model-family registry (counterpart of tell_tpu/models/registry.py):
tell_tpu's model_type names mapped onto adapters over the port's model
implementations, the multi-context captioner and the modern LM.

The pointer and LSTM families are not ported yet: their names raise
NotPortedError with the ROADMAP item. The modern family's training (its
loss) is not ported either: its adapter has loss None, and `train`
refuses it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..config import CaptionerConfig, LLMConfig, NotPortedError, \
    VIT_CONTEXTS

MODERN_TRAINING = ("queue 1 item 9, the modern family's training "
                   "(llm_forward, llm_xent, llm_loss, the MoE aux loss)")


@dataclasses.dataclass(frozen=True)
class ModelAdapter:
    name: str
    config: Any                       # the model config object
    init: Callable                    # init(generator, cfg) -> params
    loss: Callable | None             # loss(params, cfg, batch, ...)
    loss_e2e: Callable | None         # incl. frozen towers, or None
    generate: Callable                # generate(params, cfg, batch, ...)
    # encode(frozen, batch) -> batch with frozen-tower features added
    encode: Callable | None = None
    # beam(params, cfg, batch, beam_size, ...) -> {"token_ids": [B, K, T]}
    beam: Callable | None = None

    def check_levers(self, fused_topk: bool = False) -> None:
        """Refuse a decode numerics lever the family lacks: fused_topk is
        the adaptive softmax's, and the modern family's tied head has
        none."""
        if fused_topk and self.name == "modern":
            raise ValueError("fused_topk is the adaptive softmax's lever; "
                             "the modern family's tied head has none")


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
    from .llm_decoder import (llm_beam_search, llm_generate,
                              modern_encode_contexts)
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
        name="modern", config=cfg, init=init_llm_decoder, loss=None,
        loss_e2e=None, generate=llm_generate,
        encode=lambda frozen, batch: modern_encode_contexts(frozen, cfg,
                                                            batch),
        beam=llm_beam_search)


def _not_ported(what: str):
    def refuse(cfg):
        raise NotPortedError(f"{what} is not ported yet (ROADMAP queue 1 "
                             "item 9)")
    return refuse


_POINTER = _not_ported("the pointer family (models/pointer.py)")
_LSTM = _not_ported("the LSTM family (models/lstm_decoder.py)")


def get_model(model_type: str, cfg) -> ModelAdapter:
    """The adapter of a tell_tpu model_type name over `cfg` (a
    CaptionerConfig, or an LLMConfig for the modern family)."""
    mt = model_type.lower()
    if mt in ("captioner", "transformer_faces_objects", "transformer_faces",
              "transformer_flattened", "transformer_glove"):
        return _captioner(cfg)
    if mt in ("pointer", "transformer_pointer", "pointer_2",
              "transformer_pointer_2"):
        return _POINTER(cfg)
    if mt in ("lstm", "baseline_glove", "lstm_decoder_flattened"):
        return _LSTM(cfg)
    if mt in ("modern", "transformer_modern"):
        return _modern(cfg)
    if mt == "vit_modern":
        return _modern(cfg, vit=True)
    raise KeyError(f"unknown model_type {model_type!r}")
