"""Configuration dataclasses (counterpart of tell_tpu/config.py, and of
LLMConfig and VIT_CONTEXTS in tell_tpu/models/llm_decoder.py).

The port keeps its own copy, field for field and default for default, so
it imports nothing of the JAX package. Both sets are frozen, hashable
dataclasses with the same fields, so a config built by either package
works in the other by attribute access; tests/test_torch_config.py holds
the two equal.

Flagship values mirror expt/nytimes/9_transformer_objects/config.yaml.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ContextSpec:
    """One cross-attended context modality (name + raw feature dim)."""
    name: str
    kv_dim: int
    max_len: int  # static sequence capacity (the decode shapes are fixed)


# The four modalities of the flagship model (feature dims: ResNet grid 2048,
# RoBERTa 1024, FaceNet 512, object ResNet embeds 2048).
FACES_OBJECTS_CONTEXTS = (
    ContextSpec("image", 2048, 49),
    ContextSpec("article", 1024, 512),
    ContextSpec("faces", 512, 4),
    ContextSpec("obj", 2048, 64),
)
FACES_CONTEXTS = FACES_OBJECTS_CONTEXTS[:3]
FLATTENED_CONTEXTS = FACES_OBJECTS_CONTEXTS[:2]
NO_IMAGE_CONTEXTS = (FACES_OBJECTS_CONTEXTS[1],)


@dataclass(frozen=True)
class DecoderConfig:
    """DynamicConv decoder. One config covers the four decoder variants:
    they differ only in the `contexts` tuple."""
    vocab_size: int = 50265
    embed_dim: int = 1024
    conv_dim: int = 1024
    ffn_dim: int = 4096
    num_heads: int = 16
    kernel_sizes: tuple[int, ...] = (3, 7, 15, 31)
    conv_type: str = "dynamic"  # or "lightweight"
    glu: bool = True
    weight_softmax: bool = True
    normalize_before: bool = False
    final_norm: bool = False
    dropout: float = 0.1
    weight_dropout: float = 0.1
    input_dropout: float = 0.1
    relu_dropout: float = 0.0
    attention_dropout: float = 0.1
    adaptive_cutoffs: tuple[int, ...] = (5000, 20000)
    adaptive_factor: float = 1.0
    adaptive_softmax_dropout: float = 0.0
    scale_embeds: bool = True
    # "sinusoidal" (static table) or "learned" (trainable table)
    positional: str = "sinusoidal"
    embed_padding_idx: int = 0  # pins <s> rows; see ops/adaptive.py
    pad_id: int = 1
    bos_id: int = 0
    eos_id: int = 2
    max_target_positions: int = 512
    contexts: tuple[ContextSpec, ...] = FACES_OBJECTS_CONTEXTS
    # Static per-tail row budgets for the training loss, as a fraction of the
    # batch token count. None = dense tails (used by parity tests).
    tail_capacity_frac: tuple[float, ...] | None = (0.25, 0.125)

    @property
    def num_layers(self) -> int:
        return len(self.kernel_sizes)

    @property
    def full_cutoffs(self) -> tuple[int, ...]:
        if self.adaptive_cutoffs and self.adaptive_cutoffs[-1] == self.vocab_size:
            return self.adaptive_cutoffs
        return self.adaptive_cutoffs + (self.vocab_size,)

    def context(self, name: str) -> ContextSpec:
        for c in self.contexts:
            if c.name == name:
                return c
        raise KeyError(name)


@dataclass(frozen=True)
class CaptionerConfig:
    """Task model (the transformer_faces_objects family)."""
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    weigh_bert: bool = True
    num_bert_layers: int = 25  # RoBERTa-large: embeddings + 24 layers
    sampling_topk: int = 1
    sampling_temp: float = 1.0
    gen_len: int = 100
    compute_dtype: str = "float32"  # "bfloat16" for training


def small_test_config(**overrides) -> CaptionerConfig:
    """Tiny shapes for CPU tests."""
    dec = DecoderConfig(
        vocab_size=500,
        embed_dim=64,
        conv_dim=64,
        ffn_dim=128,
        num_heads=4,
        kernel_sizes=(3, 5),
        adaptive_cutoffs=(50, 200),
        dropout=0.0, weight_dropout=0.0, input_dropout=0.0,
        attention_dropout=0.0, relu_dropout=0.0,
        max_target_positions=64,
        contexts=(
            ContextSpec("image", 32, 9),
            ContextSpec("article", 24, 16),
            ContextSpec("faces", 16, 4),
            ContextSpec("obj", 32, 8),
        ),
        tail_capacity_frac=None,
    )
    dec = dataclasses.replace(dec, **{k: v for k, v in overrides.items()
                                      if hasattr(DecoderConfig, k)})
    cap_over = {k: v for k, v in overrides.items()
                if hasattr(CaptionerConfig, k) and k != "decoder"}
    return CaptionerConfig(decoder=dec, num_bert_layers=3, **cap_over)


# ViT-L/16's CLS + 14x14 patch tokens in the image slot (the modern
# family's contexts, expts 10 and 12)
VIT_CONTEXTS = (
    ContextSpec("image", 1024, 197),
    ContextSpec("article", 1024, 512),
    ContextSpec("faces", 512, 4),
    ContextSpec("obj", 2048, 64),
)


@dataclass(frozen=True)
class LLMConfig:
    """The modern captioning LM (tell_tpu/models/llm_decoder.py): RoPE +
    GQA causal self-attention, cross-attention over the contexts, SwiGLU
    or a top-k MoE FFN, a tied full-vocabulary head."""
    vocab_size: int = 50265
    dim: int = 1024
    num_layers: int = 8
    num_heads: int = 16
    # grouped-query attention: None = MHA
    num_kv_heads: int | None = 4
    ffn_dim: int = 2816
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_id: int = 1
    bos_id: int = 0
    eos_id: int = 2
    max_target_positions: int = 512
    contexts: tuple[ContextSpec, ...] = FACES_OBJECTS_CONTEXTS
    gen_len: int = 100
    loss_vocab_chunk: int = 8192
    # Mixture-of-Experts FFN (ops/moe.py): None = dense SwiGLU
    moe_experts: int | None = None
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def context(self, name: str) -> ContextSpec:
        for c in self.contexts:
            if c.name == name:
                return c
        raise KeyError(name)


def with_article_len(cfg, max_len: int):
    """cfg (a CaptionerConfig or an LLMConfig) with the article context's
    capacity set to max_len tokens (the long-article configuration,
    expt/nytimes/11_long_article.yaml, is the flagship with max_len
    2048)."""
    dcfg = getattr(cfg, "decoder", cfg)
    contexts = tuple(dataclasses.replace(c, max_len=max_len)
                     if c.name == "article" else c for c in dcfg.contexts)
    if dcfg is cfg:
        return dataclasses.replace(cfg, contexts=contexts)
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(dcfg, contexts=contexts))


class NotPortedError(ValueError):
    """A configuration or input that tell_tpu runs and the port does not
    yet; the message names the ROADMAP queue item that ports it."""


def orbax_refusal(path: str, kind: str, src: str) -> NotPortedError:
    """The error for a directory without the port's state.pt where a
    tell_tpu orbax tree may be: `kind` is "run" (a checkpoint of a
    training run, converted from its serialization dir `src`) or "towers"
    (a tower, converted from its towers dir `src`); the message gives the
    converter's command line, which runs where JAX and orbax do."""
    return NotPortedError(
        f"{path} holds no state.pt (a tell_tpu orbax tree?): convert it "
        f"where JAX and orbax are installed with python "
        f"migrate/orbax_to_torch.py {kind} {src}")
