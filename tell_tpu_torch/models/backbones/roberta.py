"""RoBERTa article encoder, frozen tower (counterpart of
tell_tpu/models/backbones/roberta.py).

Post-LN transformer encoder with pad-aware learned positions with
RoBERTa's +2 offset. Self-attention runs through kernel B
(ops/kernels/encoder_attention.py) on CUDA and its plain version, the JAX
package's einsum path with a -1e9 key-padding mask, on the CPU.

A dense leaf quantised to int8 ({"q8", "scale", "b"}: ops/quant.py's
quantize_roberta, tell_tpu's TELL_TPU_ENC8 lever) runs through kernel G
(`_lin` dispatches on the leaf, as tell_tpu's does), so a quantised tower
goes wherever a frozen tower is accepted.

The FFN's GELU is exact (erf) unless the caller asks for the tanh
approximation (RobertaConfig(gelu="tanh"), tell_tpu's TELL_TPU_FAST_GELU
lever): erf is the default on every device; the serving
numerics gate reports the tanh encode's agreement
(fast_gelu_token_agreement).

convert_hf_roberta maps a HuggingFace RobertaModel or RobertaForMaskedLM
state dict to the port's param tree (tools/convert_towers.py writes it
where the CLI reads its frozen tower).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...bridge import ParamTree
from ...ops.common import layer_norm
from ...ops.kernels.encoder_attention import encoder_attention
from ...ops.linear import linear
from ...ops.positional import make_positions
from ...ops.quant import int8_linear


GELU_MODES = ("erf", "tanh")


@dataclass(frozen=True)
class RobertaConfig:
    """Mirror of tell_tpu's RobertaConfig (importing that module pulls in
    JAX): same fields, same defaults, same presets."""
    vocab_size: int = 50265
    dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    max_positions: int = 514  # 512 + pad offset 2
    pad_id: int = 1
    ln_eps: float = 1e-5
    # the FFN's GELU, "erf" (exact) or "tanh": the port's one field beyond
    # tell_tpu's, where the TELL_TPU_FAST_GELU environment variable sets it
    gelu: str = "erf"

    def __post_init__(self):
        if self.gelu not in GELU_MODES:
            raise ValueError(f"gelu {self.gelu!r} not in {GELU_MODES}")

    @staticmethod
    def large() -> "RobertaConfig":
        return RobertaConfig()

    @staticmethod
    def base() -> "RobertaConfig":
        return RobertaConfig(dim=768, num_layers=12, num_heads=12,
                             ffn_dim=3072)

    @staticmethod
    def tiny() -> "RobertaConfig":
        return RobertaConfig(dim=1024, num_layers=2, num_heads=16,
                             ffn_dim=1024)


def _lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A dense layer: kernel G over a quantised leaf, else x @ w + b."""
    if "q8" in p:
        return int8_linear(p, x)
    return linear(p, x)


def roberta_encode(params: dict, cfg: RobertaConfig, ids: torch.Tensor,
                   return_all_hiddens: bool = True) -> torch.Tensor:
    """ids: [B, S] -> [B, S, L+1, D] all hidden states (or [B, S, D]).

    Pad-aware positions: position = pad_id + cumsum(not_pad), pads keep
    pad_id. Pad keys are masked out of attention with an additive -1e9.
    The FFN's GELU is cfg.gelu's."""
    B, S = ids.shape
    positions = make_positions(ids, cfg.pad_id)
    x = (params["word_embed"][ids] + params["pos_embed"][positions]
         + params["type_embed"][0])
    x = layer_norm(params["embed_ln"], x, cfg.ln_eps)
    hiddens = [x]
    H = cfg.num_heads
    hd = cfg.dim // H
    key_pad = ids == cfg.pad_id
    for lp in params["layers"]:
        q = _lin(lp["q"], x).reshape(B, S, H, hd)
        k = _lin(lp["k"], x).reshape(B, S, H, hd)
        v = _lin(lp["v"], x).reshape(B, S, H, hd)
        o = encoder_attention(q, k, v, key_pad)
        o = _lin(lp["attn_out"], o.reshape(B, S, cfg.dim))
        x = layer_norm(lp["attn_ln"], x + o, cfg.ln_eps)
        h = F.gelu(_lin(lp["fc1"], x).float(),
                   approximate="tanh" if cfg.gelu == "tanh" else "none"
                   ).to(x.dtype)
        h = _lin(lp["fc2"], h)
        x = layer_norm(lp["ffn_ln"], x + h, cfg.ln_eps)
        hiddens.append(x)
    if return_all_hiddens:
        return torch.stack(hiddens, dim=2)  # [B, S, L+1, D]
    return x


def roberta_encode_windowed(params: dict, cfg: RobertaConfig,
                            ids: torch.Tensor,
                            return_all_hiddens: bool = True) -> torch.Tensor:
    """Long-article encode: independent non-overlapping windows of at most
    max_positions - 2 tokens, folded into the batch axis, positions
    restarting per window; the feature streams are re-concatenated."""
    B, S = ids.shape
    W = cfg.max_positions - 2
    if S <= W:
        return roberta_encode(params, cfg, ids, return_all_hiddens)
    n_w = -(-S // W)
    idsp = F.pad(ids, (0, n_w * W - S), value=cfg.pad_id)
    out = roberta_encode(params, cfg, idsp.reshape(B * n_w, W),
                         return_all_hiddens)
    return out.reshape((B, n_w * W) + tuple(out.shape[2:]))[:, :S]


class RobertaEncoder(nn.Module):
    """The frozen tower's params as an nn.Module (so .to(device) and
    state_dict() work); forward calls roberta_encode_windowed."""

    def __init__(self, params: dict, cfg: RobertaConfig):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    def frozen(self) -> dict:
        """The {"roberta", "roberta_cfg"} dict encode_contexts takes."""
        return {"roberta": self.params.tree(), "roberta_cfg": self.cfg}

    def forward(self, ids: torch.Tensor,
                return_all_hiddens: bool = True) -> torch.Tensor:
        return roberta_encode_windowed(self.params.tree(), self.cfg, ids,
                                       return_all_hiddens)


def convert_hf_roberta(state_dict: dict, cfg: RobertaConfig) -> dict:
    """A HuggingFace RobertaModel state dict (bare keys) or
    RobertaForMaskedLM one ("roberta."-prefixed), torch tensors or numpy,
    as the port's param tree of fp32 CPU tensors (tell_tpu's
    convert_hf_roberta): dense weights transposed to [in, out]."""
    def get(name):
        for key in (name, "roberta." + name):
            if key in state_dict:
                return torch.as_tensor(state_dict[key]).detach().cpu() \
                    .float().contiguous()
        raise KeyError(name)

    def dense(name):
        return {"w": get(name + ".weight").T.contiguous(),
                "b": get(name + ".bias")}

    def ln(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    params = {
        "word_embed": get("embeddings.word_embeddings.weight"),
        "pos_embed": get("embeddings.position_embeddings.weight"),
        "type_embed": get("embeddings.token_type_embeddings.weight"),
        "embed_ln": ln("embeddings.LayerNorm"),
        "layers": [],
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}."
        params["layers"].append({
            "q": dense(pre + "attention.self.query"),
            "k": dense(pre + "attention.self.key"),
            "v": dense(pre + "attention.self.value"),
            "attn_out": dense(pre + "attention.output.dense"),
            "attn_ln": ln(pre + "attention.output.LayerNorm"),
            "fc1": dense(pre + "intermediate.dense"),
            "fc2": dense(pre + "output.dense"),
            "ffn_ln": ln(pre + "output.LayerNorm"),
        })
    return params
