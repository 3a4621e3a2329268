"""Dynamic int8 (w8a8) dense layers (counterpart of tell_tpu/ops/quant.py).

Both sides of a dense matmul are quantised:

* weights: per-output-channel symmetric int8, quantised once, offline
  (quantize_dense / quantize_roberta): the frozen tower has no gradient
  path to keep;
* activations: per-row dynamic symmetric int8, computed on every call;
* the contraction runs int8 x int8 -> int32 (kernel G on the card,
  ops/kernels/int8_linear.py), and the two scale vectors factor back out
  in fp32: y = (xq @ wq) * sx[:, None] * sw[None, :] + b.

The only approximation is the int8 rounding of x and w (about 1e-2
relative per matmul). Every lever is an explicit argument here: the frozen
encoder's (enc8: maybe_quantize_frozen, `--enc8` on the command line), the
decode step's and the softmax tables' (models/decoder.py). tell_tpu reads
TELL_TPU_ENC8 from the environment instead.

A quantised dense leaf is {"q8": int8 [dout, din], "scale": fp32 [dout],
"b": fp32 [dout]}: the int8 values are tell_tpu's "q8" transposed, each
output channel's din values contiguous, the layout kernel G's tensor-core
operand reads. It is made once, here, so no call transposes a weight.
"""
from __future__ import annotations

import torch

from .kernels.int8_linear import int8_linear as _int8_linear
from .kernels.int8_linear import int8_scale, quantize_rows

_QUANTIZED = ("q", "k", "v", "attn_out", "fc1", "fc2")


def quantize_weight_int8(w: torch.Tensor, exact_div: bool = False) -> dict:
    """w [din, dout] -> {"q8": int8 [dout, din], "scale": fp32 [dout]}.
    Each column j is scaled by max(amax_j, 1e-8) / 127 and rounded by a
    true division, half to even (tell_tpu's quantize_weight_int8; the
    values are its "q8" transposed). The scale's division by 127 is a
    product with fp32(1/127), as XLA compiles it inside tell_tpu's jitted
    decode, where its decode tables are made; exact_div keeps the true
    division of its eager load-time quantisation (kernels/int8_linear.py's
    int8_scale)."""
    w32 = w.float()
    scale = int8_scale(w32.abs().amax(dim=0), exact_div)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q8": q.T.contiguous(), "scale": scale}


def quantize_act_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., din] -> (int8 values, fp32 scales [..., 1]): per-row dynamic
    quantisation, kernel G's first launch on the card."""
    return quantize_rows(x)


def int8_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A dense layer with a quantised weight dict ({"q8", "scale"[, "b"]}):
    the per-row activation quant, the int8 contraction and the fp32
    rescale and bias (kernel G on the card). Returns x's dtype."""
    return _int8_linear(x, p["q8"], p["scale"], p.get("b"))


def is_quantized_dense(p) -> bool:
    return isinstance(p, dict) and "q8" in p


def quantize_dense(p: dict) -> dict:
    """{"w"[, "b"]} -> {"q8", "scale"[, "b" fp32]}; a quantised dict comes
    back as it is. Its scales divide by 127, as tell_tpu's load-time
    quantisation does, outside jit."""
    if is_quantized_dense(p):
        return p
    out = quantize_weight_int8(p["w"], exact_div=True)
    if "b" in p:
        out["b"] = p["b"].float()
    return out


def quantize_roberta(params: dict) -> dict:
    """Every per-layer dense matmul of a RoBERTa tree (q/k/v/attn_out/fc1/
    fc2) in int8; the embeddings and LayerNorms stay as they are (the same
    tensors). Idempotent. The encode (models/backbones/roberta.py)
    dispatches on the "q8" leaf, so the quantised tower goes wherever a
    frozen tower is accepted."""
    out = dict(params)
    out["layers"] = [{k: quantize_dense(v) if k in _QUANTIZED else v
                      for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def map_tree_preserving_quant(fn, tree):
    """fn over a tree's leaves, leaving quantised dense dicts ({"q8", ...})
    whole: a blanket fp32 -> bf16 cast must not round the fp32 scales
    (0.4% relative on top of the int8 rounding, for nothing)."""
    if isinstance(tree, dict):
        if "q8" in tree:
            return tree
        return {k: map_tree_preserving_quant(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [map_tree_preserving_quant(fn, v) for v in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return fn(tree)


def maybe_quantize_frozen(frozen: dict, enc8: bool) -> dict:
    """The frozen towers with frozen["roberta"] quantised when enc8 is on
    (tell_tpu's TELL_TPU_ENC8 lever), else `frozen` itself. Called once,
    where a tower is loaded (quantising per step would re-round 355M
    params a call)."""
    if not enc8 or "roberta" not in frozen:
        return frozen
    return {**frozen, "roberta": quantize_roberta(frozen["roberta"])}
