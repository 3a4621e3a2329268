"""Weights carried between the JAX package and the port.

* to_torch / to_numpy: a numpy param tree (as jax.tree.map(np.asarray,
  params) gives it) to a torch tree on a given device, and back. numpy has
  no bfloat16, so bf16 leaves are staged through fp32 both ways.
* tree_leaves / tree_map: the nested dicts and lists of tensors that
  params, gradients and optimizer moments are (jax.tree's counterpart).
* bert_adam_state: a BertAdamState (step, m, v) from either package, as
  the port's state on a device, so both optimizers can start from one.
* ParamTree: an nn.Module that owns such a tree (nested dicts and lists of
  tensors), so .to(device) and state_dict() work on it; tree() gives the
  nested dict back with the module's current tensors.
* init_captioner / init_roberta: torch-side initialisers with the same
  keys, shapes and init distributions as tell_tpu's, drawing from an
  explicit torch.Generator on the generator's device. (The two frameworks
  draw different numbers from one seed; parity tests build weights in JAX
  and carry them across with to_torch.)
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .config import CaptionerConfig, DecoderConfig
from .ops.adaptive import band_ranges
from .ops.dynamic_conv import init_lightweight_conv
from .ops.positional import init_learned_positional


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple tree, in tree order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _rebuild(tree, items):
    """A list, tuple or named tuple of tree's type holding `items`."""
    items = list(items)
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else type(tree)(items)


def tree_map(fn, tree, *rest):
    """fn over corresponding leaves of trees with tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, (tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)))
    return fn(tree, *rest)


def to_torch(tree, device):
    """numpy (or torch) leaves -> torch tensors on `device`; dicts, lists
    and tuples are rebuilt; other leaves (configs, ints) pass through."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, (to_torch(v, device) for v in tree))
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if hasattr(tree, "__array__") and hasattr(tree, "dtype"):
        a = np.asarray(tree)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)
    return tree


def to_numpy(tree):
    """torch leaves -> numpy arrays (bf16 comes back as fp32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, (to_numpy(v) for v in tree))
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree


def bert_adam_state(state, device):
    """A BertAdamState (step, m, v) of either package (numpy, JAX or torch
    leaves) as the port's BertAdamState on `device`; to_numpy(state) goes
    back, as a (step, m, v) tuple that tell_tpu's BertAdamState(*...)
    takes."""
    from .training.optimizer import BertAdamState
    step, m, v = state
    return BertAdamState(to_torch(np.asarray(step, np.int32), device),
                         to_torch(m, device), to_torch(v, device))


class ParamTree(nn.Module):
    """A nested params dict/list held as child modules and frozen
    Parameters; list entries are named "0", "1", ... as in nn.Sequential,
    so state_dict keys read like the JAX tree paths."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        items = enumerate(tree) if self._is_list else tree.items()
        self._names = []
        for key, val in items:
            name = str(key)
            if isinstance(val, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))
            elif isinstance(val, (dict, list, tuple)):
                self.add_module(name, ParamTree(val))
            else:
                raise TypeError(f"param leaf {name!r} is a {type(val)}, "
                                "not a tensor")
            self._names.append(name)

    def tree(self):
        vals = []
        for name in self._names:
            v = getattr(self, name)
            vals.append(v.tree() if isinstance(v, ParamTree) else v)
        return vals if self._is_list else dict(zip(self._names, vals))


# ---------------------------------------------------------------------------
# torch-side initialisers mirroring tell_tpu's init_* functions
# ---------------------------------------------------------------------------

def _normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * std


def _uniform(g: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def _zeros(g: torch.Generator, *shape) -> torch.Tensor:
    return torch.zeros(shape, device=g.device)


def _ln(g: torch.Generator, dim: int) -> dict:
    return {"scale": torch.ones(dim, device=g.device), "bias": _zeros(g, dim)}


def _linear(g: torch.Generator, din: int, dout: int, bias: bool = True
            ) -> dict:
    """tell_tpu.ops.linear.init_linear (xavier uniform)."""
    bound = (6.0 / (din + dout)) ** 0.5
    p = {"w": _uniform(g, (din, dout), -bound, bound)}
    if bias:
        p["b"] = _zeros(g, dout)
    return p


def _gehring(g: torch.Generator, din: int, dout: int) -> dict:
    """tell_tpu.ops.linear.init_gehring_linear (dropout 0, weight norm):
    v ~ N(0, 1/din), g = ||v|| over axis 0 so the effective weight is v."""
    v = _normal(g, (din, dout), (1.0 / din) ** 0.5)
    return {"v": v, "g": torch.linalg.vector_norm(v, dim=0),
            "b": _zeros(g, dout)}


def _cross_attention(g: torch.Generator, E: int, kv_dim: int) -> dict:
    """tell_tpu.ops.attention.init_cross_attention (bias_kv on)."""
    std = (2.0 / (1 + E)) ** 0.5
    return {"q_proj": _linear(g, E, E), "k_proj": _linear(g, kv_dim, E),
            "v_proj": _linear(g, kv_dim, E), "out_proj": _linear(g, E, E),
            "bias_k": _normal(g, (E,), std), "bias_v": _normal(g, (E,), std)}


def _decoder_layer(g: torch.Generator, cfg: DecoderConfig, kernel_size: int
                   ) -> dict:
    E = cfg.embed_dim
    conv_in = 2 * cfg.conv_dim if cfg.glu else cfg.conv_dim
    if cfg.conv_type == "dynamic":
        conv = {"weight_linear": _linear(
            g, cfg.conv_dim, cfg.num_heads * kernel_size, bias=False)}
    else:
        conv = init_lightweight_conv(g, kernel_size, cfg.num_heads)
    return {
        "linear1": _gehring(g, E, conv_in),
        "conv": conv,
        "linear2": _gehring(g, cfg.conv_dim, E),
        "conv_ln": _ln(g, E),
        "attn": {c.name: _cross_attention(g, E, c.kv_dim)
                 for c in cfg.contexts},
        "attn_ln": {c.name: _ln(g, E) for c in cfg.contexts},
        "context_fc": _gehring(g, E * len(cfg.contexts), E),
        "fc1": _gehring(g, E, cfg.ffn_dim),
        "fc2": _gehring(g, cfg.ffn_dim, E),
        "final_ln": _ln(g, E),
    }


def init_decoder(generator: torch.Generator, cfg: DecoderConfig) -> dict:
    """tell_tpu.models.decoder.init_decoder: the dynamic or lightweight
    conv, the learned position table where cfg.positional is "learned",
    and the final LayerNorm where normalize_before and final_norm."""
    g = generator
    E = cfg.embed_dim
    bands = []
    for i, (lo, hi) in enumerate(band_ranges(cfg.full_cutoffs)):
        d = int(E // (cfg.adaptive_factor ** i))
        embed = _normal(g, (hi - lo, d), d ** -0.5)
        if 0 <= cfg.embed_padding_idx < hi - lo:
            embed[cfg.embed_padding_idx] = 0.0
        bands.append({"embed": embed, "proj": _linear(g, d, E, False)["w"]})
    n_tails = len(cfg.full_cutoffs) - 1
    params = {
        "embed": {"bands": bands},
        "adaptive_softmax": {
            "class_proj": _linear(g, E, n_tails, bias=False),
            "tail_projs": [
                _linear(g, E, int(E // (cfg.adaptive_factor ** (i + 1))),
                        bias=False) for i in range(n_tails)],
        },
        "layers": [_decoder_layer(g, cfg, k) for k in cfg.kernel_sizes],
    }
    if cfg.normalize_before and cfg.final_norm:
        params["final_ln"] = _ln(g, E)
    if cfg.positional == "learned":
        params["pos_embed"] = init_learned_positional(
            g, cfg.max_target_positions + cfg.pad_id + 2, E,
            padding_idx=cfg.pad_id)
    return params


def init_captioner(generator: torch.Generator, cfg: CaptionerConfig
                   ) -> dict:
    """tell_tpu.models.captioner.init_captioner."""
    params = {"decoder": init_decoder(generator, cfg.decoder)}
    if cfg.weigh_bert:
        params["bert_weight"] = _uniform(generator, (cfg.num_bert_layers,),
                                         0.0, 1.0)
    return params


def init_roberta(generator: torch.Generator, rcfg) -> dict:
    """tell_tpu.models.backbones.roberta.init_roberta for a RobertaConfig
    (tell_tpu_torch.models.backbones.roberta.RobertaConfig)."""
    g = generator
    D = rcfg.dim

    def dense(din, dout):
        return {"w": _normal(g, (din, dout), 0.02), "b": _zeros(g, dout)}

    return {
        "word_embed": _normal(g, (rcfg.vocab_size, D), 0.02),
        "pos_embed": _normal(g, (rcfg.max_positions, D), 0.02),
        "type_embed": _zeros(g, 1, D),
        "embed_ln": _ln(g, D),
        "layers": [{
            "q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
            "attn_out": dense(D, D), "attn_ln": _ln(g, D),
            "fc1": dense(D, rcfg.ffn_dim), "fc2": dense(rcfg.ffn_dim, D),
            "ffn_ln": _ln(g, D),
        } for _ in range(rcfg.num_layers)],
    }
