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
* init_captioner / init_llm_decoder / init_lstm_decoder /
  init_lstm_captioner / init_pointer (with init_self_attention,
  init_copy_attention, init_gated_linear) / init_roberta / init_resnet /
  init_vit / init_mtcnn / init_facenet / init_yolov3: torch-side
  initialisers with the same keys, shapes and
  init distributions as tell_tpu's, drawing from an explicit
  torch.Generator on the generator's device. (The two frameworks
  draw different numbers from one seed; parity tests build weights in JAX
  and carry them across with to_torch.)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .config import CaptionerConfig, DecoderConfig, LLMConfig
from .ops.adaptive import band_ranges
from .ops.dynamic_conv import init_lightweight_conv
from .ops.moe import init_moe_ffn
from .ops.positional import init_learned_positional


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list/tuple tree, in tree order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_leaves_with_path(tree, prefix=()):
    """(path, leaf) of every leaf, in tree order; a path joins the dict
    keys and list indices from the root with "/" (tell_tpu's path
    strings, as "decoder/layers/0/fc1/w")."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


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


def _gehring(g: torch.Generator, din: int, dout: int, bias: bool = True
             ) -> dict:
    """tell_tpu.ops.linear.init_gehring_linear (dropout 0, weight norm):
    v ~ N(0, 1/din), g = ||v|| over axis 0 so the effective weight is v."""
    v = _normal(g, (din, dout), (1.0 / din) ** 0.5)
    p = {"v": v, "g": torch.linalg.vector_norm(v, dim=0)}
    if bias:
        p["b"] = _zeros(g, dout)
    return p


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


def init_lstm_decoder(generator: torch.Generator, cfg: DecoderConfig,
                      num_layers: int = 4, image_dim: int = 2048,
                      article_dim: int = 1024) -> dict:
    """tell_tpu.models.lstm_decoder.init_lstm_decoder: init_decoder's
    embedding and adaptive softmax with no conv layers (kernel_sizes=()),
    and under "lstm" num_layers cells (the first over [x; input feed]) in
    torch LSTMCell's gate order i, f, g, o with W_ih [in, 4H], W_hh
    [H, 4H] and their biases U(-0.1, 0.1), zero initial h and c, the
    image and article attentions (gehring input and output projections)
    and attn_proj. num_layers is 4 whatever cfg.kernel_sizes says, as in
    tell_tpu."""
    g = generator
    H = cfg.embed_dim
    base = init_decoder(g, dataclasses.replace(cfg, kernel_sizes=()))

    def cell(din):
        return {"w_ih": _uniform(g, (din, 4 * H), -0.1, 0.1),
                "w_hh": _uniform(g, (H, 4 * H), -0.1, 0.1),
                "b_ih": _uniform(g, (4 * H,), -0.1, 0.1),
                "b_hh": _uniform(g, (4 * H,), -0.1, 0.1)}

    def attention(source_dim):
        return {"input_proj": _gehring(g, H, source_dim),
                "output_proj": _gehring(g, H + source_dim, H)}

    base["lstm"] = {
        "cells": [cell(2 * H if i == 0 else H) for i in range(num_layers)],
        "h0": [_zeros(g, H) for _ in range(num_layers)],
        "c0": [_zeros(g, H) for _ in range(num_layers)],
        "image_attn": attention(image_dim),
        "article_attn": attention(article_dim),
        "attn_proj": _gehring(g, 2 * H, H),
    }
    return base


def init_lstm_captioner(generator: torch.Generator, cfg: CaptionerConfig
                        ) -> dict:
    """tell_tpu.models.lstm_decoder.init_lstm_captioner: the LSTM decoder
    over the image and article contexts' widths, and bert_weight where
    weigh_bert."""
    d = cfg.decoder
    params = {"decoder": init_lstm_decoder(
        generator, d, image_dim=d.context("image").kv_dim,
        article_dim=d.context("article").kv_dim)}
    if cfg.weigh_bert:
        params["bert_weight"] = _uniform(generator, (cfg.num_bert_layers,),
                                         0.0, 1.0)
    return params


def init_gated_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                      bias: bool = True) -> dict:
    """tell_tpu.ops.self_attention.init_gated_linear."""
    g = generator
    return {"l1": _gehring(g, in_dim, out_dim * 4, bias),
            "l2": _gehring(g, out_dim * 2, out_dim * 2, bias),
            "l3": _gehring(g, out_dim, out_dim, bias)}


def init_self_attention(generator: torch.Generator, dim: int) -> dict:
    """tell_tpu.ops.self_attention.init_self_attention: the gated
    self-attention's q/k/v/out projections and its LayerNorm."""
    g = generator
    return {"in_proj_q": _gehring(g, dim, dim),
            "in_proj_k": _gehring(g, dim, dim),
            "in_proj_v": _gehring(g, dim, dim),
            "out_proj": _gehring(g, dim, dim), "ln": _ln(g, dim)}


def init_copy_attention(generator: torch.Generator, dim: int,
                        kdim: int | None = None) -> dict:
    """tell_tpu.ops.self_attention.init_copy_attention: q/k in-projections
    [in, out] xavier-uniform over the packed [2E, E], zero biases and a
    learned bias-k column N(0, 2 / (1 + E))."""
    g = generator
    kdim = dim if kdim is None else kdim
    bound = (6.0 / (2 * dim + dim)) ** 0.5
    return {"q_w": _uniform(g, (dim, dim), -bound, bound),
            "k_w": _uniform(g, (kdim, dim), -bound, bound),
            "q_b": _zeros(g, dim), "k_b": _zeros(g, dim),
            "bias_k": _normal(g, (dim,), (2.0 / (1 + dim)) ** 0.5)}


def init_pointer(generator: torch.Generator, cfg) -> dict:
    """tell_tpu.models.pointer.init_pointer over a PointerConfig: the
    captioner, the entity head (gated self-attention and a 2-way
    classifier), the copy attention over the article's width, and
    bert_weight_2 where weigh_bert."""
    cap = cfg.captioner
    dim = cap.decoder.embed_dim
    params = {
        "captioner": init_captioner(generator, cap),
        "entity_attn": init_self_attention(generator, dim),
        "entity_fc": _gehring(generator, dim, 2),
        "copy_attn": init_copy_attention(
            generator, dim, kdim=cap.decoder.context("article").kv_dim),
    }
    if cap.weigh_bert:
        params["bert_weight_2"] = _uniform(
            generator, (cap.num_bert_layers,), 0.0, 1.0)
    return params


def init_llm_decoder(generator: torch.Generator, cfg: LLMConfig) -> dict:
    """tell_tpu.models.llm_decoder.init_llm_decoder: the tied embedding
    N(0, 0.02), RMSNorm scales 1, bias-free q/k/v/o (k and v at
    kv_heads * head_dim), the cross-attention per context, context_fc,
    and a SwiGLU (w1, w3, w2) or, with moe_experts, init_moe_ffn's
    stacked experts and router."""
    g = generator
    E, hd = cfg.dim, cfg.head_dim

    def rms():
        return {"scale": torch.ones(E, device=g.device)}

    layers = []
    for _ in range(cfg.num_layers):
        lp = {
            "attn_norm": rms(),
            "self_attn": {"q": _linear(g, E, E, False),
                          "k": _linear(g, E, cfg.kv_heads * hd, False),
                          "v": _linear(g, E, cfg.kv_heads * hd, False),
                          "o": _linear(g, E, E, False)},
            "cross_norm": rms(),
            "attn": {},
            "context_fc": _linear(g, E * len(cfg.contexts), E),
            "ffn_norm": rms(),
            "ffn": (init_moe_ffn(g, E, cfg.ffn_dim, cfg.moe_experts)
                    if cfg.moe_experts else
                    {"w1": _linear(g, E, cfg.ffn_dim, False),
                     "w3": _linear(g, E, cfg.ffn_dim, False),
                     "w2": _linear(g, cfg.ffn_dim, E, False)}),
        }
        for spec in cfg.contexts:
            lp["attn"][spec.name] = _cross_attention(g, E, spec.kv_dim)
        layers.append(lp)
    return {"tok_embed": _normal(g, (cfg.vocab_size, E), 0.02),
            "layers": layers, "final_norm": rms()}


def init_vit(generator: torch.Generator, cfg) -> dict:
    """tell_tpu.models.backbones.vit.init_vit for a ViTConfig
    (tell_tpu_torch.models.backbones.vit.ViTConfig): dense weights
    N(0, 0.02) [in, out] with zero biases, the CLS token 0, the position
    table N(0, 0.02), LayerNorms 1 and 0."""
    g = generator
    D, P = cfg.dim, cfg.patch_size

    def dense(din, dout):
        return {"w": _normal(g, (din, dout), 0.02), "b": _zeros(g, dout)}

    return {
        "patch_embed": dense(P * P * 3, D),
        "cls_token": _zeros(g, D),
        "pos_embed": _normal(g, (cfg.num_tokens, D), 0.02),
        "layers": [{"ln1": _ln(g, D), "q": dense(D, D), "k": dense(D, D),
                    "v": dense(D, D), "attn_out": dense(D, D),
                    "ln2": _ln(g, D), "fc1": dense(D, cfg.ffn_dim),
                    "fc2": dense(cfg.ffn_dim, D)}
                   for _ in range(cfg.num_layers)],
        "final_ln": _ln(g, D),
    }


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


def init_resnet(generator: torch.Generator, cfg) -> dict:
    """tell_tpu.models.backbones.resnet.init_resnet for a ResNetConfig
    (tell_tpu_torch.models.backbones.resnet.ResNetConfig): HWIO conv
    weights He-normal on the fan-out, batch norm folded to scale 1 and
    bias 0."""
    g = generator

    def conv(kh, kw, cin, cout):
        return _normal(g, (kh, kw, cin, cout), (2.0 / (kh * kw * cout)) ** 0.5)

    def bn(c):
        return {"scale": torch.ones(c, device=g.device), "bias": _zeros(g, c)}

    w = cfg.width
    params = {"stem": {"conv": conv(7, 7, 3, w), "bn": bn(w)}, "stages": []}
    cin = w
    for s, n_blocks in enumerate(cfg.block_counts):
        planes = w * (2 ** s)
        cout = planes * 4
        stage = []
        for b in range(n_blocks):
            block = {"conv1": conv(1, 1, cin, planes), "bn1": bn(planes),
                     "conv2": conv(3, 3, planes, planes), "bn2": bn(planes),
                     "conv3": conv(1, 1, planes, cout), "bn3": bn(cout)}
            if b == 0:
                block["down_conv"] = conv(1, 1, cin, cout)
                block["down_bn"] = bn(cout)
            stage.append(block)
            cin = cout
        params["stages"].append(stage)
    return params


def init_mtcnn(generator: torch.Generator) -> dict:
    """tell_tpu.models.backbones.mtcnn.init_mtcnn: facenet-pytorch's P/R/O
    net shapes, conv weights N(0, 0.1) HWIO, dense N(0, 0.05) [in, out],
    biases 0, PReLU slopes 0.25."""
    g = generator

    def conv(cin, cout, k):
        return (_normal(g, (k, k, cin, cout), 0.1), _zeros(g, cout))

    def dense(cin, cout):
        return (_normal(g, (cin, cout), 0.05), _zeros(g, cout))

    def prelu(c):
        return torch.full((c,), 0.25, device=g.device)

    p = {"conv1": conv(3, 10, 3), "prelu1": prelu(10),
         "conv2": conv(10, 16, 3), "prelu2": prelu(16),
         "conv3": conv(16, 32, 3), "prelu3": prelu(32),
         "conv4_1": conv(32, 2, 1), "conv4_2": conv(32, 4, 1)}
    r = {"conv1": conv(3, 28, 3), "prelu1": prelu(28),
         "conv2": conv(28, 48, 3), "prelu2": prelu(48),
         "conv3": conv(48, 64, 2), "prelu3": prelu(64),
         "dense4": dense(576, 128), "prelu4": prelu(128),
         "dense5_1": dense(128, 2), "dense5_2": dense(128, 4)}
    o = {"conv1": conv(3, 32, 3), "prelu1": prelu(32),
         "conv2": conv(32, 64, 3), "prelu2": prelu(64),
         "conv3": conv(64, 64, 3), "prelu3": prelu(64),
         "conv4": conv(64, 128, 2), "prelu4": prelu(128),
         "dense5": dense(1152, 256), "prelu5": prelu(256),
         "dense6_1": dense(256, 2), "dense6_2": dense(256, 4),
         "dense6_3": dense(256, 10)}
    return {"pnet": p, "rnet": r, "onet": o}


def init_facenet(generator: torch.Generator, cfg) -> dict:
    """tell_tpu.models.backbones.facenet.init_facenet for a FaceNetConfig:
    InceptionResnetV1 at its vggface2 shapes, conv weights N(0, 1 / fan_in)
    HWIO, batch norm folded to scale 1 and bias 0."""
    g = generator

    def basic(cin, cout, kh, kw=None):
        kw = kh if kw is None else kw
        return {"conv": _normal(g, (kh, kw, cin, cout),
                                (kh * kw * cin) ** -0.5),
                "scale": torch.ones(cout, device=g.device),
                "bias": _zeros(g, cout)}

    def plain(cin, cout):
        return {"w": _normal(g, (1, 1, cin, cout), cin ** -0.5),
                "b": _zeros(g, cout)}

    def block35():
        return {"branch0": basic(256, 32, 1),
                "branch1.0": basic(256, 32, 1), "branch1.1": basic(32, 32, 3),
                "branch2.0": basic(256, 32, 1), "branch2.1": basic(32, 32, 3),
                "branch2.2": basic(32, 32, 3), "conv2d": plain(96, 256)}

    def block17():
        return {"branch0": basic(896, 128, 1),
                "branch1.0": basic(896, 128, 1),
                "branch1.1": basic(128, 128, 1, 7),
                "branch1.2": basic(128, 128, 7, 1),
                "conv2d": plain(256, 896)}

    def block8():
        return {"branch0": basic(1792, 192, 1),
                "branch1.0": basic(1792, 192, 1),
                "branch1.1": basic(192, 192, 1, 3),
                "branch1.2": basic(192, 192, 3, 1),
                "conv2d": plain(384, 1792)}

    params = {"conv2d_1a": basic(3, 32, 3), "conv2d_2a": basic(32, 32, 3),
              "conv2d_2b": basic(32, 64, 3), "conv2d_3b": basic(64, 80, 1),
              "conv2d_4a": basic(80, 192, 3),
              "conv2d_4b": basic(192, 256, 3)}
    params["repeat_1"] = [block35() for _ in range(cfg.repeats[0])]
    params["mixed_6a"] = {"branch0": basic(256, 384, 3),
                          "branch1.0": basic(256, 192, 1),
                          "branch1.1": basic(192, 192, 3),
                          "branch1.2": basic(192, 256, 3)}
    params["repeat_2"] = [block17() for _ in range(cfg.repeats[1])]
    params["mixed_7a"] = {"branch0.0": basic(896, 256, 1),
                          "branch0.1": basic(256, 384, 3),
                          "branch1.0": basic(896, 256, 1),
                          "branch1.1": basic(256, 256, 3),
                          "branch2.0": basic(896, 256, 1),
                          "branch2.1": basic(256, 256, 3),
                          "branch2.2": basic(256, 256, 3)}
    params["repeat_3"] = [block8() for _ in range(cfg.repeats[2])]
    params["block8"] = block8()
    params["last_linear"] = _normal(g, (1792, cfg.embed_dim), 1792 ** -0.5)
    params["last_bn"] = {"scale": torch.ones(cfg.embed_dim, device=g.device),
                         "bias": _zeros(g, cfg.embed_dim)}
    return params


def init_yolov3(generator: torch.Generator, defs: list[dict]) -> dict:
    """tell_tpu.models.backbones.yolov3.init_yolov3: per conv (int key:
    its module index) an HWIO weight He-normal on the fan-in, batch norm
    folded to scale 1 and bias 0, or a zero bias "b" where the conv has
    no batch norm."""
    from .models.backbones.yolov3 import channel_plan
    g = generator
    channels = channel_plan(defs)
    convs = {}
    for i, d in enumerate(defs):
        if d["type"] != "convolutional":
            continue
        cin, k, cout = channels[i], d["size"], d["filters"]
        p = {"w": _normal(g, (k, k, cin, cout), (2.0 / (k * k * cin)) ** 0.5)}
        if d.get("bn", True):
            p["scale"] = torch.ones(cout, device=g.device)
            p["bias"] = _zeros(g, cout)
        else:
            p["b"] = _zeros(g, cout)
        convs[i] = p
    return {"convs": convs}
