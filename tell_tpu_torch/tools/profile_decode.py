"""Ablation timing of the decode step (counterpart of the JAX package's
tools/profile_decode.py).

    python -m tell_tpu_torch.tools.profile_decode [--B 320] [--K 1]
        [--S 512] [--device cuda] [--seed 0] [--small]

The flagship CaptionerConfig() with random weights from the seed, cast to
bf16 as the JAX tool casts them, B captions x K beams of decode rows over
an S-token article, and four ablations of 100 steps each, eager loops over
the port's ops:

  decoder_step only           the step, tokens fixed
  decoder_step + top_k        the step, then decoder_top_k(k=5) feeding
                              the best id back
  adaptive top_k only         decoder_top_k on fixed step features
  conv/proj/FFN chain only    decoder_step itself with its attention
                              block swapped for the identity: embedding,
                              linear1, GLU, dynamic_conv_step, linear2,
                              LayerNorm, context_fc on the tiled row, FFN,
                              LayerNorm

Each is run once to warm up, then timed over its 100 steps
(tools/timing.py); --small takes the CPU tests' small_test_config
(with room for the 100 positions).
"""
from __future__ import annotations

import argparse
import sys
from unittest import mock

import torch

from ..bridge import init_captioner, tree_map
from ..config import CaptionerConfig, small_test_config
from ..models import decoder
from ..models.captioner import build_contexts
from ..models.decoder import decoder_step, decoder_top_k, init_decode_state
from .timing import clock_name, device_ms

STEPS = 100
DTYPE = torch.bfloat16


def setup(cfg: CaptionerConfig, B: int, K: int, S: int, device,
          seed: int) -> dict:
    """bf16 weights, a batch of B contexts with an S-token article, its
    decode state for K beams, and fixed step features for the top-k."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = tree_map(lambda t: t.to(DTYPE) if t.dtype == torch.float32
                      else t, init_captioner(g, cfg))
    batch = {"article_mask": torch.zeros(B, S, dtype=torch.bool,
                                         device=device)}
    keys = {"image": "image_grid", "article": "article",
            "faces": "face_embeds", "obj": "obj_embeds"}
    for c in cfg.decoder.contexts:
        n = S if c.name == "article" else c.max_len
        batch[keys[c.name]] = torch.randn(B, n, c.kv_dim, generator=g,
                                          device=device).to(DTYPE)
    contexts = build_contexts(params, cfg, batch)
    state = init_decode_state(params["decoder"], cfg.decoder, contexts, B,
                              beam=K, dtype=DTYPE)
    feats = torch.randn(B * K, cfg.decoder.embed_dim, generator=g,
                        device=device).to(DTYPE)
    return {"params": params["decoder"], "dcfg": cfg.decoder,
            "state": state, "feats": feats, "rows": B * K}


def step_only(env: dict) -> torch.Tensor:
    toks = torch.zeros(env["rows"], dtype=torch.long,
                       device=env["feats"].device)
    st = env["state"]
    for _ in range(STEPS):
        feats, st = decoder_step(env["params"], env["dcfg"], toks, st)
    return feats


def step_topk(env: dict) -> torch.Tensor:
    toks = torch.zeros(env["rows"], dtype=torch.long,
                       device=env["feats"].device)
    st = env["state"]
    for _ in range(STEPS):
        feats, st = decoder_step(env["params"], env["dcfg"], toks, st)
        lp, ids = decoder_top_k(env["params"], env["dcfg"], feats, 5)
        toks = ids[:, 0]
    return lp


def topk_only(env: dict) -> torch.Tensor:
    for _ in range(STEPS):
        lp, _ = decoder_top_k(env["params"], env["dcfg"], env["feats"], 5)
    return lp


def _identity_branches(cfg, x: torch.Tensor, cat: dict,
                       need_weights: bool = False) -> tuple:
    """Stands in for decoder._attn_group: every context's branch is the
    query row itself, [B, G, E] -> ([B, M, G, E], no maps)."""
    return x[:, None].expand(-1, len(cfg.contexts), -1, -1), None


def conv_chain_only(env: dict) -> torch.Tensor:
    """decoder_step with its attention block replaced by the identity, so
    context_fc takes the row tiled once per context."""
    with mock.patch.object(decoder, "_attn_group", _identity_branches):
        return step_only(env)


ABLATIONS = (("decoder_step only", step_only),
             ("decoder_step + top_k", step_topk),
             ("adaptive top_k only", topk_only),
             ("conv/proj/FFN chain only", conv_chain_only))


def run(B: int = 320, K: int = 1, S: int = 512, device="cuda",
        seed: int = 0, small: bool = False) -> dict:
    """Times the four ablations; prints one line each and returns
    {name: ms per STEPS steps}."""
    cfg = (small_test_config(max_target_positions=STEPS) if small
           else CaptionerConfig())
    with torch.inference_mode():
        env = setup(cfg, B, K, S, device, seed)
        print(f"B={B} K={K} S={S} rows={env['rows']} bf16 "
              f"[{clock_name(device)}]", flush=True)
        out = {}
        for name, fn in ABLATIONS:
            ms = device_ms(lambda: fn(env), device, calls=1, warmup=1)
            out[name] = ms
            print(f"{name + f' x{STEPS}':40s} {ms:9.1f} ms  "
                  f"({ms / STEPS:6.2f} ms/step)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--B", type=int, default=320)
    ap.add_argument("--K", type=int, default=1)
    ap.add_argument("--S", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true",
                    help="small_test_config (the CPU tests' size)")
    args = ap.parse_args(argv)
    run(args.B, args.K, args.S, args.device, args.seed, args.small)
    return 0


if __name__ == "__main__":
    sys.exit(main())
