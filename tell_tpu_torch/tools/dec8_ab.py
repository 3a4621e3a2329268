"""A/B the int8 decode levers at the flagship's beam shape, in one process
(counterpart of the JAX package's tools/dec8_ab.py).

    python -m tell_tpu_torch.tools.dec8_ab [--arms base,sm,dec8,sm+dec8]
        [--B 128] [--beam 5] [--gen-len 100] [--S 512] [--rounds 3]
        [--device cuda] [--seed 0] [--small]

The flagship CaptionerConfig() at gen_len 100, random weights from the
seed cast to bf16, a batch of B random contexts (image 49 x 2048, an
S-token article, 4 faces, 64 objects, bf16) and one beam_search(beam 5,
early_stop=False: every step of every row runs, as the JAX tool's) per
call. The arms: base (the fp path), sm (dec8_sm: the softmax tables in
int8), dec8 (the step's projections in int8) and sm+dec8; each call
builds its arm's tables, as tell_tpu's jitted search does. Each arm is
warmed up once, then the arms are timed in turns, `rounds` times
(base, sm, dec8, sm+dec8, base, ...), so a drift of the card's clock
spreads over all of them. A call's time is CUDA events around it on the
card (the host clock on the CPU: tools/timing.py); captions/s = B / its
seconds. Prints one line per call and, last, each arm's median, min and
max, and returns them. --small takes the CPU tests' small_test_config.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys

import torch

from ..bridge import init_captioner, tree_map
from ..config import CaptionerConfig, small_test_config
from ..models.beam import beam_search
from .timing import clock_name, device_ms

DTYPE = torch.bfloat16
ARMS = {"base": {}, "sm": {"dec8_sm": True}, "dec8": {"dec8": True},
        "sm+dec8": {"dec8_sm": True, "dec8": True}}


def setup(cfg, B: int, S: int, device, seed: int) -> tuple[dict, dict]:
    """bf16 weights and a batch of B random contexts with an S-token
    article (the JAX tool's shapes)."""
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
    return params, batch


def run(arms=tuple(ARMS), B: int = 128, beam: int = 5, gen_len: int = 100,
        S: int = 512, rounds: int = 3, device="cuda", seed: int = 0,
        small: bool = False) -> dict:
    """{arm: {"captions_per_s": [each call's], "median", "min", "max"}}."""
    for arm in arms:
        if arm not in ARMS:
            raise ValueError(f"arm {arm!r} not in {tuple(ARMS)}")
    base = (small_test_config(max_target_positions=gen_len) if small
            else CaptionerConfig())
    cfg = dataclasses.replace(base, gen_len=gen_len)
    out = {arm: {"captions_per_s": []} for arm in arms}
    with torch.inference_mode():
        params, batch = setup(cfg, B, S, device, seed)

        def call(arm):
            return beam_search(params, cfg, batch, beam_size=beam,
                               early_stop=False, **ARMS[arm])

        print(f"B={B} beam={beam} gen_len={gen_len} S={S} bf16 "
              f"[{clock_name(device)}]", flush=True)
        for arm in arms:
            call(arm)                                        # warm-up
        for r in range(rounds):
            for arm in arms:
                ms = device_ms(lambda: call(arm), device, calls=1, warmup=0)
                cps = B / (ms / 1e3)
                out[arm]["captions_per_s"].append(cps)
                print(f"round {r} {arm:8s} {ms:10.1f} ms  {cps:8.2f} "
                      "captions/s", flush=True)
    for arm in arms:
        v = out[arm]["captions_per_s"]
        out[arm].update(median=statistics.median(v), min=min(v), max=max(v))
        print(f"ARM {arm:8s} median {out[arm]['median']:8.2f} captions/s "
              f"(min {out[arm]['min']:.2f}, max {out[arm]['max']:.2f}, "
              f"{len(v)} calls)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--B", type=int, default=128)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--gen-len", type=int, default=100)
    ap.add_argument("--S", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true",
                    help="small_test_config (the CPU tests' size)")
    args = ap.parse_args(argv)
    run(args.arms.split(","), args.B, args.beam, args.gen_len, args.S,
        args.rounds, args.device, args.seed, args.small)
    return 0


if __name__ == "__main__":
    sys.exit(main())
