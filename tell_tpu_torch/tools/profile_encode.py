"""Where the time of the RoBERTa article encode goes on the card.

    python -m tell_tpu_torch.tools.profile_encode [--B 8] [--S 512]
        [--dtype float32] [--lens 512,480,...] [--device cuda] [--seed 0]
        [--small]

roberta_encode (all hidden states, as encode_contexts asks for them) of B
rows of S token ids with RobertaConfig.large() and random weights from the
seed, cast to the dtype. --lens gives each row's real tokens (cycled over
the rows; the rest are pads; default: every row full). After two warm-up
encodes it prints, for five encodes: ms per encode (CUDA events, or the
host clock on the CPU), the device time per encode from torch.profiler
(card only) and its share of the encode (busy share), kernel B's device
time and share, and the five largest device consumers; --small takes
RobertaConfig.tiny() (2 layers) for a rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..bridge import init_roberta, tree_map
from ..models.backbones.roberta import RobertaConfig, roberta_encode
from .timing import clock_name, device_ms, profiled_device_ms

CALLS = 5


def encode_fn(B: int, S: int, dtype: torch.dtype, lens: list[int], device,
              seed: int, small: bool):
    """A zero-argument encode of one fixed batch."""
    cfg = RobertaConfig.tiny() if small else RobertaConfig.large()
    g = torch.Generator(device=device).manual_seed(seed)
    params = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                      init_roberta(g, cfg))
    ids = torch.randint(3, cfg.vocab_size, (B, S), generator=g,
                        device=device)
    n = torch.tensor([lens[i % len(lens)] for i in range(B)], device=device)
    ids[torch.arange(S, device=device)[None, :] >= n[:, None]] = cfg.pad_id

    def fn():
        with torch.inference_mode():
            return roberta_encode(params, cfg, ids)
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--S", type=int, default=512)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--lens", default="",
                    help="comma-separated real tokens per row (cycled)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    lens = [int(x) for x in args.lens.split(",") if x] or [args.S]
    fn = encode_fn(args.B, args.S, getattr(torch, args.dtype), lens,
                   args.device, args.seed, args.small)
    fn()
    ms = device_ms(fn, args.device, calls=CALLS, warmup=1)
    line = (f"profile_encode: B={args.B} S={args.S} {args.dtype} lens "
            f"{lens}: {ms:.2f} ms per encode ({clock_name(args.device)})")
    if torch.device(args.device).type == "cuda":
        by_kernel = profiled_device_ms(fn, calls=CALLS, warmup=1)
        total = sum(by_kernel.values())
        b_ms = sum(t for k, t in by_kernel.items() if "encoder_attention" in k)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
        line += (f"; device {total:.2f} ms ({total / ms:.1%} busy); kernel B "
                 f"{b_ms:.3f} ms ({b_ms / total:.1%} of device time); "
                 "largest: " + "; ".join(f"{k[:60]} {t:.2f} ms"
                                         for k, t in top))
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
