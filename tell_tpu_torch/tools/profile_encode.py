"""Where the time of the RoBERTa article encode goes on the card.

    python -m tell_tpu_torch.tools.profile_encode [--B 8] [--S 512]
        [--dtype float32] [--lens 512,480,...] [--device cuda] [--seed 0]
        [--enc8 | --ab] [--small]

roberta_encode (all hidden states, as encode_contexts asks for them) of B
rows of S token ids with RobertaConfig.large() and random weights from the
seed, cast to the dtype. --lens gives each row's real tokens (cycled over
the rows; the rest are pads; default: every row full). --enc8 encodes with
the int8 tower (ops/quant.py's quantize_roberta on the cast tower, as the
enc8 lever quantises it: its six dense layers a layer on kernel G); --ab
runs the fp tower and the int8 one in turns, fp, enc8, enc8, fp, so a
drift of the card's clock falls on both. After two warm-up encodes each
run prints, for five encodes: ms per encode (CUDA events, or the host
clock on the CPU), the device time per encode from torch.profiler (card
only) and its share of the encode (busy share), kernel B's and kernel G's
device time and share, and the five largest device consumers; --small
takes RobertaConfig.tiny() (2 layers) for a rehearsal on the CPU.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..bridge import init_roberta, tree_map
from ..models.backbones.roberta import RobertaConfig, roberta_encode
from ..ops.quant import quantize_roberta
from .timing import clock_name, device_ms, profiled_device_ms

CALLS = 5


def encode_fns(B: int, S: int, dtype: torch.dtype, lens: list[int], device,
               seed: int, small: bool) -> dict:
    """Zero-argument encodes of one fixed batch: "fp" with the tower cast
    to dtype, "enc8" with that tower quantised (made on first use)."""
    cfg = RobertaConfig.tiny() if small else RobertaConfig.large()
    g = torch.Generator(device=device).manual_seed(seed)
    params = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                      init_roberta(g, cfg))
    ids = torch.randint(3, cfg.vocab_size, (B, S), generator=g,
                        device=device)
    n = torch.tensor([lens[i % len(lens)] for i in range(B)], device=device)
    ids[torch.arange(S, device=device)[None, :] >= n[:, None]] = cfg.pad_id
    towers = {"fp": params}

    def fn(arm):
        def encode():
            if arm not in towers:
                towers[arm] = quantize_roberta(params)
            with torch.inference_mode():
                return roberta_encode(towers[arm], cfg, ids)
        return encode
    return {arm: fn(arm) for arm in ("fp", "enc8")}


def profile(fn, device, label: str) -> str:
    """One run's line: events time, and on the card the device time by
    kernel, kernels B's and G's shares and the five largest."""
    fn()
    ms = device_ms(fn, device, calls=CALLS, warmup=1)
    line = f"{label}: {ms:.2f} ms per encode ({clock_name(device)})"
    if torch.device(device).type == "cuda":
        by_kernel = profiled_device_ms(fn, calls=CALLS, warmup=1)
        total = sum(by_kernel.values())
        b_ms = sum(t for k, t in by_kernel.items() if "encoder_attention" in k)
        g_ms = sum(t for k, t in by_kernel.items()
                   if "quant_rows" in k or "gemm_kernel" in k)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
        line += (f"; device {total:.2f} ms ({total / ms:.1%} busy); kernel B "
                 f"{b_ms:.3f} ms ({b_ms / total:.1%} of device time); kernel "
                 f"G {g_ms:.3f} ms ({g_ms / total:.1%}); largest: "
                 + "; ".join(f"{k[:60]} {t:.2f} ms" for k, t in top))
    return line


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
    arms = ap.add_mutually_exclusive_group()
    arms.add_argument("--enc8", action="store_true",
                      help="the int8 tower (kernel G)")
    arms.add_argument("--ab", action="store_true",
                      help="fp and enc8 in turns: fp, enc8, enc8, fp")
    args = ap.parse_args(argv)
    lens = [int(x) for x in args.lens.split(",") if x] or [args.S]
    fns = encode_fns(args.B, args.S, getattr(torch, args.dtype), lens,
                     args.device, args.seed, args.small)
    order = (("fp", "enc8", "enc8", "fp") if args.ab
             else ("enc8",) if args.enc8 else ("fp",))
    for arm in order:
        print(profile(fns[arm], args.device,
                      f"profile_encode: B={args.B} S={args.S} {args.dtype} "
                      f"{arm} lens {lens}"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
