"""A/B of the decode-attention kernels (counterpart of the JAX package's
tools/kernel_variants.py).

    python -m tell_tpu_torch.tools.kernel_variants [--variant batched]
        [--B 64] [--S 640] [--device cuda] [--seed 0]

At the production head shape (H=16, hd=64, MG=20: 4 modalities x beam 5)
in bf16, with q, K and V from the seed and an all-zero bias:

  current   kernel A, the port's decode attention
  batched   kernel F, bb=2 (the single-shot form; the TPU kernel's two
            batch rows a grid step, which change no bit on the card)
  batched4  kernel F, bb=4
  q8        kernel D over the int8 cache
  q4        kernel D over the packed int4 cache
  q4split   kernel F's int4-split form, bb=2
  all       each of the above in turn

For each variant: the max abs error against the kernel's plain version on
the same inputs (limit BF16_ATOL times the larger of 1 and the output's
largest magnitude: both outputs are rounded to bf16, whose ulp grows with
the value), then the time of 100 calls (tools/timing.py), the K/V bytes
one call streams, GB/s and the share of the H100's 3.35 TB/s. On the CPU
every variant is its plain version on the host clock, and the line says so.
"""
from __future__ import annotations

import argparse
import functools
import sys

import torch

from ..models.decoder import quantize_kv, quantize_kv4
from ..ops.kernels.decode_attention import (
    decode_attention, decode_attention_plain, decode_attention_q4split,
    decode_attention_q8, decode_attention_q8_plain, decode_attention_single)
from .timing import HBM_BYTES_PER_S, clock_name, device_ms

H, HD, MG = 16, 64, 20
VARIANTS = ("current", "batched", "batched4", "q8", "q4", "q4split")
BF16_ATOL = 2e-2
CALLS = 100


def make_inputs(B: int, S: int, device, seed: int) -> list[torch.Tensor]:
    """q [B, H, MG, hd], k, v [B, H, hd, S] from the seed (unit normal, as
    the JAX tools draw them) in bf16, and a zero bias [B, MG, S]."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, MG, HD, generator=g)
    k = torch.randn(B, H, HD, S, generator=g)
    v = torch.randn(B, H, HD, S, generator=g)
    return ([t.to(device=device, dtype=torch.bfloat16) for t in (q, k, v)]
            + [torch.zeros(B, MG, S, device=device)])


def variant_call(variant: str, q, k, v, bias):
    """(kernel wrapper, plain version, its arguments, K/V bytes per call,
    the kernel's name) for one variant."""
    if variant in ("q8", "q4", "q4split"):
        quant = quantize_kv if variant == "q8" else quantize_kv4
        (k8, ks), (v8, vs) = quant(k.float()), quant(v.float())
        args = (q, k8, ks, v8, vs, bias)
        kv_bytes = 2 * (k8.numel() + 4 * ks.numel())
        if variant == "q4split":
            return (functools.partial(decode_attention_q4split, bb=2),
                    decode_attention_q8_plain, args, kv_bytes,
                    "kernel F int4-split, bb=2")
        return (decode_attention_q8, decode_attention_q8_plain, args,
                kv_bytes, f"kernel D {'int8' if variant == 'q8' else 'int4'}")
    kv_bytes = 2 * k.numel() * k.element_size()
    fns = {"current": (decode_attention, "kernel A"),
           "batched": (functools.partial(decode_attention_single, bb=2),
                       "kernel F, bb=2"),
           "batched4": (functools.partial(decode_attention_single, bb=4),
                        "kernel F, bb=4")}
    if variant not in fns:
        raise SystemExit(f"unknown variant {variant!r}; one of "
                         f"{', '.join(VARIANTS)} or all")
    fn, name = fns[variant]
    return fn, decode_attention_plain, (q, k, v, bias), kv_bytes, name


def max_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, its limit) of a bf16 or fp32 output against its
    plain version's."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, BF16_ATOL * max(1.0, ref.float().abs().max().item())


def run(variant: str, B: int = 64, S: int = 640, device="cuda",
        seed: int = 0) -> dict:
    """One variant: error against the plain version, then the time of
    CALLS calls. Prints the tool's two lines and returns the numbers."""
    q, k, v, bias = make_inputs(B, S, device, seed)
    fn, plain, args, kv_bytes, kernel = variant_call(variant, q, k, v, bias)
    on_card = torch.device(device).type == "cuda"
    err, limit = max_err(fn(*args), plain(*args))
    ok = err <= limit
    print(f"{variant}: max abs err vs plain = {err:.4g} (limit {limit:.4g})"
          f"{'' if ok else ' FAILED'}", flush=True)
    ms = device_ms(lambda: fn(*args), device, CALLS)
    line = (f"{variant}: {ms * CALLS:.3f} ms per {CALLS} calls "
            f"({ms:.4f} ms/call, B={B} S={S}); K/V {kv_bytes / 1e6:.1f} MB "
            "per call")
    out = {"variant": variant, "kernel": kernel if on_card else "plain",
           "B": B, "S": S, "err": err, "limit": limit, "ok": ok, "ms": ms,
           "kv_bytes": kv_bytes}
    if on_card:
        rate = kv_bytes / (ms * 1e-3)
        out.update(gb_s=rate / 1e9, hbm_share=rate / HBM_BYTES_PER_S)
        line += (f", {rate / 1e9:.0f} GB/s, {rate / HBM_BYTES_PER_S:.1%} of "
                 f"3.35 TB/s; {kernel}")
    print(f"{line} [{clock_name(device)}]", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="batched",
                    help=f"one of {', '.join(VARIANTS)} or all")
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--S", type=int, default=640)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    variants = VARIANTS if args.variant == "all" else (args.variant,)
    with torch.inference_mode():
        results = [run(v, args.B, args.S, args.device, args.seed)
                   for v in variants]
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
