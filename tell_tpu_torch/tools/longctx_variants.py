"""A/B of decode attention at long context (counterpart of the JAX
package's tools/longctx_variants.py).

    python -m tell_tpu_torch.tools.longctx_variants [--variant tiled]
        [--B 64] [--S 2048] [--device cuda] [--seed 0]

At the production head shape (H=16, hd=64, MG=20) and a long source S, in
bf16 with q, K and V from the seed and an all-zero bias:

  dispatch  what the port's decode path runs: kernel A
  tiled     the S-tiled form: kernel A, the same kernel (the port has
            one path for every S, its chunk fixed at 256 columns, so --BB
            and --TS, the TPU tiled kernel's tile, are refused)
  single1   kernel F at bb=1, the single-shot form (on kernel A's
            chunks, so it takes any S; the JAX tool asserts that the
            TPU's _pick_bb finds a fit, and "fits" in the result is True)
  jnp       the plain version

Each prints the max abs error against the plain version on the same
inputs (kernel_variants' limit), the time of 100 calls (tools/timing.py)
and the K/V stream in GB/s. On the CPU every variant is its plain version
on the host clock, and the line says so.
"""
from __future__ import annotations

import argparse
import functools
import sys

import torch

from ..ops.kernels.decode_attention import (decode_attention,
                                            decode_attention_plain,
                                            decode_attention_single)
from .kernel_variants import CALLS, make_inputs, max_err
from .timing import clock_name, device_ms

VARIANTS = ("dispatch", "tiled", "single1", "jnp")
_KERNELS = {
    "dispatch": (decode_attention,
                 "kernel A (the port's one path for every S: one block per "
                 "(b, h, 256-column chunk), partials combined in chunk "
                 "order)"),
    "tiled": (decode_attention, "kernel A, 256-column chunks"),
    "single1": (functools.partial(decode_attention_single, bb=1),
                "kernel F, bb=1"),
    "jnp": (decode_attention_plain, "the plain version"),
}


def run(variant: str, B: int = 64, S: int = 2048, device="cuda",
        seed: int = 0) -> dict:
    """One variant: error against the plain version, then the time of
    CALLS calls; returns the numbers."""
    if variant not in _KERNELS:
        raise SystemExit(f"unknown variant {variant!r}; one of "
                         f"{', '.join(VARIANTS)}")
    fn, kernel = _KERNELS[variant]
    on_card = torch.device(device).type == "cuda"
    print(f"{variant}: runs {kernel if on_card else 'the plain version'}",
          flush=True)
    q, k, v, bias = make_inputs(B, S, device, seed)
    err, limit = max_err(fn(q, k, v, bias),
                         decode_attention_plain(q, k, v, bias))
    ok = err <= limit
    print(f"{variant}: max abs err vs plain = {err:.4g} (limit {limit:.4g})"
          f"{'' if ok else ' FAILED'}", flush=True)
    ms = device_ms(lambda: fn(q, k, v, bias), device, CALLS)
    kv_bytes = 2 * k.numel() * k.element_size()
    line = (f"{variant}: {ms * CALLS:.3f} ms per {CALLS} calls "
            f"({ms:.4f} ms/call, B={B} S={S})")
    out = {"variant": variant, "B": B, "S": S, "fits": True, "err": err,
           "limit": limit, "ok": ok, "ms": ms, "kv_bytes": kv_bytes}
    if on_card:
        rate = kv_bytes / (ms * 1e-3)
        out["gb_s"] = rate / 1e9
        line += f"; K/V stream {rate / 1e9:.0f} GB/s"
    print(f"{line} [{clock_name(device)}]", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="tiled",
                    help=f"one of {', '.join(VARIANTS)}")
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--S", type=int, default=2048)
    ap.add_argument("--BB", type=int, default=None)
    ap.add_argument("--TS", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.BB is not None or args.TS is not None:
        ap.error("--BB/--TS pick the TPU tiled kernel's tile; the port's "
                 "kernel A has its chunk fixed at 256 columns, one block "
                 "per (b, h, chunk)")
    with torch.inference_mode():
        res = run(args.variant, args.B, args.S, args.device, args.seed)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
