"""Where kernel C's forward spends its time, at the training path's shapes.

    python -m tell_tpu_torch.tools.profile_conv [--device cuda] [--small]
        [--calls 50] [--seed 0]

For each of chip_smoke.py's phase-3 shapes (B=16, C=1024, H=16; K = 3, 7,
15, 31 at T=32, and K=31 at T=100 and T=15), in fp32 and bf16, with x and
the k-major predictor from the seed: the device milliseconds a call of
fused_dynamic_conv spends in its main launch and in its weight-layout
launch, from torch.profiler over `calls` calls (tools/timing.py). Outputs
are not checked, so a tree whose kernel was changed for a measurement
(a stage left out) can be timed with the same command. On the CPU the
plain version runs on the host clock, and the line says so; --small
takes B=2, C=128, H=4 for that rehearsal.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..ops.kernels.dynamic_conv import fused_dynamic_conv
from .timing import clock_name, device_ms, profiled_device_ms

SHAPES = ((32, 3), (32, 7), (32, 15), (32, 31), (100, 31), (15, 31))


def run(device="cuda", small: bool = False, calls: int = 50,
        seed: int = 0) -> dict:
    """{(T, K, dtype): (main ms, layout ms)} per call; on the CPU the
    host-clock ms of the plain version and 0."""
    B, C, H = (2, 128, 4) if small else (16, 1024, 16)
    on_card = torch.device(device).type == "cuda"
    g = torch.Generator().manual_seed(seed)
    res = {}
    for T, K in SHAPES:
        x = torch.randn(B, T, C, generator=g)
        bound = (6.0 / (C + K * H)) ** 0.5
        w = (torch.rand(C, K * H, generator=g) * 2 - 1) * bound
        for dtype in (torch.float32, torch.bfloat16):
            xd, wd = x.to(device, dtype), w.to(device, dtype)

            def call():
                return fused_dynamic_conv(xd, wd, K, H)
            if on_card:
                times = profiled_device_ms(call, calls=calls)
                layout = sum(t for k, t in times.items()
                             if "weight_blocks" in k)
                res[T, K, dtype] = (sum(times.values()) - layout, layout)
            else:
                res[T, K, dtype] = (device_ms(call, device, calls), 0.0)
    line = " | ".join(
        f"T={T} K={K} " + " / ".join(f"{res[T, K, d][0]:.4f}"
                                     for d in (torch.float32, torch.bfloat16))
        for T, K in SHAPES)
    print(f"kernel C forward, B={B} C={C} H={H}, ms fp32 / bf16 "
          f"({'main launch; the weight layout apart' if on_card else 'plain version'}): "
          f"{line} [{clock_name(device)}]", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with torch.inference_mode():
        run(args.device, args.small, args.calls, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
