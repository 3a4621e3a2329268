"""A CPU emulation of the 3xTF32 products that kernels B and E run for
fp32 on the tensor cores (csrc/common.cuh::split_tf32, mma_3xtf32), and
a model of how an mma.sync fragment accumulates.

No path of the package calls it: the tests use it to show that the
kernels' fp32 route keeps fp32's tolerances against a float64 reference,
which a single TF32 product (about three decimal digits) would not, and
that kernel E must add each ring slot's fragments into fp32 sums rather
than accumulate all of D in one fragment (mma_accumulate).
"""
from __future__ import annotations

import torch


def tf32(x: torch.Tensor, rounding: str = "truncate") -> torch.Tensor:
    """fp32 to TF32 (10 mantissa bits) on the int32 view: "truncate" clears
    the 13 dropped bits, as the kernels' masks do; "rna" rounds to nearest
    with ties away from zero, as cvt.rna.tf32.f32 does (add half of the
    dropped bits to the magnitude, then clear them)."""
    i = x.float().contiguous().view(torch.int32)
    if rounding == "rna":
        i = i + 0x1000
    return (i & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, rounding: str = "truncate"
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), the exact rest cut the
    same way."""
    hi = tf32(x, rounding)
    return hi, tf32(x.float() - hi, rounding)


def mm_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor,
              rounding: str = "truncate") -> torch.Tensor:
    """torch.einsum(eq, a, b) in 3xTF32 as the kernels accumulate it: each
    operand split into hi and lo, the two small cross terms first, then
    the product of the high parts (each product of two TF32 values is
    exact in fp32)."""
    (ah, al), (bh, bl) = split(a, rounding), split(b, rounding)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def mm_tf32(eq: str, a: torch.Tensor, b: torch.Tensor,
            rounding: str = "truncate") -> torch.Tensor:
    """One TF32 product, for comparison: both operands cut to TF32."""
    return torch.einsum(eq, tf32(a, rounding), tf32(b, rounding))


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 to fp32, rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma_accumulate(pairs, k_step: int, slot: int | None = None
                   ) -> torch.Tensor:
    """sum_k a[:, k] b[:, k] over D for each (a [N, D], b [V, D]) of pairs,
    as an mma.sync fragment accumulates it, under the model that fits the
    tensor cores' numbers: the products of one k-step (k_step elements of
    D) are exact and summed exactly, then added to the fragment with the
    sum rounded toward zero to fp32. The pairs go in the order given at
    each k-step (3xTF32: (lo, hi), (hi, lo), (hi, hi)). With `slot`, the
    fragment starts again from 0 every `slot` elements of D and is added
    to the running fp32 sum by an ordinary fp32 add, as kernel E does."""
    a0, b0 = pairs[0]
    D = a0.shape[1]
    acc = torch.zeros(a0.shape[0], b0.shape[0])
    frag = torch.zeros_like(acc)
    for k0 in range(0, D, k_step):
        ks = slice(k0, k0 + k_step)
        for a, b in pairs:
            frag = round_toward_zero(frag.double()
                                     + a[:, ks].double() @ b[:, ks].double().T)
        if slot and (k0 + k_step) % slot == 0:
            acc = acc + frag
            frag = torch.zeros_like(frag)
    return acc + frag
