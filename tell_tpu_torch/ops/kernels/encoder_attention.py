"""Kernel B: flash-style self-attention for the RoBERTa article encoder.

Replaces the library Pallas kernel jax.experimental.pallas.ops.tpu.
flash_attention that tell_tpu/models/backbones/roberta.py::roberta_encode
calls at S >= 512 (call at :219, gate _flash_ok at :111), at every bucket
width, with tell_tpu_torch/csrc/encoder_attention.cu.

Padding follows the einsum path of roberta_encode (:206, :227-232), the CPU
reference: pad keys get an additive -1e9, so every query row, pad rows
included, matches it. (The TPU flash path let pads attend only pads.)

What bounds it on the H100: arithmetic, 4*S*S*hd FLOPs per (b, h), which
this first version runs on the fp32 CUDA cores. The design is flash-style:
a block per (b, h, 64-query tile) streams 64-row K/V tiles through shared
memory with an fp32 online softmax, so the S x S scores never reach device
memory. See the source's header for what is left for later work.
"""
from __future__ import annotations

import torch

from .build import check_launch, load_library
from .dispatch import check_kernel_args, use_kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)  # RoBERTa-large and -base; the kernel is built for it


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, key_pad: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch version: roberta_encode's einsum attention with the
    -1e9 key-padding mask, fp32 scores and softmax, probabilities cast to
    q's dtype before the value contraction."""
    hd = q.shape[-1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    neg = torch.zeros(key_pad.shape, dtype=torch.float32,
                      device=key_pad.device).masked_fill_(key_pad, -1e9)
    scores = scores * (hd ** -0.5) + neg[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
    return out.to(q.dtype)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_pad: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, S, H, hd]; key_pad: [B, S] bool, True = pad.
    Returns [B, S, H, hd]. CUDA tensors launch kernel B (counted in
    encoder_attention.launches; .sequences adds the B sequences, e.g.
    article windows, of each launch); CPU tensors take
    encoder_attention_plain."""
    if not use_kernel(q, k, v, key_pad):
        return encoder_attention_plain(q, k, v, key_pad)
    B, S, H, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"encoder_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ")
    if key_pad.shape != (B, S):
        raise ValueError(f"encoder_attention: key_pad "
                         f"{tuple(key_pad.shape)} is not {(B, S)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"encoder_attention: head dim {hd} not in "
                         f"{_HEAD_DIMS}")
    check_kernel_args("encoder_attention",
                      {"q": q, "k": k, "v": v, "key_pad": key_pad},
                      {"q": tuple(_DTYPE_CODE), "k": (q.dtype,),
                       "v": (q.dtype,), "key_pad": (torch.bool,)})
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.tt_encoder_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_pad.data_ptr(),
            out.data_ptr(), B, S, H, hd, hd ** -0.5, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "encoder_attention", code)
    encoder_attention.launches += 1
    encoder_attention.sequences += B
    return out


encoder_attention.launches = 0
encoder_attention.sequences = 0
