"""Positional embeddings (counterpart of tell_tpu/ops/positional.py):
the static sinusoidal table (concatenated sin/cos blocks) or a trainable
learned one, both looked up at pad-aware positions (non-pad token i gets
padding_idx + 1 + i, pads get padding_idx, whose table row is zero).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sinusoidal_table(n_positions: int, dim: int,
                     padding_idx: int | None = None) -> np.ndarray:
    """Static [n_positions, dim] fp32 table; row padding_idx zeroed."""
    max_ts, min_ts = 10000.0, 1.0
    n_timescales = dim // 2
    increment = math.log(max_ts / min_ts) / max(n_timescales - 1, 1)
    inv_timescales = min_ts * np.exp(np.arange(n_timescales) * -increment)
    scaled = np.arange(n_positions)[:, None] * inv_timescales[None, :]
    signal = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    if dim % 2 == 1:
        signal = np.concatenate([signal, np.zeros((n_positions, 1))], axis=1)
    if padding_idx is not None:
        signal[padding_idx, :] = 0.0
    return np.asarray(signal, np.float32)


def init_learned_positional(generator: torch.Generator, n_positions: int,
                            dim: int, padding_idx: int | None = None
                            ) -> dict:
    """tell_tpu's init_learned_positional: a trainable [n_positions, dim]
    table, normal(0, 0.1), its padding row zeroed; drawn from `generator`
    on its device. Looked up by sinusoidal_embed like the static table."""
    table = 0.1 * torch.randn((n_positions, dim), generator=generator,
                              device=generator.device)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return {"table": table}


def make_positions(ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """Pad-aware positions for right-padded ids: non-pad tokens count up
    from padding_idx + 1, pads get padding_idx."""
    mask = ids != padding_idx
    positions = torch.cumsum(mask.long(), dim=-1) + padding_idx
    return torch.where(mask, positions, padding_idx)


def sinusoidal_embed(table: torch.Tensor, ids: torch.Tensor,
                     padding_idx: int,
                     start_pos: torch.Tensor | int = 0) -> torch.Tensor:
    """Positional embeddings for a (possibly padded) id tensor. start_pos
    shifts non-pad positions (incremental decode): a scalar shifts every
    row, a [B] tensor shifts each row."""
    positions = make_positions(ids, padding_idx)
    mask = ids != padding_idx
    start = torch.as_tensor(start_pos, device=ids.device)
    if start.ndim == 1:
        start = start[:, None]
    positions = torch.where(mask, positions + start, padding_idx)
    return table[positions]
