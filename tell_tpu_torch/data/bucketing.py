"""Token-budget bucketing into fixed pad shapes (carried over from
tell_tpu/data/bucketing.py, numpy path only).

Article lengths are quantised to {128, 256, 512} and caption lengths to
{16, 32, 64, 100}; each (article, caption) bucket gets the largest batch
within the token budget, floored to a power of two (16 x 512 with 32-token
captions at the default budget). A handful of shapes keeps the step's
allocations and kernel shapes stable on the card, as it kept XLA's
compiled programs few on the TPU. The fields are the flagship's (ids,
image grid, faces, objects) and, for evaluation, the string metadata;
tell_tpu's precomputed-article and copy-mask fields come with the models
that use them, and its C++ gather path (_native_pack) with the native
loader.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

PAD_ID = 1


@dataclass(frozen=True)
class BucketingConfig:
    article_lengths: tuple[int, ...] = (128, 256, 512)
    caption_lengths: tuple[int, ...] = (16, 32, 64, 100)
    token_budget: int = 16384
    max_batch: int = 64
    min_batch: int = 1
    max_faces: int = 4
    face_dim: int = 512
    max_objects: int = 64
    object_dim: int = 2048


def _bucket_len(n: int, lengths: tuple[int, ...]) -> int:
    for L in lengths:
        if n <= L:
            return L
    return lengths[-1]


def _batch_size(article_len: int, caption_len: int,
                cfg: BucketingConfig) -> int:
    b = max(cfg.token_budget // (article_len + caption_len), cfg.min_batch)
    b = min(b, cfg.max_batch)
    return 1 << (b.bit_length() - 1)  # floor to a power of two


META_FIELDS = ("caption", "image_hash", "web_url")


def pack_batch(examples: list, article_len: int, caption_len: int,
               cfg: BucketingConfig, include_meta: bool = False) -> dict:
    """Stack ragged examples into one fixed-shape numpy batch: ids padded
    with PAD_ID, article_mask True at pads, absent faces/objects as NaN
    rows. include_meta also carries META_FIELDS as lists of str (for
    evaluation; the trainer leaves it off)."""
    if hasattr(examples[0], "materialize"):
        examples = [e.materialize() for e in examples]
    B = len(examples)

    def fill_ids(field: str, length: int) -> np.ndarray:
        out = np.full((B, length), PAD_ID, np.int32)
        for i, e in enumerate(examples):
            ids = e[field][:length]
            out[i, :len(ids)] = ids
        return out

    batch: dict = {"context_ids": fill_ids("context_ids", article_len),
                   "caption_ids": fill_ids("caption_ids", caption_len)}
    batch["article_mask"] = batch["context_ids"] == PAD_ID
    e0 = examples[0]
    if "image_grid" in e0:
        grids = np.empty((B,) + np.asarray(e0["image_grid"]).shape,
                         np.float32)
        for i, e in enumerate(examples):
            grids[i] = e["image_grid"]   # fp16 storage upcasts in place
        batch["image_grid"] = grids

    def fill_embeds(field: str, n: int, dim: int) -> np.ndarray:
        out = np.empty((B, n, dim), np.float32)
        for i, e in enumerate(examples):
            emb = e.get(field)
            k = 0
            if emb is not None and emb.size:
                k = min(n, emb.shape[0])
                out[i, :k] = emb[:k]
            out[i, k:] = np.nan
        return out

    if "face_embeds" in e0:
        batch["face_embeds"] = fill_embeds("face_embeds", cfg.max_faces,
                                           cfg.face_dim)
    if "obj_embeds" in e0:
        batch["obj_embeds"] = fill_embeds("obj_embeds", cfg.max_objects,
                                          cfg.object_dim)
    if include_meta:
        for meta in META_FIELDS:
            if meta in e0:
                batch[meta] = [str(e.get(meta, "")) for e in examples]
    return batch


def bucket_batches(examples: Iterator, cfg: BucketingConfig,
                   include_meta: bool = False) -> Iterator[dict]:
    """Group a stream of examples into fixed-shape batches: each example
    goes to its (article, caption) length bucket and a bucket is emitted
    when it fills. The ragged rest of each bucket is padded by repeating
    its last example, and a bool "real" [B] marks the genuine rows."""
    buckets: dict[tuple[int, int], list] = {}
    for ex in examples:
        if hasattr(ex, "field_len"):
            nc, nk = ex.field_len("context_ids"), ex.field_len("caption_ids")
        else:
            nc, nk = len(ex["context_ids"]), len(ex["caption_ids"])
        key = (_bucket_len(nc, cfg.article_lengths),
               _bucket_len(nk, cfg.caption_lengths))
        buckets.setdefault(key, []).append(ex)
        b = _batch_size(*key, cfg)
        if len(buckets[key]) >= b:
            yield pack_batch(buckets[key][:b], *key, cfg, include_meta)
            buckets[key] = buckets[key][b:]
    for (al, cl), rest in buckets.items():
        b = _batch_size(al, cl, cfg)
        while rest:
            chunk = rest[:b]
            batch = pack_batch(chunk + [chunk[-1]] * (b - len(chunk)),
                               al, cl, cfg, include_meta)
            batch["real"] = np.arange(b) < len(chunk)
            yield batch
            rest = rest[b:]
