"""Token-budget bucketing into fixed pad shapes (counterpart of
tell_tpu/data/bucketing.py).

Article lengths are quantised to {128, 256, 512} and caption lengths to
{16, 32, 64, 100}; each (article, caption) bucket gets the largest batch
within the token budget, floored to a power of two (16 x 512 with 32-token
captions at the default budget). A handful of shapes keeps the step's
allocations and kernel shapes stable on the card, as it kept XLA's
compiled programs few on the TPU. The fields are the flagship's and its
siblings' (ids, image grid, faces, objects), the GloVe experiments'
article features (zero rows past each article's end, which the article
mask marks), the pointer models' copy and proper masks (padded with -1)
and, for evaluation, the string metadata.

A batch of LazyExamples over the C++ shard reader is packed in C++
(_native_pack: one gather per field, straight from the shard mappings);
dicts and the Python ShardReader's examples take the numpy path. Both give
the same bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .native import F32_NAN_BITS, gather_pad

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


def _pad_masks(masks, length: int) -> np.ndarray:
    """Copy/proper masks pad with -1."""
    masks = np.asarray(masks, np.int32)[:length]
    out = np.full((length,), -1, np.int32)
    out[:len(masks)] = masks
    return out


def _native_pack(examples: list, article_len: int, caption_len: int,
                 cfg: BucketingConfig) -> dict:
    """pack_batch's fields gathered in C++ from the shard mappings, one
    call per field (native.gather_pad); fp16 storage converts while it
    copies."""
    B, e0 = len(examples), examples[0]

    def gather(field, shape, pad, dtype=np.float32):
        out = np.empty((B,) + shape, dtype)
        gather_pad(examples, field, out, pad,
                   convert_f16=e0.field_dtype(field) == np.float16)
        return out

    batch = {"context_ids": gather("context_ids", (article_len,), PAD_ID,
                                   np.int32),
             "caption_ids": gather("caption_ids", (caption_len,), PAD_ID,
                                   np.int32)}
    batch["article_mask"] = batch["context_ids"] == PAD_ID
    if "article" in e0:
        batch["article"] = gather(
            "article", (article_len, e0.field_shape("article")[-1]), 0)
        lens = np.asarray([min(e.field_len("article"), article_len)
                           for e in examples])
        batch["article_mask"] = np.arange(article_len)[None] >= lens[:, None]
    for field, length in (("proper_masks", article_len),
                          ("caption_copy_masks", caption_len)):
        if field in e0:
            batch[field] = gather(field, (length,), -1, np.int32)
    if "image_grid" in e0:
        batch["image_grid"] = gather("image_grid",
                                     tuple(e0.field_shape("image_grid")), 0)
    if "face_embeds" in e0:
        batch["face_embeds"] = gather("face_embeds",
                                      (cfg.max_faces, cfg.face_dim),
                                      F32_NAN_BITS)
    if "obj_embeds" in e0:
        batch["obj_embeds"] = gather("obj_embeds",
                                     (cfg.max_objects, cfg.object_dim),
                                     F32_NAN_BITS)
    return batch


def pack_batch(examples: list, article_len: int, caption_len: int,
               cfg: BucketingConfig, include_meta: bool = False) -> dict:
    """Stack ragged examples into one fixed-shape numpy batch: ids padded
    with PAD_ID, article_mask True at pads, masks padded with -1, absent
    faces/objects as NaN rows. include_meta also carries META_FIELDS as
    lists of str (for evaluation; the trainer leaves it off)."""
    if all(getattr(e, "native", False) for e in examples):
        batch = _native_pack(examples, article_len, caption_len, cfg)
    else:
        batch = _numpy_pack(examples, article_len, caption_len, cfg)
    if include_meta:
        for meta in META_FIELDS:
            if meta in examples[0]:
                batch[meta] = [str(e.get(meta, "")) for e in examples]
    return batch


def _numpy_pack(examples: list, article_len: int, caption_len: int,
                cfg: BucketingConfig) -> dict:
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
    if "article" in e0:
        dim = np.asarray(e0["article"]).shape[-1]
        feats = np.zeros((B, article_len, dim), np.float32)
        mask = np.ones((B, article_len), bool)
        for i, e in enumerate(examples):
            a = np.asarray(e["article"], np.float32)[:article_len]
            feats[i, :len(a)] = a
            mask[i, :len(a)] = False
        batch["article"] = feats
        batch["article_mask"] = mask
    for field, length in (("proper_masks", article_len),
                          ("caption_copy_masks", caption_len)):
        if field in e0:
            batch[field] = np.stack([_pad_masks(e[field], length)
                                     for e in examples])
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
    return batch


def bucket_batches(examples: Iterator, cfg: BucketingConfig,
                   include_meta: bool = False,
                   ranks: int = 1) -> Iterator[dict]:
    """Group a stream of examples into fixed-shape batches: each example
    goes to its (article, caption) length bucket and a bucket is emitted
    when it fills. The ragged rest of each bucket is padded by repeating
    its last example, and a bool "real" [B] marks the genuine rows.
    ranks: the stream is one of that many data-parallel ranks' strides,
    and a batch is this rank's 1/ranks of the bucket's global batch size
    (which must divide, as tell_tpu's batch_sharding requires)."""
    if ranks > 1:
        from ..parallel.mesh import check_rows_divisible
        for al in cfg.article_lengths:
            for cl in cfg.caption_lengths:
                check_rows_divisible("caption_ids", _batch_size(al, cl, cfg),
                                     ranks)
    buckets: dict[tuple[int, int], list] = {}
    for ex in examples:
        if hasattr(ex, "field_len"):
            nc, nk = ex.field_len("context_ids"), ex.field_len("caption_ids")
        else:
            nc, nk = len(ex["context_ids"]), len(ex["caption_ids"])
        key = (_bucket_len(nc, cfg.article_lengths),
               _bucket_len(nk, cfg.caption_lengths))
        buckets.setdefault(key, []).append(ex)
        b = _batch_size(*key, cfg) // ranks
        if len(buckets[key]) >= b:
            yield pack_batch(buckets[key][:b], *key, cfg, include_meta)
            buckets[key] = buckets[key][b:]
    for (al, cl), rest in buckets.items():
        b = _batch_size(al, cl, cfg) // ranks
        while rest:
            chunk = rest[:b]
            batch = pack_batch(chunk + [chunk[-1]] * (b - len(chunk)),
                               al, cl, cfg, include_meta)
            batch["real"] = np.arange(b) < len(chunk)
            yield batch
            rest = rest[b:]
