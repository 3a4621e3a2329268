"""Offline preprocessing: article documents -> training shards
(counterpart of tell_tpu/data/pipeline.py).

  articles.jsonl (exported Mongo documents) + images
      -> context assembly (readers.py) -> byte-BPE ids (tokenizer.py)
      -> ResNet-152 grid features (the frozen tower, run once, fp16)
      -> sharded .npz records (records.py::write_shard)

The shards are tell_tpu's format, so either package reads the other's.
An image is a precomputed <hash>.npy grid, or a raw <hash>.jpg / .jpeg
photo that the converted ResNet-152 in the towers directory embeds on the
device (decoded by data/jpeg.py, resized and cropped by data/images.py,
as tell_tpu does through Pillow). PNG and the JPEG forms the port's
decoder refuses wait for ROADMAP queue 1 item 8; GloVe article features
wait for data/glove.py (item 9).
"""
from __future__ import annotations

import json
import os
import re
from typing import Callable, Iterator

import numpy as np

from ..config import NotPortedError
from ..models.backbones.resnet import ResNetConfig, image_grid, load_tower
from .images import decode_image, resize_shortest_crop
from .readers import ReaderConfig, iter_examples
from .records import write_shard
from .tokenizer import RobertaTokenizer


def entity_occurrences(text: str, entities: list[str]
                       ) -> list[tuple[int, int, int]]:
    """All occurrences of each entity string as (start, end, 1-based
    index), matched on word boundaries: a short name does not match inside
    a longer word ('Rose' in 'Rosenberg')."""
    spans = []
    for i, name in enumerate(entities):
        if not name:
            continue
        pat = r"(?<!\w)" + re.escape(name) + r"(?!\w)"
        for m in re.finditer(pat, text):
            spans.append((m.start(), m.end(), i + 1))
    return spans


def read_articles_jsonl(path: str) -> Iterator[dict]:
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def load_objects_jsonl(path: str) -> Callable[[str], dict | None]:
    """Per-image-hash object store (one JSON line per hash with
    "object_features"), loaded once into a dict; returns its lookup."""
    store: dict[str, dict] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                d = json.loads(line)
                store[d["hash"]] = d
    return store.get


def make_image_grid_fn(images_dir: str, towers_dir: str | None = None,
                       device="cuda") -> Callable[[str], np.ndarray | None]:
    """hash -> [49, 2048] ResNet-152 grid features for preprocess.

    A precomputed `<hash>.npy` wins. A raw `<hash>.jpg/.jpeg/.png` is
    decoded (data/images.py's decode_image) and embedded through the
    converted tower at `towers_dir`/resnet152/state.pt, loaded on `device`
    at the first raw image. Without a tower a raw image gives None, as
    does a missing hash: preprocess skips the example, as tell_tpu
    does."""
    state: dict = {}

    def embed(path: str) -> np.ndarray | None:
        if "tower" not in state:
            tower = (os.path.join(towers_dir, "resnet152") if towers_dir
                     else None)
            state["tower"] = (load_tower(tower, device)
                              if tower and os.path.exists(tower) else None)
        if state["tower"] is None:
            return None
        with open(path, "rb") as f:
            img = decode_image(f.read())
        return image_grid(state["tower"], ResNetConfig.resnet152(),
                          resize_shortest_crop(img).astype(np.float32))

    def fn(image_hash: str) -> np.ndarray | None:
        if not image_hash:
            return None
        npy = os.path.join(images_dir, image_hash + ".npy")
        if os.path.exists(npy):
            return np.load(npy)
        for ext in (".jpg", ".jpeg", ".png"):
            p = os.path.join(images_dir, image_hash + ext)
            if os.path.exists(p):
                return embed(p)
        return None

    return fn


def preprocess_split(articles: Iterator[dict], tokenizer: RobertaTokenizer,
                     reader_cfg: ReaderConfig, out_dir: str, split: str,
                     image_grid_fn: Callable[[str], np.ndarray] | None = None,
                     objects_lookup=None, shard_size: int = 512,
                     max_caption_len: int = 100, glove=None) -> int:
    """Write `split`-NNNNN.npz shards to out_dir; returns the number of
    examples written."""
    if glove is not None:
        raise NotPortedError("GloVe article features are not ported yet "
                             "(ROADMAP queue 1 item 9, data/glove.py)")
    os.makedirs(out_dir, exist_ok=True)
    count_tokens = lambda s: len(tokenizer.bpe.encode(s))  # noqa: E731

    buf: list[dict] = []
    n_total = 0
    n_shard = 0

    def flush():
        nonlocal buf, n_shard
        if buf:
            write_shard(os.path.join(out_dir,
                                     f"{split}-{n_shard:05d}.npz"), buf)
            n_shard += 1
            buf = []

    for article in articles:
        for ex in iter_examples(article, reader_cfg, count_tokens,
                                objects_lookup):
            if ex.get("copy_entities") is not None:
                # pointer models: indexed entity masks
                ents = ex["copy_entities"]
                ctx_spans = entity_occurrences(ex["context"], ents)
                cap_spans = entity_occurrences(ex["caption"], ents)
                context_ids, proper = tokenizer.encode_with_indexed_spans(
                    ex["context"], ctx_spans)
                caption_ids, cmask = tokenizer.encode_with_indexed_spans(
                    ex["caption"], cap_spans, max_len=max_caption_len)
                rec = {
                    "context_ids": np.asarray(context_ids, np.int32),
                    "caption_ids": np.asarray(caption_ids, np.int32),
                    "proper_masks": np.asarray(proper, np.int32),
                    "caption_copy_masks": np.asarray(cmask, np.int32),
                    "image_hash": ex["image_hash"],
                    "caption": ex["caption"],
                    "web_url": ex.get("web_url", ""),
                }
            else:
                rec = {
                    "context_ids": np.asarray(
                        tokenizer.encode(ex["context"]), np.int32),
                    "caption_ids": np.asarray(
                        tokenizer.encode(ex["caption"],
                                         max_len=max_caption_len),
                        np.int32),
                    "image_hash": ex["image_hash"],
                    "caption": ex["caption"],
                    "web_url": ex.get("web_url", ""),
                }
            if ex.get("face_embeds") is not None:
                rec["face_embeds"] = ex["face_embeds"]
            if ex.get("obj_embeds") is not None:
                rec["obj_embeds"] = ex["obj_embeds"]
            if image_grid_fn is not None:
                grid = image_grid_fn(ex["image_hash"])
                if grid is None:
                    continue  # no image: the example is skipped
                rec["image_grid"] = grid.astype(np.float16)
            buf.append(rec)
            n_total += 1
            if len(buf) >= shard_size:
                flush()
    flush()
    return n_total
