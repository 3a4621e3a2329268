"""Dataset readers: article documents -> training examples (counterpart of
tell_tpu/data/readers.py).

Pure functions over plain article dicts (the exported Mongo document
schema). Two context-assembly strategies:
* `assemble_location_aware` (the flagship's): the title, then the
  article's FIRST paragraph, then paragraphs before and after the image
  position, grown alternately until the BPE token count reaches the
  budget. The first paragraph's tokens are not counted toward the budget,
  as in the reference readers.
* `assemble_simple`: the title and the paragraphs in document order until
  the whitespace word count exceeds 500 (the paragraph that crosses the
  limit is kept).

Faces are the first N of the caption section's FaceNet embeddings (N = 4,
or the number of PERSON entities with use_caption_names), objects come
from the per-image object store; pad_embeds pads either with NaN rows,
which the model masks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np

ENTITY_LABELS = ("PERSON", "ORG", "GPE")


def _named_entities(section: dict, labels=ENTITY_LABELS) -> set[str]:
    out = set()
    for ner in section.get("named_entities", []):
        if ner.get("label") in labels:
            out.add(ner["text"])
    return out


def _person_names(section: dict) -> set[str]:
    return _named_entities(section, labels=("PERSON",))


def assemble_location_aware(article: dict, pos: int,
                            count_tokens: Callable[[str], int],
                            budget: int = 510
                            ) -> tuple[list[str], set[str]]:
    """Returns (paragraphs, named_entities) for the image at section `pos`.
    The headline's entities are not collected (as in the reference)."""
    sections = article["parsed_section"]
    paragraphs: list[str] = []
    names: set[str] = set()
    n_words = 0

    title = article.get("headline", {}).get("main", "").strip()
    if title:
        paragraphs.append(title)
        n_words += count_tokens(title)

    # the article's first paragraph (its tokens are not counted)
    k = len(sections)
    first = None
    for k, section in enumerate(sections):
        if section["type"] == "paragraph":
            first = section["text"]
            names |= _named_entities(section)
            break

    before: list[str] = []
    after: list[str] = []
    i, j = pos - 1, pos + 1
    while True:
        if i > k and sections[i]["type"] == "paragraph":
            text = sections[i]["text"]
            before.insert(0, text)
            names |= _named_entities(sections[i])
            n_words += count_tokens(text)
        i -= 1
        if k < j < len(sections) and sections[j]["type"] == "paragraph":
            text = sections[j]["text"]
            after.append(text)
            names |= _named_entities(sections[j])
            n_words += count_tokens(text)
        j += 1
        if n_words >= budget or (i <= k and j >= len(sections)):
            break

    if first is not None:
        paragraphs.append(first)
    return paragraphs + before + after, names


def assemble_simple(article: dict, budget_words: int = 500) -> list[str]:
    sections = article["parsed_section"]
    paragraphs = [s["text"].strip() for s in sections
                  if s["type"] == "paragraph"]
    title = article.get("headline", {}).get("main", "").strip()
    if title:
        paragraphs.insert(0, title)
    n_words = 0
    out = []
    for par in paragraphs:
        out.append(par)
        n_words += len(par.split())
        if n_words > budget_words:
            break
    return out


@dataclass
class ReaderConfig:
    strategy: str = "location_aware"  # or "simple"
    use_objects: bool = True
    use_faces: bool = True
    use_caption_names: bool = False
    # pointer models: per-entity character spans for indexed copy masks
    emit_copy_masks: bool = False
    n_faces: int | None = None
    max_faces: int = 4
    max_objects: int = 64
    token_budget: int = 510


def iter_examples(article: dict, cfg: ReaderConfig,
                  count_tokens: Callable[[str], int],
                  objects_lookup: Callable[[str], Any] | None = None
                  ) -> Iterator[dict]:
    """Yield one example per image position in the article."""
    sections = article["parsed_section"]
    for pos in article.get("image_positions", []):
        section = sections[pos]
        caption = section.get("text", "").strip()
        if not caption:
            continue

        if cfg.strategy == "location_aware":
            paragraphs, names = assemble_location_aware(
                article, pos, count_tokens, cfg.token_budget)
        else:
            paragraphs = assemble_simple(article)
            names = set()
            for s in sections:
                names |= _named_entities(s)

        if cfg.n_faces is not None:
            n_persons = cfg.n_faces
        elif cfg.use_caption_names:
            n_persons = len(_person_names(section))
        else:
            n_persons = cfg.max_faces

        face_embeds = None
        if cfg.use_faces:
            details = section.get("facenet_details")
            if details and n_persons > 0:
                face_embeds = np.asarray(
                    details["embeddings"][:n_persons], np.float32)
            else:
                face_embeds = np.zeros((0, 512), np.float32)

        obj_embeds = None
        if cfg.use_objects and objects_lookup is not None:
            obj = objects_lookup(section.get("hash", ""))
            feats = (obj or {}).get("object_features", [])
            obj_embeds = (np.asarray(feats[: cfg.max_objects], np.float32)
                          if len(feats) else np.zeros((0, 2048), np.float32))

        context_text = "\n".join(paragraphs).strip()
        copy_entities = None
        if cfg.emit_copy_masks:
            ents = []
            for e in section.get("named_entities", []):
                if e.get("label") in ENTITY_LABELS and e["text"] not in ents:
                    ents.append(e["text"])
            copy_entities = ents

        yield {
            "context": context_text,
            "caption": caption,
            "copy_entities": copy_entities,
            "names": sorted(names),
            "image_hash": section.get("hash", ""),
            "image_pos": pos,
            "web_url": article.get("web_url", ""),
            "face_embeds": face_embeds,
            "obj_embeds": obj_embeds,
        }


def pad_embeds(embeds: np.ndarray | None, n: int, dim: int) -> np.ndarray:
    """Fixed-shape NaN padding to [n, dim]."""
    out = np.full((n, dim), np.nan, np.float32)
    if embeds is not None and embeds.size:
        k = min(n, embeds.shape[0])
        out[:k] = embeds[:k]
    return out
