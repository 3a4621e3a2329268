"""Entity precision/recall over generated captions.

Replaces the spaCy-based entity scoring of
the reference's scripts/compute_metrics.py:61-289 (all / PERSON / GPE / ORG
and rare-name variants). The NER backend is pluggable: pass any callable
text -> [(text, label)]; `spacy_ner()` returns one when spaCy + a model are
installed, else the caller falls back to the stored `named_entities` that
the dataset construction pipeline wrote into the records.
"""
from __future__ import annotations

from typing import Callable, Iterable

NerFn = Callable[[str], list[tuple[str, str]]]


def spacy_ner(model: str = "en_core_web_lg") -> NerFn | None:
    try:
        import spacy
        nlp = spacy.load(model)
    except Exception:
        return None

    def ner(text: str):
        return [(ent.text, ent.label_) for ent in nlp(text).ents]
    return ner


def spacy_analyze(model: str = "en_core_web_lg"):
    """One parse -> (entities, propn_tokens). None without spaCy. Use this
    in loops that need both: two separate factories would load the model
    twice and parse every text twice."""
    try:
        import spacy
        nlp = spacy.load(model)
    except Exception:
        return None

    def analyze(text: str):
        doc = nlp(text)
        return (tuple((e.text, e.label_) for e in doc.ents),
                tuple(t.text for t in doc if t.pos_ == "PROPN"))
    return analyze


def spacy_propn(model: str = "en_core_web_lg"):
    """Single-token PROPN extractor — the reference's name unit
    (evaluate.py:234-239: 'Barack Obama' counts as TWO names). None
    without spaCy."""
    try:
        import spacy
        nlp = spacy.load(model)
    except Exception:
        return None

    def propn(text: str) -> list:
        return [t.text for t in nlp(text) if t.pos_ == "PROPN"]
    return propn


def entity_precision_recall(
        gen_entities: Iterable[Iterable[str]],
        ref_entities: Iterable[Iterable[str]]) -> dict:
    """Micro-averaged P/R: a generated entity counts as correct if its exact
    text appears among the reference caption's entities (compute_metrics.py
    semantics)."""
    n_gen = n_ref = n_correct_gen = n_correct_ref = 0
    for gens, refs in zip(gen_entities, ref_entities):
        gens = list(gens)
        refs = list(refs)
        ref_set = set(refs)
        gen_set = set(gens)
        n_gen += len(gens)
        n_ref += len(refs)
        n_correct_gen += sum(1 for g in gens if g in ref_set)
        n_correct_ref += sum(1 for r in refs if r in gen_set)
    return {
        "precision": n_correct_gen / n_gen if n_gen else 0.0,
        "recall": n_correct_ref / n_ref if n_ref else 0.0,
        "n_generated": n_gen,
        "n_reference": n_ref,
    }


def filter_by_label(entities: list[tuple[str, str]],
                    labels: tuple[str, ...]) -> list[str]:
    return [t for t, lab in entities if lab in labels]


# ---------------------------------------------------------------------------
# Full compute_metrics.py parity: per-label entity match families, name
# P/R, and rare-name variants keyed on training-split name counters
# (the reference's scripts/compute_metrics.py:100-415).
# ---------------------------------------------------------------------------

ENTITY_FAMILIES = (("ent", None), ("person", "PERSON"), ("orgs", "ORG"),
                   ("gpes", "GPE"), ("date", "DATE"))


def _contains(entities: list[dict], target: dict) -> bool:
    return any(e["text"] == target["text"] and e["label"] == target["label"]
               for e in entities)


def count_entity_matches(caption_entities: list[dict],
                         gen_entities: list[dict], c: dict) -> dict:
    """Accumulate the reference's ent_counter (compute_metrics.py:290-348).
    Entities are {text, label} dicts; matching is exact on both."""
    for key, label in ENTITY_FAMILIES:
        caps = ([e for e in caption_entities if e["label"] == label]
                if label else caption_entities)
        gens = ([e for e in gen_entities if e["label"] == label]
                if label else gen_entities)
        # key naming quirks preserved: ents/persons pluralize the totals but
        # person keeps singular match keys; date stays singular throughout
        total = {"ent": ("n_caption_ents", "n_gen_ents"),
                 "person": ("n_caption_persons", "n_gen_persons"),
                 "orgs": ("n_caption_orgs", "n_gen_orgs"),
                 "gpes": ("n_caption_gpes", "n_gen_gpes"),
                 "date": ("n_caption_date", "n_gen_date")}[key]
        match = {"ent": ("n_caption_ent_matches", "n_gen_ent_matches"),
                 "person": ("n_caption_person_matches",
                            "n_gen_person_matches"),
                 "orgs": ("n_caption_orgs_matches", "n_gen_orgs_matches"),
                 "gpes": ("n_caption_gpes_matches", "n_gen_gpes_matches"),
                 "date": ("n_caption_date_matches", "n_gen_date_matches")
                 }[key]
        c[total[0]] = c.get(total[0], 0) + len(caps)
        c[total[1]] = c.get(total[1], 0) + len(gens)
        c[match[1]] = c.get(match[1], 0) + sum(
            1 for e in gens if _contains(caps, e))
        c[match[0]] = c.get(match[0], 0) + sum(
            1 for e in caps if _contains(gens, e))
    return c


def name_counts(caption_names: list[str], generated_names: list[str]
                ) -> tuple[int, int, int, int]:
    """(recall_count, recall_total, precision_count, precision_total) —
    compute_full_recall/_precision semantics."""
    rc = sum(1 for n in caption_names if n in generated_names)
    pc = sum(1 for n in generated_names if n in caption_names)
    return rc, len(caption_names), pc, len(generated_names)


def rare_name_counts(caption_names: list[str], generated_names: list[str],
                     counter) -> tuple[int, int, int, int]:
    """Same, restricted to names ABSENT from the training counter
    (compute_rare_recall/_precision)."""
    rare_cap = [n for n in caption_names if n not in counter]
    rare_gen = [n for n in generated_names if n not in counter]
    rc = sum(1 for n in rare_cap if n in generated_names)
    pc = sum(1 for n in rare_gen if n in caption_names)
    return rc, len(rare_cap), pc, len(rare_gen)


def _pct(count: int, total: int) -> dict:
    return {"count": count, "total": total,
            "percentage": (count / total) if total else None}


def reported_entity_metrics(entries: list[dict],
                            counters: dict | None = None) -> dict:
    """The entity section of *_reported_metrics.json. `entries` are
    generations.jsonl dicts carrying caption_entities/generated_entities
    (and *_names); `counters` is the name_counters.pkl content
    ({'caption': Counter, 'context': Counter})."""
    c: dict = {}
    fr = frt = fp = fpt = 0
    rr = rrt = rp = rpt = 0
    frr = frrt = frp = frpt = 0
    full_counter = None
    if counters is not None:
        full_counter = dict(counters.get("caption", {}))
        for k, v in counters.get("context", {}).items():
            full_counter[k] = full_counter.get(k, 0) + v
    for obj in entries:
        caps = obj.get("caption_entities", [])
        gens = obj.get("generated_entities", [])
        count_entity_matches(caps, gens, c)
        # fallback name unit = single tokens of PERSON/ORG/GPE spans —
        # the reference counts PROPN TOKENS ('Barack Obama' = two names;
        # evaluate.py:234-239), and the name_counters.pkl keys are
        # token-level too, so span-level names would misclassify nearly
        # everything as rare
        cn = obj.get("caption_names")
        if cn is None:
            cn = [t for e in caps if e["label"] in ("PERSON", "ORG", "GPE")
                  for t in e["text"].split()]
        gn = obj.get("generated_names")
        if gn is None:
            gn = [t for e in gens if e["label"] in ("PERSON", "ORG", "GPE")
                  for t in e["text"].split()]
        a, b_, p, q = name_counts(cn, gn)
        fr, frt, fp, fpt = fr + a, frt + b_, fp + p, fpt + q
        if counters is not None:
            a, b_, p, q = rare_name_counts(cn, gn,
                                           counters.get("caption", {}))
            rr, rrt, rp, rpt = rr + a, rrt + b_, rp + p, rpt + q
            a, b_, p, q = rare_name_counts(cn, gn, full_counter)
            frr, frrt, frp, frpt = frr + a, frrt + b_, frp + p, frpt + q
    out = {
        "All names - recall": _pct(fr, frt),
        "All names - precision": _pct(fp, fpt),
        "Entity all - recall": _pct(c.get("n_caption_ent_matches", 0),
                                    c.get("n_caption_ents", 0)),
        "Entity all - precision": _pct(c.get("n_gen_ent_matches", 0),
                                       c.get("n_gen_ents", 0)),
        "Entity person - recall": _pct(c.get("n_caption_person_matches", 0),
                                       c.get("n_caption_persons", 0)),
        "Entity person - precision": _pct(c.get("n_gen_person_matches", 0),
                                          c.get("n_gen_persons", 0)),
        "Entity GPE - recall": _pct(c.get("n_caption_gpes_matches", 0),
                                    c.get("n_caption_gpes", 0)),
        "Entity GPE - precision": _pct(c.get("n_gen_gpes_matches", 0),
                                       c.get("n_gen_gpes", 0)),
        "Entity ORG - recall": _pct(c.get("n_caption_orgs_matches", 0),
                                    c.get("n_caption_orgs", 0)),
        "Entity ORG - precision": _pct(c.get("n_gen_orgs_matches", 0),
                                       c.get("n_gen_orgs", 0)),
        "Entity DATE - recall": _pct(c.get("n_caption_date_matches", 0),
                                     c.get("n_caption_date", 0)),
        "Entity DATE - precision": _pct(c.get("n_gen_date_matches", 0),
                                        c.get("n_gen_date", 0)),
    }
    if counters is not None:
        out.update({
            "Caption rare names - recall": _pct(rr, rrt),
            "Caption rare names - precision": _pct(rp, rpt),
            "Article rare names - recall": _pct(frr, frrt),
            "Article rare names - precision": _pct(frp, frpt),
        })
    return out
