"""Readability scores and narrative-productivity (TTR) metrics.

The reference computes these per generation in `tell evaluate` via the
textstat package and NLTK word_tokenize
(the reference's tell/commands/evaluate.py:253-355) and stores them in
generations.jsonl. textstat is not in this image, so the formulas are
implemented directly; syllables use the standard vowel-group heuristic with
silent-e handling (textstat's own counter is also heuristic — scores agree
to within ~1 grade level, which is what these aggregate statistics need).

The TTR family (basic/root/corrected TTR, Herdan, Summer, Maas) replicates
evaluate.py:273-355 exactly — including its quirks: `summer` returns None
(the reference forgets the return, :341-345) and `maas` is capped at 0.2.
"""
from __future__ import annotations

import math
import re
import string

_VOWELS = "aeiouy"
_WORD_RE = re.compile(r"[A-Za-z']+")
_SENT_RE = re.compile(r"[.!?]+(?:\s|$)")


def count_syllables(word: str) -> int:
    w = word.lower().strip(string.punctuation)
    if not w:
        return 0
    groups = 0
    prev = False
    for ch in w:
        is_v = ch in _VOWELS
        if is_v and not prev:
            groups += 1
        prev = is_v
    if w.endswith("e") and not w.endswith(("le", "ee")) and groups > 1:
        groups -= 1
    return max(groups, 1)


def _stats(text: str):
    words = _WORD_RE.findall(text)
    n_words = len(words)
    n_sents = max(len(_SENT_RE.findall(text)), 1)
    n_syll = sum(count_syllables(w) for w in words)
    n_chars = sum(len(w) for w in words)
    n_poly = sum(1 for w in words if count_syllables(w) >= 3)
    return words, n_words, n_sents, n_syll, n_chars, n_poly


def flesch_reading_ease(text: str) -> float:
    _, w, s, sy, _, _ = _stats(text)
    if w == 0:
        return 0.0
    return 206.835 - 1.015 * (w / s) - 84.6 * (sy / w)


def flesch_kincaid_grade(text: str) -> float:
    _, w, s, sy, _, _ = _stats(text)
    if w == 0:
        return 0.0
    return 0.39 * (w / s) + 11.8 * (sy / w) - 15.59


def gunning_fog(text: str) -> float:
    words, w, s, _, _, _ = _stats(text)
    if w == 0:
        return 0.0
    complex_words = sum(1 for x in words if count_syllables(x) >= 3
                        and not x[0].isupper())
    return 0.4 * ((w / s) + 100 * complex_words / w)


def smog_index(text: str) -> float:
    _, w, s, _, _, poly = _stats(text)
    # textstat gates SMOG on >= 3 sentences (returns 0.0 below) — nearly
    # every caption is one sentence, so without the gate every record
    # carried a spurious >= 3.13 grade
    if w == 0 or s < 3:
        return 0.0
    return 1.0430 * math.sqrt(poly * 30 / s) + 3.1291


def automated_readability_index(text: str) -> float:
    _, w, s, _, ch, _ = _stats(text)
    if w == 0:
        return 0.0
    return 4.71 * (ch / w) + 0.5 * (w / s) - 21.43


def coleman_liau_index(text: str) -> float:
    _, w, s, _, ch, _ = _stats(text)
    if w == 0:
        return 0.0
    L = ch / w * 100
    S = s / w * 100
    return 0.0588 * L - 0.296 * S - 15.8


def linsear_write_formula(text: str) -> float:
    """First-100-words sample: 1 point per easy word (<3 syllables), 3 per
    hard word, divided by the sample's sentence count; halve, minus 1 when
    the provisional result is <= 20."""
    words, w, _, _, _, _ = _stats(text)
    if w == 0:
        return 0.0
    sample = words[:100]
    pts = sum(1 if count_syllables(x) < 3 else 3 for x in sample)
    # sentence count within the sample's span of the original text
    span_end = 0
    for x in sample:
        span_end = text.find(x, span_end) + len(x)
    n_s = max(len(_SENT_RE.findall(text[:span_end])), 1)
    r = pts / n_s
    return r / 2 if r > 20 else r / 2 - 1


def dale_chall_readability_score(text: str) -> float:
    """Without the 3000-word easy list (not shipped), 'difficult' falls back
    to the >=3-syllable heuristic — a documented approximation."""
    words, w, s, _, _, _ = _stats(text)
    if w == 0:
        return 0.0
    difficult = sum(1 for x in words if count_syllables(x) >= 3)
    pdw = 100 * difficult / w
    score = 0.1579 * pdw + 0.0496 * (w / s)
    if pdw > 5:
        score += 3.6365
    return score


def difficult_words_ratio(text: str) -> float:
    words, w, _, _, _, _ = _stats(text)
    if w == 0:
        return 0.0
    return sum(1 for x in words if count_syllables(x) >= 3) / w


def _grade_votes(text: str) -> list[float]:
    return [flesch_kincaid_grade(text), gunning_fog(text),
            smog_index(text), automated_readability_index(text),
            coleman_liau_index(text)]


def text_standard(text: str) -> float:
    """Consensus grade: median-ish average of the grade-level formulas
    (textstat aggregates votes; the mean of rounded grades is the
    float_output analogue)."""
    grades = [round(g) for g in _grade_votes(text)]
    return sum(grades) / len(grades)


def get_readability_scores(text: str) -> dict:
    """Same key set as evaluate.py:253-266. The grade formulas are computed
    once and reused for text_standard (the eval loop calls this twice per
    sample; recomputing the five votes doubled the per-text work)."""
    fk, fog, smog, ari, cli = _grade_votes(text)
    votes = [round(g) for g in (fk, fog, smog, ari, cli)]
    return {
        "flesch_reading_ease": flesch_reading_ease(text),
        "flesch_kincaid_grade": fk,
        "gunning_fog": fog,
        "smog_index": smog,
        "automated_readability_index": ari,
        "coleman_liau_index": cli,
        "linsear_write_formula": linsear_write_formula(text),
        "dale_chall_readability_score": dale_chall_readability_score(text),
        "text_standard": sum(votes) / len(votes),
        "difficult_words": (difficult_words_ratio(text)),
    }


# ---------------------------------------------------------------------------
# Narrative productivity (type-token ratio family), evaluate.py:273-355
# ---------------------------------------------------------------------------

def _is_word(tok: str) -> bool:
    return tok not in string.punctuation


def _tokenize(text: str) -> list[str]:
    try:
        from nltk import word_tokenize
        return word_tokenize(text)
    except Exception:  # pragma: no cover
        return re.findall(r"\w+|[^\w\s]", text)


def basic_ttr(n_terms: int, n_words: int) -> float:
    return n_terms / n_words if n_words else 0


def root_ttr(n_terms: int, n_words: int) -> float:
    return n_terms / math.sqrt(n_words) if n_words else 0


def corrected_ttr(n_terms: int, n_words: int) -> float:
    return n_terms / math.sqrt(2 * n_words) if n_words else 0


def herdan(n_terms: int, n_words: int) -> float:
    return math.log(n_terms) / math.log(n_words) if n_words > 1 else 0


def summer(n_terms: int, n_words: int):
    """Reference quirk preserved: the function computes the value but never
    returns it (evaluate.py:336-345), so generations.jsonl stores null."""
    try:
        math.log(math.log(n_terms)) / math.log(math.log(n_words))
    except ValueError:
        return 0


def maas(n_terms: int, n_words: int) -> float:
    if n_words <= 1:
        return 0.2
    score = (math.log(n_words) - math.log(n_terms)) / (math.log(n_words) ** 2)
    return min(score, 0.2)


def get_narrative_productivity(text: str) -> dict:
    doc = [t for t in _tokenize(text) if _is_word(t)]
    n_words = len(doc)
    n_terms = len(set(doc))
    return {
        "basic_ttr": basic_ttr(n_terms, n_words),
        "root_ttr": root_ttr(n_terms, n_words),
        "corrected_ttr": corrected_ttr(n_terms, n_words),
        "herdan": herdan(n_terms, n_words),
        "summer": summer(n_terms, n_words),
        "maas": maas(n_terms, n_words),
    }
