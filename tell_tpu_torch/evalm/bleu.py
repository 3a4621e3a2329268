"""Corpus and sentence BLEU (pycocoevalcap-compatible).

Replaces the reference's pycocoevalcap BleuScorer usage
(the reference's scripts/compute_metrics.py:61-289 and the online BLEU in
transformer_faces_objects.py:109-116). Matches the 'closest' reference-length
option and the epsilon-smoothed precision product of pycocoevalcap.
"""
from __future__ import annotations

import math
from collections import Counter

_EPS = 1e-9
_TINY = 1e-15


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu_scores(candidates: list[str], references: list[list[str]],
                max_n: int = 4) -> list[float]:
    """Corpus BLEU-1..max_n. candidates[i] vs references[i] (>=1 refs)."""
    assert len(candidates) == len(references)
    correct = [0] * max_n
    total = [0] * max_n
    cand_len = 0
    ref_len = 0.0
    for cand, refs in zip(candidates, references):
        c = cand.split()
        rs = [r.split() for r in refs]
        cand_len += len(c)
        # 'closest' reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(c, n)
            maxref: Counter = Counter()
            for r in rs:
                rn = _ngrams(r, n)
                for g, k in rn.items():
                    maxref[g] = max(maxref[g], k)
            total[n - 1] += max(len(c) - n + 1, 0)
            correct[n - 1] += sum(min(k, maxref[g]) for g, k in cn.items())

    bleus = []
    ratio = cand_len / (ref_len + _TINY)
    bp = 1.0 if ratio >= 1.0 else math.exp(1 - 1 / (ratio + _TINY))
    p_prod = 1.0
    for n in range(max_n):
        p_n = (correct[n] + _TINY) / (total[n] + _EPS)
        p_prod *= p_n
        bleus.append(bp * p_prod ** (1.0 / (n + 1)))
    return bleus


def sentence_bleu(candidate: str, references: list[str],
                  max_n: int = 4) -> list[float]:
    return bleu_scores([candidate], [references], max_n)
