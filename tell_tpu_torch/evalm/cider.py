"""CIDEr-D scorer (Vedantam et al. 2015), pycocoevalcap-compatible:
n = 1..4, length-gaussian sigma = 6, count clipping, x10 scale.

This is the headline quality metric of the reference (GoodNews CIDEr 54,
README.md:17-19; computed in scripts/compute_metrics.py via pycocoevalcap).
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict

_SIGMA = 6.0
_N = 4


def _ngrams(text: str, n_max: int = _N) -> list[Counter]:
    words = text.split()
    return [Counter(tuple(words[i:i + n]) for i in
                    range(len(words) - n + 1)) for n in range(1, n_max + 1)]


class CiderScorer:
    """Document frequencies come from the evaluation corpus' references
    (pycocoevalcap's 'corpus' mode, as used by compute_metrics.py)."""

    def __init__(self):
        self.cands: list[str] = []
        self.refs: list[list[str]] = []

    def append(self, candidate: str, references: list[str]) -> None:
        self.cands.append(candidate)
        self.refs.append(references)

    def compute(self) -> tuple[float, list[float]]:
        # document frequency over reference *sets*
        df: list[dict] = [defaultdict(float) for _ in range(_N)]
        for refs in self.refs:
            seen = [set() for _ in range(_N)]
            for ref in refs:
                for n, grams in enumerate(_ngrams(ref)):
                    seen[n].update(grams.keys())
            for n in range(_N):
                for g in seen[n]:
                    df[n][g] += 1.0
        log_m = math.log(max(len(self.refs), 1))

        def tfidf(grams_by_n):
            vecs, norms, length = [], [], 0
            for n, grams in enumerate(grams_by_n):
                vec = {}
                norm = 0.0
                for g, tf in grams.items():
                    idf = log_m - math.log(max(df[n][g], 1.0))
                    v = tf * idf
                    vec[g] = v
                    norm += v * v
                vecs.append(vec)
                norms.append(math.sqrt(norm))
                if n == 0:
                    length = sum(grams.values())
            return vecs, norms, length

        scores = []
        for cand, refs in zip(self.cands, self.refs):
            cv, cn, clen = tfidf(_ngrams(cand))
            score_n = [0.0] * _N
            for ref in refs:
                rv, rn, rlen = tfidf(_ngrams(ref))
                delta = clen - rlen
                for n in range(_N):
                    # CIDEr-D: clip candidate counts at reference counts
                    sim = sum(min(cv[n].get(g, 0.0), rv[n][g]) * rv[n][g]
                              for g in rv[n])
                    if cn[n] > 0 and rn[n] > 0:
                        sim /= cn[n] * rn[n]
                    sim *= math.exp(-(delta ** 2) / (2 * _SIGMA ** 2))
                    score_n[n] += sim
            nref = max(len(refs), 1)
            scores.append(10.0 * sum(s / nref for s in score_n) / _N)
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores
