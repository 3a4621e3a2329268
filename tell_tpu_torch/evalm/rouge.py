"""ROUGE-L (pycocoevalcap-compatible: LCS F-measure with beta = 1.2)."""
from __future__ import annotations

_BETA = 1.2


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[-1], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l(candidates: list[str], references: list[list[str]]) -> float:
    """Mean over samples; multi-reference combines max precision and max
    recall INDEPENDENTLY before the F-score (pycocoevalcap Rouge.calc_score
    semantics — max over per-ref F-scores gives different, lower values)."""
    scores = []
    for cand, refs in zip(candidates, references):
        c = cand.split()
        prec_max = rec_max = 0.0
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(c, r)
            if lcs == 0 or not c or not r:
                continue
            prec_max = max(prec_max, lcs / len(c))
            rec_max = max(rec_max, lcs / len(r))
        if prec_max > 0 and rec_max > 0:
            scores.append(((1 + _BETA ** 2) * prec_max * rec_max)
                          / (rec_max + _BETA ** 2 * prec_max))
        else:
            scores.append(0.0)
    return sum(scores) / max(len(scores), 1)
