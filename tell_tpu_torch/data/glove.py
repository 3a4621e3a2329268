"""GloVe word vectors for the GloVe experiments (counterpart of
tell_tpu/data/glove.py, expts 1 and 2).

Preprocessing writes each article's [S, 300] GloVe features into its
shard record (`article`, fp16), so training reads them like any other
context and runs no article tower.
"""
from __future__ import annotations

import numpy as np


class GloveVectors:
    """Whitespace-token lookup over a glove.*.300d.txt file; an unknown
    token gets the zero vector (spaCy's out-of-vocabulary semantics)."""

    def __init__(self, vectors: dict[str, np.ndarray], dim: int = 300):
        self.vectors = vectors
        self.dim = dim

    @classmethod
    def from_file(cls, path: str, dim: int = 300,
                  max_words: int | None = None) -> "GloveVectors":
        """The first max_words lines of `path` ("word v1 ... v_dim"); a line
        of another width is skipped."""
        vecs: dict[str, np.ndarray] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                if max_words is not None and i >= max_words:
                    break
                parts = line.rstrip().split(" ")
                if len(parts) != dim + 1:
                    continue
                vecs[parts[0]] = np.asarray(parts[1:], np.float32)
        return cls(vecs, dim)

    def embed_text(self, text: str, max_tokens: int = 512) -> np.ndarray:
        """[S, dim] features of the first max_tokens whitespace tokens: the
        token's vector, else its lowercase's, else zeros."""
        toks = text.split()[:max_tokens]
        out = np.zeros((len(toks), self.dim), np.float32)
        for i, t in enumerate(toks):
            v = self.vectors.get(t)
            if v is None:
                v = self.vectors.get(t.lower())
            if v is not None:
                out[i] = v
        return out
