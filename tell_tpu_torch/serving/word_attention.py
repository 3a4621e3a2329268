"""BPE-step -> word-level attention merge for the demo frontend (the
port's copy of tell_tpu/serving/word_attention.py: piece_text,
group_pieces, merge_word_attentions).

The original Transform-and-Tell merges per-BPE attention maps into
per-word payloads inside `generate()` (tell/models/
transformer_faces_objects.py:142-309): caption sub-word steps collapse into words (maps averaged), and
the article source axis collapses into article words (columns summed),
with newline tokens kept as standalone "\\n" words so the frontend can
re-paragraph (demo/frontend/src/App.js:400-460 consumes exactly this).
This module reproduces that contract for the HTTP service.
"""
from __future__ import annotations

import numpy as np


def piece_text(tokenizer, token_id: int) -> str:
    """Readable text of one BPE piece (leading space preserved)."""
    piece = tokenizer.bpe.decoder.get(int(token_id), "")
    data = bytes(tokenizer.bpe.byte_decoder[c] for c in piece
                 if c in tokenizer.bpe.byte_decoder)
    return data.decode("utf-8", errors="replace")


def group_pieces(tokenizer, ids, *, skip_special: bool = True
                 ) -> list[tuple[str, list[int]]]:
    """Group BPE ids into words: [(word_text, [positions])].

    A piece starting with a space or newline opens a new word; newline
    runs become standalone "\\n" words (the reference keeps them as
    paragraph markers). Positions index into `ids`. Special ids (<4) are
    skipped but their positions stay consumed so attention columns keep
    aligning."""
    words: list[tuple[str, list[int]]] = []
    cur_text, cur_pos = "", []
    for i, tid in enumerate(np.asarray(ids).tolist()):
        if skip_special and tid < 4:
            continue
        raw = piece_text(tokenizer, tid)
        if not raw:
            continue
        is_newline = raw.strip(" ") != "" and raw.strip(" ").strip("\n") == ""
        starts_new = raw.startswith(" ") or raw.startswith("\n") or not cur_pos
        if is_newline:
            if cur_pos:
                words.append((cur_text, cur_pos))
            words.append(("\n", [i]))
            cur_text, cur_pos = "", []
            continue
        if starts_new and cur_pos:
            words.append((cur_text, cur_pos))
            cur_text, cur_pos = "", []
        cur_text += raw.lstrip(" ") if not cur_pos else raw
        cur_pos.append(i)
    if cur_pos:
        words.append((cur_text, cur_pos))
    return words


def merge_word_attentions(tokenizer, token_ids, attns: dict,
                          context_ids=None, eos_id: int = 2,
                          source_lens: dict | None = None) -> dict:
    """Merge per-step per-context maps into the frontend's word payload.

    token_ids: [T+1] generated ids including the seed <s>.
    attns: {context_name: [gen_len, S'] list/array} (layer-0 maps; each
        context's source axis may end with bias/zero-attention columns,
        dropped here — App.js:473 ignores them the same way).
    context_ids: the article's BPE ids (with specials), used to collapse
        the article source axis into words.
    source_lens: {context_name: true source length} — when given, the
        number of trailing extra columns is DERIVED as S' - source_len
        (0 for a config without add_bias_kv/add_zero_attn, 2 for the
        reference default) instead of assuming the default's 2.

    Returns {"caption_words": [str], "word_attns": [{ctx: [float]}],
    "article_words": [str] (when context_ids given)}.
    """
    ids = np.asarray(token_ids).tolist()
    steps = []  # generated positions: step t emitted ids[t + 1]
    for t in range(len(ids) - 1):
        tok = ids[t + 1]
        if tok == eos_id or tok == 1:  # eos / pad: caption over
            break
        steps.append(t)
    # group caption pieces (ids[1:]) into words over the emitting steps
    cap_words = group_pieces(tokenizer, [ids[t + 1] for t in steps],
                             skip_special=False)

    maps = {name: np.asarray(a, np.float32) for name, a in attns.items()}
    article_groups = None
    if context_ids is not None and "article" in maps:
        article_groups = group_pieces(tokenizer, context_ids)

    word_attns = []
    for _, positions in cap_words:
        row: dict = {}
        for name, m in maps.items():
            avg = m[[steps[p] for p in positions]].mean(axis=0)
            if source_lens is not None and name in source_lens:
                extra = max(avg.shape[0] - int(source_lens[name]), 0)
            else:
                extra = 2 if avg.shape[0] >= 2 else 0  # default bias/zero
            avg = avg[:avg.shape[0] - extra] if extra else avg
            if name == "article" and article_groups is not None:
                row[name] = [float(avg[[p for p in pos
                                        if p < avg.shape[0]]].sum())
                             for _, pos in article_groups]
            else:
                row[name] = [float(v) for v in avg]
        word_attns.append(row)
    out = {"caption_words": [w for w, _ in cap_words],
           "word_attns": word_attns}
    if article_groups is not None:
        out["article_words"] = [w for w, _ in article_groups]
    return out
