"""The port's byte-BPE tokenizer against tell_tpu's.

tell_tpu pre-tokenizes with the `regex` module (\\p{L}, \\p{N}); the port
scans characters by unicodedata.category and the White_Space property.
Their pieces must be equal on any text, and the ids equal on the quality
corpus with its committed vocabulary. Hypothesis draws characters that
this Python's Unicode database assigns (the `regex` module may know a
newer Unicode, whose new letters Python calls unassigned).
"""
import json
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tell_tpu.data.tokenizer import _PRETOKENIZE
from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
from tell_tpu_torch.data.tokenizer import (RobertaTokenizer, bytes_to_unicode,
                                           pretokenize)
from tests.test_tokenizer import build_synthetic_vocab

QUALITY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality")
VOCAB, MERGES = (os.path.join(QUALITY, "vocab.json"),
                 os.path.join(QUALITY, "merges.txt"))

# the edge cases of \p{L} / \p{N} / \s: letter-like numbers (½ is No, Ⅻ
# is Nl), combining marks (Mn), CJK, the separators U+001C..U+001F (which
# str.isspace() takes and \s does not), no-break and ideographic spaces,
# apostrophes of the contractions
EDGES = list(" \t\n\r\x0b\x0c\x1c\x1f\x85\xa0 　'½Ⅻ́̀"
             "中文語sStrevmld19٣") + ["'s", "'ll", "  ", "\n\n"]


@pytest.fixture(scope="module")
def corpus_texts():
    with open(os.path.join(QUALITY, "articles.jsonl"), encoding="utf-8") as f:
        arts = [json.loads(line) for line in f if line.strip()]
    texts = []
    for a in arts:
        texts.append(a["headline"]["main"])
        texts += [s["text"] for s in a["parsed_section"]]
    return texts


def test_ids_equal_jax_on_the_quality_corpus(corpus_texts):
    jt = JTokenizer.from_files(VOCAB, MERGES, use_native=False)
    tt = RobertaTokenizer.from_files(VOCAB, MERGES)
    assert len(corpus_texts) == 32 * 5
    for text in corpus_texts:
        assert tt.encode(text) == jt.encode(text)
        assert tt.encode(text, max_len=16) == jt.encode(text, max_len=16)
        assert tt.bpe.encode(text) == jt.bpe.encode(text)
        assert tt.decode(tt.encode(text)) == text


@settings(max_examples=400, deadline=None)
@given(st.lists(st.one_of(
    st.sampled_from(EDGES),
    st.characters(blacklist_categories=("Cn", "Cs"))), max_size=40))
def test_pieces_equal_regex(parts):
    text = "".join(parts)
    assert pretokenize(text) == _PRETOKENIZE.findall(text)


@pytest.mark.parametrize("text", [
    "½ of Ⅻ", "café́ naïve 中文 \U0001f600", "  multiple   spaces\t",
    "a\x1cb \x1f c", "don't can't we'll they've I'm he'd", "", " ", "x  ",
    "The New\nYork Times won't say 'hello' — it said ’this’.",
])
def test_pieces_equal_regex_on_edge_cases(text):
    assert pretokenize(text) == _PRETOKENIZE.findall(text)
    assert "".join(pretokenize(text)) == text


def test_indexed_spans_multibyte_entity_equal_jax(tmp_path):
    vf, mf = build_synthetic_vocab(tmp_path)
    jt = JTokenizer.from_files(vf, mf, max_len=64, use_native=False)
    tt = RobertaTokenizer.from_files(vf, mf, max_len=64)
    text = "by Émile Zola today, and Zoë Ñúñez in Ōsaka"
    spans = [(text.index("Émile"), text.index("Émile") + 10, 1),
             (text.index("Zoë"), text.index("Zoë") + 9, 2),
             (text.index("Ōsaka"), len(text), 3)]
    got = tt.encode_with_indexed_spans(text, spans)
    assert got == jt.encode_with_indexed_spans(text, spans)
    assert set(got[1]) == {0, 1, 2, 3}
    assert tt.encode_with_spans(text, [s[:2] for s in spans]) == \
        jt.encode_with_spans(text, [s[:2] for s in spans])
    assert tt.decode(got[0]) == text
    # truncation keeps ids and masks aligned
    short = tt.encode_with_indexed_spans(text, spans, max_len=6)
    assert short == jt.encode_with_indexed_spans(text, spans, max_len=6)
    assert tt.pad(short[0], 9) == jt.pad(short[0], 9)
    assert tt.pad_masks(short[1], 9) == jt.pad_masks(short[1], 9)


def test_bytes_to_unicode_and_round_trip(corpus_texts):
    from tell_tpu.data.tokenizer import bytes_to_unicode as j_b2u
    assert bytes_to_unicode() == j_b2u()
    tt = RobertaTokenizer.from_files(VOCAB, MERGES)
    for text in ("Zainab Weber in Lisbon.", "Ölçü ½ 中文 \U0001f600 ok"):
        ids = tt.encode(text)
        assert ids[0] == tt.BOS and ids[-1] == tt.EOS
        assert tt.decode(ids) == text
        assert tt.decode(ids, skip_special=False).startswith("<s>")
