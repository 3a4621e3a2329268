"""The port's tokenizer (tell_tpu_torch/data/tokenizer.py) against the
golden indexer fixtures (tests/fixtures/indexer_golden.json, written by
the reference-pipeline oracle; tests/test_indexer_fixtures.py holds
tell_tpu to them): both BPE back ends, the C++ NativeBPE and the Python
ByteBPE, give every case's ids and its copy/proper masks token for token
(newlines, repeated spaces, accented names, unicode punctuation, long
words, truncation, overlapping and partial entity spans, the space-shift
containment quirk), and the plain encode agrees on the ids of the cases
without spans."""
import json
import os

import pytest

from tell_tpu_torch.data.native import NativeBPE
from tell_tpu_torch.data.tokenizer import ByteBPE, RobertaTokenizer

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "indexer_golden.json")
with open(FIXTURE, encoding="utf-8") as _f:
    GOLDEN = json.load(_f)


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    td = tmp_path_factory.mktemp("vocab")
    vf, mf = td / "vocab.json", td / "merges.txt"
    vf.write_text(json.dumps(GOLDEN["vocab"], ensure_ascii=False),
                  encoding="utf-8")
    mf.write_text("#version: 0.2\n" + "\n".join(
        f"{a} {b}" for a, b in GOLDEN["merges"]) + "\n", encoding="utf-8")
    return str(vf), str(mf)


@pytest.mark.parametrize("native,bpe", [(True, NativeBPE),
                                        (False, ByteBPE)],
                         ids=["NativeBPE", "ByteBPE"])
def test_tokenizer_reproduces_golden_fixtures(vocab_files, native, bpe):
    tok = RobertaTokenizer.from_files(*vocab_files, use_native=native)
    assert type(tok.bpe) is bpe
    assert len(GOLDEN["cases"]) >= 100
    for case in GOLDEN["cases"]:
        spans = [tuple(s) for s in case["spans"]]
        ids, masks = tok.encode_with_indexed_spans(
            case["text"], spans, max_len=GOLDEN["max_len"])
        assert ids == case["ids"], case["text"]
        assert masks == case["masks"], case["text"]
        if not spans:
            assert tok.encode(case["text"],
                              max_len=GOLDEN["max_len"]) == case["ids"]
