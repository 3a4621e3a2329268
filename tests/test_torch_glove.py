"""GloVe article features (tell_tpu_torch.data.glove, preprocess with a
GloVe table, bucketing's `article` field) against tell_tpu's.

GloveVectors.from_file on a file the test writes (lines of another width
skipped, max_words honoured) and embed_text (the first 512 whitespace
tokens, the token's vector, else its lowercase's, else zeros) equal
tell_tpu's. preprocess_split with that table over the quality corpus and
tests/test_e2e_cli.py's synthetic corpus writes shards equal member for
member to tell_tpu's, each record's `article` the fp16 [S, 300] features
of its context; the batches bucket_batches packs from them, in C++ and
in numpy, equal tell_tpu's (features and the article mask).
"""
import os

import numpy as np
import pytest

from tell_tpu.data.bucketing import BucketingConfig as JBucketing
from tell_tpu.data.bucketing import bucket_batches as j_bucket
from tell_tpu.data.glove import GloveVectors as JGlove
from tell_tpu.data.pipeline import preprocess_split as j_preprocess
from tell_tpu.data.readers import ReaderConfig as JReaderConfig
from tell_tpu.data.records import RecordDataset as JDataset
from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
from tell_tpu_torch.data.bucketing import BucketingConfig, bucket_batches
from tell_tpu_torch.data.glove import GloveVectors
from tell_tpu_torch.data.pipeline import preprocess_split, read_articles_jsonl
from tell_tpu_torch.data.readers import ReaderConfig
from tell_tpu_torch.data.records import RecordDataset
from tell_tpu_torch.data.tokenizer import RobertaTokenizer
from tests.test_e2e_cli import _articles
from tests.test_tokenizer import build_synthetic_vocab
from tests.test_torch_pipeline import (MERGES, QUALITY, VOCAB,
                                       _assert_same_shards, _shards)

WORDS = ("Anna", "smith", "Milan", "went", "to", "on", "the", "day", "a",
         "of", "in", "news", "mayor", "city", "said")


def write_glove(path, dim=300, seed=0) -> str:
    """A GloVe text file over WORDS from the seed, with a line of the
    wrong width and a duplicate of a word later in the file."""
    rng = np.random.default_rng(seed)
    with open(path, "w", encoding="utf-8") as f:
        for i, w in enumerate(WORDS):
            vec = rng.normal(size=dim).round(5)
            f.write(w + " " + " ".join(f"{v:.5f}" for v in vec) + "\n")
            if i == 3:
                f.write("broken 0.1 0.2\n")
        f.write("the " + " ".join(["1.0"] * dim) + "\n")
    return str(path)


@pytest.mark.parametrize("max_words", [None, 6])
def test_glove_vectors_equal_jax(tmp_path, max_words):
    path = write_glove(tmp_path / "glove.txt")
    got = GloveVectors.from_file(path, max_words=max_words)
    want = JGlove.from_file(path, max_words=max_words)
    assert got.vectors.keys() == want.vectors.keys()
    assert "broken" not in got.vectors
    assert len(got.vectors) == (len(WORDS) if max_words is None else 5)
    for w in got.vectors:
        np.testing.assert_array_equal(got.vectors[w], want.vectors[w])
    text = ("Anna SMITH went to Milan , THE Mayor said the day " * 60)
    a, b = got.embed_text(text), want.embed_text(text)
    assert a.shape == (512, 300) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    # the exact token first, then its lowercase; unknown tokens are zero
    assert not a[5].any()                          # ","
    if max_words is None:
        np.testing.assert_array_equal(a[1], got.vectors["smith"])
        np.testing.assert_array_equal(a[6], got.vectors["the"])
    assert got.embed_text("").shape == (0, 300)


def _preprocess(tmp_path, articles, vf, mf, reader, glove_path, **kw):
    tt = RobertaTokenizer.from_files(vf, mf, max_len=512)
    jt = JTokenizer.from_files(vf, mf, max_len=512, use_native=False)
    n = preprocess_split(read_articles_jsonl(articles), tt, reader[0],
                         str(tmp_path / "torch"), "train",
                         glove=GloveVectors.from_file(glove_path), **kw)
    jn = j_preprocess(read_articles_jsonl(articles), jt, reader[1],
                      str(tmp_path / "jax"), "train",
                      glove=JGlove.from_file(glove_path), **kw)
    assert n == jn > 0
    _assert_same_shards(tmp_path / "torch", tmp_path / "jax")
    return _shards(tmp_path / "torch")


def test_glove_preprocess_equals_jax_on_the_quality_corpus(tmp_path):
    glove = write_glove(tmp_path / "glove.txt", seed=1)
    shards = _preprocess(tmp_path, os.path.join(QUALITY, "articles.jsonl"),
                         VOCAB, MERGES, (ReaderConfig(), JReaderConfig()),
                         glove)
    rec = shards["train-00000.npz"]
    assert rec["0/article"].dtype == np.float16
    assert rec["0/article"].shape[1] == 300
    assert rec["0/article"].any()


def test_glove_shards_pack_as_jax_packs_them(tmp_path):
    vf, mf = build_synthetic_vocab(tmp_path)
    _articles(tmp_path / "articles.jsonl")
    glove = write_glove(tmp_path / "glove.txt", seed=2)
    kw = dict(use_objects=False, token_budget=40)
    shards = _preprocess(tmp_path, str(tmp_path / "articles.jsonl"), vf, mf,
                         (ReaderConfig(**kw), JReaderConfig(**kw)), glove,
                         shard_size=4)
    assert shards["train-00000.npz"]["0/article"].shape[1] == 300
    lengths = dict(article_lengths=(16, 32, 64), caption_lengths=(16,),
                   max_batch=4, max_faces=4, face_dim=512)
    pattern = str(tmp_path / "{}" / "train-*.npz")
    want = list(j_bucket(JDataset(pattern.format("jax")).epoch(
        shuffle=False), JBucketing(**lengths)))
    for native in (True, False):
        ds = RecordDataset(pattern.format("torch"), use_native=native)
        got = list(bucket_batches(ds.epoch(lazy=True),
                                  BucketingConfig(**lengths)))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in ("article", "article_mask", "context_ids",
                      "caption_ids"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            # the article mask marks the rows past each article's words
            assert g["article_mask"].any() and (~g["article_mask"]).any()
