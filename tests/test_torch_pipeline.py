"""The port's readers, preprocess and feature generator against tell_tpu's.

Readers: iter_examples' examples equal on every article of the quality
corpus. Features: the port's write_features writes the JAX tool's bytes.
Shards: preprocess_split (train and valid) writes the same members, array
by array and string by string, on the quality corpus (grids and objects
from the features) and on tests/test_e2e_cli.py's synthetic corpus. What
the port cannot preprocess yet is refused with its ROADMAP item.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from tell_tpu.data.pipeline import load_objects_jsonl as j_objects
from tell_tpu.data.pipeline import make_image_grid_fn as j_grid_fn
from tell_tpu.data.pipeline import preprocess_split as j_preprocess
from tell_tpu.data.readers import ReaderConfig as JReaderConfig
from tell_tpu.data.readers import iter_examples as j_iter
from tell_tpu.data.readers import pad_embeds as j_pad
from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.data.pipeline import (entity_occurrences,
                                          load_objects_jsonl,
                                          make_image_grid_fn,
                                          preprocess_split,
                                          read_articles_jsonl)
from tell_tpu_torch.data.readers import ReaderConfig, iter_examples, pad_embeds
from tell_tpu_torch.data.tokenizer import RobertaTokenizer
from tell_tpu_torch.tools.gen_quality_corpus import (read_articles,
                                                     write_features)
from tests.test_e2e_cli import _articles
from tests.test_tokenizer import build_synthetic_vocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(ROOT, "tests", "fixtures", "quality")
VOCAB, MERGES = (os.path.join(QUALITY, "vocab.json"),
                 os.path.join(QUALITY, "merges.txt"))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "gen_quality_corpus", os.path.join(ROOT, "tools",
                                           "gen_quality_corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """Both tools' features for the committed corpus."""
    arts = read_articles(os.path.join(QUALITY, "articles.jsonl"))
    out = {}
    for name, fn in (("torch", write_features),
                     ("jax", _jax_tool().write_features)):
        d = tmp_path_factory.mktemp(f"features_{name}")
        fn(arts, str(d), 7)
        out[name] = d
    return arts, out


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f")
    return type(a) is type(b) and a == b


def test_write_features_is_byte_identical(features):
    arts, dirs = features
    t, j = dirs["torch"], dirs["jax"]
    assert (t / "objects.jsonl").read_bytes() == (j / "objects.jsonl"
                                                  ).read_bytes()
    names = sorted(os.listdir(t / "grids"))
    assert len(names) == 32 and names == sorted(os.listdir(j / "grids"))
    for n in names:
        assert (t / "grids" / n).read_bytes() == (j / "grids" / n
                                                  ).read_bytes()


@pytest.mark.parametrize("strategy", ["location_aware", "simple"])
def test_iter_examples_equal_jax(features, strategy):
    arts, dirs = features
    tt = RobertaTokenizer.from_files(VOCAB, MERGES)
    jt = JTokenizer.from_files(VOCAB, MERGES, use_native=False)
    lookup = load_objects_jsonl(str(dirs["torch"] / "objects.jsonl"))
    jlookup = j_objects(str(dirs["jax"] / "objects.jsonl"))
    cfg = ReaderConfig(strategy=strategy, emit_copy_masks=True,
                       token_budget=40)
    jcfg = JReaderConfig(strategy=strategy, emit_copy_masks=True,
                         token_budget=40)
    n = 0
    for art in arts:
        got = list(iter_examples(art, cfg, lambda s: len(tt.bpe.encode(s)),
                                 lookup))
        want = list(j_iter(art, jcfg, lambda s: len(jt.bpe.encode(s)),
                           jlookup))
        assert len(got) == len(want) == 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert _equal(g[k], w[k]), k
        n += len(got)
        assert np.array_equal(pad_embeds(got[0]["obj_embeds"], 8, 2048),
                              j_pad(want[0]["obj_embeds"], 8, 2048),
                              equal_nan=True)
    assert n == 32


def _shards(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".npz"):
            with np.load(os.path.join(directory, name)) as z:
                out[name] = {k: z[k] for k in z.files}
    return out


def _assert_same_shards(a, b):
    sa, sb = _shards(a), _shards(b)
    assert sa and sa.keys() == sb.keys()
    for name in sa:
        assert sa[name].keys() == sb[name].keys(), name
        for k in sa[name]:
            assert _equal(sa[name][k], sb[name][k]), (name, k)


def test_preprocess_quality_corpus_equals_jax(features, tmp_path):
    arts, dirs = features
    tt = RobertaTokenizer.from_files(VOCAB, MERGES)
    jt = JTokenizer.from_files(VOCAB, MERGES, use_native=False)
    articles = os.path.join(QUALITY, "articles.jsonl")
    for split in ("train", "valid"):
        n = preprocess_split(
            read_articles_jsonl(articles), tt, ReaderConfig(),
            str(tmp_path / "torch"), split,
            image_grid_fn=make_image_grid_fn(str(dirs["torch"] / "grids")),
            objects_lookup=load_objects_jsonl(
                str(dirs["torch"] / "objects.jsonl")))
        jn = j_preprocess(
            read_articles_jsonl(articles), jt, JReaderConfig(),
            str(tmp_path / "jax"), split,
            image_grid_fn=j_grid_fn(str(dirs["jax"] / "grids")),
            objects_lookup=j_objects(str(dirs["jax"] / "objects.jsonl")))
        assert n == jn == 32
    _assert_same_shards(tmp_path / "torch", tmp_path / "jax")
    shard = _shards(tmp_path / "torch")["train-00000.npz"]
    assert shard["0/image_grid"].shape == (49, 2048)
    assert shard["0/image_grid"].dtype == np.float16
    assert shard["0/obj_embeds"].shape == (6, 2048)
    assert str(shard["0/caption"]).startswith("Zainab Weber")


@pytest.mark.parametrize("copy", [False, True])
def test_preprocess_synthetic_corpus_equals_jax(tmp_path, copy):
    vf, mf = build_synthetic_vocab(tmp_path)
    _articles(tmp_path / "articles.jsonl")
    tt = RobertaTokenizer.from_files(vf, mf, max_len=128)
    jt = JTokenizer.from_files(vf, mf, max_len=128, use_native=False)
    kw = dict(use_objects=False, token_budget=40, emit_copy_masks=copy)
    n = preprocess_split(read_articles_jsonl(str(tmp_path / "articles.jsonl")),
                         tt, ReaderConfig(**kw), str(tmp_path / "torch"),
                         "train", shard_size=4)
    jn = j_preprocess(read_articles_jsonl(str(tmp_path / "articles.jsonl")),
                      jt, JReaderConfig(**kw), str(tmp_path / "jax"), "train",
                      shard_size=4)
    assert n == jn == 10
    assert len(_shards(tmp_path / "torch")) == 3
    _assert_same_shards(tmp_path / "torch", tmp_path / "jax")


def test_raw_images_skip_without_a_tower_and_refuse_with_one(tmp_path):
    """Without a tower a raw image gives None (the example is skipped). A
    towers/resnet152 without the port's state.pt (tell_tpu's orbax tree)
    is refused naming migrate/orbax_to_torch.py; with a converted tower a
    broken PNG or JPEG raises as corrupt. Raw JPEGs through a converted
    tower: tests/test_torch_vision.py."""
    import torch

    from tell_tpu_torch.bridge import init_resnet
    from tell_tpu_torch.models.backbones.resnet import ResNetConfig
    (tmp_path / "imgs").mkdir()
    np.save(tmp_path / "imgs" / "a.npy", np.ones((49, 2048), np.float16))
    (tmp_path / "imgs" / "b.jpg").write_bytes(b"\xff\xd8")
    (tmp_path / "imgs" / "c.png").write_bytes(b"\x89PNG\r\n\x1a\n")
    towers = str(tmp_path / "towers")
    fn = make_image_grid_fn(str(tmp_path / "imgs"), towers, "cpu")
    assert fn("a").shape == (49, 2048)
    assert fn("b") is None and fn("c") is None
    assert fn("missing") is None and fn("") is None
    (tmp_path / "towers" / "resnet152").mkdir(parents=True)
    fn = make_image_grid_fn(str(tmp_path / "imgs"), towers, "cpu")
    assert fn("a").shape == (49, 2048)
    with pytest.raises(NotPortedError, match="orbax_to_torch.py towers"):
        fn("b")
    torch.save(init_resnet(torch.Generator().manual_seed(0),
                           ResNetConfig((1, 1, 1, 1), 8)),
               tmp_path / "towers" / "resnet152" / "state.pt")
    fn = make_image_grid_fn(str(tmp_path / "imgs"), towers, "cpu")
    with pytest.raises(ValueError, match="corrupt or truncated PNG"):
        fn("c")
    with pytest.raises(ValueError, match="truncated"):
        fn("b")


def test_glove_is_refused(tmp_path):
    vf, mf = build_synthetic_vocab(tmp_path)
    with pytest.raises(NotPortedError, match="queue 1 item 9"):
        preprocess_split(iter([]), RobertaTokenizer.from_files(vf, mf),
                         ReaderConfig(), str(tmp_path), "train",
                         glove=object())


def test_entity_occurrences_equal_jax():
    from tell_tpu.data.pipeline import entity_occurrences as j_occ
    text = "Rosenberg met Rose at the Rose garden; Roses bloomed. Émile Ém"
    ents = ["Rose", "", "Émile", "Ém"]
    assert entity_occurrences(text, ents) == j_occ(text, ents)
    assert json.dumps(entity_occurrences(text, ents))
