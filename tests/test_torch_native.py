"""The port's C++ host path (tell_tpu_torch/data/native.py over native/*.cpp)
against tell_tpu's and against the port's own Python routes, on the CPU.

NativeBPE: ids equal to tell_tpu's NativeBPE and to the port's ByteBPE on
the fixed texts of tests/test_native_bpe.py and on seeded random unicode,
and decode round-trips. NativeShardReader: shards written by either package
read equal to ShardReader, and after a close and reopen. RecordDataset: an
epoch equal to tell_tpu's, native against native, in order and content.
pack_batch: the C++ gather (_native_pack) bit for bit equal to the port's
numpy route and to tell_tpu's pack_batch (both routes) on the flagship's
fields and the pointer masks. A compressed .npz takes the logged Python
route; garbage raises. The library builds into an empty directory.
"""
import logging
import time

import numpy as np
import pytest

from tell_tpu.data import bucketing as jb
from tell_tpu.data import native as jn
from tell_tpu.data import records as jr
from tell_tpu_torch.data import bucketing as tb
from tell_tpu_torch.data import native as tn
from tell_tpu_torch.data import records as tr
from tell_tpu_torch.data.tokenizer import ByteBPE, RobertaTokenizer
from tests.test_native_bpe import TEXTS, synthetic


def _jax_library():
    """tell_tpu's library (its own make build). tests/test_native_bpe.py
    deletes and rebuilds that file, so a load that lands in the gap is
    tried again."""
    for _ in range(10):
        lib = jn.load_library()
        if lib is not None:
            return lib
        time.sleep(1.0)
    raise RuntimeError("tell_tpu's native library did not load")


@pytest.fixture(scope="module")
def bpes():
    vocab, merges = synthetic(None)
    return (tn.NativeBPE(vocab, merges), ByteBPE(vocab, merges),
            jn.NativeBPE(vocab, merges, lib=_jax_library()))


@pytest.mark.parametrize("text", TEXTS)
def test_native_bpe_ids_equal_jax_and_python(bpes, text):
    native, python, jax_native = bpes
    ids = native.encode(text)
    assert ids == python.encode(text) == jax_native.encode(text)


def test_native_bpe_random_unicode_and_round_trip(bpes):
    native, python, jax_native = bpes
    rng = np.random.default_rng(0)
    pools = ["abcdefgh ", "the news er on in ", "'s't'll'd'",
             "áéí中文🎉 　 \t\n\xa0", "0123 !?.,:;½Ⅻ"]
    for i in range(400):
        if i % 2:
            pool = pools[i % len(pools)]
            text = "".join(rng.choice(list(pool), rng.integers(0, 60)))
        else:       # any code point outside the surrogates
            cps = rng.integers(1, 0x30000, rng.integers(0, 40))
            text = "".join(chr(c) for c in cps if not 0xD800 <= c < 0xE000)
        ids = native.encode(text)
        assert ids == python.encode(text) == jax_native.encode(text), \
            repr(text)
        assert native.decode(ids) == python.decode(ids)
    text = "the news. won't stop — 中文 😀 with a \x00 NUL"
    assert native.decode(native.encode(text)) == text


def test_tokenizer_from_files_takes_native_by_default(tmp_path):
    import json
    vocab, merges = synthetic(None)
    vf, mf = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vf.write_text(json.dumps(vocab), encoding="utf-8")
    mf.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in
                                                merges) + "\n",
                  encoding="utf-8")
    tok = RobertaTokenizer.from_files(str(vf), str(mf))
    ref = RobertaTokenizer.from_files(str(vf), str(mf), use_native=False)
    assert isinstance(tok.bpe, tn.NativeBPE)
    assert isinstance(ref.bpe, ByteBPE)
    text = "the news won't stop, the new era"
    assert tok.encode(text) == ref.encode(text)
    spans = [(4, 8, 1), (24, 32, 2)]
    assert (tok.encode_with_indexed_spans(text, spans)
            == ref.encode_with_indexed_spans(text, spans))


def _examples(rng, n, pointer=True):
    """The flagship's fields (fp16 grid, ragged faces/objects, some
    examples without them, articles longer than their bucket), the
    pointer masks, 0-d strings and a bool."""
    out = []
    for i in range(n):
        nc = int(rng.integers(3, 300))
        nk = int(rng.integers(2, 40))
        ex = {"context_ids": rng.integers(0, 50000, nc, np.int32),
              "caption_ids": rng.integers(0, 50000, nk, np.int32),
              "image_grid": rng.normal(size=(49, 16)).astype(np.float16),
              "caption": f"caption {i} — héllo ☃ {'x' * i}",
              "image_hash": f"{i:032x}",
              "web_url": "https://example.com/" + "a" * i}
        if pointer:
            ex["proper_masks"] = rng.integers(-1, 4, nc).astype(np.int32)
            ex["caption_copy_masks"] = rng.integers(0, 3, nk).astype(
                np.int32)
        if i % 3:
            ex["face_embeds"] = rng.normal(
                size=(int(rng.integers(0, 7)), 8)).astype(np.float32)
            ex["obj_embeds"] = rng.normal(
                size=(int(rng.integers(1, 20)), 16)).astype(np.float32)
        if i % 4 == 0:
            ex["real_flag"] = np.asarray(i % 2 == 0)
        out.append(ex)
    out[0]["face_embeds"] = rng.normal(size=(5, 8)).astype(np.float32)
    out[0]["obj_embeds"] = rng.normal(size=(12, 16)).astype(np.float32)
    return out


def _equal(a, b):
    if isinstance(a, (str, list)) or isinstance(b, (str, list)):
        assert a == b
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()          # NaN bits included


def _equal_dicts(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        _equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_shard_reader_equals_python_after_reopen(tmp_path, writer):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "t-00000.npz")
    (tr if writer == "torch" else jr).write_shard(path, _examples(rng, 7))
    python = tr.ShardReader(path)
    native = tn.NativeShardReader(path)
    assert len(native) == len(python) == 7
    first = [native[i] for i in range(7)]
    for i in range(7):
        _equal_dicts(first[i], python[i])
        assert native.fields_of(i) == python.fields_of(i)
        for f in python.fields_of(i):
            _equal(native.read_field(i, f), python.read_field(i, f))
            arr = np.asarray(python.read_field(i, f))
            assert (native.field_shape(i, f) == python.field_shape(i, f)
                    == arr.shape)
            assert (native.field_dtype(i, f) == python.field_dtype(i, f)
                    == arr.dtype)
        assert python.field_shape(i, "absent") is None
        assert native.field_dtype(i, "absent") is None
    assert native.native and not python.native
    native.close()
    for i in range(7):
        _equal_dicts(native[i], first[i])       # reopened on access
        assert first[i]["context_ids"].flags.owndata


def test_record_dataset_epoch_equals_jax_native(tmp_path):
    rng = np.random.default_rng(2)
    for s in range(3):
        tr.write_shard(str(tmp_path / f"t-{s:05d}.npz"), _examples(rng, 5))
    pattern = str(tmp_path / "t-*.npz")
    _jax_library()
    ours = tr.RecordDataset(pattern, seed=7)
    theirs = jr.RecordDataset(pattern, seed=7)
    assert all(isinstance(r, tn.NativeShardReader) for r in ours.readers)
    assert all(isinstance(r, jn.NativeShardReader) for r in theirs.readers)
    python = tr.RecordDataset(pattern, seed=7, use_native=False)
    assert all(type(r) is tr.ShardReader for r in python.readers)
    for e in (0, 3):
        a = list(ours.epoch(epoch_index=e))
        b = list(theirs.epoch(epoch_index=e))
        c = list(python.epoch(epoch_index=e))
        assert len(a) == len(b) == len(c) == 15
        for x, y, z in zip(a, b, c):
            _equal_dicts(x, y)
            _equal_dicts(x, z)
    ours._max_open = 1                  # every shard change closes one
    lazy = [ex.materialize() for ex in ours.epoch(epoch_index=1, lazy=True)]
    for x, y in zip(lazy, theirs.epoch(epoch_index=1)):
        _equal_dicts(x, y)


BCFG = dict(article_lengths=(64, 128, 256), caption_lengths=(16, 32, 64),
            token_budget=2048, max_batch=8, max_faces=4, face_dim=8,
            max_objects=10, object_dim=16)


@pytest.mark.parametrize("pointer", [True, False],
                         ids=["pointer_masks", "flagship"])
def test_native_pack_equals_numpy_and_jax(tmp_path, pointer):
    rng = np.random.default_rng(5)
    for s in range(2):
        tr.write_shard(str(tmp_path / f"t-{s:05d}.npz"),
                       _examples(rng, 13, pointer))
    pattern = str(tmp_path / "t-*.npz")
    tcfg, jcfg = tb.BucketingConfig(**BCFG), jb.BucketingConfig(**BCFG)

    def ours(use_native, lazy=True, meta=False):
        ds = tr.RecordDataset(pattern, seed=3, use_native=use_native)
        return list(tb.bucket_batches(ds.epoch(epoch_index=0, lazy=lazy),
                                      tcfg, include_meta=meta))

    native = ours(True)
    assert len(native) >= 4
    routes = [ours(True, lazy=False), ours(False)]
    _jax_library()
    theirs = jr.RecordDataset(pattern, seed=3)
    routes.append(list(jb.bucket_batches(
        theirs.epoch(epoch_index=0, lazy=True), jcfg)))
    routes.append(list(jb.bucket_batches(theirs.epoch(epoch_index=0),
                                         jcfg)))
    fields = {"context_ids", "caption_ids", "article_mask", "image_grid"}
    if pointer:
        fields |= {"proper_masks", "caption_copy_masks"}
    for batch in native:
        assert fields <= set(batch)
    # faces/objects are packed where a batch's first example has them
    assert sum("face_embeds" in b and "obj_embeds" in b for b in native) >= 2
    for other in routes:
        assert len(other) == len(native)
        for a, b in zip(native, other):
            _equal_dicts(a, b)
    # the metadata rides along on the native route as on the numpy one
    for a, b in zip(ours(True, meta=True), ours(False, meta=True)):
        _equal_dicts(a, b)
        assert a["caption"][0].startswith("caption")


def test_native_pack_refuses_mismatched_members(tmp_path):
    rng = np.random.default_rng(6)
    ex = _examples(rng, 2, pointer=False)
    ex[1]["face_embeds"] = rng.normal(size=(2, 8)).astype(np.float64)
    path = str(tmp_path / "t-00000.npz")
    tr.write_shard(path, ex)
    lazy = list(tr.RecordDataset(path).epoch(lazy=True))
    with pytest.raises(ValueError, match="face_embeds"):
        tb.pack_batch(lazy, 256, 32, tb.BucketingConfig(**BCFG))


def test_compressed_shard_logs_and_reads_python_garbage_raises(tmp_path,
                                                               caplog):
    path = str(tmp_path / "c.npz")
    with open(path, "wb") as f:
        np.savez_compressed(f, **{"__len__": np.asarray(1),
                                  "0/x": np.arange(5, dtype=np.int32)})
    with pytest.raises(RuntimeError):
        tn.NativeShardReader(path)
    with caplog.at_level(logging.INFO, logger="tell_tpu_torch.native"):
        r = tn.native_shard_reader(path)
    assert type(r) is tr.ShardReader
    assert any("compressed" in rec.message for rec in caplog.records)
    np.testing.assert_array_equal(r[0]["x"], np.arange(5, dtype=np.int32))
    assert (r.field_shape(0, "x"), r.field_dtype(0, "x")) == (
        (5,), np.dtype(np.int32))
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip file at all, definitely " * 4)
    with pytest.raises(RuntimeError, match="open failed"):
        tn.native_shard_reader(str(bad))
    with pytest.raises(RuntimeError):
        tr.RecordDataset(str(bad))


def test_library_builds_into_an_empty_directory(tmp_path):
    build_dir = tmp_path / "build"
    path = tn.build(build_dir)
    assert path.exists() and path.parent == build_dir
    assert path.name == tn.library_path(build_dir).name
    assert [p.name for p in build_dir.iterdir()] == [path.name]
    lib = tn.load_library(build_dir)
    vocab, merges = synthetic(None)
    text = "the new era, café 中文"
    assert (tn.NativeBPE(vocab, merges, lib=lib).encode(text)
            == ByteBPE(vocab, merges).encode(text))
