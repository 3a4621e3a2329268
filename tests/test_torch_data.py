"""The port's data layer against tell_tpu's: on shards written by
tell_tpu.data.records.write_shard, the port's RecordDataset +
bucket_batches give the same batches as tell_tpu's (keys, shapes, dtypes,
values with NaN rows for absent faces/objects, and the `real` mask of a
padded last batch), for the seeded epoch orders the trainer uses, lazy
(tell_tpu's native C++ gather when its library loads) and materialised.
Then the prefetcher moves them to the device unchanged.
"""
import numpy as np
import pytest
import torch

from tell_tpu.data.bucketing import (BucketingConfig as JBucketingConfig,
                                     bucket_batches as j_bucket_batches)
from tell_tpu.data.records import (RecordDataset as JRecordDataset,
                                   write_shard as j_write_shard)
from tell_tpu_torch.data.bucketing import BucketingConfig, bucket_batches
from tell_tpu_torch.data.prefetch import DevicePrefetcher
from tell_tpu_torch.data.records import RecordDataset, write_shard

BK = dict(article_lengths=(16, 32), caption_lengths=(8, 12),
          token_budget=160, max_batch=4, max_faces=3, face_dim=8,
          max_objects=5, object_dim=6)


@pytest.fixture(scope="module")
def shard_glob(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(0)
    examples = []
    for i in range(23):
        ex = {
            "context_ids": rng.randint(3, 90, rng.randint(5, 30)).astype(
                np.int32),
            "caption_ids": rng.randint(3, 90, rng.randint(3, 12)).astype(
                np.int32),
            "image_grid": rng.randn(4, 6).astype(np.float16),
            "face_embeds": rng.randn(rng.randint(0, 4), 8).astype(
                np.float32),
            "obj_embeds": rng.randn(rng.randint(1, 7), 6).astype(np.float32),
            "caption": f"caption {i}"}
        examples.append(ex)
    j_write_shard(str(d / "train-00000.npz"), examples[:12])
    j_write_shard(str(d / "train-00001.npz"), examples[12:])
    return str(d / "train-*.npz")


def _assert_same(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("epoch_index", [0, 3, None])
def test_batches_equal_tell_tpu(shard_glob, lazy, epoch_index):
    """epoch_index None: shard order, tell_tpu's epoch(shuffle=False)."""
    ours = list(bucket_batches(
        RecordDataset(shard_glob, seed=5).epoch(epoch_index, lazy=lazy),
        BucketingConfig(**BK)))
    order = (dict(shuffle=False) if epoch_index is None
             else dict(epoch_index=epoch_index))
    ref = list(j_bucket_batches(
        JRecordDataset(shard_glob, seed=5).epoch(lazy=lazy, **order),
        JBucketingConfig(**BK)))
    _assert_same(ours, ref)
    assert any("real" in b and not b["real"].all() for b in ours)
    assert any(np.isnan(b["face_embeds"]).all(-1).any() for b in ours)


def test_port_shards_read_by_tell_tpu(shard_glob, tmp_path):
    """write_shard's format is tell_tpu's: either package reads it."""
    exs = list(RecordDataset(shard_glob).epoch())
    write_shard(str(tmp_path / "s.npz"), exs)
    again = list(JRecordDataset(str(tmp_path / "s.npz")).epoch(
        shuffle=False))
    _assert_same(exs, again)


def test_prefetcher_moves_batches_unchanged(shard_glob):
    batches = list(bucket_batches(
        RecordDataset(shard_glob).epoch(epoch_index=0),
        BucketingConfig(**BK)))
    with DevicePrefetcher(iter(batches), "cpu") as pf:
        got = list(pf)
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        for k, v in b.items():
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), v)
    # closing early releases the queue and stops the worker
    pf = DevicePrefetcher(iter(batches * 10), "cpu")
    next(pf)
    pf.close()
    assert not pf._thread.is_alive() and pf._q.empty()
