"""Data-parallel training (tell_tpu_torch/training: the Trainer, the train
step's reduction, each rank's dropout, the loader's stride, rank 0's
checkpoints) on 2 gloo ranks of small_test_config, each rank holding its
rows of every global batch.

Two steps and a validation batch:
* dropout off, with the adaptive softmax's tail capacity on (it
  overflows at these shapes, so the global budget matters): the params
  after the steps, each step's loss, the validation loss and the tail's
  dropped rows equal tell_tpu's train step and loss on the global
  batches (1e-4);
* dropout on (every site, weight and softmax dropout too): they equal a
  one-process account of the same global objective in which rank r's
  rows draw their masks from fold_in(the step's generator, r), weighted
  by their sample sizes (1e-5; tests/_torch_parallel_workers.py's
  rank_masks_reference, which shares none of the step's reduction).
The loader's stride equals tell_tpu's epoch(process_index,
process_count), and a multi-shape bucketing config is refused with more
than one rank, as tell_tpu refuses it. Rank 0 alone writes checkpoints.
A SIGTERM on rank 1 after its first step stops both ranks at the same
batch, with one resumable checkpoint. The Trainer builds the pointer
models and the MoE over two ranks (tests/test_torch_pointer_dp.py and
tests/test_torch_moe_dp.py hold their global-batch objectives).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tell_tpu.config import small_test_config as j_small_config
from tell_tpu.data.records import RecordDataset as JDataset
from tell_tpu.models.captioner import captioner_loss as j_loss
from tell_tpu.training.optimizer import bert_adam as j_bert_adam
from tell_tpu.training.train_step import make_train_step as j_make_step
from tell_tpu_torch.bridge import init_captioner, to_numpy, tree_leaves
from tell_tpu_torch.config import small_test_config
from tell_tpu_torch.data.bucketing import BucketingConfig, bucket_batches
from tell_tpu_torch.data.records import RecordDataset, write_shard
from tell_tpu_torch.parallel import Ranks
from tests import _torch_parallel_workers as W

CAPACITY = dict(tail_capacity_frac=(0.25, 0.125))
DROPOUT = dict(dropout=0.1, attention_dropout=0.1, relu_dropout=0.1,
               input_dropout=0.1, weight_dropout=0.1,
               adaptive_softmax_dropout=0.1)


def _batch(cfg, B, T, seed):
    """tests/test_torch_training.py's captioner batch."""
    D = cfg.decoder
    rng = np.random.default_rng(seed)
    cap = rng.integers(3, D.vocab_size, size=(B, T)).astype(np.int32)
    cap[:, 0] = D.bos_id
    cap[0, T - 3:] = D.pad_id
    cap[-1, T - 1] = D.eos_id
    mask = np.zeros((B, 16), bool)
    mask[0, 10:] = True
    faces = rng.normal(size=(B, 4, 16)).astype(np.float32)
    faces[0, 2:] = np.nan
    objs = rng.normal(size=(B, 8, 32)).astype(np.float32)
    objs[-1, 5:] = np.nan
    return {"caption_ids": cap,
            "article_hiddens": rng.normal(size=(B, 16, 3, 24)).astype(
                np.float32),
            "article_mask": mask,
            "image_grid": rng.normal(size=(B, 9, 32)).astype(np.float32),
            "face_embeds": faces, "obj_embeds": objs}


def _jax_run(params, train, val):
    """tell_tpu's train step on the global batches (dropout off), and its
    loss on the validation batch after them; the tails' dropped rows."""
    jcfg = j_small_config(**CAPACITY)
    opt = j_bert_adam(warmup=0.0, t_total=100)
    step = jax.jit(j_make_step(jcfg, opt))
    p, o = params, opt.init(params)
    losses, dropped = [], 0
    for b in train:
        p, o, m = step(p, o, b, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        dropped += int(m["tail_dropped"])
    val_loss = float(jax.jit(lambda q, b: j_loss(q, jcfg, b)[0])(p, val[0]))
    return jax.tree.map(np.asarray, p), losses, val_loss, dropped


def test_two_ranks_equal_tell_tpu_and_one_rank(tmp_path):
    off = small_test_config(**CAPACITY)
    on = small_test_config(**DROPOUT)
    params = to_numpy(init_captioner(torch.Generator().manual_seed(0), off))
    train = [_batch(off, 8, 12, s) for s in (1, 2, 3)]
    val = [_batch(off, 8, 12, 4)]
    cases = [("off", dict(cfg=off, params=params, train=train[:2], val=val,
                          run_dir=str(tmp_path / "off"))),
             ("on", dict(cfg=on, params=params, train=train[:2], val=val,
                         run_dir=str(tmp_path / "on"))),
             ("sigterm", dict(cfg=off, params=params, train=train, val=val,
                              run_dir=str(tmp_path / "stop"),
                              sigterm_after=1))]
    ranks = Ranks(W.train_cases, 2, (cases,), deadline_s=150)
    j_params, j_losses, j_val, j_dropped = _jax_run(params, train[:2], val)
    one = W.rank_masks_reference(on, params, train[:2], val, 2)
    outs = ranks.join()
    r0, r1 = outs
    for case in ("off", "on"):
        # every rank holds the same params and reports the same losses
        assert r0[case]["losses"] == r1[case]["losses"]
        for a, b in zip(tree_leaves(r0[case]["params"]),
                        tree_leaves(r1[case]["params"])):
            assert np.array_equal(a, b)
    got = r0["off"]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-4)
    np.testing.assert_allclose(got["metrics"][0]["val_loss"], j_val,
                               rtol=1e-4)
    assert got["metrics"][0]["tail_dropped"] == j_dropped > 0
    want = jax.tree.leaves(j_params)
    mine = jax.tree.leaves(jax.tree.map(np.asarray, got["params"]))
    for a, b in zip(mine, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    got = r0["on"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"][0]["val_loss"],
                               one["val_loss"], rtol=1e-5)
    for a, b in zip(tree_leaves(got["params"]),
                    tree_leaves(one["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # rank 0 alone writes (the best and the epoch's checkpoint)
    assert [os.path.basename(p) for p in r0["on"]["writes"]] == \
        ["best", "ckpt-0"] and r1["on"]["writes"] == []
    # SIGTERM on rank 1 after step 1: both stop before step 2
    for r in outs:
        assert r["sigterm"]["result"]["preempted"] is True
        assert r["sigterm"]["step"] == 1
    assert [os.path.basename(p) for p in r0["sigterm"]["writes"]] == \
        ["ckpt-0"] and r1["sigterm"]["writes"] == []
    import json
    meta = json.load(open(tmp_path / "stop" / "checkpoints" / "ckpt-0" /
                          "meta.json"))
    assert (meta["step"], meta["epoch"], meta["batch_cursor"]) == (1, 0, 1)
    for r in outs:
        # once refused as item 10's rest, now built over both ranks
        assert r["refused"] == {"pointer": None, "pointer_2": None,
                                "moe": None}


def test_loader_stride_equals_tell_tpu(tmp_path):
    rng = np.random.default_rng(0)
    for s, n in enumerate((6, 5)):
        write_shard(str(tmp_path / f"train-{s}.npz"), [
            {"caption_ids": rng.integers(3, 50, 6).astype(np.int32),
             "context_ids": rng.integers(3, 50, 20).astype(np.int32)}
            for _ in range(n)])
    pattern = str(tmp_path / "train-*.npz")
    port, ref = RecordDataset(pattern, seed=5), JDataset(pattern, seed=5)
    for epoch in (0, 3):
        seen = []
        for i in range(2):
            mine = [e["caption_ids"].tolist() for e in port.epoch(
                epoch_index=epoch, process_index=i, process_count=2)]
            want = [e["caption_ids"].tolist() for e in ref.epoch(
                epoch_index=epoch, process_index=i, process_count=2)]
            assert mine == want and len(mine) == 5
            seen += mine
        assert len({tuple(c) for c in seen}) == 10
    bcfg = BucketingConfig(article_lengths=(32,), caption_lengths=(8,),
                           max_batch=4)
    batches = list(bucket_batches(port.epoch(epoch_index=0, process_index=1,
                                             process_count=2), bcfg,
                                  ranks=2))
    assert [b["caption_ids"].shape[0] for b in batches] == [2, 2, 2]
    with pytest.raises(ValueError, match="'data' mesh axis \\(3\\)"):
        next(bucket_batches(port.epoch(), bcfg, ranks=3))


def test_multi_shape_bucketing_is_refused_with_several_ranks():
    """As tell_tpu's train refuses it with more than one process: the
    ranks' strides would fill different buckets and deadlock."""
    from tell_tpu_torch.parallel import run_ranks
    bcfg = BucketingConfig(article_lengths=(32,), caption_lengths=(16, 32))
    with pytest.raises(RuntimeError, match="single-shape bucketing"):
        run_ranks(W.data_ranks_of, 2, (bcfg,), deadline_s=60)
