"""The pointer family through the port's Trainer on the CPU, against
tell_tpu's Trainer.

tests/test_torch_pointer.py's small faces configuration (weigh_bert: the
article's 3 hidden layers from a RoBERTa of dim 24 encoding it in every
step, the e2e loss), v1 here and v2 in
tests/test_torch_pointer_training_v2.py, copy-attention dropout 0 on both
sides
(the decoder's dropouts are 0 in the small configuration). Shards of 12
examples with entities in their articles and captions (proper_masks,
caption_copy_masks; one caption without any, whose loss is 0). Three
steps of the port's Trainer and three of tell_tpu's (n_data=1), the same
weights (tell_tpu's init_pointer) and batches: the loss, params and the
BertAdam moments within 1e-5 (absolute and relative); the generation
loss trains nothing on either side.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.models.backbones import RobertaConfig as JRobertaConfig
from tell_tpu.models.backbones import init_roberta as j_init_roberta
from tell_tpu.models.registry import get_model as j_get_model
from tell_tpu.training.trainer import Trainer as JTrainer
from tell_tpu.training.trainer import TrainerConfig as JTrainerConfig
from tell_tpu_torch.bridge import to_torch, tree_leaves
from tell_tpu_torch.data.bucketing import BucketingConfig, bucket_batches
from tell_tpu_torch.data.records import RecordDataset, write_shard
from tell_tpu_torch.models.backbones.roberta import RobertaConfig
from tell_tpu_torch.models.registry import get_model
from tell_tpu_torch.training.trainer import (Trainer, TrainerConfig,
                                             step_generator)
from tests.test_torch_pointer import configs, jax_params

torch.set_num_threads(2)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
RKW = dict(vocab_size=500, dim=24, num_layers=2, num_heads=4, ffn_dim=32,
           max_positions=40)
BCFG = BucketingConfig(article_lengths=(16,), caption_lengths=(12,),
                       token_budget=112, max_batch=4, max_faces=4,
                       face_dim=16)
RUN = dict(patience=10, lr=3e-3, t_total=200, log_every=1000)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("pointer_shards")
    rng = np.random.RandomState(1)
    ex = []
    for i in range(12):
        la, lc = rng.randint(8, 14), rng.randint(6, 10)
        ctx = np.concatenate([[0], rng.randint(4, 90, la), [2]])
        cap = np.concatenate([[0], rng.randint(4, 90, lc), [2]])
        proper = np.zeros(len(ctx), np.int32)
        cmask = np.zeros(len(cap), np.int32)
        if i != 5:
            for e, (a, b, c) in enumerate(((1, 4, 2), (6, 7, 4)), 1):
                ctx[b] = ctx[a]
                cap[c] = ctx[a]
                proper[[a, b]] = e
                cmask[c] = e
        ex.append({"context_ids": ctx.astype(np.int32),
                   "caption_ids": cap.astype(np.int32),
                   "proper_masks": proper, "caption_copy_masks": cmask,
                   "image_grid": rng.randn(9, 32).astype(np.float32),
                   "face_embeds": rng.randn(2, 16).astype(np.float32)})
    write_shard(str(d / "train-00000.npz"), ex)
    return str(d)


@pytest.fixture(scope="module")
def roberta():
    jr = j_init_roberta(jax.random.PRNGKey(5), JRobertaConfig(**RKW))
    return ({"roberta": jr, "roberta_cfg": JRobertaConfig(**RKW)},
            {"roberta": to_torch(jax.tree.map(np.array, jr), "cpu"),
             "roberta_cfg": RobertaConfig(**RKW)})


def _no_dropout(adapter):
    return dataclasses.replace(adapter, config=dataclasses.replace(
        adapter.config, attn_dropout=0.0))


def check_trainer_steps(shards, roberta, tmp_path, name):
    """Three Trainer steps of the `name` adapter against tell_tpu's."""
    jcfg, pcfg = configs(1)
    batches = list(bucket_batches(RecordDataset(
        shards + "/train-*.npz").epoch(lazy=True), BCFG))
    assert len(batches) == 3
    for b in batches:
        b.pop("real", None)
    jad = _no_dropout(j_get_model(name, jcfg.captioner))
    pad = _no_dropout(get_model(name, pcfg.captioner))
    jt = JTrainer(jcfg.captioner, JTrainerConfig(
        serialization_dir=str(tmp_path / "j"), n_data=1, **RUN),
        lambda e: iter([]), None, frozen=roberta[0], adapter=jad)
    tt = Trainer(pcfg.captioner, TrainerConfig(
        serialization_dir=str(tmp_path / "t"), **RUN),
        lambda e: iter([]), None, roberta[1], device="cpu", adapter=pad)
    assert tt.cfg is pad.config
    init = jax_params(7)
    tparams = to_torch(jax.tree.map(np.array, init), "cpu")
    topt = tt.optimizer.init(tparams)
    jparams, jopt = init, jt.optimizer.init(init)
    for i, b in enumerate(batches):
        with jt.mesh:
            jparams, jopt, jm = jt._step_fn(
                jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()},
                jax.random.PRNGKey(i), jt.frozen)
        tparams, topt, tm = tt._step_fn(
            tparams, topt, {k: torch.from_numpy(v) for k, v in b.items()},
            step_generator(0, i, "cpu"), tt.frozen)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **STEP_TOL)
        assert float(tm["loss"]) > 0 and int(tm["skipped"]) == 0
        assert int(tm["sample_size"]) == int(jm["sample_size"]) == 0
        for got, want in ((tparams, jparams), (topt.m, jopt.m),
                          (topt.v, jopt.v)):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           **STEP_TOL)
    assert int(topt.step) == int(jopt.step) == 3
    # the adaptive softmax, read by the reported generation loss only,
    # keeps zero moments
    sm = topt.m["captioner"]["decoder"]["adaptive_softmax"]
    assert not any(x.any() for x in tree_leaves(sm))


def test_trainer_steps_v1_equal_jax(shards, roberta, tmp_path):
    check_trainer_steps(shards, roberta, tmp_path, "transformer_pointer")
