"""The modern family (expts 10 and 12) through the port's Trainer on the
CPU, against tell_tpu's Trainer.

An LM of dim 16 (2 layers, 2 heads; vocab 500 streamed in chunks of
128) over small_test_config's four contexts, with a RoBERTa of dim 24
encoding the article in every step (the e2e loss), dense and with 2
experts at top-2. Three steps of the port's Trainer and three of
tell_tpu's (n_data=1), the same weights (tell_tpu's init_llm_decoder) and
batches, dropout 0: params and the BertAdam moments within 1e-5
(absolute and relative). tell_tpu's tests/test_moe.py end-to-end scenario
without the mesh, dropout 0.1: the loss falls over 4 epochs, val_loss is
finite, and a run stopped after its second step and recovered ends with
the params of the run that never stopped, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tell_tpu.config import ContextSpec as JSpec
from tell_tpu.config import small_test_config as j_small_config
from tell_tpu.models import llm_decoder as J
from tell_tpu.models.backbones import RobertaConfig as JRobertaConfig
from tell_tpu.models.backbones import init_roberta as j_init_roberta
from tell_tpu.models.registry import get_model as j_get_model
from tell_tpu.training.trainer import Trainer as JTrainer
from tell_tpu.training.trainer import TrainerConfig as JTrainerConfig
from tell_tpu_torch.bridge import to_torch, tree_leaves
from tell_tpu_torch.config import ContextSpec, LLMConfig, small_test_config
from tell_tpu_torch.data.bucketing import BucketingConfig, bucket_batches
from tell_tpu_torch.data.records import RecordDataset, write_shard
from tell_tpu_torch.models.backbones.roberta import RobertaConfig
from tell_tpu_torch.models.registry import get_model
from tell_tpu_torch.training.trainer import (Trainer, TrainerConfig,
                                             make_trainer, step_generator)

torch.set_num_threads(2)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
CONTEXTS = (("image", 32, 9), ("article", 24, 16), ("faces", 16, 4),
            ("obj", 32, 8))
FIELDS = dict(vocab_size=500, dim=16, num_layers=2, num_heads=2,
              num_kv_heads=2, ffn_dim=24, dropout=0.0, attention_dropout=0.0,
              max_target_positions=16, gen_len=5, loss_vocab_chunk=128)
RKW = dict(vocab_size=500, dim=24, num_layers=2, num_heads=4, ffn_dim=32,
           max_positions=40)
BCFG = BucketingConfig(article_lengths=(16,), caption_lengths=(12,),
                       token_budget=112, max_batch=4, max_faces=4,
                       face_dim=16, max_objects=8, object_dim=32)
RUN = dict(patience=10, lr=3e-3, t_total=200, log_every=1000)


def configs(moe: bool, **over):
    fields = {**FIELDS, **({"moe_experts": 2, "moe_top_k": 2} if moe
                           else {}), **over}
    return (J.LLMConfig(**fields, contexts=tuple(JSpec(*c)
                                                 for c in CONTEXTS)),
            LLMConfig(**fields, contexts=tuple(ContextSpec(*c)
                                               for c in CONTEXTS)))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """tell_tpu's test_moe scenario: 16 train and 8 valid examples."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(1)
    ex = []
    for _ in range(24):
        la, lc = rng.randint(6, 14), rng.randint(5, 11)
        ex.append({
            "context_ids": np.concatenate(
                [[0], rng.randint(4, 90, la), [2]]).astype(np.int32),
            "caption_ids": np.concatenate(
                [[0], rng.randint(4, 90, lc), [2]]).astype(np.int32),
            "image_grid": rng.randn(9, 32).astype(np.float32),
            "face_embeds": rng.randn(2, 16).astype(np.float32),
            "obj_embeds": rng.randn(3, 32).astype(np.float32)})
    write_shard(str(d / "train-00000.npz"), ex[:16])
    write_shard(str(d / "valid-00000.npz"), ex[16:])
    return str(d)


@pytest.fixture(scope="module")
def roberta():
    jr = j_init_roberta(jax.random.PRNGKey(5), JRobertaConfig(**RKW))
    return ({"roberta": jr, "roberta_cfg": JRobertaConfig(**RKW)},
            {"roberta": to_torch(jax.tree.map(np.array, jr), "cpu"),
             "roberta_cfg": RobertaConfig(**RKW)})


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_trainer_steps_equal_jax(shards, roberta, tmp_path, moe):
    jcfg, pcfg = configs(moe)
    batches = list(bucket_batches(RecordDataset(
        shards + "/train-*.npz").epoch(lazy=True), BCFG))[:3]
    for b in batches:
        b.pop("real", None)
    jt = JTrainer(j_small_config(), JTrainerConfig(
        serialization_dir=str(tmp_path / "j"), n_data=1, **RUN),
        lambda e: iter([]), None, frozen=roberta[0],
        adapter=j_get_model("modern", jcfg))
    tt = Trainer(small_test_config(), TrainerConfig(
        serialization_dir=str(tmp_path / "t"), **RUN),
        lambda e: iter([]), None, roberta[1], device="cpu",
        adapter=get_model("modern", pcfg))
    assert tt.cfg is pcfg
    init = J.init_llm_decoder(jax.random.PRNGKey(7), jcfg)
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
        assert int(tm["sample_size"]) == int(jm["sample_size"])
        assert int(tm["tail_dropped"]) == 0
        for got, want in ((tparams, jparams), (topt.m, jopt.m),
                          (topt.v, jopt.v)):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           **STEP_TOL)
    assert int(topt.step) == int(jopt.step) == 3


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_trains_and_recovers_step_exact(shards, roberta, tmp_path, moe):
    _, pcfg = configs(moe, dropout=0.1, attention_dropout=0.1)
    adapter = get_model("modern", pcfg)

    def trainer(run, epochs=4):
        tcfg = TrainerConfig(serialization_dir=str(tmp_path / run),
                             num_epochs=epochs, **RUN)
        return make_trainer(small_test_config(), tcfg, BCFG, shards,
                            roberta[1], device="cpu", adapter=adapter)

    ta = trainer("a")
    ta.train()
    hist = ta.metrics_history
    assert len(hist) == 4 and [h["batches"] for h in hist] == [4] * 4
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["val_loss"]) for h in hist)

    tb = trainer("b")
    inner = tb._step_fn

    def stop_after_second(*args):
        out = inner(*args)
        if tb.state["step"] == 1:
            tb.request_stop()
        return out

    tb._step_fn = stop_after_second
    assert tb.train()["preempted"] is True
    tc = trainer("b")
    assert tc.recover() and tc.state["step"] == 2
    for a, b in zip(tree_leaves(tb.state["params"]),
                    tree_leaves(tc.state["params"])):
        assert torch.equal(a, b)
    tc.train()
    assert tc.state["step"] == ta.state["step"] == 16
    for a, b in zip(tree_leaves(ta.state["params"]),
                    tree_leaves(tc.state["params"])):
        assert torch.equal(a, b)
