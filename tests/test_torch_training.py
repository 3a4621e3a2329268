"""The port's training path against tell_tpu on the CPU: adaptive
embedding and loss (dense and tail-capacity), the teacher-forced decoder
forward and loss, the captioner loss with every gradient, one BertAdam
update, the train step (bf16 compute over fp32 masters, NaN skip),
checkpoints, the Trainer's mid-epoch stop and step-exact recover, and the
frozen encode's stop-gradient.

small_test_config (2 layers, E=64, 4 contexts), weights from tell_tpu's
initialisers carried across with the bridge, inputs from a numpy seed,
dropout off wherever the two packages are compared (their random bits
differ). Tolerance: 1e-4 absolute and relative on losses, features,
gradients and updates (the same math summed in another order).
"""
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.config import small_test_config
from tell_tpu.models import decoder as jd
from tell_tpu.models.captioner import (captioner_loss as j_captioner_loss,
                                       init_captioner as j_init)
from tell_tpu.ops import adaptive as ja
from tell_tpu.training.optimizer import (BertAdamState as JState,
                                         bert_adam as j_bert_adam)
from tell_tpu_torch.bridge import (bert_adam_state, init_captioner,
                                   init_roberta, to_numpy, to_torch,
                                   tree_leaves, tree_map)
from tell_tpu_torch.data.bucketing import BucketingConfig
from tell_tpu_torch.data.records import write_shard
from tell_tpu_torch.models import decoder as td
from tell_tpu_torch.models.backbones.roberta import RobertaConfig
from tell_tpu_torch.models.captioner import (captioner_loss,
                                             captioner_loss_e2e)
from tell_tpu_torch.ops import adaptive as ta
from tell_tpu_torch.training.checkpoint import CheckpointManager
from tell_tpu_torch.training.optimizer import bert_adam
from tell_tpu_torch.training.train_step import make_train_step
from tell_tpu_torch.training.trainer import TrainerConfig, make_trainer

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
CFG = small_test_config()
DCFG = CFG.decoder


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(B, T, seed):
    """A captioner batch: precomputed article hiddens [B, 16, 3, 24], an
    image grid, faces/objects with absent (NaN) rows, padded captions."""
    rng = np.random.default_rng(seed)
    cap = rng.integers(3, DCFG.vocab_size, size=(B, T)).astype(np.int32)
    cap[:, 0] = DCFG.bos_id
    cap[0, T - 3:] = DCFG.pad_id
    cap[-1, T - 1] = DCFG.eos_id
    art_mask = np.zeros((B, 16), bool)
    art_mask[0, 10:] = True
    faces = rng.normal(size=(B, 4, 16)).astype(np.float32)
    faces[0, 2:] = np.nan
    objs = rng.normal(size=(B, 8, 32)).astype(np.float32)
    objs[-1, 5:] = np.nan
    return {"caption_ids": cap,
            "article_hiddens": rng.normal(size=(B, 16, 3, 24)).astype(
                np.float32),
            "article_mask": art_mask,
            "image_grid": rng.normal(size=(B, 9, 32)).astype(np.float32),
            "face_embeds": faces, "obj_embeds": objs}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(lambda r: j_init(r, CFG))(jax.random.PRNGKey(0))


def _tparams(jparams, requires_grad=False):
    return tree_map(lambda t: t.requires_grad_(requires_grad),
                    to_torch(_np(jparams), "cpu"))


def _contexts(B, seed):
    rng = np.random.default_rng(seed)
    ctx = {}
    for spec in DCFG.contexts:
        feats = rng.normal(size=(B, spec.max_len, spec.kv_dim)).astype(
            np.float32)
        mask = np.zeros((B, spec.max_len), bool)
        mask[-1, spec.max_len // 2:] = True
        ctx[spec.name] = (feats, mask)
    return ctx, {k: (torch.from_numpy(f), torch.from_numpy(m))
                 for k, (f, m) in ctx.items()}


# ---------------------------------------------------------------------------
# ops: adaptive embedding and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [None, (12, 3)],
                         ids=["dense", "tail_capacity"])
def test_adaptive_embed_and_loss_values_and_grads(jparams, capacity):
    emb = jparams["decoder"]["embed"]
    sm = jparams["decoder"]["adaptive_softmax"]
    rng = np.random.default_rng(1)
    N = 40
    x = rng.normal(size=(N, DCFG.embed_dim)).astype(np.float32)
    # every band, the pinned id 0 and pads; more tail-2 rows than cap 3
    targets = rng.integers(0, DCFG.vocab_size, size=N).astype(np.int32)
    targets[:4] = [0, 1, 60, 300]
    ids = rng.integers(0, DCFG.vocab_size, size=(3, 7)).astype(np.int32)
    ids[0, :3] = [0, 50, 200]                      # pinned rows of each band
    cut = DCFG.full_cutoffs

    def j_fn(emb, sm, x):
        e = ja.adaptive_embed(emb, jnp.asarray(ids), cut, DCFG.embed_dim)
        loss, size, aux = ja.adaptive_softmax_loss(
            sm, emb, x, jnp.asarray(targets), cut, tail_capacity=capacity)
        return loss + jnp.sum(e * jnp.cos(e)), (loss, size, e, aux)

    (_, (jl, jsize, je, jaux)), jg = jax.jit(jax.value_and_grad(
        j_fn, argnums=(0, 1, 2), has_aux=True))(emb, sm, jnp.asarray(x))
    temb = tree_map(lambda t: t.requires_grad_(), to_torch(_np(emb), "cpu"))
    tsm = tree_map(lambda t: t.requires_grad_(), to_torch(_np(sm), "cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    e = ta.adaptive_embed(temb, torch.from_numpy(ids), cut, DCFG.embed_dim)
    loss, size, aux = ta.adaptive_softmax_loss(
        tsm, temb, tx, torch.from_numpy(targets), cut, tail_capacity=capacity)
    (loss + (e * torch.cos(e)).sum()).backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(to_numpy(e), np.asarray(je), **TOL)
    assert int(size) == int(jsize)
    assert int(aux["tail_dropped"]) == int(jaux["tail_dropped"])
    if capacity is not None:
        assert int(aux["tail_dropped"]) > 0
    for t, j in zip(tree_leaves(temb) + tree_leaves(tsm) + [tx],
                    jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL)
    # the pinned <s> rows of every band get a zero gradient
    for band in temb["bands"]:
        assert not band["embed"].grad[0].any()


def test_cross_attention_matches_jax(jparams):
    """The full cross-attention (K/V projected here, padded keys masked,
    bias and zero columns appended) and its head-averaged map."""
    from tell_tpu.ops.attention import cross_attention as j_cross
    from tell_tpu_torch.ops.attention import cross_attention
    p = jparams["decoder"]["layers"][0]["attn"]["obj"]
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 5, DCFG.embed_dim)).astype(np.float32)
    key = rng.normal(size=(2, 8, 32)).astype(np.float32)
    pad = np.zeros((2, 8), bool)
    pad[1, 3:] = True
    jo, ja_ = j_cross(p, jnp.asarray(q), jnp.asarray(key), jnp.asarray(pad),
                      num_heads=DCFG.num_heads, need_weights=True)
    o, a = cross_attention(to_torch(_np(p), "cpu"), torch.from_numpy(q),
                           torch.from_numpy(key), torch.from_numpy(pad),
                           num_heads=DCFG.num_heads, need_weights=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja_), **TOL)
    assert not a[1, :, 3:8].any()                 # padded keys get nothing


# ---------------------------------------------------------------------------
# decoder and captioner
# ---------------------------------------------------------------------------

def test_decoder_forward_and_loss_match_jax(jparams):
    jp = jparams["decoder"]
    tp = _tparams(jparams)["decoder"]
    ctx, tctx = _contexts(2, 2)
    cap = _batch(2, 9, 3)["caption_ids"]
    jx, _ = jax.jit(lambda p, i, c: jd.decoder_forward(p, DCFG, i, c))(
        jp, cap, ctx)
    x = td.decoder_forward(tp, DCFG, torch.from_numpy(cap), tctx)
    np.testing.assert_allclose(to_numpy(x), np.asarray(jx), **TOL)
    jl, jn, _ = jax.jit(lambda p, i, c: jd.decoder_loss(p, DCFG, i, c))(
        jp, cap, ctx)
    loss, n, _ = td.decoder_loss(tp, DCFG, torch.from_numpy(cap), tctx)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert int(n) == int(jn)


def test_step_decode_matches_full_forward(jparams):
    """The port's decode path (decoder_step over the stacked contexts)
    gives the features of its teacher-forced forward, step by step."""
    tp = _tparams(jparams)["decoder"]
    _, tctx = _contexts(2, 4)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(3, DCFG.vocab_size, size=(2, 6)))
    full = td.decoder_forward(tp, DCFG, ids, tctx)
    state = td.init_decode_state(tp, DCFG, tctx, 2)
    for t in range(ids.shape[1]):
        x, state = td.decoder_step(tp, DCFG, ids[:, t], state)
        torch.testing.assert_close(x, full[:, t], **TOL)


def test_captioner_loss_and_all_gradients_match_jax(jparams):
    batch = _batch(3, 10, 6)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_captioner_loss(p, CFG, b), has_aux=True))(
            jparams, batch)
    tp = _tparams(jparams, requires_grad=True)
    loss, aux = captioner_loss(tp, CFG, _tb(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    assert int(aux["sample_size"]) == int(jaux["sample_size"])
    jleaves = jax.tree.leaves(jg)
    tleaves = tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL)


E2E_CFG = dataclasses.replace(CFG, decoder=dataclasses.replace(
    DCFG, contexts=tuple(dataclasses.replace(c, kv_dim=32)
                         if c.name == "article" else c
                         for c in DCFG.contexts)))
RCFG = RobertaConfig(vocab_size=DCFG.vocab_size, dim=32, num_layers=2,
                     num_heads=2, ffn_dim=64, max_positions=20)


def test_encode_contexts_stops_gradients():
    """captioner_loss_e2e: the frozen RoBERTa leaves get no gradient even
    when they ask for one; bert_weight, which mixes their hiddens, does."""
    g = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.requires_grad_(),
                      init_captioner(g, E2E_CFG))
    roberta = tree_map(lambda t: t.requires_grad_(), init_roberta(g, RCFG))
    batch = _tb(_batch(2, 8, 7))
    del batch["article_hiddens"], batch["article_mask"]
    ids = np.random.default_rng(0).integers(3, 500, size=(2, 16))
    ids[1, 12:] = RCFG.pad_id
    batch["context_ids"] = torch.from_numpy(ids)
    loss, _ = captioner_loss_e2e(params, {"roberta": roberta,
                                          "roberta_cfg": RCFG},
                                 E2E_CFG, batch)
    loss.backward()
    assert all(t.grad is None for t in tree_leaves(roberta))
    assert params["bert_weight"].grad is not None
    assert params["bert_weight"].grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# optimizer, train step, checkpoints
# ---------------------------------------------------------------------------

def test_bert_adam_update_from_carried_state_matches_optax():
    rng = np.random.default_rng(9)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=(4,)).astype(np.float32) * 3]}
    grads = tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32)
                     * 0.2, params)
    m = tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32)
                 * 0.01, params)
    v = tree_map(lambda p: rng.random(p.shape).astype(np.float32)
                 * 1e-3, params)
    kw = dict(lr=1e-3, t_total=100, warmup=0.1, weight_decay=1e-2)
    jopt = j_bert_adam(**kw)
    jstate = JState(jnp.asarray(7, jnp.int32), m, v)
    jup, jnew = jopt.update(grads, jstate, params)
    opt = bert_adam(**kw)
    state = bert_adam_state(jstate, "cpu")       # carried across
    up, new = opt.update(to_torch(grads, "cpu"), state,
                         to_torch(params, "cpu"))
    for t, j in zip(tree_leaves(up), jax.tree.leaves(jup)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-7,
                                   rtol=1e-5)
    assert int(new.step) == int(jnew.step) == 8
    back = JState(*to_numpy(new))
    for t, j in zip(jax.tree.leaves(back), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=1e-7,
                                   rtol=1e-5)


def test_train_step_bf16_keeps_fp32_masters_and_skips_nan():
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    params = init_captioner(torch.Generator().manual_seed(0), cfg)
    opt = bert_adam(t_total=100, warmup=0.0)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = _tb(_batch(2, 8, 10))
    gen = torch.Generator().manual_seed(1)
    p1, s1, m = step(params, state, batch, gen)
    assert torch.isfinite(m["loss"]) and int(m["skipped"]) == 0
    assert all(t.dtype == torch.float32 for t in tree_leaves(p1))
    assert all(t.dtype == torch.float32 for t in tree_leaves(s1.m))
    assert not any(t.requires_grad for t in tree_leaves(p1))
    assert max((a - b).abs().max().item()
               for a, b in zip(tree_leaves(params), tree_leaves(p1))) > 0
    assert int(s1.step) == 1

    bad = dict(batch, image_grid=torch.full_like(batch["image_grid"],
                                                 float("nan")))
    p2, s2, m2 = step(p1, s1, bad, gen)
    assert not torch.isfinite(m2["loss"]) and int(m2["skipped"]) == 1
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert torch.equal(a, b)


def test_checkpoint_keep_n_best_and_restore(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ck"), keep=3)
    for i in range(6):
        cm.save(i, {"x": torch.arange(3) + i,
                    "opt": {"step": torch.tensor(i)}}, {"step": i})
    assert cm.list() == [3, 4, 5]
    state, meta = cm.restore()
    assert meta == {"step": 5}
    torch.testing.assert_close(state["x"], torch.arange(3) + 5)
    cm.save_best({"x": torch.ones(2)}, {"metric": 0.5})
    state, meta = cm.restore("best")
    assert meta["metric"] == 0.5 and cm.list() == [3, 4, 5]
    assert cm.restore(1) is None
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "best", "ckpt-3", "ckpt-4", "ckpt-5"]          # no temporaries left


# ---------------------------------------------------------------------------
# the Trainer: mid-epoch stop and step-exact recover, dropout on
# ---------------------------------------------------------------------------

TRAIN_CFG = dataclasses.replace(E2E_CFG, decoder=dataclasses.replace(
    E2E_CFG.decoder, dropout=0.1, weight_dropout=0.1, input_dropout=0.1,
    attention_dropout=0.1, relu_dropout=0.1))
BCFG = BucketingConfig(article_lengths=(16,), caption_lengths=(12,),
                       token_budget=112, max_batch=4, max_faces=4,
                       face_dim=16, max_objects=8, object_dim=32)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(0)
    ex = []
    for _ in range(20):
        ex.append({
            "context_ids": np.concatenate(
                [[0], rng.randint(4, 90, rng.randint(6, 15)), [2]]
            ).astype(np.int32),
            "caption_ids": np.concatenate(
                [[0], rng.randint(4, 90, rng.randint(5, 11)), [2]]
            ).astype(np.int32),
            "image_grid": rng.randn(9, 32).astype(np.float32),
            "face_embeds": rng.randn(rng.randint(0, 3), 16).astype(
                np.float32),
            "obj_embeds": rng.randn(3, 32).astype(np.float32)})
    write_shard(str(d / "train-00000.npz"), ex[:16])
    write_shard(str(d / "valid-00000.npz"), ex[16:])
    return str(d)


def test_trainer_midepoch_stop_and_recover_is_step_exact(shards, tmp_path):
    frozen = {"roberta": init_roberta(torch.Generator().manual_seed(5),
                                      RCFG), "roberta_cfg": RCFG}

    def trainer(run):
        tcfg = TrainerConfig(serialization_dir=str(tmp_path / run),
                             num_epochs=2, patience=5, lr=3e-3,
                             t_total=100, log_every=1000)
        return make_trainer(TRAIN_CFG, tcfg, BCFG, shards, frozen,
                            device="cpu")

    ta_ = trainer("a")
    res_a = ta_.train()
    assert "preempted" not in res_a and ta_.state["step"] == 8
    assert [m["batches"] for m in ta_.metrics_history] == [4, 4]
    assert all(np.isfinite(m["val_loss"]) for m in ta_.metrics_history)

    tb = trainer("b")
    inner = tb._step_fn

    def stop_after_second(*args):
        out = inner(*args)
        if tb.state["step"] == 1:          # the step about to finish is #2
            tb.request_stop()
        return out

    tb._step_fn = stop_after_second
    res_b = tb.train()
    assert res_b["preempted"] is True and tb.state["step"] == 2

    tc = trainer("b")
    assert tc.recover()
    assert (tc.state["epoch"], tc.state["batch_cursor"],
            tc.state["step"]) == (0, 2, 2)
    for a, b in zip(tree_leaves(tb.state["params"]),
                    tree_leaves(tc.state["params"])):
        assert torch.equal(a, b)
    seen = []
    inner_c = tc._step_fn

    def record(params, opt, batch, gen, frozen):
        seen.append(batch["caption_ids"].clone())
        return inner_c(params, opt, batch, gen, frozen)

    tc._step_fn = record
    assert "preempted" not in tc.train()
    # it continued at the NEXT batch of epoch 0's order
    third = list(tc.train_batches(0))[2]["caption_ids"]
    np.testing.assert_array_equal(seen[0].numpy(), third)
    assert tc.state["step"] == ta_.state["step"]
    for a, b in zip(tree_leaves(ta_.state["params"]),
                    tree_leaves(tc.state["params"])):
        assert torch.equal(a, b)


def test_warmup_linear_matches_jax():
    from tell_tpu.training.optimizer import warmup_linear as j_warmup
    from tell_tpu_torch.training.optimizer import warmup_linear
    steps = np.arange(0, 130, 7, dtype=np.int32)
    ours = warmup_linear(torch.from_numpy(steps), 120, 0.1)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(j_warmup(steps, 120, 0.1)),
                               atol=1e-7)


def test_dropout_is_inverted_and_off_when_deterministic():
    from tell_tpu_torch.ops.common import dropout
    x = torch.ones(200, 300)
    gen = torch.Generator().manual_seed(0)
    assert dropout(x, 0.3, gen, True) is x
    assert dropout(x, 0.0, gen, False) is x
    assert dropout(x, 0.3, None, False) is x
    y = dropout(x, 0.3, gen, False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    again = dropout(x, 0.3, torch.Generator().manual_seed(0), False)
    assert torch.equal(y, again)          # the generator alone decides


def test_trainer_warns_on_tail_overflow_and_recover_needs_a_checkpoint(
        shards, tmp_path, caplog):
    import logging
    from tell_tpu_torch.training.trainer import train_from_shards
    cfg = dataclasses.replace(E2E_CFG, decoder=dataclasses.replace(
        E2E_CFG.decoder, tail_capacity_frac=(0.01, 0.01)))
    frozen = {"roberta": init_roberta(torch.Generator().manual_seed(5),
                                      RCFG), "roberta_cfg": RCFG}
    tcfg = TrainerConfig(serialization_dir=str(tmp_path / "run"),
                         num_epochs=1, t_total=100, log_every=1000)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        train_from_shards(cfg, tcfg, BCFG, shards, frozen, recover=True,
                          device="cpu")
    with caplog.at_level(logging.WARNING):
        result = train_from_shards(cfg, tcfg, BCFG, shards, frozen,
                                   device="cpu")
    assert result["epochs"] == 1 and np.isfinite(result["best_metric"])
    assert any("tail capacity" in r.message for r in caplog.records)
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        (em,) = [json.loads(line) for line in f]
    assert em["tail_dropped"] > 0 and em["tail_dropped_frac"] > 1e-3
    assert sorted(p.name for p in (tmp_path / "run" / "checkpoints")
                  .iterdir()) == ["best", "ckpt-0"]
