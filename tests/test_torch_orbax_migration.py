"""A tell_tpu training run, written by tell_tpu's Trainer in orbax form,
converted by migrate/orbax_to_torch.py and read by the port on the CPU:
the numbered checkpoint and best/ restored by the port's
CheckpointManager bit for bit equal to tell_tpu's own restore (params,
BertAdam state, meta), greedy captions from the converted params equal
to tell_tpu's ids for ids, warm start taking them, and `--recover`'s next
epoch equal to tell_tpu's next epoch within the train-parity tolerance
(1e-4); before the conversion each of the port's readers refuses the
orbax run naming the converter. (The towers: test_torch_orbax_towers.py.)
The other families' runs likewise: tell_tpu's Trainer trains the modern
LM (dense, and with 2 experts at top-2) and the LSTM for two epochs
through its registry adapter; converted, the port's Trainer with the
port's adapter recovers the epoch-0 checkpoint (what `train -r` does) and
its epoch 1 equals tell_tpu's within 1e-4.

The run is test_torch_trainer_options.py's setup: small_test_config with
a 32-wide article context, 3 batches an epoch, two epochs (ckpt-0, ckpt-1
and best/); the port resumes from the converted ckpt-0 and its epoch 1 is
held to tell_tpu's.
"""
import dataclasses
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from tell_tpu.models.captioner import encode_contexts as j_encode
from tell_tpu.models.captioner import generate as j_generate
from tell_tpu.models.captioner import init_captioner as j_init_captioner
from tell_tpu.parallel import shard_params
from tell_tpu.training.checkpoint import CheckpointManager as JManager
from tell_tpu.training.trainer import Trainer as JTrainer
from tell_tpu.training.trainer import TrainerConfig as JTrainerConfig
from tell_tpu_torch.bridge import to_numpy, tree_leaves
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
from tell_tpu_torch.models.captioner import Captioner, encode_contexts
from tell_tpu_torch.training.checkpoint import CheckpointManager
from tell_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests.test_torch_trainer_options import CFG, JCFG, RUN, _feeds, data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "migrate"))
import orbax_to_torch  # noqa: E402

__all__ = ["data"]
torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_trainer(data, run_dir, adapter=None, **kw):
    """tell_tpu's Trainer (of `adapter`'s family, default the captioner)
    with its initial state made under jit (as
    test_torch_trainer_options.py makes it: the eager init is slow)."""
    train, valid = _feeds(data)
    jt = JTrainer(JCFG, JTrainerConfig(serialization_dir=str(run_dir),
                                       n_data=1, **{**RUN, **kw}),
                  train, valid, frozen=data[2], adapter=adapter)
    init_fn = (lambda r: j_init_captioner(r, JCFG)) if adapter is None \
        else (lambda r: adapter.init(r, adapter.config))
    init = shard_params(jax.jit(init_fn)(jax.random.PRNGKey(0)), jt.mesh)
    opt = jt.optimizer.init(init)
    opt = opt._replace(step=jax.device_put(opt.step, NamedSharding(
        jt.mesh, PartitionSpec())))
    jt.state = {"params": init, "opt": opt, "step": 0, "epoch": 0,
                "best_metric": float("inf"), "bad_epochs": 0}
    return jt


def _port_trainer(data, run_dir, adapter=None, **kw):
    train, valid = _feeds(data)
    return Trainer(CFG, TrainerConfig(serialization_dir=str(run_dir),
                                      **{**RUN, **kw}),
                   train, valid, data[3], device="cpu", adapter=adapter)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """(tell_tpu's run dir, the converted copy, tell_tpu's trainer): two
    epochs of tell_tpu's trainer, its checkpoints converted into another
    directory."""
    root = tmp_path_factory.mktemp("runs")
    jt = _jax_trainer(data, root / "jax", num_epochs=2)
    jt.train()
    written = orbax_to_torch.convert_run(str(root / "jax"),
                                         str(root / "port"))
    assert sorted(os.path.basename(p) for p in written) == [
        "best", "ckpt-0", "ckpt-1"]
    return root / "jax", root / "port", jt


def _equal_trees(port, jax_tree):
    want = jax.tree.leaves(jax.tree.map(np.asarray, jax_tree))
    got = tree_leaves(port)
    assert len(got) == len(want)
    for g, w in zip(tree_leaves(to_numpy(port)), want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    return got


def test_restore_equals_tell_tpus_restore(runs):
    jdir, pdir, _ = runs
    jm = JManager(str(jdir / "checkpoints"), use_async=False)
    for tag in (0, "best"):
        jstate, jmeta = jm.restore(tag)
        state, meta = CheckpointManager(str(pdir / "checkpoints")).restore(
            tag)
        assert meta == jmeta
        _equal_trees(state["params"], jstate["params"])
        if tag == 0:
            opt = jstate["opt"]
            assert set(state["opt"]) == {"step", "m", "v"}
            assert state["opt"]["step"].dtype == torch.int32
            assert int(state["opt"]["step"]) == int(np.asarray(opt["step"]))
            _equal_trees(state["opt"]["m"], opt["m"])
            _equal_trees(state["opt"]["v"], opt["v"])
            assert meta["step"] == 3 and meta["epoch"] == 1
        else:
            assert "opt" not in state and set(meta) == {"epoch", "metric"}
    # converted in place, the orbax files stay beside the port's
    inplace = jdir.parent / "inplace"
    shutil.copytree(jdir, inplace)
    orbax_to_torch.main(["run", str(inplace)])
    assert (inplace / "checkpoints" / "best" / "state.pt").exists()
    assert (inplace / "checkpoints" / "best" / "_METADATA").exists()


def test_greedy_captions_equal_tell_tpus(data, runs):
    jdir, pdir, _ = runs
    jparams = JManager(str(jdir / "checkpoints"),
                       use_async=False).restore("best")[0]["params"]
    params = CheckpointManager(str(pdir / "checkpoints")).restore(
        "best")[0]["params"]
    keys = ("context_ids", "image_grid", "face_embeds", "obj_embeds")
    batch = {k: data[1][0][k] for k in keys}
    jcfg = dataclasses.replace(JCFG, gen_len=12)
    ref = jax.jit(lambda p, b: j_generate(p, jcfg, j_encode(
        data[2], jcfg, b)))(jparams, batch)
    enc = RobertaEncoder(data[3]["roberta"], data[3]["roberta_cfg"])
    with torch.inference_mode():
        e = encode_contexts(enc.frozen(), CFG,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
        out = Captioner(params, dataclasses.replace(CFG, gen_len=12)
                        ).generate(e)
    np.testing.assert_array_equal(to_numpy(out["token_ids"]),
                                  np.asarray(ref["token_ids"]))


def test_readers_refuse_the_orbax_run_naming_the_converter(data, runs,
                                                           tmp_path):
    """Before the conversion: warm start, --recover and evaluate/serve's
    best/ refuse the orbax directories by name; after it, evaluate's
    loader takes the converted best/."""
    from tell_tpu_torch.commands import __main__ as cli
    from tell_tpu_torch.config_io import load_experiment
    from tests.test_torch_cli import write_e2e_config
    jdir, pdir, _ = runs
    best = str(jdir / "checkpoints" / "best")
    with pytest.raises(NotPortedError,
                       match="migrate/orbax_to_torch.py run"):
        _port_trainer(data, tmp_path / "w", warm_start=best).initialize()
    with pytest.raises(NotPortedError,
                       match=f"ckpt-1 holds no state.pt.*orbax_to_torch.py "
                             f"run {jdir}"):
        _port_trainer(data, jdir).recover()
    exp = load_experiment(write_e2e_config(tmp_path))
    with pytest.raises(NotPortedError,
                       match=f"{best} holds no state.pt.*orbax_to_torch.py "
                             f"run {jdir}"):
        cli._restore_params(exp, best, "cpu")
    # after it, evaluate's and serve's loader reads tell_tpu's best params
    jparams = JManager(str(jdir / "checkpoints"),
                       use_async=False).restore("best")[0]["params"]
    _equal_trees(cli._restore_params(exp, str(pdir / "checkpoints" / "best"),
                                     "cpu"), jparams)


def test_warm_start_and_recover_continue_as_tell_tpu(data, runs, tmp_path):
    jdir, pdir, jt = runs
    best = CheckpointManager(str(pdir / "checkpoints")).restore("best")[0]
    warm = _port_trainer(data, tmp_path / "warm",
                         warm_start=str(pdir / "checkpoints" / "best"))
    warm.initialize()
    for a, b in zip(tree_leaves(warm.state["params"]),
                    tree_leaves(best["params"])):
        assert torch.equal(a, b)
    # the port resumes from the converted ckpt-0; tell_tpu went on from
    # the same state in the run that wrote it
    pcopy = tmp_path / "port"
    shutil.copytree(pdir, pcopy)
    shutil.rmtree(pcopy / "checkpoints" / "ckpt-1")
    tt = _port_trainer(data, pcopy, num_epochs=2)
    assert tt.recover() and tt.state["step"] == 3
    tt.train()
    assert tt.state["step"] == jt.state["step"] == 6
    np.testing.assert_allclose(tt.metrics_history[-1]["loss"],
                               jt.metrics_history[-1]["loss"], **TOL)
    np.testing.assert_allclose(tt.metrics_history[-1]["val_loss"],
                               jt.metrics_history[-1]["val_loss"], **TOL)
    jstate = JManager(str(jdir / "checkpoints"), use_async=False).restore(1)
    for g, w in zip(tree_leaves(to_numpy(tt.state["params"])),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jstate[0]["params"]))):
        np.testing.assert_allclose(g, w, **TOL)


def _family(name):
    """(tell_tpu's adapter, the port's) of a small config over the data's
    contexts: the modern LM (dense or 2 experts) or the LSTM over the
    image and the article."""
    from tell_tpu.config import ContextSpec as JSpec
    from tell_tpu.models.llm_decoder import LLMConfig as JLLM
    from tell_tpu.models.registry import get_model as j_get_model
    from tell_tpu_torch.config import ContextSpec, LLMConfig
    from tell_tpu_torch.models.registry import get_model
    if name == "lstm":
        flat = lambda cfg: dataclasses.replace(cfg, decoder=(  # noqa: E731
            dataclasses.replace(cfg.decoder,
                                contexts=cfg.decoder.contexts[:2])))
        return j_get_model("lstm", flat(JCFG)), get_model("lstm", flat(CFG))
    specs = [(c.name, c.kv_dim, c.max_len) for c in CFG.decoder.contexts]
    fields = dict(vocab_size=500, dim=16, num_layers=2, num_heads=2,
                  num_kv_heads=1, ffn_dim=24, dropout=0.0,
                  attention_dropout=0.0,
                  max_target_positions=16, gen_len=5, loss_vocab_chunk=128,
                  moe_experts=2 if name == "moe" else None)
    return (j_get_model("modern", JLLM(**fields, contexts=tuple(
                JSpec(*c) for c in specs))),
            get_model("modern", LLMConfig(**fields, contexts=tuple(
                ContextSpec(*c) for c in specs))))


@pytest.mark.parametrize("family", ["modern", "moe", "lstm"])
def test_other_families_recover_as_tell_tpu(data, tmp_path, family):
    jad, pad = _family(family)
    jt = _jax_trainer(data, tmp_path / "jax", adapter=jad, num_epochs=2)
    jt.train()
    orbax_to_torch.convert_run(str(tmp_path / "jax"), str(tmp_path / "port"))
    shutil.rmtree(tmp_path / "port" / "checkpoints" / "ckpt-1")
    tt = _port_trainer(data, tmp_path / "port", adapter=pad, num_epochs=2)
    assert tt.recover() and tt.state["step"] == 3
    tt.train()
    assert tt.state["step"] == jt.state["step"] == 6
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(tt.metrics_history[-1][key],
                                   jt.metrics_history[-1][key], **TOL)
