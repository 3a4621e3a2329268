"""The pointer family served by the port (serving/server.py's micro-batch
mode through the pointer adapter) against tell_tpu's CaptionService on
the CPU, and a tell_tpu pointer run converted by
migrate/orbax_to_torch.py.

tests/test_torch_pointer.py's small faces configuration (weigh_bert, the
article's 3 hidden layers from a RoBERTa of dim 24, a 16-token article),
weights from tell_tpu's init_pointer and init_roberta, the quality
corpus's tokenizer. Requests carry `entities` as plain strings and as
NER dicts ({"text", "label"}), entities absent from the text, and none:
the port's _pack gives tell_tpu's ids and proper_masks (-1 at pads,
each entity token's 1-based index), and each request, alone and in one
micro-batch, answers tell_tpu's token ids; with need_attention both
answer without maps (the pointer decode records none); the int8 K/V cache
with the fused top-k answers tell_tpu's ids under TELL_TPU_KV8; the
engine is refused by both with tell_tpu's words. A tell_tpu run's orbax
checkpoints (ckpt-0 and best/) converted: best/'s params read by the
port give tell_tpu's greedy ids, copy decisions and log-probs.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
from tell_tpu.models.backbones.roberta import RobertaConfig as JR
from tell_tpu.models.backbones.roberta import init_roberta
from tell_tpu.models.registry import get_model as j_get_model
from tell_tpu.serving.server import CaptionService as JService
from tell_tpu.training.checkpoint import CheckpointManager as JManager
from tell_tpu_torch.bridge import to_torch, tree_leaves
from tell_tpu_torch.data.tokenizer import RobertaTokenizer
from tell_tpu_torch.models import pointer as P
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.models.registry import get_model
from tell_tpu_torch.serving import CaptionService
from tests.test_torch_pointer import (TOL, _generate_pair, _jax_generate,
                                      _jb, _tb, configs, jax_params)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(ROOT, "tests", "fixtures", "quality")
RFIELDS = dict(vocab_size=708, dim=24, num_layers=2, num_heads=2,
               ffn_dim=64, max_positions=40)
TEXTS = ("Anna Smith met Lisbon officials, and Anna Smith spoke.",
         "The mayor of Lisbon spoke on Monday about the city budget.",
         "The city talks.",
         "Anna Smith went to the market on Monday morning.")


def _files():
    return (os.path.join(QUALITY, "vocab.json"),
            os.path.join(QUALITY, "merges.txt"))


def _requests():
    rng = np.random.default_rng(4)
    ents = (["Anna Smith", "Lisbon"],
            [{"text": "Lisbon", "label": "GPE"},
             {"text": "Monday", "label": "DATE"}],
            ["Zyxwvut Qqqq"], None)
    reqs = []
    for text, e in zip(TEXTS, ents):
        req = {"context": text,
               "image_grid": rng.normal(size=(9, 32)).round(4).tolist(),
               "face_embeds": rng.normal(size=(2, 16)).round(4).tolist()}
        if e is not None:
            req["entities"] = e
        reqs.append(req)
    return reqs


@pytest.fixture(scope="module")
def model():
    jcfg, pcfg = configs(1, gen_len=6)
    jparams = dict(jax_params(0))
    # the entity head leans to copying, so that both services copy
    jparams["entity_fc"] = {**jparams["entity_fc"],
                            "b": jax.numpy.asarray([0.0, 1.0])}
    jrob = init_roberta(jax.random.PRNGKey(1), JR(**RFIELDS))
    np_tree = jax.tree.map(np.asarray, {"m": jparams, "r": jrob})
    return {"jcfg": jcfg, "pcfg": pcfg, "jparams": jparams,
            "jfrozen": {"roberta": jrob, "roberta_cfg": JR(**RFIELDS)},
            "params": to_torch(np_tree["m"], "cpu"),
            "roberta": to_torch(np_tree["r"], "cpu")}


def _services(model, need_attention=False, port_kw=None, **kw):
    """tell_tpu's CaptionService and the port's on the same weights; kw
    goes to both, port_kw to the port's (its decode levers)."""
    jcap, pcap = model["jcfg"].captioner, model["pcfg"].captioner
    jsvc = JService(model["jparams"], model["jfrozen"], jcap,
                    JTokenizer.from_files(*_files(), max_len=16,
                                          use_native=False),
                    max_batch=4, need_attention=need_attention,
                    adapter=j_get_model("transformer_pointer", jcap), **kw)
    svc = CaptionService(
        model["params"], RobertaEncoder(model["roberta"],
                                        RobertaConfig(**RFIELDS)),
        pcap, "cpu", tokenizer=RobertaTokenizer.from_files(
            *_files(), max_len=16), max_batch=4,
        need_attention=need_attention,
        adapter=get_model("transformer_pointer", pcap), **kw,
        **(port_kw or {}))
    return jsvc, svc


def test_pack_and_served_ids_equal_jax(model):
    jsvc, svc = _services(model, need_attention=True)
    reqs = _requests()
    try:
        jbatch, jerr = jsvc._pack(reqs)
        batch, err = svc._pack(reqs, bucketed=True)
        assert not any(jerr) and not any(err)
        for key in ("context_ids", "proper_masks"):
            assert np.array_equal(batch[key], np.asarray(jbatch[key])), key
        pm = batch["proper_masks"]
        assert (pm[0] >= 1).sum() > 0 and set(pm[0][pm[0] > 0]) == {1, 2}
        assert (pm[1] >= 1).sum() > 0 and (pm[2:] <= 0).all()
        assert (pm == -1).any()               # the pads
        want = [jsvc.caption(r) for r in reqs]
        alone = [svc.caption(r) for r in reqs]
        together = svc._run(reqs)
    finally:
        jsvc.close()
        svc.close()
    for got in (alone, together):
        for g, w in zip(got, want):
            assert g["token_ids"] == w["token_ids"]
            assert g["caption"] == w["caption"]
            assert "attns" not in g and "attns" not in w
    # the two requests whose entities are in their text copy, the others
    # never do
    with torch.inference_mode():
        enc = svc._encode({k: torch.from_numpy(v) for k, v in
                           batch.items()})
        out = svc._generate(enc)
    copies = out["should_copy"]
    assert copies[:2].any() and not copies[2:].any()


def test_levers_reach_the_decode_as_in_jax(model, monkeypatch):
    """kv_cache="int8" with fused_topk (kernel D's and E's plain versions
    here) against tell_tpu's service under TELL_TPU_KV8=1, read when its
    decode is traced: each request answers tell_tpu's ids."""
    monkeypatch.setenv("TELL_TPU_KV8", "1")
    jsvc, svc = _services(model, port_kw={"kv_cache": "int8",
                                          "fused_topk": True})
    reqs = _requests()
    try:
        want = [jsvc.caption(r)["token_ids"] for r in reqs]
        got = [a["token_ids"] for a in svc._run(reqs)]
    finally:
        jsvc.close()
        svc.close()
    assert got == want


def test_engine_refused_as_in_jax(model):
    with pytest.raises(ValueError) as jerr:
        _services(model, engine_slots=2)
    with pytest.raises(ValueError) as err:
        CaptionService(model["params"], RobertaEncoder(
            model["roberta"], RobertaConfig(**RFIELDS)),
            model["pcfg"].captioner, "cpu", engine_slots=2,
            adapter=get_model("transformer_pointer",
                              model["pcfg"].captioner))
    assert str(err.value) == str(jerr.value)
    assert "captioner and modern families only" in str(err.value)


def test_converted_tell_tpu_run_gives_equal_greedy_ids(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "migrate"))
    import orbax_to_torch
    jcfg, pcfg = configs(1)
    jp, _, batch = _generate_pair(pcfg, jcfg, 2)
    batch.pop("caption_ids")
    run = str(tmp_path / "run")
    mgr = JManager(os.path.join(run, "checkpoints"), use_async=False)
    mgr.save(0, {"params": jp}, {"step": 3, "epoch": 1})
    mgr.save_best({"params": jp}, {"epoch": 0, "metric": 1.5})
    assert orbax_to_torch.main(["run", run]) == 0
    params = torch.load(os.path.join(run, "checkpoints", "best", "state.pt"),
                        weights_only=True)["params"]
    leaves = tree_leaves(params)
    assert len(leaves) == len(jax.tree.leaves(jp))
    want = _jax_generate(jcfg)(jp, _jb(batch))
    with torch.inference_mode():
        got = P.pointer_generate(params, pcfg, _tb(batch))
    for key in ("token_ids", "should_copy", "finished"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    assert got["should_copy"].any()
    np.testing.assert_allclose(got["log_probs"].numpy(),
                               np.asarray(want["log_probs"]), **TOL)
