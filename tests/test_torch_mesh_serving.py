"""Data-parallel micro-batch serving (CaptionService(devices=...), `serve
--mesh-data N`) on the CPU.

A service on ["cpu", "cpu"] splits each 4-row micro-batch over its two
replicas and answers four text requests with the ids (and, with
need_attention, the maps) of the one-device service, and with the ids of
tell_tpu's CaptionService on a 2-device mesh of the virtual CPU mesh,
from tell_tpu-initialised weights. Engine mode on two devices (the
slots sharded over them) answers as on one, and a max_batch that the
devices do not divide is refused with tell_tpu's message. `serve --mesh-data 2` answers as
`--mesh-data 1` does.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tell_tpu_torch.bridge import init_captioner, to_torch
from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
from tell_tpu_torch.serving import CaptionService
from tests.test_torch_cli import _start_serve, write_e2e_config
from tests.test_torch_modern_serving import _requests
from tests.test_torch_serving import CFG, RCFG, _WordTokenizer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    """tell_tpu-initialised captioner and RoBERTa (both packages)."""
    from tell_tpu.models.backbones.roberta import RobertaConfig as JR
    from tell_tpu.models.backbones.roberta import init_roberta
    from tell_tpu.models.captioner import init_captioner as j_init
    fields = dataclasses.asdict(RCFG)
    fields.pop("gelu")
    jrcfg = JR(**fields)
    jp = jax.jit(lambda r: j_init(r, CFG))(jax.random.PRNGKey(0))
    jr = jax.jit(lambda r: init_roberta(r, jrcfg))(jax.random.PRNGKey(1))
    return {"jparams": jp, "jfrozen": {"roberta": jr, "roberta_cfg": jrcfg},
            "params": jax.tree.map(np.asarray, jp),
            "roberta": jax.tree.map(np.asarray, jr)}


def _service(w, devices, **kw):
    return CaptionService(
        w["params"], RobertaEncoder(to_torch(w["roberta"], "cpu"), RCFG),
        CFG, "cpu", tokenizer=_WordTokenizer(), max_batch=4, article_len=16,
        devices=devices, **kw)


def test_two_replicas_answer_as_one_and_as_tell_tpu(weights, monkeypatch):
    from tell_tpu.parallel import make_mesh
    from tell_tpu.serving.server import CaptionService as JService
    from tell_tpu_torch.serving import server
    # the stand-in tokenizer has no BPE to merge the maps into words: the
    # per-step maps are compared as they are
    monkeypatch.setattr(server, "merge_word_attentions",
                        lambda *a, **kw: {})
    reqs = _requests(4)
    one = _service(weights, None, need_attention=True)
    two = _service(weights, ["cpu", "cpu"], need_attention=True)
    jsvc = JService(weights["jparams"], weights["jfrozen"], CFG,
                    _WordTokenizer(), max_batch=4,
                    mesh=make_mesh(n_data=2, n_model=1,
                                   devices=jax.devices()[:2]))
    try:
        assert two.status()["config"]["devices"] == ["cpu", "cpu"]
        for batch in (reqs, reqs[1:3]):
            a, b = one._run(batch), two._run(batch)
            want = jsvc._run(list(batch))
            for x, y, z in zip(a, b, want):
                assert "error" not in y
                assert x["token_ids"] == y["token_ids"]
                assert y["token_ids"] == list(z["token_ids"])
                assert x["attns"] == y["attns"]
    finally:
        for s in (one, two, jsvc):
            s.close()


def test_what_stays_refused(weights):
    """Engine mode over two devices, once refused as item 10's rest,
    answers each request as the one-device engine does (the slots shard
    over the devices: serving/engine.py); a max_batch that the devices do
    not divide stays refused with tell_tpu's message."""
    reqs = _requests(4)
    answers = []
    for devices in (None, ["cpu", "cpu"]):
        svc = _service(weights, devices, engine_slots=2, engine_beam=2)
        try:
            if devices:
                assert [s.device.type for s in svc.engine._shards] == \
                    ["cpu", "cpu"]
            answers.append([svc.caption(r) for r in reqs])
        finally:
            svc.close()
    for a, b in zip(*answers):
        assert "error" not in b and a["token_ids"] == b["token_ids"]
        np.testing.assert_allclose(
            [a["score"]] + [x["score"] for x in a["alternatives"]],
            [b["score"]] + [x["score"] for x in b["alternatives"]],
            rtol=1e-5)
    with pytest.raises(ValueError, match="max_batch 4 must be divisible by "
                       "the mesh data axis 3"):
        _service(weights, ["cpu"] * 3)


def test_serve_mesh_data_answers_as_one_device(tmp_path):
    from tell_tpu_torch.config_io import load_experiment
    cfg = write_e2e_config(tmp_path)
    exp = load_experiment(cfg)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"params": init_captioner(torch.Generator().manual_seed(0),
                                         exp.model)}, ckpt / "state.pt")
    texts = ["Anna Smith went to Milan on day 3.", "A photo of Bob.",
             "The mayor spoke in Rome on Tuesday."]
    answers = []
    for mesh in ("1", "2"):
        call, server, rc = _start_serve(cfg, ["-m", str(ckpt),
                                              "--mesh-data", mesh])
        got = [call("POST", "/caption", {"context": t}) for t in texts]
        status = call("GET", "/status")[1]["config"]
        assert call("POST", "/shutdown")[0] == 200
        server.join(timeout=60)
        assert not server.is_alive() and rc == [0]
        assert all(code == 200 and "error" not in b for code, b in got)
        answers.append([b["token_ids"] for _, b in got])
        assert len(status["devices"]) == int(mesh)
    assert answers[0] == answers[1]
