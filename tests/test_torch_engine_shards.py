"""The continuous-batching engine with its slots sharded over devices
(tell_tpu_torch/serving/engine.py over ["cpu", "cpu"]: 4 slots, 2 a
device) against tell_tpu's one-device DecodeEngine on the same requests,
on the CPU, with weights from tell_tpu's initialisers.

Staggered admissions that fill both shards, a queue that waits for a
free slot, and a shard that goes idle while the other decodes: each
answer's token ids equal tell_tpu's and its scores are within 1e-5.
Covered: the flagship in fp, the flagship with the int8 cache and the
fused top-k (the port's plain routes; tell_tpu's TELL_TPU_KV8 and
TELL_TPU_TOPK); expt 10's shape through LLMDecodeEngine in
tests/test_torch_llm_engine_shards.py. Slots that do not divide over the
devices are refused with tell_tpu's message.
"""
import dataclasses

import jax
import numpy as np
import pytest

from tell_tpu.config import small_test_config as j_small_config
from tell_tpu.models import init_captioner as j_init
from tell_tpu.serving import engine as JE
from tell_tpu_torch.bridge import to_torch
from tell_tpu_torch.config import small_test_config
from tell_tpu_torch.serving.engine import DecodeEngine
from tests.test_torch_engine import _request

SLOTS, BEAM = 4, 2

SCHEDULE = (2, 3, 1)       # requests submitted before each of the ticks


def _drive(eng, reqs):
    """Submit reqs in the SCHEDULE's bursts, a tick after each, then
    drain; the answers in submission order."""
    futs, it = [], iter(reqs)
    for n in SCHEDULE:
        futs += [eng.submit(next(it)) for _ in range(n)]
        eng.tick()
    futs += [eng.submit(r) for r in it]
    eng.run_until_drained()
    return [f.result(timeout=0) for f in futs]


def _check(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["token_ids"], np.asarray(
            b["token_ids"]))
        np.testing.assert_allclose(a["scores"], np.asarray(b["scores"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(a["finished"], np.asarray(
            b["finished"]))


@pytest.mark.parametrize("levers", [{}, {"kv_cache": "int8",
                                         "fused_topk": True}],
                         ids=["fp", "int8_fused_topk"])
def test_flagship_engine_over_two_devices_equals_tell_tpu(levers,
                                                          monkeypatch):
    cfg = dataclasses.replace(small_test_config(), gen_len=6)
    jcfg = dataclasses.replace(j_small_config(), gen_len=6)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    reqs = [_request(cfg, s) for s in range(7)]
    if levers:
        monkeypatch.setenv("TELL_TPU_KV8", "1")
        monkeypatch.setenv("TELL_TPU_TOPK", "1")
    want = _drive(JE.DecodeEngine(jparams, jcfg, slots=SLOTS, beam=BEAM,
                                  chunk_steps=2), reqs)
    params = to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    eng = DecodeEngine(params, cfg, ["cpu", "cpu"], slots=SLOTS, beam=BEAM,
                       chunk_steps=2, **levers)
    _check(_drive(eng, reqs), want)
    assert sorted(eng.free) == list(range(SLOTS))
    assert [s.slots for s in eng._shards] == [2, 2]


def test_slots_that_do_not_divide_are_refused_as_tell_tpu_refuses():
    from tell_tpu.parallel.mesh import make_mesh
    cfg = small_test_config()
    jparams = j_init(jax.random.PRNGKey(0), j_small_config())
    params = to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    with pytest.raises(ValueError) as port:
        DecodeEngine(params, cfg, ["cpu"] * 3, slots=4)
    with pytest.raises(ValueError) as ref:
        JE.DecodeEngine(jparams, j_small_config(), slots=4,
                        mesh=make_mesh(3, 1, devices=jax.devices()[:3]))
    assert str(port.value) == str(ref.value) == (
        "engine slots 4 must divide over the mesh data axis 3")
