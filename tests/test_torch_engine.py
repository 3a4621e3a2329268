"""tell_tpu_torch's continuous-batching DecodeEngine against the port's
one-shot beam_search, on the CPU (following tests/test_engine.py).

A request's caption must never depend on which other requests share the
engine or when they were admitted: staggered admissions, slot reuse, the
backpressure drain with max_lag=1, warm-then-serve, random schedules, the
length penalty, and the int8 K/V cache with the fused top-k each give
token ids and `finished` equal, and scores within 1e-5, to beam_search on
the request alone (tests/test_torch_captioner.py holds beam_search to
tell_tpu's). small_test_config, weights from the port's initialisers,
requests from numpy seeds with ragged article padding.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from tell_tpu_torch.bridge import init_captioner
from tell_tpu_torch.config import small_test_config
from tell_tpu_torch.models.beam import beam_search
from tell_tpu_torch.serving.engine import DecodeEngine

torch.set_num_threads(2)


def _setup(gen_len=6):
    cfg = dataclasses.replace(small_test_config(), gen_len=gen_len)
    return cfg, init_captioner(torch.Generator().manual_seed(0), cfg)


def _request(cfg, seed):
    """One feature batch (leading dim 1) with a ragged article pad."""
    dcfg = cfg.decoder
    rng = np.random.default_rng(seed)
    art = dcfg.context("article")
    mask = np.zeros((1, art.max_len), bool)
    mask[0, art.max_len - int(rng.integers(0, art.max_len // 2)):] = True

    def feats(name):
        c = dcfg.context(name)
        return rng.normal(size=(1, c.max_len, c.kv_dim)).astype(np.float32)

    return {"image_grid": feats("image"),
            "article_hiddens": rng.normal(
                size=(1, art.max_len, cfg.num_bert_layers,
                      art.kv_dim)).astype(np.float32),
            "article_mask": mask,
            "face_embeds": feats("faces"), "obj_embeds": feats("obj")}


def _ref(params, cfg, req, beam, **kw):
    with torch.inference_mode():
        out = beam_search(params, cfg, {k: torch.from_numpy(v)
                                        for k, v in req.items()},
                          beam_size=beam, **kw)
    return {k: v[0].numpy() for k, v in out.items()}


def _check(result, ref):
    np.testing.assert_array_equal(result["token_ids"], ref["token_ids"])
    np.testing.assert_allclose(result["scores"], ref["scores"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(result["finished"], ref["finished"])


def test_engine_matches_one_shot_beam_search():
    """Staggered admissions: r2 joins while r0/r1 are mid-decode."""
    cfg, params = _setup()
    reqs = [_request(cfg, s) for s in (1, 2, 3)]
    refs = [_ref(params, cfg, r, beam=2) for r in reqs]
    eng = DecodeEngine(params, cfg, "cpu", slots=3, beam=2, chunk_steps=2)
    futs = [eng.submit(reqs[0]), eng.submit(reqs[1])]
    eng.tick()                        # r0/r1 advance to t=2
    futs.append(eng.submit(reqs[2]))  # joins at t=0 while the others run
    eng.run_until_drained()
    for fut, ref in zip(futs, refs):
        _check(fut.result(timeout=0), ref)


def test_engine_slot_reuse():
    """More requests than slots: freed slots take queued requests, and
    the dirty state (conv windows, K/V, counters) does not leak."""
    cfg, params = _setup()
    reqs = [_request(cfg, s) for s in (4, 5, 6, 7)]
    refs = [_ref(params, cfg, r, beam=2) for r in reqs]
    eng = DecodeEngine(params, cfg, "cpu", slots=2, beam=2, chunk_steps=3)
    futs = [eng.submit(r) for r in reqs]
    eng.run_until_drained()
    for fut, ref in zip(futs, refs):
        _check(fut.result(timeout=0), ref)
    assert sorted(eng.free) == [0, 1]
    assert eng.stats["requests"] == 4


def test_engine_queued_not_stranded_after_backpressure_drain():
    """max_lag=1 and chunk_steps >= gen_len: one backpressure drain can
    settle every report while the queue still holds requests; tick() must
    keep reporting work so those requests are admitted and resolve."""
    cfg, params = _setup()
    reqs = [_request(cfg, 20 + s) for s in range(6)]
    refs = [_ref(params, cfg, r, beam=2) for r in reqs]
    eng = DecodeEngine(params, cfg, "cpu", slots=2, beam=2,
                       chunk_steps=cfg.gen_len, max_lag=1)
    futs = [eng.submit(r) for r in reqs]
    eng.run_until_drained()
    for fut, ref in zip(futs, refs):
        _check(fut.result(timeout=0), ref)
    assert eng.stats["requests"] == len(reqs)


def test_engine_warm_then_results_match_one_shot():
    """warm() drives every admission size and leaves the engine inert."""
    cfg, params = _setup()
    reqs = [_request(cfg, 40 + s) for s in range(3)]
    refs = [_ref(params, cfg, r, beam=2) for r in reqs]
    eng = DecodeEngine(params, cfg, "cpu", slots=3, beam=2, chunk_steps=2)
    eng.warm(reqs[0])
    assert sorted(eng.free) == [0, 1, 2]
    assert eng.tick() is False        # nothing live after warm
    futs = [eng.submit(r) for r in reqs]
    eng.run_until_drained()
    for fut, ref in zip(futs, refs):
        _check(fut.result(timeout=0), ref)


def test_engine_idle_tick():
    cfg, params = _setup()
    eng = DecodeEngine(params, cfg, "cpu", slots=2, beam=2)
    assert eng.tick() is False
    assert eng.stats["chunks"] == 0


def test_engine_random_schedules():
    """Random geometry and a random interleaving of submissions and ticks
    (seeded, 2 rounds) reproduce every one-shot beam_search."""
    rng = np.random.RandomState(1234)
    for round_i in range(2):
        cfg, params = _setup(gen_len=int(rng.randint(4, 8)))
        slots, beam = int(rng.randint(2, 5)), int(rng.randint(2, 4))
        n_req = int(rng.randint(3, 6))
        reqs = [_request(cfg, 100 * round_i + i) for i in range(n_req)]
        refs = [_ref(params, cfg, r, beam=beam) for r in reqs]
        eng = DecodeEngine(params, cfg, "cpu", slots=slots, beam=beam,
                           chunk_steps=int(rng.randint(1, 4)),
                           max_lag=int(rng.randint(1, 4)))
        futs, i, live = [], 0, True
        while i < n_req or live:
            for _ in range(int(rng.randint(0, 3))):
                if i < n_req:
                    futs.append(eng.submit(reqs[i]))
                    i += 1
            live = eng.tick()
        eng.run_until_drained()
        for fut, ref in zip(futs, refs):
            _check(fut.result(timeout=0), ref)
        assert sorted(eng.free) == list(range(slots))


def test_engine_length_penalty_matches_one_shot():
    cfg, params = _setup()
    req = _request(cfg, 55)
    ref = _ref(params, cfg, req, beam=3, length_penalty=0.7)
    eng = DecodeEngine(params, cfg, "cpu", slots=2, beam=3, chunk_steps=2,
                       length_penalty=0.7)
    out = eng.submit(req)
    eng.run_until_drained()
    _check(out.result(timeout=0), ref)


@pytest.mark.parametrize("kv_cache", ["int8", "int4"])
def test_engine_quantised_cache_and_fused_topk_match_one_shot(kv_cache):
    """The quantised cache (written into slot rows with its scales) and
    kernel E's route give the one-shot beam_search of the same numerics."""
    cfg, params = _setup()
    reqs = [_request(cfg, s) for s in (71, 72, 73)]
    refs = [_ref(params, cfg, r, beam=2, kv_cache=kv_cache,
                 fused_topk=True) for r in reqs]
    eng = DecodeEngine(params, cfg, "cpu", slots=2, beam=2, chunk_steps=2,
                       kv_cache=kv_cache, fused_topk=True)
    assert eng.state["kv"][0]["k"].dtype == torch.int8
    futs = [eng.submit(r) for r in reqs]
    eng.run_until_drained()
    for fut, ref in zip(futs, refs):
        _check(fut.result(timeout=0), ref)


def test_engine_concurrent_submits_while_ticking():
    """Eight client threads submit while a tick thread runs the engine,
    with a shortened switch interval to interleave them finely: every
    request resolves, to its one-shot result, and the counters add up."""
    cfg, params = _setup(gen_len=4)
    reqs = [_request(cfg, 300 + i) for i in range(16)]
    refs = [_ref(params, cfg, r, beam=2) for r in reqs]
    eng = DecodeEngine(params, cfg, "cpu", slots=3, beam=2, chunk_steps=2)
    futs = [None] * len(reqs)
    stop = threading.Event()

    def client(c):
        for i in range(c, len(reqs), 8):
            futs[i] = eng.submit(reqs[i])

    def ticker():
        while not stop.is_set():
            eng.tick()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        tick_thread = threading.Thread(target=ticker)
        tick_thread.start()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=60)
        results = [f.result(timeout=60) for f in futs]
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    tick_thread.join(timeout=60)
    assert not tick_thread.is_alive()
    assert not any(t.is_alive() for t in clients)
    for result, ref in zip(results, refs):
        _check(result, ref)
    assert eng.stats["requests"] == len(reqs)
    assert sorted(eng.free) == [0, 1, 2] and not eng.pending


def test_engine_poison_fails_futures_fast():
    cfg, params = _setup(gen_len=4)
    eng = DecodeEngine(params, cfg, "cpu", slots=2, beam=2, chunk_steps=2)
    req = _request(cfg, 1)
    f_queued = eng.submit(req)          # never ticked: stays queued
    eng.poison(RuntimeError("tick loop died"))
    with pytest.raises(RuntimeError, match="tick loop died"):
        f_queued.result(timeout=1)
    with pytest.raises(RuntimeError, match="tick loop died"):
        eng.submit(req).result(timeout=1)


def test_engine_failed_admission_fails_its_futures():
    """A tick that raises inside an admission (here a malformed feature
    batch) leaves the grabbed request pending, so poison() fails it at once
    instead of leaving its caller waiting."""
    cfg, params = _setup(gen_len=4)
    eng = DecodeEngine(params, cfg, "cpu", slots=2, beam=2, chunk_steps=2)
    bad = _request(cfg, 1)
    bad["image_grid"] = bad["image_grid"][..., :-1]
    fut = eng.submit(bad)
    with pytest.raises(RuntimeError):
        eng.tick()
    eng.poison(RuntimeError("tick loop died"))
    with pytest.raises(RuntimeError, match="tick loop died"):
        fut.result(timeout=1)


def test_engine_refuses_too_long_captions():
    cfg, params = _setup(gen_len=small_test_config().decoder
                         .max_target_positions + 1)
    with pytest.raises(ValueError, match="max_target_positions"):
        DecodeEngine(params, cfg, "cpu", slots=2, beam=2)
