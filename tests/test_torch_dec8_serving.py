"""The int8 and merged-table levers in tell_tpu_torch's serving and command
line, on the CPU: the continuous-batching DecodeEngine against the port's
one-shot beam_search under each lever (dec8, dec8_sm, merged_vocab,
dec8 + dec8_sm) and over two shards, the CaptionService's micro-batch
decode and its numerics gate under the levers and with the enc8 tower, and
the command line's --dec8, --dec8-sm, --merged-vocab and --enc8 reaching
the decode and the towers.

The engine holds each request to beam_search on the request alone, with
the same lever: token ids and `finished` equal, scores within 1e-5 (the
tables are the same, built once in the engine's aux and once a search).
The service's micro-batch answers equal the port's generate under the
service's levers. small_test_config, weights from the port's initialisers,
requests from numpy seeds.
"""
import numpy as np
import pytest
import torch

from tell_tpu_torch.bridge import init_captioner, init_roberta
from tell_tpu_torch.commands import __main__ as cli
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.models.captioner import generate
from tell_tpu_torch.ops.quant import is_quantized_dense
from tell_tpu_torch.serving import CaptionService
from tell_tpu_torch.serving.engine import DecodeEngine
from tests.test_torch_engine import _check, _ref, _request, _setup
from tests.test_torch_serving import CFG, RCFG, _requests

torch.set_num_threads(2)
LEVERS = {"dec8": {"dec8": True}, "dec8_sm": {"dec8_sm": True},
          "merged_vocab": {"merged_vocab": True},
          "dec8+dec8_sm": {"dec8": True, "dec8_sm": True}}


@pytest.mark.parametrize("lever", list(LEVERS))
def test_engine_matches_one_shot_under_each_lever(lever):
    """Three requests through 2 slots (one waits for a free slot), beam 2:
    each equal to the one-shot search under the same lever."""
    kw = LEVERS[lever]
    cfg, params = _setup()
    reqs = [_request(cfg, s) for s in (4, 5, 6)]
    refs = [_ref(params, cfg, r, beam=2, **kw) for r in reqs]
    eng = DecodeEngine(params, cfg, "cpu", slots=2, beam=2, chunk_steps=3,
                       **kw)
    assert (eng._aux["step_quant"] is not None) == kw.get("dec8", False)
    assert (eng._aux["quant_sm"] is not None) == kw.get("dec8_sm", False)
    futs = [eng.submit(r) for r in reqs]
    eng.run_until_drained()
    for fut, ref in zip(futs, refs):
        _check(fut.result(timeout=0), ref)
    plain = _ref(params, cfg, reqs[0], beam=2)
    if lever != "merged_vocab":     # int8 moves the scores
        assert not np.array_equal(plain["scores"], refs[0]["scores"])


def test_sharded_engine_keeps_the_tables_in_every_shard():
    """Slots over ["cpu", "cpu"]: each shard builds its own tables, and
    the answers are one engine's."""
    cfg, params = _setup()
    kw = {"dec8": True, "dec8_sm": True}
    reqs = [_request(cfg, s) for s in (7, 8, 9)]
    refs = [_ref(params, cfg, r, beam=2, **kw) for r in reqs]
    eng = DecodeEngine(params, cfg, ["cpu", "cpu"], slots=4, beam=2,
                       chunk_steps=2, **kw)
    for shard in eng._shards:
        assert shard._aux["step_quant"] is not None
        assert shard._aux["quant_sm"] is not None
    futs = [eng.submit(r) for r in reqs]
    eng.run_until_drained()
    for fut, ref in zip(futs, refs):
        _check(fut.result(timeout=0), ref)


@pytest.fixture(scope="module")
def weights():
    g = torch.Generator().manual_seed(0)
    return init_captioner(g, CFG), init_roberta(g, RCFG)


def test_micro_batch_decodes_under_the_service_levers(weights):
    """The micro-batch answers are generate's under the service's levers
    (not the fp path's), and /status names them."""
    params, roberta = weights
    levers = {"dec8": True, "dec8_sm": True}
    svc = CaptionService(params, RobertaEncoder(roberta, RCFG), CFG, "cpu",
                         max_batch=4, article_len=16, **levers)
    try:
        reqs = _requests()
        got = [a["token_ids"] for a in svc._run(reqs)]
        batch, _ = svc._pack(reqs)
        with torch.inference_mode():
            enc = svc._encode({k: torch.from_numpy(v)
                               for k, v in batch.items()})
            want = generate(svc.params, CFG, enc, **levers)["token_ids"]
        assert got == [want[i].tolist() for i in range(len(reqs))]
        config = svc.status()["config"]
        assert config["dec8"] and config["dec8_sm"]
        assert not config["merged_vocab"]
        assert config["encoder_mode"] == "fp"
    finally:
        svc.close()


def test_numerics_ab_reports_the_new_levers_and_enc8(weights):
    """numerics_ab adds enc8_, dec8_, dec8_sm_ and merged_vocab_
    token_agreement beside its keys; merged_vocab is exact math in another
    summation order. A service built with enc8 holds the int8 tower only
    (its dense leaves quantised at load) and says so."""
    params, roberta = weights
    svc = CaptionService(params, RobertaEncoder(roberta, RCFG), CFG, "cpu",
                         max_batch=4, article_len=16)
    q8 = CaptionService(params, RobertaEncoder(roberta, RCFG), CFG, "cpu",
                        max_batch=4, article_len=16, enc8=True)
    try:
        report = svc.numerics_ab(_requests()[:2])
        for key in ("enc8_token_agreement", "dec8_token_agreement",
                    "dec8_sm_token_agreement",
                    "merged_vocab_token_agreement"):
            assert 0.5 <= report[key] <= 1.0, (key, report)
        assert report["merged_vocab_token_agreement"] == 1.0
        assert report["encoder_mode"] == "fp"
        layer = q8.roberta.frozen()["roberta"]["layers"][0]
        assert is_quantized_dense(layer["fc1"])
        assert not is_quantized_dense(
            svc.roberta.frozen()["roberta"]["layers"][0]["fc1"])
        assert q8.status()["config"]["encoder_mode"] == "int8"
        out = q8.numerics_ab(_requests()[:1])
        assert out["encoder_mode"] == "int8"
        assert out["enc8_token_agreement"] == 1.0    # int8 both ways
    finally:
        svc.close()
        q8.close()


def test_service_refuses_the_levers_a_family_lacks(weights):
    from tell_tpu_torch.models.registry import get_model
    params, roberta = weights
    with pytest.raises(ValueError, match="^dec8 is the flagship"):
        CaptionService(params, RobertaEncoder(roberta, RCFG), CFG, "cpu",
                       adapter=get_model("transformer_pointer", CFG),
                       dec8=True)


def _record(monkeypatch):
    """Replace what the commands load and run with recorders."""
    seen = {}
    monkeypatch.setattr(cli, "_restore_params", lambda *a: {})
    monkeypatch.setattr(cli, "_tokenizer", lambda exp: None)

    def towers(exp, device, gelu="erf", enc8=False):
        seen["towers_enc8"] = enc8
        return {"roberta": {}, "roberta_cfg": RCFG}

    monkeypatch.setattr(cli, "_frozen_towers", towers)

    def evaluate_split(*args, **kw):
        seen["evaluate"] = kw
        return {}

    from tell_tpu_torch.commands import evaluate
    monkeypatch.setattr(evaluate, "evaluate_split", evaluate_split)
    return seen


def test_command_line_flags_reach_the_decode_and_the_towers(monkeypatch):
    """evaluate and serve take --dec8, --dec8-sm and --merged-vocab;
    train, evaluate and serve take --enc8 (the tower quantised at load,
    the Trainer's after its cast)."""
    seen = _record(monkeypatch)
    cfg = "expt/quality/overfit_small.yaml"
    assert cli.main(["evaluate", cfg, "--device", "cpu", "--dec8",
                     "--dec8-sm", "--merged-vocab", "--enc8"]) == 0
    kw = seen["evaluate"]
    assert (kw["dec8"], kw["dec8_sm"], kw["merged_vocab"]) == (True,) * 3
    assert seen["towers_enc8"] is True

    made = {}

    class Service:
        def __init__(self, *args, **kw):
            made.update(kw)

        def close(self):
            pass

    from tell_tpu_torch import serving
    monkeypatch.setattr(serving, "CaptionService", Service)
    monkeypatch.setattr(serving, "serve", lambda *a, **k: None)
    monkeypatch.setattr(cli, "_restore_params", lambda *a: {})
    import tell_tpu_torch.models.backbones.roberta as rb
    monkeypatch.setattr(rb, "RobertaEncoder", lambda *a: None)
    assert cli.main(["serve", cfg, "--device", "cpu", "--dec8-sm",
                     "--enc8"]) == 0
    assert (made["dec8"], made["dec8_sm"], made["merged_vocab"],
            made["enc8"]) == (False, True, False, True)
    assert seen["towers_enc8"] is True

    trained = {}

    def train(exp, device, recover, enc8):
        trained["enc8"] = enc8
        return 0, {}

    monkeypatch.setattr(cli, "_train", train)
    assert cli.main(["train", cfg, "--device", "cpu", "--enc8"]) == 0
    assert trained["enc8"] is True
    assert cli.build_parser().parse_args(["train", cfg]).enc8 is False
    with pytest.raises(SystemExit):     # a decode lever has no train flag
        cli.build_parser().parse_args(["train", cfg, "--dec8"])
