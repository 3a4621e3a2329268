"""The flagship's sibling configurations with weigh_bert false (the
article is RoBERTa's last hidden state, as expts 4 and 5 read it) against
tell_tpu on the CPU: the loss and every gradient, greedy, beam 5 and
predict_forced (tests/test_torch_siblings.py's check_case and
tolerances); and the continuous-batching engine on sibling configurations
against the one-shot beam search (tests/test_torch_engine.py's check)."""
import pytest

from tests.test_torch_siblings import CASES, check_case


@pytest.mark.parametrize("name", ["no_image", "flattened", "faces"])
def test_unweighted_sibling_matches_jax(name):
    check_case(CASES[name])


@pytest.mark.parametrize("name", ["no_image", "flattened", "learned"])
def test_engine_admits_sibling_configs(name):
    """The continuous-batching engine on a sibling configuration (no image
    context for no_image; the learned position table read at each slot's
    own step for learned): staggered admissions, each answer equal to the
    one-shot beam_search of its request alone."""
    import numpy as np
    import torch

    from tell_tpu_torch.bridge import init_captioner
    from tell_tpu_torch.serving.engine import DecodeEngine
    from tests.test_torch_engine import _check, _ref
    from tests.test_torch_siblings import _batch
    cfg = CASES[name]
    params = init_captioner(torch.Generator().manual_seed(0), cfg)
    feats, _ = _batch(cfg, 3, 4, 2)
    reqs = [{k: np.ascontiguousarray(v[i:i + 1]) for k, v in feats.items()}
            for i in range(3)]
    refs = [_ref(params, cfg, r, beam=2) for r in reqs]
    eng = DecodeEngine(params, cfg, "cpu", slots=2, beam=2, chunk_steps=2)
    futs = [eng.submit(reqs[0])]
    eng.tick()                        # r0 advances to t=2
    futs += [eng.submit(r) for r in reqs[1:]]   # r2 waits for a free slot
    eng.run_until_drained()
    for fut, ref in zip(futs, refs):
        _check(fut.result(timeout=0), ref)
