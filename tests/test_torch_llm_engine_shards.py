"""LLMDecodeEngine (the modern family's continuous batching) with its 4
slots sharded over ["cpu", "cpu"], against tell_tpu's one-device
LLMDecodeEngine on the same requests, at tests/test_torch_llm_decoder.py's
small expt 10 shape (GQA) with weights from tell_tpu's init_llm_decoder:
tests/test_torch_engine_shards.py's schedule, each answer's token ids
equal and its scores within 1e-5.
"""
import jax
import numpy as np

from tell_tpu.models.llm_decoder import init_llm_decoder as j_init_llm
from tell_tpu.serving import engine as JE
from tell_tpu_torch.bridge import to_torch
from tell_tpu_torch.serving.engine import LLMDecodeEngine
from tests.test_torch_engine_shards import BEAM, SLOTS, _check, _drive
from tests.test_torch_llm_decoder import configs as llm_configs
from tests.test_torch_llm_decoder import make_batch as llm_batch


def test_modern_engine_over_two_devices_equals_tell_tpu():
    jcfg, pcfg = llm_configs(gen_len=6)
    jparams = jax.jit(j_init_llm, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    reqs = [llm_batch(seed, B=1) for seed in range(6)]
    want = _drive(JE.LLMDecodeEngine(jparams, jcfg, slots=SLOTS, beam=BEAM,
                                     chunk_steps=2), reqs)
    params = to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    eng = LLMDecodeEngine(params, pcfg, ["cpu", "cpu"], slots=SLOTS,
                          beam=BEAM, chunk_steps=2)
    _check(_drive(eng, reqs), want)
