"""The int8 and merged-table decode levers of tell_tpu_torch against
tell_tpu's on the CPU (following tests/test_dec8.py): merged_decode_table,
quantize_softmax_tables, adaptive_top_k's vocab_table= and quant_sm=
routes, decode_step_quant and the decode step, the pointer decode with the
merged table, and check_levers' refusals (the searches under each lever:
tests/test_torch_dec8_search.py; the engine, the service and evaluate:
tests/test_torch_dec8_serving.py).

tell_tpu reads its levers from the environment (TELL_TPU_DEC8,
TELL_TPU_DEC8_SM, TELL_TPU_MERGED_VOCAB, set with monkeypatch.setenv and
read when JAX traces) and runs its decodes jitted; the port takes them as
arguments. Weights from tell_tpu's initialisers carried across with the
bridge, inputs from numpy seeds, small_test_config.

Tolerances. The merged table within 1e-6 (fp32 products summed in
another order). The int8 softmax tables' bytes exact, the head's scales
exact and the tails' within 1e-6 (each tail's collapsed product P_i @
T_i^T is summed in another order). dec8's tables quantise the
weight-normed weights, whose norm XLA sums in another order, so their
scales are within 1e-6 and their int8 values equal but where a last-bit
difference crosses a .5 tie (within 1, at most one in a thousand). Top-k:
ids equal, log-probs 1e-5. Steps: features 1e-4. The pointer decode: ids
and copy decisions equal, log-probs 1e-5.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.config import small_test_config as j_small_config
from tell_tpu.models import decoder as jd
from tell_tpu.models.captioner import init_captioner as j_init
from tell_tpu.ops import adaptive as ja
from tell_tpu_torch.bridge import to_numpy, to_torch
from tell_tpu_torch.config import small_test_config
from tell_tpu_torch.models import decoder as td
from tell_tpu_torch.models.registry import get_model
from tell_tpu_torch.ops import adaptive as ta

torch.set_num_threads(2)
TABLE_TOL = dict(atol=1e-6, rtol=1e-6)
LP_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
GEN_LEN = 10


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(small_test_config(), gen_len=GEN_LEN)
    jcfg = dataclasses.replace(j_small_config(), gen_len=GEN_LEN)
    params = jax.jit(lambda r: j_init(r, jcfg))(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return cfg, jcfg, params, to_torch(params, "cpu")


def _tables(params, jcfg):
    dec = params["decoder"]
    d = jcfg.decoder
    return jax.jit(lambda sm, emb: (
        ja.merged_decode_table(sm, emb, d.full_cutoffs,
                               padding_idx=d.embed_padding_idx),
        ja.quantize_softmax_tables(sm, emb, d.full_cutoffs,
                                   padding_idx=d.embed_padding_idx)))(
        dec["adaptive_softmax"], dec["embed"])


def test_merged_decode_table_equals_jax(model):
    """One fp32 table [E, c0 + n_tails + tail bands], padding columns 0."""
    cfg, jcfg, params, tparams = model
    want, _ = _tables(params, jcfg)
    got = td.decode_vocab_table(tparams["decoder"], cfg.decoder)
    d = cfg.decoder
    c0 = d.full_cutoffs[0]
    n_tails = len(d.full_cutoffs) - 1
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (d.embed_dim, d.vocab_size + n_tails)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TABLE_TOL)
    pad = d.embed_padding_idx
    assert (to_numpy(got)[:, [pad, c0 + n_tails + pad]] == 0).all()


def test_quantize_softmax_tables_bytes_equal_jax(model):
    """The head (band 0's table) and each tail's collapsed P_i @ T_i^T in
    int8 with tell_tpu's bytes (transposed to [band, D]), each padding
    column zeroed through its scale; the class projection fp32. The
    head's scales are tell_tpu's bit for bit; a tail's within 1e-6 (its
    product P_i @ T_i^T is summed in another order)."""
    cfg, jcfg, params, tparams = model
    _, want = _tables(params, jcfg)
    got = td.decode_softmax_quant(tparams["decoder"], cfg.decoder)
    pad = cfg.decoder.embed_padding_idx
    for i, (g, w) in enumerate(zip([got["head"]] + got["tails"],
                                   [want["head"]] + want["tails"])):
        assert g["q8"].dtype == torch.int8
        np.testing.assert_array_equal(to_numpy(g["q8"]).T,
                                      np.asarray(w["q8"]))
        np.testing.assert_allclose(to_numpy(g["scale"]),
                                   np.asarray(w["scale"]),
                                   rtol=0 if i == 0 else 1e-6, atol=0)
        assert float(g["scale"][pad]) == 0.0
    np.testing.assert_array_equal(to_numpy(got["class_w"]),
                                  np.asarray(want["class_w"]))


@pytest.mark.parametrize("route", ["vocab_table", "quant_sm", "both",
                                   "fused_and_quant"])
def test_adaptive_top_k_routes_equal_jax(model, route):
    """Each route's top-5 against tell_tpu's adaptive_top_k given its own
    tables: ids equal, log-probs 1e-5. With both tables the merged one
    wins (tell_tpu's precedence); either one turns the fused route (kernel
    E's) off."""
    cfg, jcfg, params, tparams = model
    d = cfg.decoder
    jvt, jqs = _tables(params, jcfg)
    tvt = td.decode_vocab_table(tparams["decoder"], d)
    tqs = td.decode_softmax_quant(tparams["decoder"], d)
    x = np.random.default_rng(9).normal(size=(12, d.embed_dim)).astype(
        np.float32)
    jkw = {"vocab_table": jvt if route in ("vocab_table", "both") else None,
           "quant_sm": jqs if route != "vocab_table" else None}
    tkw = {"vocab_table": tvt if route in ("vocab_table", "both") else None,
           "quant_sm": tqs if route != "vocab_table" else None,
           "fused": route == "fused_and_quant"}
    dec = params["decoder"]
    want = jax.jit(lambda sm, emb, x, vt, qs: ja.adaptive_top_k(
        sm, emb, x, d.full_cutoffs, 5, padding_idx=d.embed_padding_idx,
        vocab_table=vt, quant_sm=qs))(dec["adaptive_softmax"], dec["embed"],
                                      jnp.asarray(x), jkw["vocab_table"],
                                      jkw["quant_sm"])
    got = ta.adaptive_top_k(tparams["decoder"]["adaptive_softmax"],
                            tparams["decoder"]["embed"], torch.from_numpy(x),
                            d.full_cutoffs, 5,
                            padding_idx=d.embed_padding_idx, **tkw)
    np.testing.assert_array_equal(to_numpy(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(to_numpy(got[0]), np.asarray(want[0]),
                               **LP_TOL)
    if route == "both":   # the int8 tables are not read at all
        again = ta.adaptive_top_k(
            tparams["decoder"]["adaptive_softmax"],
            tparams["decoder"]["embed"], torch.from_numpy(x),
            d.full_cutoffs, 5, padding_idx=d.embed_padding_idx,
            vocab_table=tvt)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def _jax_step_quant(params, jcfg):
    return jax.jit(lambda p: jd.decode_step_quant(p, jcfg.decoder))(
        params["decoder"])


def _as_port_tables(jtables):
    """tell_tpu's decode_step_quant tables in the port's layout."""
    return [{n: {"q8": torch.from_numpy(np.asarray(v["q8"]).T.copy()),
                 "scale": torch.from_numpy(np.array(v["scale"])),
                 "b": torch.from_numpy(np.array(v["b"]))}
             for n, v in layer.items()} for layer in jtables]


def test_decode_step_quant_and_step_equal_jax(model, monkeypatch):
    """The step's five projections a layer in int8: scales within 1e-6 of
    tell_tpu's (the weight norm's summation order, see above), and so the
    int8 values equal but where a last-bit difference crosses a .5 tie:
    within 1, at most one in a thousand. Three decode steps, the port's on
    tell_tpu's tables: features within 1e-4, but on a step where an
    activation's int8 rounding flips (its x / scale within the two
    packages' last-bit fp32 difference of a .5 tie, step 0 here: 1.0e-2)
    within 5% relative L2 of the lever's own move from the fp step; at
    least one step within 1e-4."""
    monkeypatch.setenv("TELL_TPU_DEC8", "1")
    cfg, jcfg, params, tparams = model
    jq = _jax_step_quant(params, jcfg)
    tq = td.decode_step_quant(tparams["decoder"])
    for jl, tl in zip(jq, tq):
        assert set(tl) == {"linear1", "linear2", "context_fc", "fc1",
                           "fc2"} == set(jl)
        for n in tl:
            diff = np.abs(to_numpy(tl[n]["q8"]).T.astype(int)
                          - np.asarray(jl[n]["q8"]).astype(int))
            assert diff.max() <= 1 and diff.mean() <= 1e-3, n
            np.testing.assert_allclose(to_numpy(tl[n]["scale"]),
                                       np.asarray(jl[n]["scale"]),
                                       rtol=1e-6)
            assert tl[n]["b"].dtype == torch.float32
    d = cfg.decoder
    rng = np.random.default_rng(0)
    B = 2
    contexts = {}
    for spec in d.contexts:
        mask = np.zeros((B, spec.max_len), bool)
        mask[1, spec.max_len // 2:] = True
        contexts[spec.name] = (rng.normal(size=(B, spec.max_len,
                                                spec.kv_dim)
                                          ).astype(np.float32), mask)
    jstate = jax.jit(lambda p, c: jd.init_decode_state(p, jcfg.decoder, c,
                                                       B))(
        params["decoder"], contexts)
    tstate = td.init_decode_state(tparams["decoder"], d, {
        k: (torch.from_numpy(f), torch.from_numpy(m))
        for k, (f, m) in contexts.items()}, B)
    jstep = jax.jit(lambda p, t, s, q: jd.decoder_step(
        p, jcfg.decoder, t, s, quant=q)[:2])
    close = 0
    for _ in range(3):
        toks = rng.integers(3, d.vocab_size, size=B)
        want, jstate = jstep(params["decoder"], jnp.asarray(toks), jstate,
                             jq)
        got, tstate = td.decoder_step(tparams["decoder"], d,
                                      torch.from_numpy(toks), tstate,
                                      quant=_as_port_tables(jq))
        fp, _ = td.decoder_step(tparams["decoder"], d, torch.from_numpy(toks),
                                tstate)
        want = torch.from_numpy(np.asarray(want))
        if torch.allclose(got, want, **STEP_TOL):
            close += 1
        else:
            assert float((got - want).norm()) \
                <= 0.05 * float((fp - want).norm())
        assert float((got - fp).abs().max()) > 1e-3    # int8 moved it
    assert close >= 1


def test_pointer_generate_with_the_merged_table_equals_jax(monkeypatch):
    """pointer_generate(merged_vocab=True) against tell_tpu's under
    TELL_TPU_MERGED_VOCAB=1 (the one table lever its pointer decode reads):
    ids, copy decisions and finished equal, log-probs 1e-5."""
    from tests.test_torch_pointer import (_generate_pair, _jb, _tb, configs)
    from tell_tpu.models import pointer as J
    from tell_tpu_torch.models import pointer as P
    monkeypatch.setenv("TELL_TPU_MERGED_VOCAB", "1")
    jcfg, pcfg = configs(1)
    jp, tp, batch = _generate_pair(pcfg, jcfg, 0)
    batch.pop("caption_ids")
    want = jax.jit(lambda p, b: J.pointer_generate(p, jcfg, b))(
        jp, _jb(batch))
    with torch.inference_mode():
        got = P.pointer_generate(tp, pcfg, _tb(batch), merged_vocab=True)
    for key in ("token_ids", "should_copy", "finished"):
        np.testing.assert_array_equal(to_numpy(got[key]),
                                      np.asarray(want[key]))
    np.testing.assert_allclose(to_numpy(got["log_probs"]),
                               np.asarray(want["log_probs"]), **LP_TOL)


@pytest.mark.parametrize("model_type,allowed", [
    ("transformer_faces_objects", {"dec8", "dec8_sm", "merged_vocab"}),
    ("transformer_pointer", {"merged_vocab"}),
    ("transformer_pointer_2", {"merged_vocab"}),
    ("baseline_glove", set()),
    ("transformer_modern", set())])
def test_check_levers_refuses_what_tell_tpu_does_not_read(model_type,
                                                          allowed):
    """Each family takes exactly the levers tell_tpu's code reads for it
    (enc8, the encode's, all of them) and refuses the others by name."""
    adapter = get_model(model_type, small_test_config())
    for name in ("dec8", "dec8_sm", "merged_vocab"):
        if name in allowed:
            adapter.check_levers(**{name: True})
        else:
            with pytest.raises(ValueError, match=f"^{name} is the "):
                adapter.check_levers(**{name: True})
