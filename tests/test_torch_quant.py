"""tell_tpu_torch's w8a8 quantisation (ops/quant.py, kernel G's plain
version) against tell_tpu's ops/quant.py on the CPU (following
tests/test_quant.py).

tell_tpu runs its activation quantisation and its decode tables inside
jit, where XLA turns the scale's division by 127 into a product with the
fp32 reciprocal and contracts the bias add into an FMA; it quantises its
frozen tower eagerly, at load, where the division stays a division. The
port follows each, so its int8 values and scales equal tell_tpu's (jitted
or eager, as tell_tpu runs each) bit for bit, .5 ties planted; the dense
layer's outputs within 1e-6 relative (equal here). The quantised tower's
encode within 1e-4 of tell_tpu's (two layers, fp32 sums in another
order). Inputs from numpy seeds; the tower from tell_tpu's init_roberta
carried across with the bridge.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tell_tpu.models.backbones.roberta import (
    RobertaConfig as JRobertaConfig, init_roberta as j_init,
    roberta_encode_windowed as j_windowed)
from tell_tpu.ops import quant as jq
from tell_tpu_torch.bridge import to_numpy, to_torch
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder,
                                                     roberta_encode_windowed)
from tell_tpu_torch.ops import quant as tq
from tell_tpu_torch.ops.kernels.int8_linear import (fma32, int8_gemm_plain,
                                                    int8_linear_plain,
                                                    quantize_rows)
from tell_tpu_torch.training.train_step import cast_tree

torch.set_num_threads(2)
ENC_TOL = dict(atol=1e-4, rtol=1e-4)
RK = dict(vocab_size=300, dim=32, num_layers=2, num_heads=2, ffn_dim=64,
          max_positions=20)
JCFG, CFG = JRobertaConfig(**RK), RobertaConfig(**RK)


def _tied(rng, shape, axis):
    """Normal values with slice 0 along the other axis holding amax 127
    (scale exactly 1 both ways) and .5 ties: round half to even decides
    them."""
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    n = shape[axis]
    ties = (np.arange(n) % 254 - 127 + 0.5).astype(np.float32)
    ties[0] = 127.0
    if axis == 0:
        x[:, 0] = ties
    else:
        x[0, :] = ties
    return x


@pytest.mark.parametrize("where", ["jit", "eager"])
def test_weight_quant_equals_jax(where):
    """Inside jit (the decode tables): the reciprocal product; eagerly (the
    tower at load, quantize_dense): the division. Values are tell_tpu's
    "q8" transposed to [dout, din]."""
    w = _tied(np.random.default_rng(0), (300, 40), 0)
    if where == "jit":
        ref = jax.jit(jq.quantize_weight_int8)(jnp.asarray(w))
        out = tq.quantize_weight_int8(torch.from_numpy(w))
    else:
        ref = jq.quantize_weight_int8(jnp.asarray(w))
        out = tq.quantize_weight_int8(torch.from_numpy(w), exact_div=True)
    assert out["q8"].dtype == torch.int8 and out["q8"].is_contiguous()
    assert tuple(out["q8"].shape) == (40, 300)
    np.testing.assert_array_equal(to_numpy(out["q8"]).T,
                                  np.asarray(ref["q8"]))
    np.testing.assert_array_equal(to_numpy(out["scale"]),
                                  np.asarray(ref["scale"]))
    # the tie column's scale is 1: its .5 values round half to even
    assert to_numpy(out["scale"])[0] == 1.0
    np.testing.assert_array_equal(to_numpy(out["q8"])[0], np.round(w[:, 0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant_equals_jax(dtype):
    """Per-row dynamic quantisation as tell_tpu's jitted encode runs it;
    bf16 rows go to fp32 first on both sides."""
    x = _tied(np.random.default_rng(1), (37, 300), 1)
    x[5] *= 100.0       # an outlier row leaves the others' scales alone
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = jax.jit(jq.quantize_act_int8)(jx)
    tq8, ts = tq.quantize_act_int8(tx)
    assert tq8.dtype == torch.int8 and tuple(ts.shape) == (37, 1)
    np.testing.assert_array_equal(to_numpy(tq8), np.asarray(q))
    np.testing.assert_array_equal(to_numpy(ts), np.asarray(s))
    # the kernel wrapper takes its plain version on a CPU tensor
    np.testing.assert_array_equal(to_numpy(quantize_rows(tx)[0]),
                                  np.asarray(q))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_plain_matches_jax(bias, dtype):
    """int8_linear_plain against tell_tpu's jitted int8_linear at 1e-6
    relative, over 3-d rows: the same int8 values, exact int32 sums, and
    the epilogue rounded as XLA rounds it."""
    rng = np.random.default_rng(2)
    p = {"w": rng.normal(size=(128, 96)).astype(np.float32) * 0.05}
    if bias:
        p["b"] = rng.normal(size=(96,)).astype(np.float32) * 0.1
    x = rng.normal(size=(4, 50, 128)).astype(np.float32)
    jp = jq.quantize_dense({k: jnp.asarray(v) for k, v in p.items()})
    tp = tq.quantize_dense({k: torch.from_numpy(v) for k, v in p.items()})
    ref = jax.jit(jq.int8_linear)(jp, jnp.asarray(x, getattr(jnp, dtype)))
    out = tq.int8_linear(tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype) and out.shape == (4, 50, 96)
    np.testing.assert_allclose(to_numpy(out), np.asarray(
        ref.astype(jnp.float32)), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        to_numpy(out), to_numpy(int8_linear_plain(
            torch.from_numpy(x).to(getattr(torch, dtype)), tp["q8"],
            tp["scale"], tp.get("b"))))


def test_fma32_rounds_once():
    """A product whose sum with c lands on an fp32 midpoint in float64
    (the double rounding a plain float64 sum would take), and random
    values against the exact sum rounded once."""
    a = torch.tensor([2.0 ** -12 * (1 + 2.0 ** -23)])
    b = torch.tensor([2.0 ** -12 * (1 - 2.0 ** -23)])
    c = torch.tensor([1 + 2.0 ** -23])
    assert fma32(a, b, c).item() == 1 + 2.0 ** -23
    assert (a.double() * b.double() + c.double()).float().item() \
        == 1 + 2.0 ** -22
    from fractions import Fraction
    rng = np.random.default_rng(3)
    x, y, z = (rng.normal(size=400).astype(np.float32) for _ in range(3))
    got = to_numpy(fma32(*map(torch.from_numpy, (x, y, z))))
    for i in range(400):
        exact = Fraction(float(x[i])) * Fraction(float(y[i])) \
            + Fraction(float(z[i]))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert got[i] == best, i


def test_int8_gemm_plain_is_the_exact_integer_product():
    """The float64 product of int8 values is the int32 sum: K = 4096 at
    the extremes (|sum| up to 127^2 x 4096 = 66M, beyond fp32's 2^24)."""
    rng = np.random.default_rng(4)
    xq = rng.integers(-127, 128, size=(6, 4096)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(10, 4096)).astype(np.int8)
    xq[0], wq[0] = 127, 127
    acc = xq.astype(np.int64) @ wq.astype(np.int64).T
    out = int8_gemm_plain(torch.from_numpy(xq), torch.ones(6, 1),
                          torch.from_numpy(wq), torch.ones(10))
    np.testing.assert_array_equal(to_numpy(out), acc.astype(np.float32))
    assert acc[0, 0] == 127 * 127 * 4096


def test_quantize_dense_idempotent():
    p = {"w": torch.randn(16, 8), "b": torch.zeros(8)}
    q1 = tq.quantize_dense(p)
    assert tq.quantize_dense(q1) is q1
    assert tq.is_quantized_dense(q1) and not tq.is_quantized_dense(p)
    assert q1["b"].dtype == torch.float32


@pytest.fixture(scope="module")
def tower():
    p = jax.tree.map(np.array, j_init(jax.random.PRNGKey(6), JCFG))
    rng = np.random.default_rng(0)
    for ln in [p["embed_ln"]] + [lp[n] for lp in p["layers"]
                                 for n in ("attn_ln", "ffn_ln")]:
        ln["scale"] = rng.uniform(0.5, 1.5, ln["scale"].shape).astype(
            np.float32)
        ln["bias"] = rng.normal(0, 0.1, ln["bias"].shape).astype(np.float32)
    return p


def test_quantize_roberta_equals_jax_and_encodes(tower):
    """quantize_roberta: q/k/v/attn_out/fc1/fc2 int8 with tell_tpu's bytes
    and scales (its eager load-time quantisation), the embeddings and
    LayerNorms the same tensors, idempotent; the windowed encode (30 ids
    over 18-token windows) of the int8 tower within 1e-4 of tell_tpu's,
    through RobertaEncoder too, and its kernel-dispatch leaf the int8
    one."""
    jqt = jq.quantize_roberta(jax.tree.map(jnp.asarray, tower))
    params = to_torch(tower, "cpu")
    q = tq.quantize_roberta(params)
    assert tq.quantize_roberta(q)["layers"][0]["q"] is q["layers"][0]["q"]
    assert q["word_embed"] is params["word_embed"]
    assert q["layers"][0]["attn_ln"] is params["layers"][0]["attn_ln"]
    for jl, tl in zip(jqt["layers"], q["layers"]):
        for name in ("q", "k", "v", "attn_out", "fc1", "fc2"):
            assert "w" not in tl[name]
            np.testing.assert_array_equal(to_numpy(tl[name]["q8"]).T,
                                          np.asarray(jl[name]["q8"]))
            np.testing.assert_array_equal(to_numpy(tl[name]["scale"]),
                                          np.asarray(jl[name]["scale"]))
    ids = np.random.default_rng(7).integers(4, 300, size=(2, 30))
    ids[1, 20:] = CFG.pad_id
    ref = jax.jit(lambda p, i: j_windowed(p, JCFG, i,
                                          return_all_hiddens=False))(
        jqt, jnp.asarray(ids))
    out = roberta_encode_windowed(q, CFG, torch.from_numpy(ids),
                                  return_all_hiddens=False)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), **ENC_TOL)
    fp = roberta_encode_windowed(params, CFG, torch.from_numpy(ids),
                                 return_all_hiddens=False)
    rel = float((out - fp).norm() / fp.norm())
    assert 0 < rel < 0.1, rel       # int8 moves it, within the contract
    enc = RobertaEncoder(q, CFG)
    assert enc.params.tree()["layers"][1]["fc2"]["q8"].dtype == torch.int8
    np.testing.assert_array_equal(
        to_numpy(enc(torch.from_numpy(ids), return_all_hiddens=False)),
        to_numpy(out))


def test_cast_tree_keeps_quantised_leaves_whole(tower):
    """The bf16 compute cast of the train step and the Trainer leaves an
    int8 dense dict as it is (fp32 scales and bias, int8 values), as
    tell_tpu's map_tree_preserving_quant does, and casts the rest."""
    frozen = {"roberta": tq.quantize_roberta(to_torch(tower, "cpu")),
              "roberta_cfg": CFG}
    out = cast_tree(frozen, "bfloat16")
    lq = out["roberta"]["layers"][0]["q"]
    assert lq is frozen["roberta"]["layers"][0]["q"]
    assert lq["scale"].dtype == torch.float32 and lq["q8"].dtype == torch.int8
    assert out["roberta"]["word_embed"].dtype == torch.bfloat16
    assert out["roberta"]["layers"][0]["attn_ln"]["scale"].dtype \
        == torch.bfloat16
    assert out["roberta_cfg"] is CFG
    assert cast_tree(frozen, "float32") is frozen
    mapped = tq.map_tree_preserving_quant(lambda t: "leaf", {
        "a": [torch.zeros(1), (torch.zeros(1),)], "d": {"q8": 1}})
    assert mapped == {"a": ["leaf", ("leaf",)], "d": {"q8": 1}}


def test_maybe_quantize_frozen_lever(tower):
    frozen = {"roberta": to_torch(tower, "cpu"), "roberta_cfg": CFG}
    assert tq.maybe_quantize_frozen(frozen, False) is frozen
    out = tq.maybe_quantize_frozen(frozen, True)
    assert tq.is_quantized_dense(out["roberta"]["layers"][0]["q"])
    assert out["roberta_cfg"] is CFG
    assert not tq.is_quantized_dense(frozen["roberta"]["layers"][0]["q"])
    assert tq.maybe_quantize_frozen({"resnet": {}}, True) == {"resnet": {}}


def test_trainer_quantises_the_frozen_tower_once_after_the_cast(tower):
    """Trainer(enc8=True) under bf16: the tower's dense leaves int8 with
    fp32 scales (cast first, then quantised), its other leaves bf16; an
    encode through the Trainer's frozen dict runs the int8 layers."""
    import dataclasses
    from tell_tpu_torch.config import small_test_config
    from tell_tpu_torch.training.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(small_test_config(), compute_dtype="bfloat16")
    tr = Trainer(cfg, TrainerConfig(serialization_dir="unused"),
                 lambda epoch: iter(()), None,
                 {"roberta": to_torch(tower, "cpu"), "roberta_cfg": CFG},
                 device="cpu", enc8=True)
    layer = tr.frozen["roberta"]["layers"][1]
    assert layer["fc1"]["q8"].dtype == torch.int8
    assert layer["fc1"]["scale"].dtype == torch.float32
    assert layer["ffn_ln"]["scale"].dtype == torch.bfloat16
    # quantised from the bf16-cast weight, as tell_tpu orders it
    w16 = torch.from_numpy(tower["layers"][1]["fc1"]["w"]).bfloat16()
    want = tq.quantize_weight_int8(w16, exact_div=True)
    assert torch.equal(layer["fc1"]["q8"], want["q8"])
    ids = torch.from_numpy(np.random.default_rng(8).integers(4, 300, (2, 9)))
    out = roberta_encode_windowed(tr.frozen["roberta"], CFG, ids,
                                  return_all_hiddens=False)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
