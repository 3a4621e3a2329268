"""GPipe pipelines (tell_tpu_torch/parallel/pipeline.py and the modern
LM's llm_forward_pp / llm_loss_pp) on 2 and 4 gloo ranks against
tell_tpu's pipeline_apply and llm_loss_pp on the virtual 8-device mesh.

pipeline_apply over 4 stages (4 microbatches), with layer_aux (the aux
of real work only), with extras and per-example batched extras, and as
dp x pp (2 stages x 2 data ranks): its output equals tell_tpu's within
1e-4, and the gradients of sum(out ** 2) (+ aux) on each stage's slice
of the stacked params equal jax.grad's within 1e-4 relative L2. A
stacked tree of 3 stages over 2 ranks is refused. llm_loss_pp over 2
stages, dense (GQA) and MoE (2 experts, top-2; the aux per microbatch, as
tell_tpu's): the loss, the MoE aux and every gradient (each stage's
layers, tok_embed, the final norm) equal tell_tpu's within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tell_tpu.config import ContextSpec as JSpec
from tell_tpu.models import llm_decoder as J
from tell_tpu.parallel.pipeline import pipeline_apply as j_apply
from tell_tpu.parallel.pipeline import pipeline_spec as j_spec
from tell_tpu.parallel.pipeline import stack_stages as j_stack
from tell_tpu_torch.config import ContextSpec, LLMConfig
from tell_tpu_torch.parallel import Ranks
from tests import _torch_parallel_workers as W

D, L, B = 16, 8, 12


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(
        np.linalg.norm(np.asarray(b)), 1e-30)


def _layers(seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(D, D)) * 0.3).astype(np.float32),
             "b": (rng.normal(size=(D,)) * 0.1).astype(np.float32)}
            for _ in range(L)]


def _j_layer(case):
    if case == "aux":
        def fn(lp, x, extras):
            out = jnp.tanh(x @ lp["w"] + lp["b"])
            return out, jnp.sum(out ** 2)
        return fn

    def fn(lp, x, extras):
        bias = 0.0
        if extras:
            bias = extras[0] + extras[-1]
        return jnp.tanh(x @ lp["w"] + lp["b"] + bias)
    return fn


def _j_pipeline(layers, x, n_stages, n_micro, case, n_data=1):
    """tell_tpu's output, aux and stacked gradients for a worker case."""
    devs = np.array(jax.devices()[:n_stages * n_data])
    mesh = Mesh(devs.reshape(n_stages, n_data), ("pipe", "data")) \
        if case == "dp" else Mesh(devs.reshape(n_stages), ("pipe",))
    stacked = j_stack(layers, n_stages)
    stacked = jax.device_put(stacked, j_spec(stacked, mesh))
    kw = {"layer_aux": case == "aux",
          "data_axis": "data" if case == "dp" else None}
    if case == "extras":
        kw["extras"] = (jnp.full((D,), 0.05),)
        kw["batched"] = jnp.broadcast_to(
            jnp.linspace(-0.2, 0.2, B)[:, None], (B, D))

    def loss(st):
        r = j_apply(st, _j_layer(case), x, mesh, n_micro, **kw)
        out, aux = r if case == "aux" else (r, 0.0)
        return jnp.sum(out ** 2) + aux, (out, aux)
    (val, (out, aux)), g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(stacked)
    return float(val), np.asarray(out), float(aux), g


def _check(outs, want, n_stages, n_data=1, n_micro=None):
    val, out, aux, g = want
    if n_data == 1:
        got = outs[0]["out"].numpy()
        for o in outs[1:]:
            assert np.array_equal(o["out"].numpy(), got)
    else:   # rank p*D + d holds data rank d's rows of each microbatch
        mb = B // n_micro
        k = mb // n_data
        got = np.zeros_like(out)
        for r, o in enumerate(outs):
            d = r % n_data
            rows = o["out"].numpy().reshape(n_micro, k, D)
            for m in range(n_micro):
                got[m * mb + d * k:m * mb + (d + 1) * k] = rows[m]
    np.testing.assert_allclose(got, out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[0]["loss"], val, rtol=1e-4)
    if outs[0]["aux"] is not None:
        np.testing.assert_allclose(outs[0]["aux"], aux, rtol=1e-4)
    for s in range(n_stages):
        mine = outs[s * n_data]["grads"]
        for name in ("w", "b"):
            assert _rel(mine[name][s], g[name][s]) < 1e-4, (s, name)


def _llm(moe):
    fields = dict(vocab_size=97, dim=16, num_layers=2, num_heads=2,
                  num_kv_heads=2 if moe else 1, ffn_dim=24, dropout=0.0,
                  attention_dropout=0.0, max_target_positions=16,
                  gen_len=5, loss_vocab_chunk=32)
    if moe:
        fields.update(moe_experts=2, moe_top_k=2)
    ctx = (("image", 8, 3), ("article", 8, 5))
    jcfg = J.LLMConfig(**fields, contexts=tuple(JSpec(*c) for c in ctx))
    pcfg = LLMConfig(**fields, contexts=tuple(ContextSpec(*c) for c in ctx))
    params = J.init_llm_decoder(jax.random.PRNGKey(10 + moe), jcfg)
    rng = np.random.default_rng(11)
    caps = rng.integers(4, 97, (4, 8)).astype(np.int32)
    caps[:, 0], caps[:, -1], caps[1, 5:] = 0, 2, 1
    batch = {"image_grid": rng.normal(size=(4, 3, 8)).astype(np.float32),
             "article": rng.normal(size=(4, 5, 8)).astype(np.float32),
             "article_mask": np.zeros((4, 5), bool), "caption_ids": caps}
    batch["article_mask"][2, 3:] = True
    return jcfg, pcfg, jax.tree.map(np.asarray, params), batch


def _j_llm(jcfg, params, batch):
    mesh = Mesh(np.array(jax.devices()[:2]), ("pipe",))
    stacked = J.stack_llm_layers(params, 2)
    stacked = jax.device_put(stacked, J.llm_pp_sharding(stacked, mesh))

    def loss(st):
        return J.llm_loss_pp(st, jcfg, batch, mesh, n_micro=2)
    (val, aux), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    return float(val), aux, g


def test_two_stage_cases_and_the_modern_lm_equal_tell_tpu():
    layers = _layers()
    x = np.random.default_rng(1).normal(size=(B, D)).astype(np.float32)
    dense, moe = _llm(False), _llm(True)
    todo = [("pipeline", (layers, x, 2, 4, "aux")),
            ("pipeline", (layers, x, 2, 2, "extras")),
            ("pipeline", (layers[:6], x, 3, 2, "plain")),
            ("llm_pp", (dense[1], dense[2], dense[3], 2)),
            ("llm_pp", (moe[1], moe[2], moe[3], 2))]
    ranks = Ranks(W.jobs, 2, (todo,), deadline_s=120)
    wants = [_j_pipeline(layers, x, 2, 4, "aux"),
             _j_pipeline(layers, x, 2, 2, "extras")]
    llm_wants = [_j_llm(c[0], c[2], c[3]) for c in (dense, moe)]
    outs = ranks.join()
    for job, want in enumerate(wants):
        _check([o[job] for o in outs], want, 2)
    assert all("3 stages but the pipe group has 2 ranks" in o[2]["error"]
               for o in outs)
    for job, (val, aux, g) in zip((3, 4), llm_wants):
        np.testing.assert_allclose(outs[0][job]["loss"], float(val),
                                   rtol=1e-4)
        if "moe_aux" in aux:
            np.testing.assert_allclose(outs[0][job]["moe_aux"],
                                       float(aux["moe_aux"]), rtol=1e-4)
        for s in range(2):
            mine = outs[s][job]["grads"]
            for path, ref in jax.tree_util.tree_leaves_with_path(
                    g["layers"]):
                leaf = mine["layers"]
                for k in path:
                    leaf = leaf[k.key]
                assert _rel(leaf[s], np.asarray(ref)[s]) < 1e-4, (s, path)
            for name in ("tok_embed", "final_norm"):
                a = jax.tree.leaves(mine[name])
                b = jax.tree.leaves(g[name])
                for x_, y_ in zip(a, b):
                    assert _rel(x_, y_) < 1e-4, name
    assert outs[0][4]["moe_aux"] is not None and outs[0][3]["moe_aux"] \
        is None


def test_four_stages_and_dp_x_pp_equal_tell_tpu():
    layers = _layers(2)
    x = np.random.default_rng(3).normal(size=(B, D)).astype(np.float32)
    todo = [("pipeline", (layers, x, 4, 4, "plain")),
            ("pipeline", (layers[:4], x, 2, 3, "dp"))]
    ranks = Ranks(W.jobs, 4, (todo,), deadline_s=120)
    plain = _j_pipeline(layers, x, 4, 4, "plain")
    dp = _j_pipeline(layers[:4], x, 2, 3, "dp", n_data=2)
    outs = ranks.join()
    _check([o[0] for o in outs], plain, 4)
    _check([o[1] for o in outs], dp, 2, n_data=2, n_micro=3)
