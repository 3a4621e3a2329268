"""Drive tell_tpu_torch's serving and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):
  1. device and setup: needs CUDA; prints the card's name and power limit;
     TF32 off for matmuls and cuDNN (fp32 means fp32).
  2. build: compiles the hand-written kernels of tell_tpu_torch/csrc/ with
     nvcc for sm_90a.
  3. kernel vs plain on the card: kernel A (decode attention) and kernel B
     (encoder attention) at the serving path's shapes, kernel C (fused
     dynamic conv) at the training path's (B=16, C=1024, H=16, T=32 with
     K=3/7/15/31, T=100 and T=15 with K=31), kernel D (decode attention over
     the int8/int4 K/V cache; B=8, MG=20, S=637 and 2173) and kernel E
     (streamed top-k; N=40 and 640, D=1024, V=5000/15000/30265, k=5, and
     k=8 once) at the engine's, fp32 and bf16, against their plain PyTorch
     versions, kernel C's gradient through its autograd Function too;
     kernels A, B and D also 100 times on the same input, bit for bit
     (a race would vary); kernel E's ids held by the logit at each id;
     CUDA-event times of both, C forward and forward+backward.
  4. full-width service: CaptionerConfig() + RobertaConfig.large() with
     random weights from the seed, served over HTTP on a local port; four
     /caption requests with token ids and features, then one beam search
     (beam 5, B=8). Kernels A and B must have launched during this phase.
  5. card vs CPU: the same weights on the CPU (plain versions) and on the
     card (kernels), teacher-forced over the first 16 steps of a card
     caption; top-1 agreement >= 15/16.
  6. training, card vs CPU: full-width CaptionerConfig() weights in fp32,
     a B=2 batch with precomputed article hiddens [2, 512, 25, 1024]; the
     deterministic captioner_loss and every gradient on the card (kernel C
     forward, its Function's backward), on the card with kernel C's plain
     version, and on the CPU (plain versions). Kernel C against its plain
     version: each gradient leaf within 1e-4 relative L2. Card against CPU:
     loss within 1e-5 relative, each leaf within 2e-2 relative L2 and the
     median leaf within 5e-3 (fp32 summation order; see the limits).
  7. the trainer on the card: a synthetic shard set, train_from_shards at
     compute_dtype bfloat16 with the frozen RoBERTa-large and the flagship
     dropouts, 16 x 512 batches with 32-token captions: two epochs of
     steps, validation (kernels B and C must launch) and a checkpoint; then
     a mid-epoch request_stop and a recover in a fresh Trainer, which must
     restore the saved params exactly and continue at the next batch.
  8. the engine service at full width: CaptionService(engine_slots=8,
     engine_beam=5, engine_buckets=True, kv_cache="int8",
     fused_topk=True) over HTTP, warmed up; 16 requests with articles of
     40-512 tokens in four staggered bursts (10 in the 128 bucket, so its
     8 slots are reused). Each answer against a one-shot beam_search with
     the same numerics on the same encoded features: equal tokens, or a
     near tie (the first differing token's two log-probs within 1e-4; that
     gap and the two final scores' gap are printed). Kernels B, D and E must
     launch on that run and kernel A must not; then one int4 beam_search at
     B=8 must launch kernel D on the packed cache. Prints captions/s, the
     p50/max request latency and /status.
  9. the numerics gate at full width: teacher-forced top-1 agreement with
     the fp path (fp cache, exact top-k) over four requests' greedy
     captions, for each lever (CaptionService.numerics_ab): int8 K/V >=
     0.95 (tell_tpu's floor), fused top-k >= 15/16 (it is exact), int4 K/V
     reported without a floor. Defaults stay fp and exact.
Then one JSON line describing the kernels and, last, the result line.
"""
from __future__ import annotations

import argparse
import http.client
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

FP32_TOL = dict(atol=1e-5, rtol=1e-4)
CONV_TOL = dict(atol=2e-5, rtol=2e-5)        # the JAX kernel test's
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 2e-2
TOPK_TOL = dict(atol=1e-5, rtol=1e-5)        # fp32 sums in another order
NEAR_TIE = 1e-4     # phase 8: engine and one-shot may swap candidates closer
REPEATS = 100       # phase 3: bit-for-bit repeats of kernels A, B and D
KV8_FLOOR = 0.95    # phase 9: tell_tpu's gate (BENCH_r05.json)
FUSED_TOPK_FLOOR = 15 / 16
# Phase 6 (training loss and gradients, fp32). Kernel C against its plain
# version inside the same card run moves no gradient leaf by more than
# CONV_GRAD_REL_L2. Card against CPU is looser: the network is random-init
# with a confident softmax (about 21 bits), and two fp32 orders of the same
# sums differ by 1e-4..6e-3 relative L2 on the worst leaf (CPU fp32 against
# a float64 CPU run: 1.8e-4; an NVIDIA H100 against the CPU: 1.1e-3 and
# 5.9e-3 on two seeds, with kernel C or its plain version alike). A wrong
# gradient is off by O(1).
TRAIN_LOSS_RTOL = 1e-5
CONV_GRAD_REL_L2 = 1e-4
TRAIN_GRAD_REL_L2 = 2e-2
TRAIN_GRAD_MEDIAN_REL_L2 = 5e-3
FLAGSHIP_SEGMENTS = (("image", 49), ("article", 512), ("faces", 4),
                     ("obj", 64))


class CheckFailed(Exception):
    """A phase's check failed (raised, not asserted: python -O keeps it)."""


def require(cond, what) -> None:
    if not cond:
        raise CheckFailed(str(what))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _decode_case(g, B, MG, article_len, dev):
    """Kernel A inputs at the decoder's layout: the four modalities' rows
    (+ bias and zero columns each) on the source axis, a real segment bias
    with padded articles and absent faces/objects. Four copies (one per
    decoder layer) so a timed loop streams K/V from device memory rather
    than L2, as the decode step does."""
    from tell_tpu_torch.ops.kernels.decode_attention import segment_bias
    H, hd, M = 16, 64, len(FLAGSHIP_SEGMENTS)
    lens = [n if name != "article" else article_len
            for name, n in FLAGSHIP_SEGMENTS]
    seg = torch.cat([torch.full((n + 2,), m, dtype=torch.long)
                     for m, n in enumerate(lens)]).to(dev)
    S = seg.numel()
    pad = torch.zeros(B, S, dtype=torch.bool)
    off = 0
    for m, n in enumerate(lens):
        keep = torch.randint(0, n + 1, (B,), generator=g)  # real rows per b
        for b in range(B):
            pad[b, off + int(keep[b]):off + n] = True
        off += n + 2
    bias = segment_bias(seg, pad.to(dev), M, MG // M)
    sets = []
    for _ in range(4):
        q = torch.randn(B, H, MG, hd, generator=g) * hd ** -0.5
        k = torch.randn(B, H, hd, S, generator=g)
        v = torch.randn(B, H, hd, S, generator=g)
        sets.append([t.to(dev) for t in (q, k, v)] + [bias])
    return S, sets


def _encoder_case(g, B, S, dev):
    H, hd = 16, 64
    q, k, v = (torch.randn(B, S, H, hd, generator=g).to(dev)
               for _ in range(3))
    lens = [S, (3 * S) // 4, S // 3, 1][:B]
    key_pad = torch.arange(S)[None, :] >= torch.tensor(lens)[:, None]
    return [[q, k, v, key_pad.to(dev)], [k, v, q, key_pad.to(dev)]]


def check_repeats(name, kernel, sets, shape, n=REPEATS):
    """n launches on sets[0], each after one on sets[1] (so shared memory
    and the L2 hold other data in between), must all equal the first
    output bit for bit: a race between a block's phases shows as an output
    that changes from launch to launch."""
    first = kernel(*sets[0])
    bad = torch.zeros((), dtype=torch.long, device=first.device)
    for _ in range(n):
        kernel(*sets[1])
        bad += (kernel(*sets[0]) != first).sum()
    require(bad.item() == 0, f"{name} {shape}: {bad.item()} outputs changed "
            f"over {n} launches on the same inputs")


def check_kernel(name, kernel, plain, sets, shape):
    """fp32: kernel vs plain on the same inputs, and bit-for-bit repeats;
    bf16: kernel on bf16 inputs vs plain in fp32 on the same bf16-rounded
    inputs. Returns the fp32 error and both times (ms per call, CUDA
    events)."""
    args = sets[0]
    ref = plain(*args)
    out = kernel(*args)
    torch.cuda.synchronize()
    err32 = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **FP32_TOL)
    check_repeats(name, kernel, sets, shape)
    args16 = [a.to(torch.bfloat16) if a.is_floating_point() and i < 3 else a
              for i, a in enumerate(args)]
    out16 = kernel(*args16)
    ref16 = plain(*[a.float() if a.dtype == torch.bfloat16 else a
                    for a in args16])
    torch.cuda.synchronize()
    err16 = (out16.float() - ref16).abs().max().item()
    if not np.isfinite(err16) or err16 > BF16_ATOL:
        raise CheckFailed(f"{name} {shape} bf16: max abs err {err16} > "
                          f"{BF16_ATOL}")
    cycle = itertools.cycle(sets)
    ms = cuda_ms(lambda: kernel(*next(cycle)))
    plain_ms = cuda_ms(lambda: plain(*next(cycle)))
    log(f"phase 3: {name} {shape}: fp32 max abs err {err32:.3e}, bf16 "
        f"max abs err {err16:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        "ms (fp32)")
    return {"shape": shape, "err32": err32, "err16": err16, "ms": ms,
            "plain_ms": plain_ms}


def check_conv(g, B, T, K, dev, C=1024, H=16):
    """Kernel C against dynamic_conv_plain: fp32 forward, bf16 forward on
    the same bf16-rounded inputs, dx and dw through the autograd Function
    against autograd of the plain version; CUDA-event times of both,
    forward and forward+backward."""
    from tell_tpu_torch.ops.kernels.dynamic_conv import (
        dynamic_conv_plain, fused_dynamic_conv)
    shape = f"B={B} T={T} C={C} H={H} K={K}"
    x = torch.randn(B, T, C, generator=g).to(dev)
    bound = (6.0 / (C + K * H)) ** 0.5
    w = ((torch.rand(C, K * H, generator=g) * 2 - 1) * bound).to(dev)
    ref = dynamic_conv_plain(x, w, K, H)
    out = fused_dynamic_conv(x, w, K, H)
    torch.cuda.synchronize()
    err32 = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **CONV_TOL)
    out16 = fused_dynamic_conv(x.bfloat16(), w.bfloat16(), K, H)
    ref16 = dynamic_conv_plain(x.bfloat16().float(), w.bfloat16().float(),
                               K, H)
    torch.cuda.synchronize()
    err16 = (out16.float() - ref16).abs().max().item()
    if not np.isfinite(err16) or err16 > BF16_ATOL:
        raise CheckFailed(f"fused_dynamic_conv {shape} bf16: max abs err "
                          f"{err16} > {BF16_ATOL}")
    gy = torch.randn(B, T, C, generator=g).to(dev)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()

    def fwd_bwd(fn):
        return torch.autograd.grad(fn(xr, wr, K, H), (xr, wr), gy)

    dk = fwd_bwd(fused_dynamic_conv)
    dp = fwd_bwd(dynamic_conv_plain)
    torch.cuda.synchronize()
    errg = max((a - b).abs().max().item() for a, b in zip(dk, dp))
    for a, b in zip(dk, dp):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    ms = cuda_ms(lambda: fused_dynamic_conv(x, w, K, H))
    plain_ms = cuda_ms(lambda: dynamic_conv_plain(x, w, K, H))
    fb_ms = cuda_ms(lambda: fwd_bwd(fused_dynamic_conv))
    plain_fb_ms = cuda_ms(lambda: fwd_bwd(dynamic_conv_plain))
    log(f"phase 3: fused_dynamic_conv {shape}: fp32 max abs err "
        f"{err32:.3e}, bf16 max abs err {err16:.3e}, grad max abs err "
        f"{errg:.3e}; forward kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"forward+backward kernel {fb_ms:.4f} ms, plain {plain_fb_ms:.4f} "
        "ms (fp32)")
    return {"shape": shape, "err32": err32, "err16": err16, "errg": errg,
            "ms": ms, "plain_ms": plain_ms, "fb_ms": fb_ms,
            "plain_fb_ms": plain_fb_ms}


def check_q8(g, B, MG, article_len, dev, mode):
    """Kernel D against decode_attention_q8_plain on _decode_case's inputs
    with K/V quantised as the decode state stores them: q fp32 (FP32_TOL,
    and bit-for-bit repeats), q bf16 (against the plain version in fp32 on the same bf16 query,
    BF16_ATOL); CUDA-event times of both with q fp32."""
    from tell_tpu_torch.models.decoder import quantize_kv, quantize_kv4
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_q8, decode_attention_q8_plain)
    quant = quantize_kv4 if mode == "int4" else quantize_kv
    S, fp_sets = _decode_case(g, B, MG, article_len, dev)
    sets = [[q, *quant(k), *quant(v), bias] for q, k, v, bias in fp_sets]
    shape = f"{mode} B={B} H=16 hd=64 MG={MG} S={S}"
    args = sets[0]
    ref = decode_attention_q8_plain(*args)
    out = decode_attention_q8(*args)
    torch.cuda.synchronize()
    err32 = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **FP32_TOL)
    check_repeats("decode_attention_q8", decode_attention_q8, sets, shape)
    q16 = args[0].to(torch.bfloat16)
    out16 = decode_attention_q8(q16, *args[1:])
    ref16 = decode_attention_q8_plain(q16.float(), *args[1:])
    torch.cuda.synchronize()
    err16 = (out16.float() - ref16).abs().max().item()
    if not np.isfinite(err16) or err16 > BF16_ATOL:
        raise CheckFailed(f"decode_attention_q8 {shape} bf16: max abs err "
                          f"{err16} > {BF16_ATOL}")
    cycle = itertools.cycle(sets)
    ms = cuda_ms(lambda: decode_attention_q8(*next(cycle)))
    plain_ms = cuda_ms(lambda: decode_attention_q8_plain(*next(cycle)))
    log(f"phase 3: decode_attention_q8 {shape}: fp32 max abs err "
        f"{err32:.3e}, bf16 max abs err {err16:.3e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (fp32 q)")
    return {"shape": shape, "err32": err32, "err16": err16, "ms": ms,
            "plain_ms": plain_ms}


def _topk_agree(out, ref, x, table, zero_row, what):
    """Values and lse within TOPK_TOL of the plain version's. The ids are
    held on their own: distinct within each row, and the fp32 logit at each
    returned id, recomputed from x @ table.T, within TOPK_TOL of the value
    the kernel returned beside it. So a wrong id fails even where its value
    is right, and an id may differ from the plain version's only at a near
    tie. Returns (max abs err over values and lse, differing ids)."""
    (v, i, l), (rv, ri, rl) = out, ref
    torch.testing.assert_close(v, rv, **TOPK_TOL)
    torch.testing.assert_close(l, rl, **TOPK_TOL)
    ids = i.long()
    require(bool(((ids >= 0) & (ids < table.shape[0])).all()),
            f"topk_logits {what}: ids outside the vocabulary")
    srt = ids.sort(dim=1).values
    require(bool((srt[:, 1:] != srt[:, :-1]).all()),
            f"topk_logits {what}: an id repeats within a row")
    logits = x.float() @ table.float().T
    logits[:, zero_row] = 0.0
    at_ids = logits.gather(1, ids)
    id_err = (at_ids - v).abs().max().item()
    torch.testing.assert_close(at_ids, v, **TOPK_TOL,
                               msg=lambda m: f"topk_logits {what}: the "
                               f"logits at the kernel's ids: {m}")
    diff = i != ri
    n_diff = int(diff.sum())
    if n_diff:
        log(f"phase 3: topk_logits {what}: {n_diff} ids differ from the "
            "plain version's, each a near tie (value gap <= "
            f"{(v - rv)[diff].abs().max().item():.3e}, logit at the "
            f"kernel's id within {id_err:.3e} of its value)")
    err = max((v - rv).abs().max().item(), (l - rl).abs().max().item())
    return err, n_diff


def check_topk(g, N, V, k, dev, D=1024):
    """Kernel E against topk_logits_plain at the engine's shapes (N = slots
    x beam rows of step features, a band's table [V, D] at the tables'
    init scale, the padding row 1 pinned): fp32, and bf16 against the plain
    version on the same bf16 values, ids held as _topk_agree says; CUDA-event times of both in fp32, over
    table copies that together exceed the L2 cache."""
    from tell_tpu_torch.ops.kernels.topk_logits import (topk_logits,
                                                        topk_logits_plain)
    shape = f"N={N} V={V} D={D} k={k}"
    x = torch.randn(N, D, generator=g).to(dev)
    n_copies = min(4, max(2, -(-200 * 2**20 // (V * D * 4))))
    tables = [(torch.randn(V, D, generator=g) * D ** -0.5).to(dev)
              for _ in range(n_copies)]
    ref = topk_logits_plain(x, tables[0], k, 1)
    out = topk_logits(x, tables[0], k, 1)
    torch.cuda.synchronize()
    err32, n_diff = _topk_agree(out, ref, x, tables[0], 1, f"{shape} fp32")
    x16, t16 = x.bfloat16(), tables[0].bfloat16()
    out16 = topk_logits(x16, t16, k, 1)
    ref16 = topk_logits_plain(x16.float(), t16.float(), k, 1)
    torch.cuda.synchronize()
    err16, n_diff16 = _topk_agree(out16, ref16, x16, t16, 1,
                                  f"{shape} bf16")
    cycle = itertools.cycle(tables)
    ms = cuda_ms(lambda: topk_logits(x, next(cycle), k, 1))
    plain_ms = cuda_ms(lambda: topk_logits_plain(x, next(cycle), k, 1))
    log(f"phase 3: topk_logits {shape}: fp32 max abs err {err32:.3e}, bf16 "
        f"max abs err {err16:.3e}, ids differing {n_diff}/{n_diff16} of "
        f"{N * k}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (fp32)")
    return {"shape": shape, "err32": err32, "err16": err16, "ms": ms,
            "plain_ms": plain_ms}


def phase_kernels(seed: int) -> dict:
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from tell_tpu_torch.ops.kernels.encoder_attention import (
        encoder_attention, encoder_attention_plain)
    g = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    res = {"decode_attention": [], "encoder_attention": [],
           "fused_dynamic_conv": [], "decode_attention_q8": [],
           "topk_logits": []}
    for MG, article in ((4, 512), (20, 512), (20, 2048)):
        S, sets = _decode_case(g, 8, MG, article, dev)
        res["decode_attention"].append(check_kernel(
            "decode_attention", decode_attention, decode_attention_plain,
            sets, f"B=8 H=16 hd=64 MG={MG} S={S}"))
    for S in (128, 512):
        res["encoder_attention"].append(check_kernel(
            "encoder_attention", encoder_attention, encoder_attention_plain,
            _encoder_case(g, 4, S, dev), f"B=4 S={S} H=16 hd=64"))
    for T, K in ((32, 3), (32, 7), (32, 15), (32, 31), (100, 31), (15, 31)):
        res["fused_dynamic_conv"].append(check_conv(g, 16, T, K, dev))
    for mode in ("int8", "int4"):
        for article in (512, 2048):
            res["decode_attention_q8"].append(
                check_q8(g, 8, 20, article, dev, mode))
    for N in (40, 640):
        for V in (5000, 15000, 30265):
            res["topk_logits"].append(check_topk(g, N, V, 5, dev))
    res["topk_logits"].append(check_topk(g, 40, 30265, 8, dev))
    return res


# ---------------------------------------------------------------------------
# phase 4: the full-width service
# ---------------------------------------------------------------------------

def _request(rng, cfg, n_ids, n_faces, n_objs, vocab):
    """A /caption payload: n_ids token ids (<s> ... </s>) drawn over the
    vocabulary, an image grid, and face/object rows of which only the
    first n_faces / n_objs are present (the rest NaN, i.e. absent)."""
    spec = {c.name: (c.max_len, c.kv_dim) for c in cfg.decoder.contexts}
    ids = [0] + rng.integers(3, vocab, n_ids - 2).tolist() + [2]
    faces = rng.normal(size=spec["faces"])
    faces[n_faces:] = np.nan
    objs = rng.normal(size=spec["obj"])
    objs[n_objs:] = np.nan
    return {"context_ids": ids,
            "image_grid": rng.normal(size=spec["image"]).round(4).tolist(),
            "face_embeds": faces.round(4).tolist(),
            "obj_embeds": objs.round(4).tolist()}


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def phase_service(seed: int, cfg, rcfg, dev: str):
    """Serve cfg/rcfg with random weights on `dev`; returns the service,
    the first request, its caption and the kernels' launch counts."""
    from tell_tpu_torch.bridge import init_captioner, init_roberta
    from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
    from tell_tpu_torch.models.captioner import encode_contexts
    from tell_tpu_torch.ops.kernels.decode_attention import decode_attention
    from tell_tpu_torch.ops.kernels.encoder_attention import (
        encoder_attention)
    from tell_tpu_torch.serving import CaptionService, serve

    t0 = time.time()
    g = torch.Generator(device=dev).manual_seed(seed)
    params = init_captioner(g, cfg)
    roberta = RobertaEncoder(init_roberta(g, rcfg), rcfg)
    article_len = cfg.decoder.context("article").max_len
    svc = CaptionService(params, roberta, cfg, dev, max_batch=8,
                         article_len=article_len)
    log(f"phase 4: random-init weights on {dev} in {time.time() - t0:.1f} s"
        f" (E={cfg.decoder.embed_dim}, RoBERTa {rcfg.num_layers}x{rcfg.dim})")
    rng = np.random.default_rng(seed)
    vocab = rcfg.vocab_size
    reqs = [_request(rng, cfg, n, f, o, vocab)
            for n, f, o in ((512, 4, 64), (300, 2, 20), (120, 1, 0),
                            (40, 0, 5))]
    httpd = serve(svc, port=0, block=False)
    port = httpd.server_address[1]
    answers = [None] * len(reqs)
    latencies = [None] * len(reqs)

    def post(i):
        t = time.perf_counter()
        answers[i] = _post(port, "/caption", reqs[i])
        latencies[i] = time.perf_counter() - t

    # warm-up request (first launches, cuBLAS handles): not measured
    status, body = _post(port, "/caption", reqs[3])
    require(status == 200 and "error" not in body, body)

    decode_attention.launches = 0
    encoder_attention.launches = 0
    t_serve = time.perf_counter()
    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    serve_s = time.perf_counter() - t_serve
    require(not any(t.is_alive() for t in threads), "requests did not finish")
    captions = []
    for i, ans in enumerate(answers):
        status, body = ans
        require(status == 200 and "error" not in body, (i, status, body))
        ids = np.asarray(body["token_ids"])
        require(ids.shape == (cfg.gen_len + 1,), ids.shape)
        require(ids.min() >= 0 and ids.max() < cfg.decoder.vocab_size,
                f"token ids outside the vocabulary: {ids}")
        captions.append(ids)
    lengths = [int((ids[1:] != cfg.decoder.pad_id).sum()) for ids in captions]
    log("phase 4: 4 /caption answers, token ids of length "
        f"{cfg.gen_len + 1} within the vocab, {lengths} tokens before "
        "padding; latencies (s) "
        + ", ".join(f"{x:.3f}" for x in latencies)
        + f"; {len(reqs) / serve_s:.3f} captions/s over {serve_s:.3f} s "
        f"(batches served: {svc.batcher.stats['batches']})")

    # beam search, beam 5, B=8, on the same weights
    beam_reqs = [_request(rng, cfg, n, 4, 64, vocab)
                 for n in (512, 480, 400, 300, 256, 200, 128, 64)]
    batch, errors = svc._pack(beam_reqs)
    require(errors == [None] * 8, errors)
    with torch.inference_mode():
        t = time.perf_counter()
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        enc = encode_contexts(svc.roberta.frozen(), cfg, tb)
        out = svc.model.beam_search(enc, beam_size=5)
        beam_ok = bool(torch.isfinite(out["scores"]).all())  # synchronises
        beam_s = time.perf_counter() - t
    require(out["token_ids"].shape == (8, 5, cfg.gen_len + 1),
            out["token_ids"].shape)
    require(beam_ok, "non-finite beam scores")
    require(bool((out["scores"][:, :-1] >= out["scores"][:, 1:]).all()),
            "beam scores not best-first")
    launches = {"decode_attention": decode_attention.launches,
                "encoder_attention": encoder_attention.launches}
    log(f"phase 4: beam_search beam=5 B=8 in {beam_s:.3f} s "
        f"({8 / beam_s:.3f} captions/s, encode included); launches "
        f"{launches}")
    if dev == "cuda":
        for name, n in launches.items():
            require(n > 0, f"{name} never launched on the main path")

    status, _ = _post(port, "/shutdown", {})
    require(status == 200, f"/shutdown answered {status}")
    deadline = time.time() + 30
    while svc.batcher._thread.is_alive() and time.time() < deadline:
        time.sleep(0.05)
    httpd.server_close()
    return svc, reqs[0], captions[0], launches


# ---------------------------------------------------------------------------
# phase 5: the same weights on the CPU and on the card
# ---------------------------------------------------------------------------

def phase_cpu_vs_card(svc, req, caption):
    from tell_tpu_torch.bridge import to_torch
    from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
    from tell_tpu_torch.models.captioner import Captioner, encode_contexts
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = svc.cfg
    batch, errors = svc._pack([req])
    require(errors == [None], errors)
    tokens = torch.from_numpy(caption[None, :17])
    preds, lps = {}, {}
    cpu_model = Captioner(to_torch(svc.model.tree(), "cpu"), cfg)
    cpu_roberta = RobertaEncoder(
        to_torch(svc.roberta.frozen()["roberta"], "cpu"), svc.roberta.cfg)
    for label, model, enc in (("card", svc.model, svc.roberta),
                              ("cpu", cpu_model, cpu_roberta)):
        dev = svc.device if label == "card" else torch.device("cpu")
        t = time.perf_counter()
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            e = encode_contexts(enc.frozen(), cfg, tb)
            p, lp = model.predict_forced(e, tokens.to(dev),
                                         with_log_probs=True)
        preds[label], lps[label] = p.cpu()[0], lp.cpu()[0]
        log(f"phase 5: predict_forced on the {label} ({dev}) in "
            f"{time.perf_counter() - t:.2f} s")
    agree = int((preds["cpu"] == preds["card"]).sum())
    lp_diff = (lps["cpu"] - lps["card"]).abs().max().item()
    follows = int((preds["card"] == tokens[0, 1:]).sum())
    log(f"phase 5: card vs CPU top-1 agreement {agree}/16, max abs "
        f"log-prob difference {lp_diff:.3e}; the card's forced top-1 "
        f"matches its own greedy caption at {follows}/16 steps")
    require(agree >= 15, f"card vs CPU agreement {agree}/16 < 15/16")
    return agree, lp_diff


# ---------------------------------------------------------------------------
# phase 6: the training loss and its gradients, card against CPU
# ---------------------------------------------------------------------------

def _train_batch(rng, cfg, B, caption_len, hiddens_layers=None):
    """A numpy captioner batch at the flagship's widths: captions of
    caption_len ids (<s> ... </s> pads), an image grid, faces and objects
    with absent (NaN) rows, and either precomputed article hiddens
    [B, 512, L, 1024] with a padded article mask or nothing (the trainer's
    shards carry context_ids instead)."""
    dcfg = cfg.decoder
    spec = {c.name: (c.max_len, c.kv_dim) for c in dcfg.contexts}
    cap = rng.integers(3, dcfg.vocab_size, size=(B, caption_len))
    cap[:, 0] = dcfg.bos_id
    cap[-1, caption_len - 6:] = dcfg.pad_id
    cap[-1, caption_len - 7] = dcfg.eos_id
    faces = rng.normal(size=(B,) + spec["faces"]).astype(np.float32)
    faces[0, 2:] = np.nan
    objs = rng.normal(size=(B,) + spec["obj"]).astype(np.float32)
    objs[-1, 20:] = np.nan
    batch = {"caption_ids": cap.astype(np.int32),
             "image_grid": rng.normal(size=(B,) + spec["image"]).astype(
                 np.float32),
             "face_embeds": faces, "obj_embeds": objs}
    if hiddens_layers is not None:
        S, D = spec["article"]
        batch["article_hiddens"] = rng.normal(
            size=(B, S, hiddens_layers, D)).astype(np.float32)
        mask = np.zeros((B, S), bool)
        mask[-1, 300:] = True
        batch["article_mask"] = mask
    return batch


def _rel_l2(grads, ref):
    return [((a.cpu() - b.cpu()).norm() / b.norm().clamp_min(1e-30)).item()
            for a, b in zip(grads, ref)]


def phase_train_cpu_vs_card(seed: int, cfg, dev: str = "cuda") -> dict:
    """captioner_loss and its gradients (deterministic, fp32) from the same
    weights and batch three times: on `dev` (the card) through kernel C,
    on `dev` with kernel C's plain version in its place (which isolates the
    kernel and its Function), and on the CPU (plain versions)."""
    from tell_tpu_torch.bridge import (init_captioner, to_torch, tree_leaves,
                                       tree_map)
    from tell_tpu_torch.models.captioner import captioner_loss
    from tell_tpu_torch.ops import dynamic_conv as port_dc
    from tell_tpu_torch.ops.kernels.dynamic_conv import (
        dynamic_conv_plain, fused_dynamic_conv)
    torch.set_num_threads(os.cpu_count() or 1)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    card_params = init_captioner(g, cfg)
    batch = _train_batch(np.random.default_rng(seed + 1), cfg, 2, 32,
                         hiddens_layers=cfg.num_bert_layers)
    out = {}
    for label, where in (("card", dev), ("card, plain conv", dev),
                         ("cpu", "cpu")):
        params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          to_torch(card_params, where))
        tb = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        launches = fused_dynamic_conv.launches
        if label == "card, plain conv":
            port_dc.fused_dynamic_conv = dynamic_conv_plain
        t = time.perf_counter()
        try:
            loss, aux = captioner_loss(params, cfg, tb)
            loss.backward()
        finally:
            port_dc.fused_dynamic_conv = fused_dynamic_conv
        grads = [p.grad for p in tree_leaves(params)]
        require(all(x is not None for x in grads), "a leaf got no gradient")
        if label == "card" and where == "cuda":
            torch.cuda.synchronize()
            require(fused_dynamic_conv.launches
                    == launches + cfg.decoder.num_layers,
                    "kernel C did not run every layer of the card's loss")
        out[label] = (loss.item(), grads)
        log(f"phase 6: captioner_loss + backward, {label} ({where}), in "
            f"{time.perf_counter() - t:.2f} s: loss {loss.item():.6f} bits "
            f"over {int(aux['sample_size'])} tokens")
    (l_card, g_card), (l_plain, g_plain), (l_cpu, g_cpu) = out.values()
    kernel_rel = _rel_l2(g_card, g_plain)
    cpu_rel = _rel_l2(g_card, g_cpu)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"phase 6: {len(cpu_rel)} gradient leaves. Kernel C vs its plain "
        f"version on the card: loss {l_card:.7f} vs {l_plain:.7f}, largest "
        f"relative L2 error {max(kernel_rel):.3e} (limit "
        f"{CONV_GRAD_REL_L2}). Card vs CPU: loss relative difference "
        f"{loss_rel:.3e} (limit {TRAIN_LOSS_RTOL}), largest relative L2 "
        f"error {max(cpu_rel):.3e} (leaf {int(np.argmax(cpu_rel))}, limit "
        f"{TRAIN_GRAD_REL_L2}), median {float(np.median(cpu_rel)):.3e} "
        f"(limit {TRAIN_GRAD_MEDIAN_REL_L2})")
    require(math.isfinite(l_card) and loss_rel <= TRAIN_LOSS_RTOL,
            f"training loss card {l_card} vs CPU {l_cpu}")
    require(max(kernel_rel) <= CONV_GRAD_REL_L2,
            f"kernel C moved a gradient leaf by {max(kernel_rel)}")
    require(max(cpu_rel) <= TRAIN_GRAD_REL_L2
            and float(np.median(cpu_rel)) <= TRAIN_GRAD_MEDIAN_REL_L2,
            f"card vs CPU gradients: {max(cpu_rel)} / median "
            f"{float(np.median(cpu_rel))}")
    return {"loss_rel": loss_rel, "grad_rel_l2": max(cpu_rel),
            "kernel_grad_rel_l2": max(kernel_rel)}


# ---------------------------------------------------------------------------
# phase 7: the trainer on the card
# ---------------------------------------------------------------------------

def _write_shards(rng, cfg, vocab, directory, n_train=48, n_valid=16):
    """Synthetic examples for the (512, 32) bucket: 512 context ids, a
    caption of 17-32 ids, an image grid (49 x 2048 at the flagship), and
    0-4 faces x 512 and 0-64 objects x 2048 (the rest absent)."""
    from tell_tpu_torch.data.records import write_shard
    dcfg = cfg.decoder
    spec = {c.name: (c.max_len, c.kv_dim) for c in dcfg.contexts}

    def rows(name):
        n, dim = spec[name]
        return rng.normal(size=(int(rng.integers(0, n + 1)), dim)).astype(
            np.float32)

    def example():
        # caption ids Zipf-distributed like text, so most land in the
        # adaptive softmax's head band and the tails stay within capacity
        words = np.minimum(rng.zipf(1.5, int(rng.integers(15, 31))) + 2,
                           dcfg.vocab_size - 1)
        return {
            "context_ids": np.concatenate(
                [[0], rng.integers(3, vocab, 510), [2]]).astype(np.int32),
            "caption_ids": np.concatenate(
                [[dcfg.bos_id], words, [dcfg.eos_id]]).astype(np.int32),
            "image_grid": rng.normal(size=spec["image"]).astype(np.float32),
            "face_embeds": rows("faces"), "obj_embeds": rows("obj")}

    write_shard(os.path.join(directory, "train-00000.npz"),
                [example() for _ in range(n_train)])
    write_shard(os.path.join(directory, "valid-00000.npz"),
                [example() for _ in range(n_valid)])


def phase_trainer(seed: int, cfg, rcfg, card: str, dev: str = "cuda"
                  ) -> dict:
    from tell_tpu_torch.bridge import init_roberta, tree_leaves
    from tell_tpu_torch.data.bucketing import BucketingConfig
    from tell_tpu_torch.ops.kernels.dynamic_conv import fused_dynamic_conv
    from tell_tpu_torch.ops.kernels.encoder_attention import (
        encoder_attention)
    from tell_tpu_torch.training.trainer import (TrainerConfig, make_trainer,
                                                 train_from_shards)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t = time.perf_counter()
        _write_shards(np.random.default_rng(seed + 2), cfg, rcfg.vocab_size,
                      tmp)
        g = torch.Generator(device=dev).manual_seed(seed + 2)
        frozen = {"roberta": init_roberta(g, rcfg), "roberta_cfg": rcfg}
        faces, objs = cfg.decoder.context("faces"), cfg.decoder.context("obj")
        bcfg = BucketingConfig(max_faces=faces.max_len, face_dim=faces.kv_dim,
                               max_objects=objs.max_len,
                               object_dim=objs.kv_dim)
        log(f"phase 7: 48 + 16 examples written and RoBERTa "
            f"{rcfg.num_layers}x{rcfg.dim} initialised in "
            f"{time.perf_counter() - t:.1f} s")

        def tcfg(num_epochs):
            return TrainerConfig(serialization_dir=os.path.join(tmp, "run"),
                                 num_epochs=num_epochs, checkpoint_every=2,
                                 keep_checkpoints=2, t_total=100,
                                 seed=seed, log_every=1000)

        on_card = dev == "cuda"
        encoder_attention.launches = 0
        fused_dynamic_conv.launches = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        result = train_from_shards(cfg, tcfg(2), bcfg, tmp, frozen,
                                   device=dev)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        launches = {"encoder_attention": encoder_attention.launches,
                    "fused_dynamic_conv": fused_dynamic_conv.launches}
        with open(os.path.join(tmp, "run", "metrics.jsonl")) as f:
            hist = [json.loads(line) for line in f]
        require(len(hist) == 2 and all(h["batches"] == 3 for h in hist),
                f"expected 2 epochs of 3 batches: {hist}")
        for h in hist:
            require(math.isfinite(h["loss"]) and math.isfinite(h["val_loss"])
                    and h["skipped"] == 0, f"non-finite epoch: {h}")
        ckpts = sorted(os.listdir(os.path.join(tmp, "run", "checkpoints")))
        require(ckpts == ["best", "ckpt-1"], f"checkpoints {ckpts}")
        step_ms = 1e3 * hist[1]["epoch_seconds"] / hist[1]["batches"]
        log(f"phase 7 ({card}): train_from_shards {cfg.compute_dtype}, 2 "
            f"epochs x 3 steps of 16 x 512 (32-token captions) + validation "
            f"+ checkpoint in {wall:.1f} s: {step_ms:.1f} ms per train step "
            f"(epoch 1, after the warm-up epoch), train loss "
            f"{hist[0]['loss']:.4f} -> {hist[1]['loss']:.4f}, val loss "
            f"{hist[0]['val_loss']:.4f} -> {hist[1]['val_loss']:.4f} bits; "
            f"launches {launches}; peak memory {peak / 2**30:.2f} GiB "
            f"(max_memory_allocated); result {result}")
        if on_card:
            for name, n in launches.items():
                require(n > 0, f"{name} never launched on the training path")

        # a mid-epoch stop, then a fresh Trainer recovers and goes on
        stopper = make_trainer(cfg, tcfg(3), bcfg, tmp, frozen, device=dev)
        require(stopper.recover() and stopper.state["epoch"] == 2,
                "no epoch-2 start to recover")
        inner = stopper._step_fn

        def stop_after_one(*args):
            out = inner(*args)
            stopper.request_stop()
            return out

        stopper._step_fn = stop_after_one
        res = stopper.train()
        require(res.get("preempted") is True, f"not preempted: {res}")
        resumed = make_trainer(cfg, tcfg(3), bcfg, tmp, frozen, device=dev)
        require(resumed.recover(), "nothing to recover after the stop")
        require((resumed.state["epoch"], resumed.state["batch_cursor"],
                 resumed.state["step"]) == (2, 1, stopper.state["step"]),
                f"recovered at {resumed.state}")
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(stopper.state["params"]),
            tree_leaves(resumed.state["params"])))
        require(same, "recovered params differ from the saved ones")
        seen = []
        inner_r = resumed._step_fn

        def record(params, opt, batch, gen, fz):
            seen.append(batch["caption_ids"].cpu().numpy())
            return inner_r(params, opt, batch, gen, fz)

        resumed._step_fn = record
        res = resumed.train()
        order = [b["caption_ids"] for b in resumed.train_batches(2)]
        require("preempted" not in res and len(seen) == 2
                and np.array_equal(seen[0], order[1]),
                "the resumed run did not continue at the next batch")
        last = resumed.metrics_history[-1]
        require(math.isfinite(last["loss"]) and math.isfinite(
            last["val_loss"]), f"non-finite resumed epoch: {last}")
        log(f"phase 7: request_stop after step {stopper.state['step']} "
            "(epoch 2, batch 1 of 3); a fresh Trainer recovered the params "
            "exactly and trained batches 2-3 of epoch 2 (train loss "
            f"{last['loss']:.4f}, val loss {last['val_loss']:.4f} bits)")
        return {"step_ms": step_ms, "peak_bytes": peak,
                "val_loss": hist[1]["val_loss"], "launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: the engine service at full width
# ---------------------------------------------------------------------------

def _token_log_probs(dparams, dcfg, feats, tokens) -> list[float]:
    """log p(tokens[r] | step features feats[r]) under the full adaptive
    softmax, by the plain ops: the near-tie check's measure."""
    from tell_tpu_torch.ops.adaptive import (_head_logits, _tail_logits,
                                             band_ranges)
    sm, emb, pad = dparams["adaptive_softmax"], dparams["embed"], \
        dcfg.embed_padding_idx
    ranges = band_ranges(dcfg.full_cutoffs)
    c0 = ranges[0][1]
    head = torch.log_softmax(_head_logits(sm, emb, feats, pad).float(), -1)
    out = []
    for r, tok in enumerate(int(t) for t in tokens):
        if tok < c0:
            out.append(head[r, tok].item())
            continue
        i = next(i for i, (lo, hi) in enumerate(ranges[1:]) if tok < hi)
        tail = torch.log_softmax(_tail_logits(
            sm, emb, feats[r:r + 1], i, pad).float(), -1)
        out.append((head[r, c0 + i] + tail[0, tok - ranges[i + 1][0]]
                    ).item())
    return out


def _divergence_gap(params, cfg, enc, path_a, path_b, kv_cache):
    """(t, gap): the first position where two caption paths differ, and
    the difference of the two tokens' log-probs there given their shared
    prefix, decoded teacher-forced with the same K/V numerics."""
    from tell_tpu_torch.models.captioner import build_contexts
    from tell_tpu_torch.models.decoder import decoder_step, init_decode_state
    t = int(np.flatnonzero(np.asarray(path_a) != np.asarray(path_b))[0])
    dparams, dcfg = params["decoder"], cfg.decoder
    state = init_decode_state(dparams, dcfg, build_contexts(params, cfg, enc),
                              1, kv_cache=kv_cache)
    dev = enc["article"].device
    for j in range(t):
        feats, state = decoder_step(dparams, dcfg, torch.tensor(
            [int(path_a[j])], device=dev), state)
    lp = _token_log_probs(dparams, dcfg, feats.expand(2, -1),
                          [path_a[t], path_b[t]])
    return t, abs(lp[0] - lp[1])


ENGINE_ARTICLES = (40, 512, 64, 300, 90, 128, 200, 100,
                   50, 480, 110, 256, 70, 120, 160, 80)


def phase_engine(seed: int, cfg, rcfg, dev: str = "cuda"):
    """The engine service over HTTP (see the module docstring, phase 8).
    Returns the service, the requests and the kernels' launch counts."""
    from tell_tpu_torch.bridge import init_captioner, init_roberta
    from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
    from tell_tpu_torch.models.beam import beam_search
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_q8)
    from tell_tpu_torch.ops.kernels.encoder_attention import (
        encoder_attention)
    from tell_tpu_torch.ops.kernels.topk_logits import topk_logits
    from tell_tpu_torch.serving import CaptionService, serve
    from tell_tpu_torch.serving.server import _cfg_at

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    svc = CaptionService(init_captioner(g, cfg),
                         RobertaEncoder(init_roberta(g, rcfg), rcfg), cfg,
                         dev, article_len=512, engine_slots=8, engine_beam=5,
                         engine_buckets=True, encode_batch=8,
                         kv_cache="int8", fused_topk=True)
    warm = svc.warmup()
    log(f"phase 8: engine service up in {time.perf_counter() - t0:.1f} s "
        f"(warm-up {warm['seconds']:.1f} s over widths {warm['widths']})")
    rng = np.random.default_rng(seed + 3)
    reqs = [_request(rng, cfg, n, int(rng.integers(0, 5)),
                     int(rng.integers(0, 65)), rcfg.vocab_size)
            for n in ENGINE_ARTICLES]
    httpd = serve(svc, port=0, block=False)
    port = httpd.server_address[1]
    answers, latencies = [None] * len(reqs), [None] * len(reqs)

    def post(i):
        t = time.perf_counter()
        answers[i] = _post(port, "/caption", reqs[i])
        latencies[i] = time.perf_counter() - t

    counters = (decode_attention, encoder_attention, decode_attention_q8,
                topk_logits)
    for fn in counters:
        fn.launches = 0
    before = {w: e.stats["requests"] for w, e in svc.engines.items()}
    t_serve = time.perf_counter()
    threads = []
    for burst in range(4):          # four bursts of four, staggered
        for i in range(4 * burst, 4 * burst + 4):
            threads.append(threading.Thread(target=post, args=(i,)))
            threads[-1].start()
        time.sleep(0.25)
    for t in threads:
        t.join(timeout=900)
    serve_s = time.perf_counter() - t_serve
    launches = {fn.__name__: fn.launches for fn in counters}
    require(not any(t.is_alive() for t in threads), "requests did not finish")
    status = json.loads(_get(port, "/status"))
    lat = np.asarray(latencies)
    log(f"phase 8: {len(reqs)} /caption answers in {serve_s:.3f} s: "
        f"{len(reqs) / serve_s:.3f} captions/s, latency p50 "
        f"{np.median(lat):.3f} s, max {lat.max():.3f} s; launches "
        f"{launches}")
    log(f"phase 8: /status {json.dumps(status)}")
    on_card = dev == "cuda"
    if on_card:
        require(launches["decode_attention"] == 0,
                "kernel A launched on the int8 engine path")
        for name in ("encoder_attention", "decode_attention_q8",
                     "topk_logits"):
            require(launches[name] > 0, f"{name} never launched on the "
                    "engine path")
    routed = {w: e.stats["requests"] - before[w]
              for w, e in svc.engines.items()}
    require(routed == {128: 10, 256: 3, 512: 3}, routed)

    exact, gaps = 0, []
    params = svc.model.tree()
    for i, (req, (code, body)) in enumerate(zip(reqs, answers)):
        require(code == 200 and "error" not in body, (i, code, body))
        batch, errors = svc._pack([req], bucketed=True)
        require(errors == [None], errors)
        cfg_w = _cfg_at(cfg, batch["context_ids"].shape[1])
        with torch.inference_mode():
            enc = svc._encode_many(batch)
            ref = beam_search(params, cfg_w, enc, beam_size=5,
                              kv_cache="int8", fused_topk=True)
            ref_ids = ref["token_ids"][0, 0].cpu().numpy()
            ids = np.asarray(body["token_ids"])
            require(ids.shape == ref_ids.shape and len(body["alternatives"])
                    == 4, (ids.shape, len(body["alternatives"])))
            if np.array_equal(ids, ref_ids):
                exact += 1
                continue
            t, gap = _divergence_gap(params, cfg_w, enc, ids, ref_ids,
                                     "int8")
        score_gap = abs(body["score"] - ref["scores"][0, 0].item())
        gaps.append((i, t, gap, score_gap))
        log(f"phase 8: request {i}: engine and one-shot differ first at "
            f"token {t}: log-prob gap {gap:.3e}, final score gap "
            f"{score_gap:.3e}")
        require(gap < NEAR_TIE, f"request {i}: engine vs one-shot differ "
                f"at token {t} by a log-prob gap {gap:.3e} >= {NEAR_TIE}")
    log(f"phase 8: engine vs one-shot beam_search: {exact}/{len(reqs)} "
        f"best beams equal, {len(gaps)} near ties")

    status_code, _ = _post(port, "/shutdown", {})
    require(status_code == 200, f"/shutdown answered {status_code}")
    httpd.server_close()

    # int4: one beam_search at B=8 on the packed cache
    batch, _ = svc._pack(reqs[:8])
    n0, n4 = decode_attention_q8.launches, decode_attention_q8.int4_launches
    with torch.inference_mode():
        t = time.perf_counter()
        enc = svc._encode_many(batch)
        out = svc.model.beam_search(enc, beam_size=5, kv_cache="int4",
                                    fused_topk=True)
        ok = bool(torch.isfinite(out["scores"]).all())
        beam_s = time.perf_counter() - t
    int4 = decode_attention_q8.int4_launches - n4
    log(f"phase 8: int4 beam_search beam=5 B=8 in {beam_s:.3f} s "
        f"({8 / beam_s:.3f} captions/s, encode included); kernel D int4 "
        f"launches {int4} of {decode_attention_q8.launches - n0}")
    require(ok, "non-finite int4 beam scores")
    if on_card:
        require(int4 > 0 and int4 == decode_attention_q8.launches - n0,
                "the int4 beam search did not run kernel D on a packed "
                "cache")
    return svc, reqs, launches


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        require(resp.status == 200, f"GET {path}: {resp.status}")
        return resp.read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# phase 9: the numerics gate
# ---------------------------------------------------------------------------

def phase_numerics(svc, reqs) -> dict:
    report = svc.numerics_ab(reqs[:4])
    log(f"phase 9: teacher-forced top-1 agreement with the fp path over "
        f"{report['tokens']} tokens: int8 K/V "
        f"{report['kv8_token_agreement']:.4f} (floor {KV8_FLOOR}), fused "
        f"top-k {report['fused_topk_token_agreement']:.4f} (floor "
        f"{FUSED_TOPK_FLOOR:.4f}), int4 K/V "
        f"{report['kv4_token_agreement']:.4f} (no floor); "
        f"{report['seconds']:.1f} s")
    require(report["kv8_token_agreement"] >= KV8_FLOOR, report)
    require(report["fused_topk_token_agreement"] >= FUSED_TOPK_FLOOR, report)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # phase 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1: torch {torch.__version__} CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    # phase 2
    from tell_tpu_torch.ops.kernels import build
    t = time.perf_counter()
    build.load_library()
    log(f"phase 2: built and loaded {build.library_path().name} in "
        f"{time.perf_counter() - t:.2f} s")
    report = build.library_path().with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("phase 2: ptxas: " + line.strip())

    # phase 3
    res = phase_kernels(args.seed)
    # phase 4
    from tell_tpu_torch.config import CaptionerConfig
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    svc, req0, caption0, launches = phase_service(
        args.seed, CaptionerConfig(), RobertaConfig.large(), "cuda")
    # phase 5
    phase_cpu_vs_card(svc, req0, caption0)
    del svc
    torch.cuda.empty_cache()
    # phase 6
    phase_train_cpu_vs_card(args.seed, CaptionerConfig())
    # phase 7
    trained = phase_trainer(args.seed, CaptionerConfig(
        compute_dtype="bfloat16"), RobertaConfig.large(), smi)
    launches["fused_dynamic_conv"] = trained["launches"][
        "fused_dynamic_conv"]
    torch.cuda.empty_cache()
    # phase 8
    svc, reqs, eng_launches = phase_engine(
        args.seed, CaptionerConfig(), RobertaConfig.large())
    for name in ("decode_attention_q8", "topk_logits"):
        launches[name] = eng_launches[name]
    # phase 9
    phase_numerics(svc, reqs)

    # MG=20/S=512, B=4 S=512, K=31 at T=32, int8 S=637, N=40 V=30265 k=5
    main_case = {"decode_attention": 1, "encoder_attention": 1,
                 "fused_dynamic_conv": 3, "decode_attention_q8": 0,
                 "topk_logits": 2}
    sources = {
        "decode_attention": ("tell_tpu_torch/csrc/decode_attention.cu",
                             "tell_tpu/ops/kernels/decode_attention.py:216"),
        "encoder_attention": ("tell_tpu_torch/csrc/encoder_attention.cu",
                              "tell_tpu/models/backbones/roberta.py:219"),
        "fused_dynamic_conv": ("tell_tpu_torch/csrc/dynamic_conv.cu",
                               "tell_tpu/ops/kernels/dynamic_conv.py:83"),
        "decode_attention_q8": (
            "tell_tpu_torch/csrc/decode_attention.cu",
            "tell_tpu/ops/kernels/decode_attention.py:399"),
        "topk_logits": ("tell_tpu_torch/csrc/topk_logits.cu",
                        "tell_tpu/ops/kernels/topk_logits.py:126"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        case = res[name][main_case[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["err32"] for c in res[name]),
            "ms": case["ms"], "plain_ms": case["plain_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
