"""Drive tell_tpu_torch's serving and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):
  1. device and setup: needs CUDA; prints the card's name and power limit;
     TF32 off for matmuls and cuDNN (fp32 means fp32).
  2. build: compiles the hand-written kernels of tell_tpu_torch/csrc/ with
     nvcc for sm_90a, and the host library of native/*.cpp (the C++ BPE,
     shard reader and batch gather) with g++.
  3. kernel vs plain on the card: kernel B (encoder attention; H=16,
     hd=64, S=128 and 512 at B=4 with 3/4, 1/3 and 1 key of S real, and
     at S=512 B=1 (the engine's single-request encode) and B=32 (phase
     10's 8 articles x 4 windows, one window all pads)): fp32 and bf16
     against its plain version, the 100-repeat probe, every batch row
     launched alone equal to its row bit for bit in both dtypes, the kept
     key tiles, and in both dtypes the CUDA-event and torch.profiler
     device times beside scaled_dot_product_attention in the same dtype
     and beside the bound at the tensor-core rate the kernel uses (fp32:
     3xTF32, 3 x the operations over 495 TFLOP/s; bf16: the operations
     over 989 TFLOP/s; or the bytes over 3.35 TB/s where that is longer);
     kernel A (decode attention; B=8, MG=4 and 20, S=637 and 2173, and
     the siblings' MG = 1/5 at S=514, 2/10 at S=565 and 3/15 at S=571,
     from a generator of their own) at the
     serving path's shapes, kernel C (fused
     dynamic conv) at the training path's (B=16, C=1024, H=16, T=32 with
     K=3/7/15/31, T=100 and T=15 with K=31), kernel D (decode attention over
     the int8/int4 K/V cache; B=8, MG=20, S=637 and 2173, and the 128-slot
     engine's B=128, MG=20, S=637 int8 with 167 MB of K/V, and the
     siblings' beam 5 int8: MG=5 at S=514 and MG=15 at S=571) and kernel E
     (streamed top-k; N=40 and 640, D=1024, V=5000/15000/30265, k=5, and
     k=8 once, and phase 13's top-k sampling, N=2 at k=4 over the three
     bands) at the engine's, fp32 and bf16, against their plain PyTorch
     versions, kernel C's gradient through its autograd Function too;
     kernel F (single-shot decode attention; B=8, MG=20, S=637 and 2173,
     and its int4-split form) against the same plain versions as A and D,
     its outputs at bb = 2 and 4 and a batch row at B=1 equal bit for bit
     to bb = 1 (q, and K/V for the fp form, in fp32 and bf16), the device
     time of its launches at each bb beside SDPA's (torch.profiler), and
     S=4096 in both forms against the plain versions; kernels A, B, D, E
     and F also 100
     times on the same input, bit for bit (a race would vary); kernel E's
     ids held by the logit at each id; kernels A and D at B=1 on one batch
     row equal bit for bit to that row of the batch, q in fp32 and bf16
     (their chunking is set by S alone; D int8 and int4), with the chunk
     count, the device time of the two kernels (torch.profiler), for A its
     share of the byte bound and the wrapper's host floor; kernel E's rows
     launched as N=40 and N=5 equal bit for bit to their rows of the N=640
     launch, fp32 and bf16, and the device time of its pass 1 and merge
     (torch.profiler) in both dtypes; CUDA-event times of both, C forward
     (fp32, bf16; and its device time) and forward+backward, C's bound at
     the tensor-core rate of its route (fp32: 3xTF32; bf16) plus the K-tap
     sum on the CUDA cores, the CUDA-core bound logged beside it. Beside
     each fp32 case of A, D, E and F: its bound
     (the larger of the bytes it must move over 3.35 TB/s and its
     operations over the 67 TFLOP/s fp32 peak, and which one bounds it;
     for E the operations at the tensor-core rate its route uses, 3xTF32
     over 495 TFLOP/s in fp32 and 989 TFLOP/s in bf16, the CUDA-core
     bound logged beside it) and, where one PyTorch call computes the
     same function, that call's time (A, B, F: scaled_dot_product_attention
     on pre-transposed copies; a yardstick only, the port never calls
     it).
  4. full-width service: CaptionerConfig() + RobertaConfig.large() with
     random weights from the seed, served over HTTP on a local port (the
     service built without article_len takes 512 from the article
     context); four /caption requests with token ids and features, then
     one beam search (beam 5, B=8). Kernels A and B must have launched
     during this phase. Then the server's other routes: four 512-token
     articles posted one at a time and again through the port's
     CaptioningClient.parse (concurrent) must get the same token ids;
     /metrics' counters must equal /status'; GET / must answer the bytes
     of demo/index.html; POST /scrape of a file:// URL must answer 422.
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
     the same numerics on the same encoded features (the engine's own row
     of its batched encode, itself held to the request encoded alone
     within FEATURE_TOL): equal tokens, or a near tie shown where the two
     searches split (at the first step where an engine beam's prefix
     leaves the one-shot's survivors, that prefix within TIE_TOL of the
     one-shot's 5th candidate; the step and the margins are printed).
     Kernels B, D and E must launch on that run and kernel A must not;
     then one int4 beam_search at B=8 must launch kernel D on the packed
     cache. Prints captions/s, the p50/max request latency, /status and
     the rows of each encode and admission.
  9. the numerics gate at full width: teacher-forced top-1 agreement with
     the fp path (fp cache, exact top-k) over four requests' greedy
     captions, for each lever (CaptionService.numerics_ab): int8 K/V >=
     0.95 (tell_tpu's floor), fused top-k >= 15/16 (it is exact), int4 K/V
     reported without a floor, and the tanh-GELU encode's
     (fast_gelu_token_agreement) beside tell_tpu's floor of 0.95, reported
     only. Defaults stay fp, exact and erf.
 10. the long-article configuration (expt/nytimes/11_long_article.yaml:
     the flagship with a 2048-token article, served in fp32) with
     RobertaConfig.large(): phases 4 and 5 again, the service built
     without article_len so it must take 2048, with four 1500-2048-token
     articles; kernel A must attend a source of >= 2048 columns and kernel
     B must encode four 512-token windows per article row; card vs CPU
     >= 15/16. Then the engine service (8 slots, beam 5, buckets
     512/1024/2048, fp cache, exact top-k): 8 requests over the three
     buckets, each held to a one-shot beam_search as in phase 8, with no
     near tie allowed: every answer equal; kernels A and B must launch, D
     and E must not.
 11. the measurement tools on the card (tell_tpu_torch/tools):
     kernel_variants with every variant at its defaults (B=64, S=640,
     bf16), longctx_variants' single1, dispatch and jnp at S=2048, and
     profile_decode at its defaults (B=320, K=1, S=512, bf16, 100 steps
     per ablation); every variant within its error limit, and kernel F
     (both forms), A and D launched.
 12. text in, scored captions out, through `python -m
     tell_tpu_torch.commands` at full width: expt/quality/overfit_flagship
     .yaml (transformer_faces_objects, RoBERTa-large, bf16 training, 512
     article tokens) with an override that puts the run, the shards and
     the features in a temporary directory and num_epochs at 2: the
     features by the port's write_features, preprocess (train and valid,
     32 examples each; through the C++ BPE, and every example equal bit
     for bit to a second preprocess through the Python ByteBPE; the BPE's
     tokens/s on the corpus, C++ against Python), train (2 epochs of 2
     steps of 16 x 512 plus validation, read and packed in C++; kernels B
     and C must launch; TensorBoard scalars every step, each train/loss
     equal to the logged loss within 1e-6, each epoch's mean to
     metrics.jsonl's loss and epoch/val_loss to its val_loss; the profiler
     over steps [0, 2), all of epoch 0 (the window closes with its epoch,
     as tell_tpu's), its chrome trace marking steps 0 and 1 and holding
     kernel B's device kernel; async checkpoints keeping one: after
     train's flush only ckpt-1 and best, each restoring, and one save of
     the flagship's train state from the card timed to save()'s return
     (async) and to its flush (sync)), the train split packed
     five times by the C++ gather and by numpy (equal batches, host ms per
     batch), evaluate -s train --beam 5 (kernels A and B must launch, D
     and E must not) and score, then one epoch warm-started from the
     first run's checkpoints/best (its params equal to the checkpoint's
     bit for bit before its first step). 32 samples, every metric finite,
     tell_tpu's generation fields, score equal to evaluate's metrics; one
     line with the seconds of each step, ms per train step (epoch 1,
     outside the profiler window; epoch 0's and the warm-started epoch's
     beside it), evaluate
     captions/s, the metrics and the launch counts, and one with the host
     side's readings. Then the checkpoint on the CPU and on the card,
     teacher-forced along two of the card's greedy captions: >= 15/16
     agreement each.
 13. the flagship's siblings at full width (RobertaConfig.large(), one
     tower shared): expts 4 (no image, M=1), 5 (flattened, M=2), 8 (faces,
     M=3) and 13 (learned positions, M=4) of NYTimes, each with random
     weights from the seed in a micro-batch CaptionService over HTTP: four
     /caption requests, one of them scraped sections whose packed ids must
     equal assemble_location_aware's window; a one-shot beam 5 at B=8;
     kernels A (at MG = M greedy and 5M beam) and B must launch; card
     against CPU teacher-forced along two captions >= 15/16 each. Expt 8
     also through the int8 engine (2 slots, beam 5): kernel D at MG=15,
     kernel A not at all. Then on the flagship: need_attention in
     micro-batch and engine mode (every answer's maps sum to 1 and carry
     their word merge; the engine's replay of each micro-batch caption
     within 1e-5 of its maps), and sampling_topk=4 with one generator seed
     twice on each route (the same tokens, each within its step's exact
     top-4 on both routes; kernel E at k=4 on the fused route, none on the
     exact one; along the fused route's tokens its top-4 log-probs within
     TOPK_TOL of the exact route's and of the full log-probs at its ids).
     Prints each configuration's readings and the phase's seconds.
 14. images in: every JPEG and PNG of tests/fixtures/images through the
     port's decoders (built with g++ here) and its resize and crop, each
     RGB and 224-crop sha256 equal to the one Pillow gave (manifest.json),
     each refused form refused with its name and ROADMAP queue 1 item 8,
     each corrupt file refused as corrupt, and
     the host ms of decode and crop per news photo; ResNet-152 at full
     width from init_resnet (seeded, each bottleneck's last batch-norm
     scale at RESIDUAL_BN) on the two news photos' crops, card against
     CPU (max abs and relative error, limit GRID_REL_TOL), the grid with
     cudnn.allow_tf32 on bit equal to the one with it off, the tower with
     its fp32 pin taken out under TF32 further than GRID_REL_TOL from the
     CPU (the control that shows the limit can tell them apart), ms per
     image at B=1 and B=16 (CUDA events, 3 warm-ups) in the tower's NCHW
     layout and in a channels-last copy, and the peak memory at B=16; the
     flagship micro-batch service
     with the tower (RoBERTa-large, the quality corpus's tokenizer): an
     image_b64 request with article text and the same text with the
     photo's image_grid (computed outside the service: decode, crop,
     image_grid) pack the same ids and grid and answer the same
     ids over HTTP, and so do a scraped sections request with the photo
     in sections[image_position].image_data and its window's text with
     the grid; a micro-batch of six with a bad base64 and a refused
     (under-refined) progressive JPEG answers the four others and reports the two (kernels A and B
     counted and required); the engine (4 slots, beam 5) on the same
     weights: the photo and grid requests answer the same beams, each
     equal to a one-shot beam 5 on the features it was given or a near
     tie (phase 8's rule); then convert_towers --resnet on a
     torchvision-named state dict of the tower and preprocess --device
     cuda over an images_dir holding one photo as a <hash>.jpg: every
     example's image_grid equals that photo's grid in fp16.
 15. faces and objects from a photo: random full-width MTCNN (its face
     logits' biases raised by FACE_BIAS), FaceNet InceptionResnetV1
     (repeats 5/10/5) and YOLOv3-SPP (80 classes; batch norm scaled by
     YOLO_BN, the objectness biases raised by OBJ_BIAS) from the seed on
     the CPU, and phase 14's ResNet-152; the two news photos letterboxed
     onto the 416 canvas; on the card against the CPU: every face MTCNN
     finds and every detection YOLO's NMS keeps, the same counts and each
     box within BOX_TOL_PX of one of the other's (a reordering is
     logged), the FaceNet rows of the four largest faces and the pooled
     ResNet rows of the first CPU_OBJECT_ROWS detections on the card's
     boxes within FEATURE_REL_TOL, and the served stages' rows equal to
     those; the same rows with every fp32 pin taken out under TF32 must
     miss that limit (the control); ms per photo of the letterbox, each
     stage and the whole process() (CUDA events around calls that end on
     the host, 2 warm-ups), the share of the NMS in each stage and each
     stage's peak memory; the flagship service with all four towers:
     phase 14's checks with the photo's image_grid, face_embeds and
     obj_embeds sent precomputed, computed outside the service's
     pipeline (the grid as in phase 14; the faces and objects from
     detect_faces' and nms_fixed's boxes on the letterbox canvas,
     embedded by FaceNet and the pooled ResNet; micro-batch and engine,
     kernels A and B counted and required); then convert_towers
     --facenet, --mtcnn and --yolo-cfg/--yolo-weights on facenet-pytorch
     and darknet files (tests/tower_writers.py) from the same towers, and
     the loader serve uses reads back the converter's trees bit for bit.
 16. what tell_tpu users hold: (a) every fixture added for the other
     photo forms (progressive JPEGs, 4:1:1, 4:4:0, CMYK, YCCK, RGB-coded,
     PNGs of every colour type and depth, Adam7, filters) decoded on the
     card's host to its manifest sha256, RGB and 224 crop, the news
     photos' twins equal to their baseline files where the manifest says
     so, each refusal naming its form; (b) ms per photo of the host
     decode of each news photo's baseline, progressive and PNG files
     (median of 3 calls); (c) the flagship at full width (RoBERTa-large,
     phase 15's four random towers) served over HTTP in micro-batch mode
     and in the engine (4 slots, beam 5): the progressive and PNG twins
     of the news photos as image_b64, each answering the baseline photo's
     tokens where it decodes to the baseline's bytes and otherwise the
     tokens of its features computed by _photo_features' own route
     (kernels A and B counted and required); (d) `python -m
     tell_tpu_torch.commands towers verify --json` over the five towers
     (phase 15's trees and a seeded RoBERTa-large, saved as
     convert_towers saves them) on the card: five CONVERTED rows with
     tell_tpu's output shapes and the ViT row naming ROADMAP item 8, cut
     4; each probe's outputs on the card within FEATURE_REL_TOL of the
     same probe on the CPU, and kernel B launched by the RoBERTa probe.
Then one JSON line describing the kernels and, last, the result line.

    python3 chip_smoke.py --cli

runs phases 1-2, then phase 12 only; no result line.

    python3 chip_smoke.py --quality [--quality-out DIR]

runs phases 1-2, then tell_tpu_torch.tools.quality_loop on
expt/quality/overfit_flagship.yaml as it stands (200 epochs of 2 steps,
trainer seed 0; run, shards and features in a temporary directory):
preprocess, "before" after one epoch (greedy, then beam 5), train, "after"
greedy and beam 5, the re-score, the gazetteer entity P/R, and the kv8 and
fused top-k A/Bs against the beam decode. It prints one line of readings
and fails unless before CIDEr <= 5, after beam CIDEr >= 900 with >= 30 of
32 captions exact, and kernels D and E launched in their A/Bs; DIR gets
the loop's result, phase journal and generation files. No result line.

    python3 chip_smoke.py --engine-repeats N

runs phases 1-2, then only the engine checks of phases 8 and 10, N times
over the seeds seed, seed+1, ... (the first failure ends it); it prints no
result line.

    python3 chip_smoke.py --trace-engine N

runs phases 1-2, then phase 8's engine run (no int4 beam search) at --seed
up to N times, stopping at the first answer that differs from the
one-shot search, where both searches' ranked candidates at the step they
split are logged side by side (every phase 8 and 10 run logs them for a
differing answer); no result line.

    python3 chip_smoke.py --kernels [NAME,...]

runs phases 1-3 only (every kernel against its plain version, with its
times; with names, e.g. encoder_attention or
decode_attention_q8,topk_logits, those kernels' cases only, so that a copy
of this script can time a parent tree in the same call) and prints no
result line.

    python3 chip_smoke.py --siblings

runs phases 1-2, then phase 13 only; no result line.

    python3 chip_smoke.py --images

runs phases 1-2, then phase 14 only; no result line.

    python3 chip_smoke.py --faces-objects

runs phases 1-2, then phase 15 only; no result line.

    python3 chip_smoke.py --forms

runs phases 1-2, then phase 16 only; no result line.

    python3 chip_smoke.py --beam N

runs phases 1-2, then phase 10's one-shot beam search (the long-article
configuration, beam 5, B=8, fp32) N + 1 times on one set of weights,
printing the encode and beam-search wall time of each (the first is a
warm-up); no result line. It uses only what earlier trees of the port also
have, so a copy of it can time a parent tree in the same call.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import http.client
import importlib.util
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

from tell_tpu_torch.tools.timing import (BF16_FLOPS, FP32_FLOPS,
                                        HBM_BYTES_PER_S, TF32_FLOPS,
                                        device_ms)

FP32_TOL = dict(atol=1e-5, rtol=1e-4)
CONV_TOL = dict(atol=2e-5, rtol=2e-5)        # the JAX kernel test's
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 2e-2
TOPK_TOL = dict(atol=1e-5, rtol=1e-5)        # fp32 sums in another order
# Phases 8 and 10: the features the engine was given (its batched encode's
# row for a request) against the request encoded alone: within 1.2e-5 over
# 15 runs on an H100 (another encode batch sums in another order); a wrong
# row is off by O(1).
FEATURE_TOL = dict(atol=1e-4, rtol=1e-4)
# Phase 8: on those same features the engine decodes 40 rows a step (8
# slots x 5 beams) and the one-shot search 5, so their sums still differ in
# the last bits: an equal beam's final score differed by up to 3.5e-3 over
# 8 runs on an H100 (int8 cache, fused top-k; 1.2e-4 with the fp cache).
# A differing answer passes only where that drift explains it: at the
# first step where an engine beam's prefix leaves the one-shot's
# survivors, that prefix lies within TIE_TOL (twice the drift, rounded up)
# of the one-shot's 5th candidate. Phase 10 allows no differing answer.
TIE_TOL = 1e-2
REPEATS = 100       # phase 3: bit-for-bit repeats of kernels A, B, D, E and F
KV8_FLOOR = 0.95    # phase 9: tell_tpu's gate (BENCH_r05.json)
FAST_GELU_FLOOR = 0.95   # phase 9, reported only: tell_tpu's (bench.py:633)
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
# the siblings' sources (expts 4, 5 and 8): S = 514, 565 and 571
SIBLING_SEGMENTS = {1: FLAGSHIP_SEGMENTS[1:2], 2: FLAGSHIP_SEGMENTS[:2],
                    3: FLAGSHIP_SEGMENTS[:3]}
# phase 3's sibling cases of kernel A: (M, MG) greedy and beam 5 for each
# sibling, MG = M x G; and of kernel D (int8) at beam 5 over the no-image
# and the faces source
SIBLING_A_CASES = ((1, 1), (1, 5), (2, 2), (2, 10), (3, 3), (3, 15))
SIBLING_D_CASES = ((1, 5), (3, 15))
# phase 13's top-k sampling: two requests, k=4 (kernel E's N and k there)
SAMPLING_ROWS, SAMPLING_K = 2, 4
LONG_ARTICLE = 2048     # expt/nytimes/11_long_article.yaml


class CheckFailed(Exception):
    """A phase's check failed (raised, not asserted: python -O keeps it)."""


def require(cond, what) -> None:
    if not cond:
        raise CheckFailed(str(what))


def log(msg: str) -> None:
    print(msg, flush=True)


# mean ms per call from CUDA events around 20 calls after 3 warm-ups
cuda_ms = functools.partial(device_ms, device="cuda", calls=20)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: int, flops: float, peak: float = FP32_FLOPS
          ) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for a call
    that must read its inputs and write its outputs once (nbytes) and do
    flops operations at `peak` per second (fp32 CUDA cores by default),
    whichever of the two takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_flops(q, S) -> float:
    """q . K and p . V over S columns: 2 x 2 x B*H*MG*hd*S operations."""
    return 4.0 * q.numel() * S


def _sdpa_decode_sets(sets):
    """Kernel A/F inputs as one scaled_dot_product_attention call takes
    them: K and V transposed to [B, H, S, hd] and the bias broadcast over
    heads. The copies are made here, outside any timed window."""
    return [[q, k.transpose(2, 3).contiguous(), v.transpose(2, 3).contiguous(),
             bias[:, None]] for q, k, v, bias in sets]


def _sdpa_decode(q, kt, vt, mask):
    return torch.nn.functional.scaled_dot_product_attention(
        q, kt, vt, attn_mask=mask, scale=1.0)


def _sdpa_encoder_sets(sets):
    """Kernel B inputs [B, S, H, hd] as [B, H, S, hd] copies with the
    einsum path's additive -1e9 key-padding mask."""
    out = []
    for q, k, v, key_pad in sets:
        neg = torch.zeros(key_pad.shape, device=key_pad.device,
                          dtype=q.dtype)
        neg.masked_fill_(key_pad, -1e9)
        out.append([t.transpose(1, 2).contiguous() for t in (q, k, v)]
                   + [neg[:, None, None, :]])
    return out


def _sdpa_encoder(q, k, v, mask):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _decode_case(g, B, MG, article_len, dev, copies=4,
                 segments=FLAGSHIP_SEGMENTS):
    """Kernel A inputs at the decoder's layout: the modalities' rows
    (+ bias and zero columns each) on the source axis, a real segment bias
    with padded articles and absent faces/objects. Four copies (one per
    decoder layer) so a timed loop streams K/V from device memory rather
    than L2, as the decode step does (two where one copy exceeds L2).
    segments: the configuration's (name, rows) contexts (the flagship's
    four by default; a sibling's one to three), M of them, MG a multiple
    of M (G = MG / M query rows a modality)."""
    from tell_tpu_torch.ops.kernels.decode_attention import segment_bias
    H, hd, M = 16, 64, len(segments)
    lens = [n if name != "article" else article_len
            for name, n in segments]
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
    for _ in range(copies):
        q = torch.randn(B, H, MG, hd, generator=g) * hd ** -0.5
        k = torch.randn(B, H, hd, S, generator=g)
        v = torch.randn(B, H, hd, S, generator=g)
        sets.append([t.to(dev) for t in (q, k, v)] + [bias])
    return S, sets


def _encoder_case(g, lens, S, dev):
    """Kernel B inputs: one sequence per entry of lens (its real keys, the
    rest pads; 0 = an all-pad row), H=16, hd=64."""
    H, hd = 16, 64
    B = len(lens)
    q, k, v = (torch.randn(B, S, H, hd, generator=g).to(dev)
               for _ in range(3))
    key_pad = torch.arange(S)[None, :] >= torch.tensor(lens)[:, None]
    return [[q, k, v, key_pad.to(dev)], [k, v, q, key_pad.to(dev)]]


# Kernel B's phase-3 cases: (name, real keys per sequence) at S=512 (and
# the first at 128 too). B=4 is phase 4's micro-batch, B=1 the engine's
# single-request encode, B=32 phase 10's 8 articles x 4 windows of 512
# (the 1500-token article's fourth window is all pads).
ENCODER_CASES = (
    ("B=4", lambda S: [S, (3 * S) // 4, S // 3, 1]),
    ("B=1", lambda S: [S]),
    ("B=32", lambda S: [min(max(n - 512 * w, 0), S)
                        for n in LONG_BEAM_ARTICLES for w in range(4)]))


def check_repeats(name, kernel, sets, shape, n=REPEATS):
    """n launches on sets[0], each after one on sets[1] (so shared memory
    and the L2 hold other data in between), must all equal the first
    output (every output of a kernel that returns several) bit for bit: a
    race between a block's phases shows as an output that changes from
    launch to launch."""
    def outs(o):
        return o if isinstance(o, tuple) else (o,)
    first = outs(kernel(*sets[0]))
    bad = torch.zeros((), dtype=torch.long, device=first[0].device)
    for _ in range(n):
        kernel(*sets[1])
        for a, b in zip(outs(kernel(*sets[0])), first):
            bad += (a != b).sum()
    require(bad.item() == 0, f"{name} {shape}: {bad.item()} outputs changed "
            f"over {n} launches on the same inputs")


def library_time(library, ref) -> tuple[float | None, float | None]:
    """(ms per call, max abs error against the plain version's output) of
    the one PyTorch call that computes a kernel's function: library is
    (call, its argument sets, a map of its output to the kernel's layout),
    or None where no single call does (then (None, None))."""
    if library is None:
        return None, None
    fn, lib_sets, back = library
    err = (back(fn(*lib_sets[0])) - ref).abs().max().item()
    cycle = itertools.cycle(lib_sets)
    return cuda_ms(lambda: fn(*next(cycle))), err


def check_kernel_a(sets, S, shape, res, row=3):
    """Kernel A at B=1 on batch row `row` of sets[0] must equal that row of
    the B=8 launch bit for bit, in fp32 and bf16: the chunk count is set by
    S alone, so a row sums in the same order at any batch. Logs the chunk
    count, the fp32 time's share of the byte bound (res: check_kernel's
    result for these sets) and the device time of A's two kernels
    (torch.profiler), which the CUDA-event time adds the host's launch
    overhead to."""
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, split_count)
    from tell_tpu_torch.tools.timing import profiled_device_ms
    q, k, v, bias = sets[0]
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (q, k, v)]
        full = decode_attention(*args, bias)
        one = decode_attention(*(t[row:row + 1].contiguous() for t in args),
                               bias[row:row + 1].contiguous())
        n_diff = int((full[row:row + 1] != one).sum())
        require(n_diff == 0, f"decode_attention {shape} {dtype}: B=1 differs "
                f"from row {row} of B=8 in {n_diff} outputs")
    cycle = itertools.cycle(sets)
    dev_ms = profiled_device_ms(lambda: decode_attention(*next(cycle)))
    chunk = sum(t for k, t in dev_ms.items() if "chunk_kernel" in k)
    combine = sum(t for k, t in dev_ms.items() if "combine_kernel" in k)
    share = res["bound_ms"] / res["ms"]
    log(f"phase 3: decode_attention {shape}: n_split {split_count(S)}, "
        f"{share:.1%} of the byte bound ({share * HBM_BYTES_PER_S / 1e9:.0f}"
        f" GB/s); device time {chunk:.4f} ms + combine {combine:.4f} ms "
        f"({res['bound_ms'] / (chunk + combine):.1%} of the bound); batch "
        f"row {row} at B=1 equals B=8 bit for bit (fp32, bf16)")


def decode_attention_host_floor(dev) -> None:
    """ms per call of kernel A's wrapper on a tiny input with two chunks
    (checks, allocation, both launches): where the CUDA-event time of a
    call is set by the host, it cannot go below this."""
    from tell_tpu_torch.ops.kernels.decode_attention import decode_attention
    q = torch.zeros(1, 1, 4, 64, device=dev)
    kv = torch.zeros(1, 1, 64, 300, device=dev)
    bias = torch.zeros(1, 4, 300, device=dev)
    ms = cuda_ms(lambda: decode_attention(q, kv, kv, bias))
    log(f"phase 3: decode_attention host floor {ms:.4f} ms per call (B=1, "
        "H=1, MG=4, S=300: two launches on a tiny input)")


def check_kernel(name, kernel, plain, sets, shape, flops, library=None,
                 peak=FP32_FLOPS):
    """fp32: kernel vs plain on the same inputs, and bit-for-bit repeats;
    bf16: kernel on bf16 inputs vs plain in fp32 on the same bf16-rounded
    inputs. Returns the fp32 error, both times (ms per call, CUDA events),
    the bound of the fp32 call (flops operations at peak per second) and
    the library call's time (library_time)."""
    args = sets[0]
    ref = plain(*args)
    out = kernel(*args)
    torch.cuda.synchronize()
    err32 = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **FP32_TOL)
    bound_ms, bound_by = bound(_nbytes(args) + _nbytes([out]), flops, peak)
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
    library_ms, lib_err = library_time(library, ref)
    log(f"phase 3: {name} {shape}: fp32 max abs err {err32:.3e}, bf16 "
        f"max abs err {err16:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms ({bound_by}), library "
        + ("none" if library_ms is None else
           f"{library_ms:.4f} ms (max abs err {lib_err:.3e})") + " (fp32)")
    return {"shape": shape, "err32": err32, "err16": err16, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_kernel_b(g, name, lens, S, dev) -> dict:
    """Kernel B at one phase-3 case. fp32 through check_kernel (FP32_TOL,
    the 100-repeat probe, SDPA beside it), its bound at the rate of the
    kernel's fp32 route: 3xTF32, three TF32 products per fp32 product over
    495 TFLOP/s. bf16: CUDA-event time beside SDPA in bf16 and its bound
    (the operations over 989 TFLOP/s). In both dtypes: the device time of
    the kernel and of SDPA from torch.profiler, and each batch row launched
    alone at B=1 equal to its row of the batch bit for bit. Logs the kept
    key tiles (64 keys; a tile of pads only is skipped where its row has a
    real key) and each time's share of its bound."""
    from tell_tpu_torch.ops.kernels.encoder_attention import (
        encoder_attention, encoder_attention_plain)
    from tell_tpu_torch.tools.timing import profiled_device_ms
    sets = _encoder_case(g, lens, S, dev)
    q, key_pad = sets[0][0], sets[0][3]
    B, _, H, hd = q.shape
    # every query row attends its row's real keys (all S in an all-pad row)
    flops = 4.0 * S * H * hd * sum(n if n else S for n in lens)
    real = torch.nn.functional.pad(~key_pad, (0, -S % 64)).reshape(
        B, -1, 64).any(-1)
    kept = int((real | ~real.any(-1, keepdim=True)).sum())
    shape = f"{name} S={S} H={H} hd={hd}"
    res = check_kernel(
        "encoder_attention", encoder_attention, encoder_attention_plain,
        sets, shape, 3 * flops,
        (_sdpa_encoder, _sdpa_encoder_sets(sets), lambda o: o.transpose(1, 2)),
        peak=TF32_FLOPS)
    sets16 = [[t.to(torch.bfloat16) for t in x[:3]] + [x[3]] for x in sets]
    cycle = itertools.cycle(sets16)
    ms16 = cuda_ms(lambda: encoder_attention(*next(cycle)))
    plain16 = cuda_ms(lambda: encoder_attention_plain(*next(cycle)))
    lib16 = _sdpa_encoder_sets(sets16)
    cycle = itertools.cycle(lib16)
    sdpa16 = cuda_ms(lambda: _sdpa_encoder(*next(cycle)))
    bound16, by16 = bound(_nbytes(sets16[0]) + _nbytes(sets16[0][:1]), flops,
                          BF16_FLOPS)
    dev_ms, sdpa_dev = {}, {}
    for dtype, xs, lib in (("fp32", sets, _sdpa_encoder_sets(sets)),
                           ("bf16", sets16, lib16)):
        full = encoder_attention(*xs[0])
        for r in range(B):
            one = encoder_attention(*(t[r:r + 1].contiguous() for t in xs[0]))
            n_diff = int((full[r:r + 1] != one).sum())
            require(n_diff == 0, f"encoder_attention {shape} {dtype}: row {r} "
                    f"alone differs from the batch in {n_diff} outputs")
        cycle = itertools.cycle(xs)
        times = profiled_device_ms(lambda: encoder_attention(*next(cycle)))
        dev_ms[dtype] = sum(t for k, t in times.items()
                            if "encoder_attention" in k)
        cycle = itertools.cycle(lib)
        sdpa_dev[dtype] = sum(profiled_device_ms(
            lambda: _sdpa_encoder(*next(cycle))).values())
    log(f"phase 3: encoder_attention {shape}: kept tiles {kept}/{real.numel()}"
        f"; fp32 {res['ms']:.4f} ms ({res['bound_ms'] / res['ms']:.1%} of "
        f"{res['bound_ms']:.4f} ms, {res['bound_by']}), device "
        f"{dev_ms['fp32']:.4f} ms, SDPA {res['library_ms']:.4f} ms (device "
        f"{sdpa_dev['fp32']:.4f} ms); bf16 {ms16:.4f} ms ({bound16 / ms16:.1%}"
        f" of {bound16:.4f} ms, {by16}), device {dev_ms['bf16']:.4f} ms, "
        f"plain {plain16:.4f} ms, SDPA {sdpa16:.4f} ms (device "
        f"{sdpa_dev['bf16']:.4f} ms); each row "
        f"alone equals its row of B={B} bit for bit (fp32, bf16)")
    res.update(ms16=ms16, plain16=plain16, sdpa16=sdpa16, bound16=bound16,
               dev_ms=dev_ms, sdpa_dev=sdpa_dev, kept=kept)
    return res


# Kernel C's routes: the rate of its tap-logit product, and how many
# products of that rate one logit product takes
CONV_ROUTES = {"3xtf32": (TF32_FLOPS, 3), "bf16": (BF16_FLOPS, 1),
               "cuda cores": (FP32_FLOPS, 1)}


def conv_bound(tensors, B, T, K, C, H, route) -> tuple[float, str]:
    """Kernel C's bound: its bytes (x, w_km in, out) over 3.35 TB/s
    against its operations, the tap logits x . W (2*B*T*C*K*H) at the
    rate of `route` (CONV_ROUTES) plus the K-tap sum (2*B*T*C*K) on the
    fp32 CUDA cores."""
    peak, n = CONV_ROUTES[route]
    ops_ms = (2.0 * B * T * C * K * H * n / peak
              + 2.0 * B * T * C * K / FP32_FLOPS) * 1e3
    bytes_ms = _nbytes(tensors) / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def check_conv(g, B, T, K, dev, C=1024, H=16):
    """Kernel C against dynamic_conv_plain: fp32 forward (CONV_TOL), bf16
    forward on the same bf16-rounded inputs (BF16_ATOL), dx and dw through
    the autograd Function against autograd of the plain version
    (GRAD_TOL); CUDA-event times of the forward (fp32, bf16) and of
    forward+backward beside the plain version's, and the forward's device
    time from torch.profiler (fp32, bf16), each beside its bound at the
    tensor-core rate of the kernel's route (conv_bound; the CUDA-core bound
    logged beside it)."""
    from tell_tpu_torch.ops.kernels.dynamic_conv import (
        dynamic_conv_plain, fused_dynamic_conv)
    from tell_tpu_torch.tools.timing import profiled_device_ms
    shape = f"B={B} T={T} C={C} H={H} K={K}"
    x = torch.randn(B, T, C, generator=g).to(dev)
    w_bound = (6.0 / (C + K * H)) ** 0.5
    w = ((torch.rand(C, K * H, generator=g) * 2 - 1) * w_bound).to(dev)
    ref = dynamic_conv_plain(x, w, K, H)
    out = fused_dynamic_conv(x, w, K, H)
    torch.cuda.synchronize()
    err32 = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **CONV_TOL)
    x16, w16 = x.bfloat16(), w.bfloat16()
    out16 = fused_dynamic_conv(x16, w16, K, H)
    ref16 = dynamic_conv_plain(x16.float(), w16.float(), K, H)
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
    ms16 = cuda_ms(lambda: fused_dynamic_conv(x16, w16, K, H))
    plain_ms = cuda_ms(lambda: dynamic_conv_plain(x, w, K, H))
    fb_ms = cuda_ms(lambda: fwd_bwd(fused_dynamic_conv))
    plain_fb_ms = cuda_ms(lambda: fwd_bwd(dynamic_conv_plain))
    times = profiled_device_ms(lambda: fused_dynamic_conv(x, w, K, H))
    times16 = profiled_device_ms(lambda: fused_dynamic_conv(x16, w16, K, H))
    dev_ms, dev16 = sum(times.values()), sum(times16.values())
    prep, prep16 = (sum(t for k, t in ts.items() if "weight_blocks" in k)
                    for ts in (times, times16))
    bound_ms, bound_by = conv_bound([x, w, out], B, T, K, C, H, "3xtf32")
    bound16, by16 = conv_bound([x16, w16, out16], B, T, K, C, H, "bf16")
    cores_ms, _ = conv_bound([x, w, out], B, T, K, C, H, "cuda cores")
    log(f"phase 3: fused_dynamic_conv {shape}: fp32 max abs err "
        f"{err32:.3e}, bf16 max abs err {err16:.3e}, grad max abs err "
        f"{errg:.3e}; forward fp32 {ms:.4f} ms (device {dev_ms:.4f} ms, "
        f"of which the weight layout {prep:.4f} ms, "
        f"{bound_ms / dev_ms:.1%} of the 3xTF32 {bound_by} bound "
        f"{bound_ms:.4f} ms; CUDA-core bound {cores_ms:.4f} ms), bf16 "
        f"{ms16:.4f} ms (device {dev16:.4f} ms, layout {prep16:.4f} ms, "
        f"{bound16 / dev16:.1%} of "
        f"the {by16} bound {bound16:.4f} ms), plain {plain_ms:.4f} ms, "
        f"library none; forward+backward kernel {fb_ms:.4f} ms, plain "
        f"{plain_fb_ms:.4f} ms (fp32)")
    return {"shape": shape, "err32": err32, "err16": err16, "errg": errg,
            "ms": ms, "plain_ms": plain_ms, "fb_ms": fb_ms,
            "plain_fb_ms": plain_fb_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "ms16": ms16,
            "dev_ms": dev_ms, "dev_ms16": dev16, "bound16": bound16}


def check_q8(g, B, MG, article_len, dev, mode, name="decode_attention_q8",
             kernel=None, copies=4, segments=FLAGSHIP_SEGMENTS):
    """Kernel D (or `kernel`, e.g. kernel F's int4-split form) against
    decode_attention_q8_plain on _decode_case's inputs with K/V quantised
    as the decode state stores them: q fp32 (FP32_TOL, and bit-for-bit
    repeats), q bf16 (against the plain version in fp32 on the same bf16
    query, BF16_ATOL); CUDA-event times of both with q fp32, and the
    bound (no single PyTorch call computes it). Kernel D also goes through
    check_kernel_d."""
    from tell_tpu_torch.models.decoder import quantize_kv, quantize_kv4
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_q8, decode_attention_q8_plain)
    kernel = kernel or decode_attention_q8
    quant = quantize_kv4 if mode == "int4" else quantize_kv
    S, fp_sets = _decode_case(g, B, MG, article_len, dev, copies, segments)
    sets = []
    while fp_sets:   # quantise a copy at a time (B=128: 334 MB of fp32 K)
        q, k, v, bias = fp_sets.pop(0)
        sets.append([q, *quant(k), *quant(v), bias])
        del k, v
    shape = f"{mode} B={B} H=16 hd=64 MG={MG} S={S}"
    args = sets[0]
    ref = decode_attention_q8_plain(*args)
    out = kernel(*args)
    torch.cuda.synchronize()
    err32 = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **FP32_TOL)
    bound_ms, bound_by = bound(_nbytes(args) + _nbytes([out]),
                               decode_flops(args[0], S))
    del ref
    check_repeats(name, kernel, sets, shape)
    q16 = args[0].to(torch.bfloat16)
    out16 = kernel(q16, *args[1:])
    ref16 = decode_attention_q8_plain(q16.float(), *args[1:])
    torch.cuda.synchronize()
    err16 = (out16.float() - ref16).abs().max().item()
    if not np.isfinite(err16) or err16 > BF16_ATOL:
        raise CheckFailed(f"{name} {shape} bf16: max abs err {err16} > "
                          f"{BF16_ATOL}")
    cycle = itertools.cycle(sets)
    ms = cuda_ms(lambda: kernel(*next(cycle)))
    plain_ms = cuda_ms(lambda: decode_attention_q8_plain(*next(cycle)))
    log(f"phase 3: {name} {shape}: fp32 max abs err {err32:.3e}, bf16 max "
        f"abs err {err16:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}), library none (fp32 q)")
    res = {"shape": shape, "err32": err32, "err16": err16, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None}
    if name == "decode_attention_q8":
        check_kernel_d(sets, S, shape, res)
    elif name == "decode_attention_q4split":
        check_kernel_f(name, kernel, sets, S, shape, res, fp=False)
    return res


def check_kernel_d(sets, S, shape, res, row=3):
    """Kernel D at B=1 on batch row `row` of sets[0] must equal that row of
    the full batch bit for bit, with q in fp32 and in bf16: the chunk count
    is set by S alone, so a row sums in the same order at any batch. Logs
    the chunk count, the bf16-q CUDA-event time, and the device time of
    D's launches from torch.profiler (its chunk and combine kernels, by
    name; all of them for a tree whose D has other kernels) for q in fp32
    and bf16, each beside the bound (res: check_q8's result)."""
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_q8, split_count)
    from tell_tpu_torch.tools.timing import profiled_device_ms
    q, k8, ks, v8, vs, bias = sets[0]
    B = q.shape[0]
    dev_ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        qd = q.to(dtype)
        full = decode_attention_q8(qd, k8, ks, v8, vs, bias)
        one = decode_attention_q8(*(t[row:row + 1].contiguous()
                                    for t in (qd, k8, ks, v8, vs, bias)))
        n_diff = int((full[row:row + 1] != one).sum())
        require(n_diff == 0, f"decode_attention_q8 {shape} {dtype}: B=1 "
                f"differs from row {row} of B={B} in {n_diff} outputs")
        xs = [[x[0].to(dtype), *x[1:]] for x in sets]
        cycle = itertools.cycle(xs)
        times = profiled_device_ms(lambda: decode_attention_q8(*next(cycle)))
        chunk = sum(t for k, t in times.items() if "chunk_kernel" in k)
        combine = sum(t for k, t in times.items() if "combine_kernel" in k)
        dev_ms[dtype] = (chunk, combine, sum(times.values()))
    cycle = itertools.cycle([[x[0].to(torch.bfloat16), *x[1:]] for x in sets])
    ms16 = cuda_ms(lambda: decode_attention_q8(*next(cycle)))
    (c32, m32, t32), (c16, m16, t16) = (dev_ms[torch.float32],
                                        dev_ms[torch.bfloat16])
    log(f"phase 3: decode_attention_q8 {shape}: n_split {split_count(S)}; "
        f"device time, q fp32: {c32:.4f} ms + combine {m32:.4f} ms (all "
        f"kernels {t32:.4f} ms, {res['bound_ms'] / t32:.1%} of the bound), "
        f"q bf16: {c16:.4f} + {m16:.4f} ms (all {t16:.4f} ms; events "
        f"{ms16:.4f} ms); batch row {row} at B=1 equals B={B} bit for bit "
        "(q fp32, bf16)")
    res.update(ms16=ms16, dev_ms=t32, dev_ms16=t16)


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
    version on the same bf16 values, ids held as _topk_agree says; the
    100-repeat probe (values, ids and lse); CUDA-event times of both in
    fp32 and of the kernel in bf16, over table copies that together exceed
    the L2 cache; the device time of pass 1 and of the merge
    (torch.profiler) in both dtypes. The bound counts the operations at
    the tensor-core rate the kernel's route uses (fp32: 3xTF32, three TF32
    products per product at 495 TFLOP/s; bf16: 989 TFLOP/s) or the bytes,
    whichever is longer; the CUDA-core fp32 bound (67 TFLOP/s) is logged
    beside it. At N=640, rows launched as N=40 and N=5 must equal their
    rows of the N=640 launch bit for bit, in fp32 and bf16."""
    from tell_tpu_torch.ops.kernels.topk_logits import (topk_logits,
                                                        topk_logits_plain)
    from tell_tpu_torch.tools.timing import profiled_device_ms
    shape = f"N={N} V={V} D={D} k={k}"
    x = torch.randn(N, D, generator=g).to(dev)
    n_copies = min(4, max(2, -(-200 * 2**20 // (V * D * 4))))
    tables = [(torch.randn(V, D, generator=g) * D ** -0.5).to(dev)
              for _ in range(n_copies)]
    ref = topk_logits_plain(x, tables[0], k, 1)
    out = topk_logits(x, tables[0], k, 1)
    torch.cuda.synchronize()
    err32, n_diff = _topk_agree(out, ref, x, tables[0], 1, f"{shape} fp32")
    x16, t16 = x.bfloat16(), [t.bfloat16() for t in tables]
    out16 = topk_logits(x16, t16[0], k, 1)
    ref16 = topk_logits_plain(x16.float(), t16[0].float(), k, 1)
    torch.cuda.synchronize()
    err16, n_diff16 = _topk_agree(out16, ref16, x16, t16[0], 1,
                                  f"{shape} bf16")
    check_repeats("topk_logits", topk_logits,
                  [[x, tables[0], k, 1], [x, tables[1], k, 1]], shape)
    cycle = itertools.cycle(tables)
    ms = cuda_ms(lambda: topk_logits(x, next(cycle), k, 1))
    plain_ms = cuda_ms(lambda: topk_logits_plain(x, next(cycle), k, 1))
    cycle = itertools.cycle(t16)
    ms16 = cuda_ms(lambda: topk_logits(x16, next(cycle), k, 1))
    dev_ms = {}
    for dtype, xd, ts in (("fp32", x, tables), ("bf16", x16, t16)):
        cycle = itertools.cycle(ts)
        times = profiled_device_ms(lambda: topk_logits(xd, next(cycle), k, 1))
        dev_ms[dtype] = (
            sum(t for n, t in times.items() if "partial_kernel" in n),
            sum(t for n, t in times.items() if "merge_kernel" in n))
    # x . table^T (2*N*V*D); no single PyTorch call computes the top-k and
    # the lse of a product
    flops = 2.0 * N * V * D
    bound_ms, bound_by = bound(_nbytes([x, tables[0], *out]), 3 * flops,
                               TF32_FLOPS)
    bound16, by16 = bound(_nbytes([x16, t16[0], *out16]), flops, BF16_FLOPS)
    core_ms, core_by = bound(_nbytes([x, tables[0], *out]), flops)
    (p32, m32), (p16, m16) = dev_ms["fp32"], dev_ms["bf16"]
    log(f"phase 3: topk_logits {shape}: fp32 max abs err {err32:.3e}, bf16 "
        f"max abs err {err16:.3e}, ids differing {n_diff}/{n_diff16} of "
        f"{N * k}; fp32 kernel {ms:.4f} ms (device: pass 1 {p32:.4f} ms + "
        f"merge {m32:.4f} ms, {bound_ms / (p32 + m32):.1%} of the bound "
        f"{bound_ms:.4f} ms, {bound_by}, 3xTF32; CUDA-core bound "
        f"{core_ms:.4f} ms, {core_by}), plain {plain_ms:.4f} ms; bf16 "
        f"kernel {ms16:.4f} ms (device: pass 1 {p16:.4f} ms + merge "
        f"{m16:.4f} ms, {bound16 / (p16 + m16):.1%} of the bound "
        f"{bound16:.4f} ms, {by16}); library none")
    if N == 640:
        for dtype, xd, t in (("fp32", x, tables[0]), ("bf16", x16, t16[0])):
            full = topk_logits(xd, t, k, 1)
            for rows in (slice(0, 40), slice(100, 105)):
                part = topk_logits(xd[rows].contiguous(), t, k, 1)
                n_diff = sum(int((a[rows] != b).sum())
                             for a, b in zip(full, part))
                require(n_diff == 0, f"topk_logits {shape} {dtype}: rows "
                        f"{rows.start}-{rows.stop - 1} launched alone differ "
                        f"from the N={N} launch in {n_diff} outputs")
        log(f"phase 3: topk_logits {shape}: rows launched as N=40 and N=5 "
            f"equal their rows of N={N} bit for bit (fp32, bf16)")
    return {"shape": shape, "err32": err32, "err16": err16, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "ms16": ms16, "bound16": bound16,
            "dev_ms": dev_ms}


def check_kernel_f(name, kernel, sets, S, shape, res, fp, row=3):
    """Kernel F (fp form, or fp=False its int4-split form) on sets[0]: the
    outputs at bb = 2 and 4 equal bb = 1 bit for bit, and batch row `row`
    launched alone at B=1 equals its row of B=8, with q (and K/V for the fp
    form) in fp32 and bf16; the device time of F's launches from
    torch.profiler at each bb (fp32; at bb=1 also by kernel) and in bf16,
    and, for the fp form, of the SDPA call (res: check_kernel's or
    check_q8's result for these sets, which gets dev_ms, the device ms at
    each bb, dev_ms16 and sdpa_dev)."""
    from tell_tpu_torch.tools.timing import profiled_device_ms
    n_cast = 3 if fp else 1
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) if i < n_cast else t
                for i, t in enumerate(sets[0])]
        outs = [kernel(*args, bb=bb) for bb in (1, 2, 4)]
        one = kernel(*(t[row:row + 1].contiguous() for t in args))
        for what, a, b in (("bb=2", outs[1], outs[0]),
                           ("bb=4", outs[2], outs[0]),
                           (f"B=1 row {row}", one, outs[0][row:row + 1])):
            n_diff = int((a != b).sum())
            require(n_diff == 0, f"{name} {shape} {dtype}: {what} differs "
                    f"from bb=1 in {n_diff} outputs")
    dev_ms, split = {}, {}
    for bb in (1, 2, 4):
        cycle = itertools.cycle(sets)
        times = profiled_device_ms(lambda: kernel(*next(cycle), bb=bb))
        dev_ms[bb] = sum(times.values())
        if bb == 1:   # F's three kernels by name (all for another tree's F)
            split = {part: sum(t for k, t in times.items() if part in k)
                     for part in ("scores", "pv", "combine")}
    sets16 = [[t.to(torch.bfloat16) if i < n_cast else t
               for i, t in enumerate(x)] for x in sets]
    cycle = itertools.cycle(sets16)
    dev16 = sum(profiled_device_ms(lambda: kernel(*next(cycle))).values())
    sdpa_dev = None
    if fp:
        cycle = itertools.cycle(_sdpa_decode_sets(sets))
        sdpa_dev = sum(profiled_device_ms(
            lambda: _sdpa_decode(*next(cycle))).values())
    log(f"phase 3: {name} {shape}: n_split {-(-S // 256)}; device time "
        + ", ".join(f"bb={bb} {t:.4f} ms" for bb, t in dev_ms.items())
        + f" ({res['bound_ms'] / dev_ms[1]:.1%} of the {res['bound_by']} "
        f"bound {res['bound_ms']:.4f} ms; scores {split['scores']:.4f} + "
        f"pv {split['pv']:.4f} + combine {split['combine']:.4f} ms), bf16 "
        f"{dev16:.4f} ms"
        + ("" if sdpa_dev is None else f", SDPA device {sdpa_dev:.4f} ms")
        + f"; bb = 1, 2, 4 and batch row {row} at B=1 equal bit for bit "
        "(fp32, bf16)")
    res.update(dev_ms=dev_ms, dev_ms16=dev16, sdpa_dev=sdpa_dev)


def check_single_long(g, dev, S=4096) -> None:
    """Kernel F at S=4096 (MG=20, hd=64; past what a block's shared memory
    could hold of the [MG, S] score row), both forms, against their plain
    versions (FP32_TOL)."""
    from tell_tpu_torch.models.decoder import quantize_kv4
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_plain, decode_attention_q4split,
        decode_attention_q8_plain, decode_attention_single)
    q = (torch.randn(2, 16, 20, 64, generator=g) * 0.125).to(dev)
    k, v = (torch.randn(2, 16, 64, S, generator=g).to(dev) for _ in "kv")
    bias = torch.zeros(2, 20, S, device=dev)
    bias[:, :, S // 2:] = float("-inf")
    errs = []
    for out, ref in (
            (decode_attention_single(q, k, v, bias),
             decode_attention_plain(q, k, v, bias)),
            (decode_attention_q4split(q, *quantize_kv4(k), *quantize_kv4(v),
                                      bias),
             decode_attention_q8_plain(q, *quantize_kv4(k), *quantize_kv4(v),
                                       bias))):
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **FP32_TOL)
        errs.append((out - ref).abs().max().item())
    log(f"phase 3: decode_attention_single and _q4split at S={S} (B=2, "
        f"MG=20): max abs err {errs[0]:.3e} / {errs[1]:.3e} against the "
        "plain versions")


# The kernels of phase 3, as --kernels names them
KERNEL_NAMES = ("decode_attention", "encoder_attention", "fused_dynamic_conv",
                "decode_attention_q8", "topk_logits", "decode_attention_single")


def phase_kernels(seed: int, only: set[str] | None = None) -> dict:
    """Every kernel against its plain version, or only the kernels named in
    `only` (KERNEL_NAMES; decode_attention_single also takes its int4-split
    form). In a full run kernel B's B=4 cases draw from the generator where
    they always did, so every later kernel keeps the inputs of earlier
    trees; the B=1 and B=32 cases draw from a second generator and kernel
    D's B=128 case from a third. A run of some kernels only draws other
    inputs than the full run, the same in every tree that runs it."""
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_plain, decode_attention_q4split,
        decode_attention_single)
    dev = torch.device("cuda")
    res = {"decode_attention": [], "encoder_attention": [],
           "fused_dynamic_conv": [], "decode_attention_q8": [],
           "topk_logits": [], "decode_attention_single": [],
           "decode_attention_q4split": []}

    def run(name):
        return only is None or name in only

    g = torch.Generator().manual_seed(seed)
    identity = lambda o: o  # noqa: E731
    for MG, article in (((4, 512), (20, 512), (4, 2048), (20, 2048))
                        if run("decode_attention") else ()):
        S, sets = _decode_case(g, 8, MG, article, dev)
        shape = f"B=8 H=16 hd=64 MG={MG} S={S}"
        res["decode_attention"].append(check_kernel(
            "decode_attention", decode_attention, decode_attention_plain,
            sets, shape, decode_flops(sets[0][0], S),
            (_sdpa_decode, _sdpa_decode_sets(sets), identity)))
        check_kernel_a(sets, S, shape, res["decode_attention"][-1])
    if run("decode_attention"):
        decode_attention_host_floor(dev)
        # the siblings' decode shapes: partial row tiles and PV passes
        gs = torch.Generator().manual_seed(seed + 3)
        for M, MG in SIBLING_A_CASES:
            S, sets = _decode_case(gs, 8, MG, 512, dev,
                                   segments=SIBLING_SEGMENTS[M])
            shape = f"B=8 H=16 hd=64 MG={MG} S={S}"
            res["decode_attention"].append(check_kernel(
                "decode_attention", decode_attention, decode_attention_plain,
                sets, shape, decode_flops(sets[0][0], S),
                (_sdpa_decode, _sdpa_decode_sets(sets), identity)))
            check_kernel_a(sets, S, shape, res["decode_attention"][-1])
    gb = torch.Generator().manual_seed(seed + 1)
    for S, (name, lens) in (([(128, ENCODER_CASES[0])]
                             + [(512, c) for c in ENCODER_CASES])
                            if run("encoder_attention") else ()):
        res["encoder_attention"].append(check_kernel_b(
            g if name == "B=4" else gb, name, lens(S), S, dev))
    if run("fused_dynamic_conv"):
        for T, K in ((32, 3), (32, 7), (32, 15), (32, 31), (100, 31),
                     (15, 31)):
            res["fused_dynamic_conv"].append(check_conv(g, 16, T, K, dev))
    if run("decode_attention_q8"):
        for mode in ("int8", "int4"):
            for article in (512, 2048):
                res["decode_attention_q8"].append(
                    check_q8(g, 8, 20, article, dev, mode))
        # the 128-slot engine's step: 167 MB of int8 K/V
        res["decode_attention_q8"].append(check_q8(
            torch.Generator().manual_seed(seed + 2), 128, 20, 512, dev,
            "int8", copies=2))
        torch.cuda.empty_cache()
        gd = torch.Generator().manual_seed(seed + 4)
        for M, MG in SIBLING_D_CASES:   # the siblings' int8 engine
            res["decode_attention_q8"].append(check_q8(
                gd, 8, MG, 512, dev, "int8", segments=SIBLING_SEGMENTS[M]))
    if run("topk_logits"):
        for N in (40, 640):
            for V in (5000, 15000, 30265):
                res["topk_logits"].append(check_topk(g, N, V, 5, dev))
        res["topk_logits"].append(check_topk(g, 40, 30265, 8, dev))
        # phase 13's top-k sampling: its batch, k=4, the three bands
        gk = torch.Generator().manual_seed(seed + 5)
        for V in (5000, 15000, 30265):
            res["topk_logits"].append(check_topk(gk, SAMPLING_ROWS, V,
                                                 SAMPLING_K, dev))
    if not run("decode_attention_single"):
        return res
    for article in (512, 2048):
        S, sets = _decode_case(g, 8, 20, article, dev)
        shape = f"B=8 H=16 hd=64 MG=20 S={S}"
        res["decode_attention_single"].append(check_kernel(
            "decode_attention_single", decode_attention_single,
            decode_attention_plain, sets, shape,
            decode_flops(sets[0][0], S),
            (_sdpa_decode, _sdpa_decode_sets(sets), identity)))
        check_kernel_f("decode_attention_single", decode_attention_single,
                       sets, S, shape, res["decode_attention_single"][-1],
                       fp=True)
        del sets
        res["decode_attention_q4split"].append(check_q8(
            g, 8, 20, article, dev, "int4", "decode_attention_q4split",
            decode_attention_q4split))
    check_single_long(g, dev)
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


SERVICE_ARTICLES = (512, 300, 120, 40)                 # phase 4
BEAM_ARTICLES = (512, 480, 400, 300, 256, 200, 128, 64)
LONG_SERVICE_ARTICLES = (2048, 1500, 1800, 1650)       # phase 10
LONG_BEAM_ARTICLES = (2048, 2000, 1900, 1800, 1700, 1600, 1550, 1500)


def phase_service(seed: int, cfg, rcfg, dev: str, label: str = "phase 4",
                  articles=SERVICE_ARTICLES, beam_articles=BEAM_ARTICLES,
                  routes: bool = False):
    """Serve cfg/rcfg with random weights on `dev` (the service built
    without article_len, so it must take the article context's max_len);
    returns the service, the first request, its caption and the kernels'
    launch counts, with the widest source kernel A attended and the
    article windows kernel B encoded per launch. routes: also check
    /metrics, the demo page, /scrape and the client (_check_routes)."""
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
    svc = CaptionService(params, roberta, cfg, dev, max_batch=8)
    article_len = cfg.decoder.context("article").max_len
    require(svc.article_len == article_len,
            f"the service took article_len {svc.article_len}, not the "
            f"article context's {article_len}")
    log(f"{label}: random-init weights on {dev} in {time.time() - t0:.1f} s"
        f" (E={cfg.decoder.embed_dim}, RoBERTa {rcfg.num_layers}x{rcfg.dim}"
        f"); article_len {svc.article_len}, buckets {svc._article_buckets}")
    rng = np.random.default_rng(seed)
    vocab = rcfg.vocab_size
    reqs = [_request(rng, cfg, n, f, o, vocab)
            for n, f, o in zip(articles, (4, 2, 1, 0), (64, 20, 0, 5))]
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

    decode_attention.launches = decode_attention.max_columns = 0
    decode_attention.combine_launches = 0
    encoder_attention.launches = encoder_attention.sequences = 0
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
    windows = encoder_attention.sequences / max(1, encoder_attention.launches)
    log(f"{label}: {len(reqs)} /caption answers (articles of "
        f"{list(articles)} tokens), token ids of length "
        f"{cfg.gen_len + 1} within the vocab, {lengths} tokens before "
        "padding; latencies (s) "
        + ", ".join(f"{x:.3f}" for x in latencies)
        + f"; {len(reqs) / serve_s:.3f} captions/s over {serve_s:.3f} s "
        f"(batches served: {svc.batcher.stats['batches']}); kernel A "
        f"attended up to {decode_attention.max_columns} source columns, "
        f"kernel B encoded {windows:g} sequences per launch "
        f"({windows / svc.max_batch:g} windows per article row)")
    max_columns = decode_attention.max_columns

    # beam search, beam 5, B=8, on the same weights
    beam_reqs = [_request(rng, cfg, n, 4, 64, vocab) for n in beam_articles]
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
    log(f"{label}: beam_search beam=5 B=8 in {beam_s:.3f} s "
        f"({8 / beam_s:.3f} captions/s, encode included); launches "
        f"{launches}, kernel A's combine pass "
        f"{decode_attention.combine_launches}")
    if dev == "cuda":
        for name, n in launches.items():
            require(n > 0, f"{name} never launched on the main path")
        S = sum(c.max_len + 2 for c in cfg.decoder.contexts)
        require(max_columns == S, f"kernel A attended at most {max_columns} "
                f"source columns on /caption, not the {S} of this config")
        n_windows = -(-article_len // (rcfg.max_positions - 2))
        require(windows == n_windows * svc.max_batch,
                f"kernel B encoded {windows} sequences per launch, not "
                f"{n_windows} windows x {svc.max_batch} rows")
    launches["max_columns"] = max_columns
    launches["windows_per_row"] = windows / svc.max_batch
    if routes:
        launches["routes"] = _check_routes(svc, port, rng, cfg, vocab, label)

    status, _ = _post(port, "/shutdown", {})
    require(status == 200, f"/shutdown answered {status}")
    deadline = time.time() + 30
    while svc.batcher._thread.is_alive() and time.time() < deadline:
        time.sleep(0.05)
    httpd.server_close()
    return svc, reqs[0], captions[0], launches


def _check_routes(svc, port, rng, cfg, vocab, label) -> dict:
    """The server's other routes and the port's client: four articles of
    article_len tokens (one bucket, so every micro-batch has one shape)
    posted one at a time, then CaptioningClient.parse of the same four
    (concurrent) must answer the same token ids; /metrics' counters equal
    /status'; GET / the bytes of demo/index.html; POST /scrape of a file://
    URL 422 (the SSRF guard)."""
    from tell_tpu_torch.serving import CaptioningClient
    from tell_tpu_torch.serving.server import DEMO_PAGE
    reqs = [_request(rng, cfg, svc.article_len, f, o, vocab)
            for f, o in ((4, 64), (2, 20), (1, 0), (0, 5))]
    direct = []
    for r in reqs:
        status, body = _post(port, "/caption", r)
        require(status == 200 and "error" not in body, (status, body))
        direct.append(body["token_ids"])
    client = CaptioningClient(port=port, timeout=600)
    t = time.perf_counter()
    parsed = client.parse(reqs)
    parse_s = time.perf_counter() - t
    same = sum(p["token_ids"] == d for p, d in zip(parsed, direct))
    require(same == len(reqs), f"{label}: CaptioningClient.parse answered "
            f"{len(reqs) - same} of {len(reqs)} captions unlike a POST alone")
    text = _get(port, "/metrics").decode()
    counters = {line.split()[0]: int(line.split()[1])
                for line in text.splitlines() if not line.startswith("#")}
    st = client.status()["statistics"]
    require(counters == {"tnt_requests_total": st["requests"],
                         "tnt_batches_total": st["batches"],
                         "tnt_errors_total": st["errors"]},
            f"{label}: /metrics {counters} != /status {st}")
    with open(DEMO_PAGE, "rb") as f:
        require(_get(port, "/") == f.read(),
                f"{label}: GET / is not demo/index.html")
    status, body = _post(port, "/scrape", {"url": "file:///etc/passwd"})
    require(status == 422, f"{label}: /scrape of a file:// URL: {status} "
            f"{body}")
    out = {"metrics": counters, "parse_equal": same,
           "parse_s": parse_s, "scrape_file_url": status}
    log(f"{label}: routes: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the same weights on the CPU and on the card
# ---------------------------------------------------------------------------

def phase_cpu_vs_card(svc, req, caption, label: str = "phase 5"):
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
    for where, model, enc in (("card", svc.model, svc.roberta),
                              ("cpu", cpu_model, cpu_roberta)):
        dev = svc.device if where == "card" else torch.device("cpu")
        t = time.perf_counter()
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            e = encode_contexts(enc.frozen(), cfg, tb)
            p, lp = model.predict_forced(e, tokens.to(dev),
                                         with_log_probs=True)
        preds[where], lps[where] = p.cpu()[0], lp.cpu()[0]
        log(f"{label}: encode + predict_forced on the {where} ({dev}) in "
            f"{time.perf_counter() - t:.2f} s")
    agree = int((preds["cpu"] == preds["card"]).sum())
    lp_diff = (lps["cpu"] - lps["card"]).abs().max().item()
    follows = int((preds["card"] == tokens[0, 1:]).sum())
    log(f"{label}: card vs CPU top-1 agreement {agree}/16, max abs "
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

def _record_engine_inputs(svc) -> dict:
    """Wraps the service's batched encodes and its engines' admissions to
    record what the engine was given: each request's row of the encoded
    features (keyed by its article ids), and the rows of every encode and
    every admission, in order."""
    seen = {"features": {}, "encodes": [], "admissions": []}
    for batcher in svc.enc_batchers.values():
        def encode(stacked, encode_many=batcher.encode_many):
            enc = encode_many(stacked)
            ids = stacked["context_ids"]
            seen["encodes"].append(len(ids))
            for r in range(len(ids)):
                seen["features"][ids[r].tobytes()] = {
                    k: v[r:r + 1] for k, v in enc.items()}
            return enc
        batcher.encode_many = encode
    for eng in svc.engines.values():
        def admit(batchN, bs, admit_fn=eng._admit):
            seen["admissions"].append(int(bs.shape[0]))
            admit_fn(batchN, bs)
        eng._admit = admit
    return seen


def _feature_err(enc, ref) -> tuple[float, bool]:
    """(max abs difference, within FEATURE_TOL) of two encoded feature
    dicts; masks must be equal, and so must the NaNs of absent rows."""
    err, ok = 0.0, True
    for k, v in ref.items():
        if v.dtype == torch.bool:
            ok &= torch.equal(enc[k], v)
            continue
        err = max(err, (enc[k] - v).abs().nan_to_num(0.0).max().item())
        ok &= torch.allclose(enc[k], v, equal_nan=True, **FEATURE_TOL)
    return err, ok


@contextlib.contextmanager
def _beam_trace():
    """Records each step of the one-shot beam search (batch row 0): the
    candidate pool its selection ranks ([K, K] totals and token ids, a
    frozen beam offering one <pad>), and the survivors' parents and
    tokens."""
    from tell_tpu_torch.models import beam
    select, steps = beam.beam_select, []

    def traced(scores, finished, lengths, cand_lp, cand_ids, fin_lp,
               pad_id, eos_id, frozen=None):
        out = select(scores, finished, lengths, cand_lp, cand_ids, fin_lp,
                     pad_id, eos_id, frozen)
        K = scores.shape[1]
        fr = (finished if frozen is None else frozen)[0, :, None]
        steps.append({
            "total": (scores[0, :, None] + torch.where(
                fr, fin_lp, cand_lp[:K])).cpu().numpy(),
            "ids": torch.where(fr, pad_id, cand_ids[:K]).cpu().numpy(),
            "parent": out[1][0].cpu().numpy(),
            "tok": out[2][0].cpu().numpy()})
        return out

    beam.beam_select = traced
    try:
        yield steps
    finally:
        beam.beam_select = select


@contextlib.contextmanager
def _engine_trace(svc):
    """Records the engines' beam steps without a host synchronisation (the
    tensors stay on the device until the run is over): every admission's
    slots, and at every step each slot's candidate pool ([K, K] totals and
    token ids, as _beam_trace) and its survivors' parents and tokens, each
    tagged with its engine (one per bucket). Yields the event list for
    _engine_steps."""
    from tell_tpu_torch.serving import engine as eng
    E = eng.DecodeEngine
    select, step = eng.beam_select, E._step
    admits = {e: e._admit for e in svc.engines.values()}
    events, current = [], {}   # current: thread -> the engine stepping

    def traced(scores, finished, lengths, cand_lp, cand_ids, fin_lp,
               pad_id, eos_id, frozen=None):
        out = select(scores, finished, lengths, cand_lp, cand_ids, fin_lp,
                     pad_id, eos_id, frozen)
        B, K = scores.shape
        fr = (finished if frozen is None else frozen)[:, :, None]
        events.append(("step", current[threading.get_ident()],
                       scores[:, :, None] + torch.where(
                           fr, fin_lp, cand_lp.reshape(B, K, K)),
                       torch.where(fr, pad_id, cand_ids.reshape(B, K, K)),
                       out[1].clone(), out[2].clone()))
        return out

    def traced_step(self):
        current[threading.get_ident()] = id(self)
        return step(self)

    def traced_admit(e, batchN, bs):
        events.append(("admit", id(e), bs.clone()))
        return admits[e](batchN, bs)

    eng.beam_select, E._step = traced, traced_step
    for e in admits:
        e._admit = functools.partial(traced_admit, e)
    try:
        yield events
    finally:
        eng.beam_select, E._step = select, step
        for e, admit in admits.items():
            e._admit = admit


def _engine_steps(events, paths) -> list | None:
    """The engine's steps (as _beam_trace records them) for the request
    whose answer is paths [K, L+1]: the slot and admission whose traced
    steps rebuild exactly those beams; None where none does."""
    K, L = paths.shape[0], paths.shape[1] - 1
    ev = [(kind, who, *(t.cpu().numpy() for t in rest))
          for kind, who, *rest in events]
    starts = [(i, who, int(b)) for i, (kind, who, *rest) in enumerate(ev)
              if kind == "admit" for b in set(rest[0].tolist())]
    for i, who, b in starts:
        steps, prefixes = [], [()] * K
        for kind, other, *rest in ev[i + 1:]:
            if other != who:
                continue
            if kind == "admit" and b in rest[0]:
                break
            if kind == "step" and len(steps) < L:
                total, ids, parent, tok = (a[b] for a in rest)
                steps.append({"total": total, "ids": ids, "parent": parent,
                              "tok": tok})
                prefixes = [prefixes[int(p)] + (int(x),)
                            for p, x in zip(parent, tok)]
        n = len(steps)
        if n and sorted(prefixes) == sorted(
                tuple(int(x) for x in path[1:n + 1]) for path in paths):
            return steps
    return None


def _log_candidates(label, i, step, one_shot, engine, n=10) -> None:
    """Both searches' ranked candidates at `step` side by side: total
    (full precision), beam, token, and the last tokens of the beam's
    prefix; the order is the selection's (total descending, lower flat
    index first)."""
    def ranked(steps):
        prefixes = [()] * steps[0]["total"].shape[0]
        for st in steps[:step]:
            prefixes = [prefixes[int(p)] + (int(x),)
                        for p, x in zip(st["parent"], st["tok"])]
        st = steps[step]
        K = st["total"].shape[0]
        flat = st["total"].reshape(-1)
        order = np.argsort(-flat, kind="stable")[:n]
        return [f"{flat[f]:.9e} b{f // K} t{int(st['ids'].reshape(-1)[f])} "
                f"{prefixes[f // K][-3:]}" for f in order]
    rows = zip(ranked(one_shot), ranked(engine))
    log(f"{label}: request {i} step {step} candidates (total, beam, token, "
        "prefix end), one-shot | engine:\n" + "\n".join(
            f"  {r + 1:2d}: {a} | {b}" for r, (a, b) in enumerate(rows)))


def _beam_split(steps, paths) -> dict | None:
    """Where the engine's final beams (paths [K, L+1], <s> first) leave the
    one-shot search traced in `steps`: the first step whose survivors lack
    an engine beam's prefix, the largest gap there between the one-shot's
    K-th candidate total and such a prefix's own total in its pool (inf
    when the prefix was not a candidate), the K-th to (K+1)-th margin
    there, and the smallest margin up to there with its step. None when
    every engine prefix survives every step."""
    K = paths.shape[0]
    prefixes = [()] * K
    margins = []
    for t, st in enumerate(steps):
        pool: dict = {}
        for j in range(K):
            for c in range(K):
                key = prefixes[j] + (int(st["ids"][j, c]),)
                pool[key] = max(pool.get(key, -math.inf),
                                float(st["total"][j, c]))
        ranked = np.sort(st["total"].reshape(-1))[::-1]
        kth = float(ranked[K - 1])
        margin = kth - float(ranked[K])
        margins.append(margin if math.isfinite(margin) else math.inf)
        prefixes = [prefixes[int(p)] + (int(tok),)
                    for p, tok in zip(st["parent"], st["tok"])]
        missing = {tuple(int(x) for x in path[1:t + 2])
                   for path in paths} - set(prefixes)
        if missing:
            low = int(np.argmin(margins))
            return {"step": t, "margin": margins[-1],
                    "gap": max(kth - pool.get(m, -math.inf)
                               for m in missing),
                    "min_margin": margins[low], "min_margin_step": low}
    return None


ENGINE_ARTICLES = (40, 512, 64, 300, 90, 128, 200, 100,
                   50, 480, 110, 256, 70, 120, 160, 80)
ENGINE_ROUTED = {128: 10, 256: 3, 512: 3}
LONG_ENGINE_ARTICLES = (300, 2048, 900, 1500, 450, 1100, 2000, 700)
LONG_ENGINE_ROUTED = {512: 2, 1024: 2, 2048: 4}
# phase 10's engine: fp cache, exact top-k, every answer equal
LONG_ENGINE = dict(label="phase 10", articles=LONG_ENGINE_ARTICLES,
                   routed_want=LONG_ENGINE_ROUTED, kv_cache="fp",
                   fused_topk=False, int4=False, tie_tol=None)


def phase_engine(seed: int, cfg, rcfg, dev: str = "cuda",
                 label: str = "phase 8", articles=ENGINE_ARTICLES,
                 routed_want=ENGINE_ROUTED, kv_cache: str = "int8",
                 fused_topk: bool = True, int4: bool = True,
                 tie_tol: float | None = TIE_TOL):
    """The engine service over HTTP (see the module docstring, phases 8
    and 10): built without article_len, engine_buckets on, the requests in
    staggered bursts of four, each answer held to a one-shot beam_search
    with the same numerics on the features the engine was given: equal,
    or (tie_tol not None) a near tie within tie_tol where the two beam
    searches split (_beam_split). Kernel A launches exactly where the
    cache is fp, kernel D where it is quantised, kernel E where
    fused_topk is on; kernel B always. With int4, one int4 beam_search
    at B=8 after. Returns the service, the requests, the kernels' launch
    counts and the differing answers' (request, gap). Where an answer
    differs, both searches' ranked candidates at the step where they split
    are logged (_engine_trace, _log_candidates)."""
    from tell_tpu_torch.bridge import init_captioner, init_roberta
    from tell_tpu_torch.config import with_article_len
    from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
    from tell_tpu_torch.models.beam import beam_search
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_q8)
    from tell_tpu_torch.ops.kernels.encoder_attention import (
        encoder_attention)
    from tell_tpu_torch.ops.kernels.topk_logits import topk_logits
    from tell_tpu_torch.serving import CaptionService, serve

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    svc = CaptionService(init_captioner(g, cfg),
                         RobertaEncoder(init_roberta(g, rcfg), rcfg), cfg,
                         dev, engine_slots=8, engine_beam=5,
                         engine_buckets=True, encode_batch=8,
                         kv_cache=kv_cache, fused_topk=fused_topk)
    warm = svc.warmup()
    log(f"{label}: engine service up in {time.perf_counter() - t0:.1f} s "
        f"(warm-up {warm['seconds']:.1f} s over widths {warm['widths']}; "
        f"{kv_cache} cache, {'fused' if fused_topk else 'exact'} top-k)")
    rng = np.random.default_rng(seed + 3)
    reqs = [_request(rng, cfg, n, int(rng.integers(0, 5)),
                     int(rng.integers(0, 65)), rcfg.vocab_size)
            for n in articles]
    seen = _record_engine_inputs(svc)
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
    with _engine_trace(svc) as events:
        for first in range(0, len(reqs), 4):     # bursts of four, staggered
            for i in range(first, min(first + 4, len(reqs))):
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
    log(f"{label}: {len(reqs)} /caption answers in {serve_s:.3f} s: "
        f"{len(reqs) / serve_s:.3f} captions/s, latency p50 "
        f"{np.median(lat):.3f} s, max {lat.max():.3f} s; launches "
        f"{launches}")
    log(f"{label}: /status {json.dumps(status)}")
    on_card = dev == "cuda"
    if on_card:
        expect = {"decode_attention": kv_cache == "fp",
                  "encoder_attention": True,
                  "decode_attention_q8": kv_cache != "fp",
                  "topk_logits": fused_topk}
        for name, want in expect.items():
            require((launches[name] > 0) == want,
                    f"{name} launched {launches[name]} times on the "
                    f"{kv_cache}/{'fused' if fused_topk else 'exact'} "
                    "engine path")
    routed = {w: e.stats["requests"] - before[w]
              for w, e in svc.engines.items()}
    require(routed == routed_want, routed)

    exact, differing, score_diff, feat_err = 0, [], 0.0, 0.0
    params = svc.model.tree()
    for i, (req, (code, body)) in enumerate(zip(reqs, answers)):
        require(code == 200 and "error" not in body, (i, code, body))
        batch, errors = svc._pack([req], bucketed=True)
        require(errors == [None], errors)
        cfg_w = with_article_len(cfg, batch["context_ids"].shape[1])
        beams = [body] + body["alternatives"]
        require(len(beams) == 5, f"request {i}: {len(beams)} beams")
        enc = seen["features"][batch["context_ids"][0].tobytes()]
        with torch.inference_mode():
            err, ok = _feature_err(enc, svc._encode_many(batch))
            feat_err = max(feat_err, err)
            require(ok, f"request {i}: the engine's features are {err:.3e} "
                    "off the request encoded alone")
            with _beam_trace() as steps:
                ref = beam_search(params, cfg_w, enc, beam_size=5,
                                  kv_cache=kv_cache, fused_topk=fused_topk)
        ref_ids = ref["token_ids"][0].cpu().numpy()
        paths = np.stack([b["token_ids"] for b in beams])
        require(paths.shape == ref_ids.shape, (paths.shape, ref_ids.shape))
        if np.array_equal(paths[0], ref_ids[0]):
            exact += 1
            same = (paths == ref_ids).all(axis=1)
            diff = np.abs(np.asarray([b["score"] for b in beams])
                          - ref["scores"][0].cpu().numpy())[same]
            score_diff = max(score_diff, float(diff.max()))
            continue
        t = int(np.flatnonzero(paths[0] != ref_ids[0])[0])
        split = _beam_split(steps, paths)
        if split is None:       # the same beams, ranked otherwise
            j = np.flatnonzero((ref_ids == paths[0]).all(axis=1))
            gap = (ref["scores"][0, 0] - ref["scores"][0, j[0]]).item() \
                if len(j) else math.inf
            where = (f"the same 5 beams, the engine's best {gap:.3e} below "
                     "the one-shot's best")
        else:
            gap = split["gap"]
            where = (f"the beam sets split at step {split['step']}: an "
                     f"engine prefix {gap:.3e} below the one-shot's 5th "
                     f"candidate, whose margin to the 6th is "
                     f"{split['margin']:.3e} (smallest margin up to there "
                     f"{split['min_margin']:.3e}, step "
                     f"{split['min_margin_step']})")
        differing.append((i, gap))
        log(f"{label}: request {i}: engine and one-shot best beams differ "
            f"first at token {t} (final scores {body['score']:.4f} and "
            f"{ref['scores'][0, 0].item():.4f}); {where}")
        eng_steps = _engine_steps(events, paths)
        if eng_steps is None:
            log(f"{label}: request {i}: no traced engine slot rebuilds its "
                "beams")
        else:
            _log_candidates(label, i, t - 1 if split is None
                            else split["step"], steps, eng_steps)
    log(f"{label}: engine vs one-shot beam_search on the engine's "
        f"features: {exact}/{len(reqs)} best beams equal (largest score "
        f"difference of an equal beam {score_diff:.3e}), differing "
        f"{[i for i, _ in differing]}; the features vs the request encoded "
        f"alone: max abs err {feat_err:.3e}; rows per encode "
        f"{seen['encodes']}, per admission {seen['admissions']}")
    for i, gap in differing:
        require(tie_tol is not None and gap <= tie_tol,
                f"request {i}: the engine's answer differs from the "
                f"one-shot beam search with a gap of {gap:.3e} where they "
                f"split (near tie allowed: {tie_tol})")

    status_code, _ = _post(port, "/shutdown", {})
    require(status_code == 200, f"/shutdown answered {status_code}")
    httpd.server_close()
    if not int4:
        return svc, reqs, launches, differing

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
    n_int4 = decode_attention_q8.int4_launches - n4
    log(f"{label}: int4 beam_search beam=5 B=8 in {beam_s:.3f} s "
        f"({8 / beam_s:.3f} captions/s, encode included); kernel D int4 "
        f"launches {n_int4} of {decode_attention_q8.launches - n0}")
    require(ok, "non-finite int4 beam scores")
    if on_card:
        require(n_int4 > 0 and n_int4 == decode_attention_q8.launches - n0,
                "the int4 beam search did not run kernel D on a packed "
                "cache")
    return svc, reqs, launches, differing


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
    gelu = report["fast_gelu_token_agreement"]
    log(f"phase 9: teacher-forced top-1 agreement with the fp path over "
        f"{report['tokens']} tokens: int8 K/V "
        f"{report['kv8_token_agreement']:.4f} (floor {KV8_FLOOR}), fused "
        f"top-k {report['fused_topk_token_agreement']:.4f} (floor "
        f"{FUSED_TOPK_FLOOR:.4f}), int4 K/V "
        f"{report['kv4_token_agreement']:.4f} (no floor), tanh-GELU encode "
        f"{gelu:.4f} (tell_tpu's floor {FAST_GELU_FLOOR}: "
        f"{'met' if gelu >= FAST_GELU_FLOOR else 'missed'}; the default "
        f"stays {report['gelu_mode']}); {report['seconds']:.1f} s")
    require(report["kv8_token_agreement"] >= KV8_FLOOR, report)
    require(report["fused_topk_token_agreement"] >= FUSED_TOPK_FLOOR, report)
    return report


# ---------------------------------------------------------------------------
# phase 11: the measurement tools
# ---------------------------------------------------------------------------

def phase_tools(seed: int, dev: str = "cuda", small: bool = False) -> dict:
    """kernel_variants (every variant), longctx_variants (single1,
    dispatch, jnp at S=2048) and profile_decode at their defaults (small:
    CPU-sized shapes for a rehearsal). Every variant must be within its
    error limit and, on the card, kernels A, D and F's two forms must have
    launched. Returns the tools' results and the launch counts."""
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_q4split, decode_attention_q8,
        decode_attention_single)
    from tell_tpu_torch.tools import (kernel_variants, longctx_variants,
                                      profile_decode)
    kv_shape = dict(B=4, S=70) if small else {}
    long_shape = dict(B=2, S=130) if small else dict(S=LONG_ARTICLE)
    counters = (decode_attention, decode_attention_q8,
                decode_attention_single, decode_attention_q4split)
    for fn in counters:
        fn.launches = 0
    t = time.perf_counter()
    with torch.inference_mode():
        variants = [kernel_variants.run(v, device=dev, seed=seed, **kv_shape)
                    for v in kernel_variants.VARIANTS]
        long = [longctx_variants.run(v, device=dev, seed=seed, **long_shape)
                for v in ("single1", "dispatch", "jnp")]
    prof = profile_decode.run(device=dev, seed=seed, small=small,
                              **(dict(B=2, K=2, S=12) if small else {}))
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"phase 11: the three tools in {time.perf_counter() - t:.1f} s; "
        f"launches {launches}")
    for r in variants + long:
        require(r["ok"], f"phase 11: {r['variant']} outside its limit: {r}")
    require(long[0]["fits"], "phase 11: kernel F refused single1 at "
            f"S={long[0]['S']}")
    if dev == "cuda":
        for name, n in launches.items():
            require(n > 0, f"{name} never launched by the tools")
    return {"variants": variants, "long": long, "profile": prof,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 12: text in, scored captions out, through the command line
# ---------------------------------------------------------------------------

QUALITY_EXPT = "expt/quality/overfit_flagship.yaml"
METRIC_KEYS = ("bleu-1", "bleu-2", "bleu-3", "bleu-4", "rouge-l",
               "meteor_exact_stem", "cider", "meteor", "n_samples",
               "captions_per_sec", "captions_per_sec_steady")
GENERATION_FIELDS = {"caption", "generation", "image_hash", "web_url",
                     "caption_readability", "gen_readability", "caption_np",
                     "gen_np"}


def _cli(argv, label, module="tell_tpu_torch.commands"
         ) -> tuple[dict, float, str]:
    """`python -m <module> argv` from the repo root; returns the last JSON
    object it printed, its wall seconds and its stderr (the log)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module] + argv, cwd=root,
                          env=env, capture_output=True, text=True)
    dt = time.perf_counter() - t
    require(proc.returncode == 0, f"{label}: {argv[0]} exited "
            f"{proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out = proc.stdout
    return ((json.loads(out[out.index("{"):]) if "{" in out else {}), dt,
            proc.stderr)


def _cli_overrides(tmp, extra=None) -> dict:
    """Runs, shards and the regenerated features under tmp."""
    over = {"trainer": {"serialization_dir": os.path.join(tmp, "run")},
            "data": {"shards_dir": os.path.join(tmp, "shards"),
                     "objects_jsonl": os.path.join(tmp, "features",
                                                   "objects.jsonl"),
                     "images_dir": os.path.join(tmp, "features", "grids")}}
    for k, v in (extra or {}).items():
        over.setdefault(k, {}).update(v)
    return over


def phase_cli(card: str, dev: str = "cuda", expt: str = QUALITY_EXPT,
              epochs: int = 2) -> dict:
    """The quality corpus through `python -m tell_tpu_torch.commands` at
    the flagship's full width (expt/quality/overfit_flagship.yaml; runs,
    shards and features in a temporary directory, num_epochs `epochs`):
    the features by the port's write_features, preprocess (the C++ BPE,
    its shards equal to the Python ByteBPE route's), train (the C++ reader
    and gather, TensorBoard scalars every step, the profiler over epoch
    0's steps [0, 2), async checkpoints keeping one), evaluate -s train --beam 5 and
    score; the host side's readings (BPE tokens/s, ms per packed batch,
    an async save's return against its flush); a warm-started run of one
    epoch from the first run's best checkpoint; then the card's checkpoint
    on the CPU, teacher-forced along two of the card's captions (phase 5's
    rule)."""
    from tell_tpu_torch.commands import __main__ as cli
    from tell_tpu_torch.config_io import load_experiment
    from tell_tpu_torch.tools.gen_quality_corpus import (
        FEATURES_SEED, read_articles, write_features)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        over = json.dumps(_cli_overrides(
            tmp, {"trainer": {"num_epochs": epochs, **CLI_TRAINER}}))
        exp = load_experiment(expt, over)
        secs = {}
        t = time.perf_counter()
        write_features(read_articles(exp.data.articles_jsonl),
                       os.path.join(tmp, "features"), FEATURES_SEED)
        secs["features"] = time.perf_counter() - t
        n = {}
        for split in ("train", "valid"):
            out, secs[f"preprocess_{split}"], err = _cli(
                ["preprocess", expt, "-o", over, "-s", split], "phase 12")
            n[split] = out["examples"]
            require("tokenized by NativeBPE" in err,
                    f"phase 12: preprocess did not take the C++ BPE:\n{err}")
        require(n == {"train": 32, "valid": 32}, f"phase 12: examples {n}")
        host = {"bpe": _bpe_rates(exp),
                "python_preprocess_equal": _python_preprocess_equal(exp, tmp)}
        launches = {}
        for cmd, extra in (("train", []),
                           ("evaluate", ["-s", "train", "--beam", "5"])):
            path = os.path.join(tmp, f"launches-{cmd}.json")
            out, secs[cmd], err = _cli([cmd, expt, "-o", over, "--device",
                                        dev, "--report-launches", path]
                                       + extra, "phase 12")
            with open(path) as f:
                launches[cmd] = json.load(f)
            if cmd == "train":
                trained, train_log = out, err
            else:
                metrics = out
        run = exp.trainer.serialization_dir
        gen_path = os.path.join(run, "generations-train.jsonl")
        scored, secs["score"], _ = _cli(["score", gen_path], "phase 12")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            hist = [json.loads(line) for line in f]
        with open(gen_path) as f:
            rows = [json.loads(line) for line in f]
        require(trained.get("epochs") == epochs and len(hist) == epochs,
                f"phase 12: train {trained}, {len(hist)} epochs")
        for h in hist:
            require(math.isfinite(h["loss"]) and math.isfinite(h["val_loss"])
                    and h["skipped"] == 0, f"phase 12: epoch {h}")
        require(os.path.isdir(os.path.join(run, "checkpoints", "best")),
                "phase 12: no checkpoints/best")
        require(metrics.get("n_samples") == 32 and len(rows) == 32,
                f"phase 12: {metrics.get('n_samples')} samples, "
                f"{len(rows)} generations")
        for k in METRIC_KEYS:
            require(k in metrics and math.isfinite(metrics[k]),
                    f"phase 12: metric {k} missing or not finite: {metrics}")
        require((metrics["kv_cache_mode"], metrics["topk_mode"])
                == ("fp", "exact"), f"phase 12: levers {metrics}")
        require(all(set(r) == GENERATION_FIELDS for r in rows),
                f"phase 12: generation fields {sorted(rows[0])}")
        require(all(scored[k] == metrics[k] for k in scored),
                f"phase 12: score {scored} != evaluate {metrics}")
        # epoch 1: outside the profiler window (its two steps still read
        # the loss on the host for the log and the scalar); epoch 0 holds
        # the window, its stop and the trace's export
        step_ms = 1e3 * hist[-1]["epoch_seconds"] / hist[-1]["batches"]
        profiled_ms = 1e3 * hist[0]["epoch_seconds"] / hist[0]["batches"]
        host["tensorboard"] = _check_tensorboard(run, train_log, hist)
        host["trace"] = _check_trace(run, dev)
        host["checkpoints"] = _check_checkpoints(exp, dev, tmp)
        host["pack"] = _pack_times(exp)
        host["warm_start"] = _check_warm_start(expt, tmp, dev)
        if dev == "cuda":
            for cmd, names in (("train", ("encoder_attention",
                                          "fused_dynamic_conv")),
                               ("evaluate", ("encoder_attention",
                                             "decode_attention"))):
                for name in names:
                    require(launches[cmd][name] > 0, f"phase 12: {name} "
                            f"never launched by {cmd}: {launches[cmd]}")
            require(launches["evaluate"]["decode_attention_q8"] == 0
                    and launches["evaluate"]["topk_logits"] == 0,
                    f"phase 12: a lever ran by default: {launches}")
        log(f"phase 12 ({card}): {expt} at full width, {epochs} epochs: "
            + json.dumps({
                "seconds": {k: round(v, 2) for k, v in secs.items()},
                "train_ms_per_step": round(step_ms, 1),
                "train_ms_per_step_profiled_epoch": round(profiled_ms, 1),
                "warm_ms_per_step": round(
                    host["warm_start"]["ms_per_step"], 1),
                "train_loss": [round(h["loss"], 4) for h in hist],
                "val_loss": [round(h["val_loss"], 4) for h in hist],
                "evaluate_captions_per_sec": metrics["captions_per_sec"],
                "evaluate_captions_per_sec_steady":
                    metrics["captions_per_sec_steady"],
                "metrics": {k: metrics[k] for k in METRIC_KEYS[:8]},
                "launches": launches}))
        log(f"phase 12 ({card}): the host side (host clocks of this "
            "machine): " + json.dumps(host))

        # the card's checkpoint on the CPU: two captions, phase 5's rule
        result = {"launches": launches, "step_ms": step_ms,
                  "seconds": secs, "metrics": metrics, "host": host}
        result["cpu_vs_card"] = _cli_cpu_vs_card(exp, cli, dev)
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 12's trainer options: TensorBoard scalars at every step, the
# profiler over steps [0, 2) (all of epoch 0's two batches, so epoch 1's
# ms per step is outside the window), the log at every step, and one
# numbered checkpoint kept (so keep-N acts)
CLI_TRAINER = {"summary_interval": 1, "profile_at": 0, "profile_steps": 2,
               "log_every": 1, "keep_checkpoints": 1}
BPE_PASSES = 10        # the corpus's texts, encoded this many times
PACK_EPOCHS = 5        # epochs of the train split packed per route
SCALAR_TOL = 1e-6      # a logged loss is printed to 6 decimals


def _bpe_rates(exp) -> dict:
    """The corpus's headlines, paragraphs and captions, BPE_PASSES times,
    through the C++ BPE and through the Python ByteBPE (fresh tokenizers):
    equal ids, and each one's tokens/s on the host clock."""
    from tell_tpu_torch.commands import __main__ as cli
    from tell_tpu_torch.tools.gen_quality_corpus import read_articles
    texts = []
    for a in read_articles(exp.data.articles_jsonl):
        texts += [a["headline"]["main"]] + [s["text"]
                                            for s in a["parsed_section"]]
    texts *= BPE_PASSES
    ids, rate = {}, {}
    for route, native in (("native", True), ("python", False)):
        bpe = cli._tokenizer(exp, native).bpe
        t = time.perf_counter()
        ids[route] = [bpe.encode(x) for x in texts]
        rate[route] = (sum(map(len, ids[route]))
                       / (time.perf_counter() - t))
    require(ids["native"] == ids["python"],
            "phase 12: NativeBPE's ids differ from ByteBPE's on the corpus")
    return {"texts": len(texts), "tokens": sum(map(len, ids["native"])),
            "native_tokens_per_s": rate["native"],
            "python_tokens_per_s": rate["python"],
            "speedup": rate["native"] / rate["python"]}


def _same(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _python_preprocess_equal(exp, tmp) -> int:
    """Preprocess again with the Python ByteBPE into another directory; every
    example of both splits must equal the C++ BPE's, field for field, bit
    for bit. Returns the examples compared."""
    from tell_tpu_torch.commands import __main__ as cli
    from tell_tpu_torch.data.records import RecordDataset
    py_exp = dataclasses.replace(exp, data=dataclasses.replace(
        exp.data, shards_dir=os.path.join(tmp, "shards_python")))
    n = 0
    for split in ("train", "valid"):
        count, bpe = cli.preprocess(py_exp, split, use_native=False)
        require(bpe == "ByteBPE", f"phase 12: the Python route took {bpe}")
        ours = RecordDataset(os.path.join(exp.data.shards_dir,
                                          f"{split}-*.npz"))
        theirs = RecordDataset(os.path.join(py_exp.data.shards_dir,
                                            f"{split}-*.npz"),
                               use_native=False)
        require(len(ours) == len(theirs) == count, "phase 12: the two "
                f"preprocess routes wrote {len(ours)} and {len(theirs)}")
        for i, (a, b) in enumerate(zip(ours.epoch(), theirs.epoch())):
            require(sorted(a) == sorted(b) and all(_same(a[k], b[k])
                                                   for k in a),
                    f"phase 12: {split} example {i} differs between the "
                    "C++ and the Python BPE")
            n += 1
    return n


def _check_tensorboard(run, train_log, hist) -> dict:
    """train/loss at every step equal to the logged loss, each epoch's mean
    of them equal to metrics.jsonl's loss and epoch/val_loss to its
    val_loss, within SCALAR_TOL."""
    import glob
    import re
    from tell_tpu_torch.training.tensorboard import read_events
    files = glob.glob(os.path.join(run, "tb", "events.out.tfevents.*"))
    require(len(files) == 1, f"phase 12: events files {files}")
    events = read_events(files[0])
    losses = {e["step"]: e["scalars"]["train/loss"] for e in events
              if "train/loss" in e["scalars"]}
    logged = {int(st): float(v) for st, v in
              re.findall(r"step (\d+) loss (\S+)", train_log)}
    steps = sum(h["batches"] for h in hist)
    require(sorted(losses) == sorted(logged) == list(range(1, steps + 1)),
            f"phase 12: train/loss at steps {sorted(losses)}, logged at "
            f"{sorted(logged)}, {steps} steps")
    worst = max(abs(losses[k] - logged[k]) for k in losses)
    require(worst <= SCALAR_TOL, f"phase 12: train/loss differs from the "
            f"log by {worst:.3e}")
    val = {e["step"]: e["scalars"]["epoch/val_loss"] for e in events
           if "epoch/val_loss" in e["scalars"]}
    first = 1
    for h, end in zip(hist, itertools.accumulate(h["batches"]
                                                 for h in hist)):
        mean = float(np.mean([losses[k] for k in range(first, end + 1)]))
        require(math.isclose(mean, h["loss"], rel_tol=SCALAR_TOL,
                             abs_tol=SCALAR_TOL),
                f"phase 12: epoch {h['epoch']}: mean train/loss {mean} != "
                f"metrics.jsonl {h['loss']}")
        require(end in val and math.isclose(val[end], h["val_loss"],
                                            rel_tol=SCALAR_TOL,
                                            abs_tol=SCALAR_TOL),
                f"phase 12: epoch {h['epoch']}: epoch/val_loss "
                f"{val.get(end)} != metrics.jsonl {h['val_loss']}")
        first = end + 1
    return {"train_loss_steps": len(losses), "epochs": len(val),
            "max_abs_vs_log": worst}


def _check_trace(run, dev) -> dict:
    """The chrome trace of the profiler window: epoch 0's steps 0 and 1
    marked, and on the card kernel B's device kernel in it (the window
    closes with its epoch, before the validation, so kernel C's count is
    read, not required)."""
    with open(os.path.join(run, "profile", "trace-0.json")) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted({int(e["name"].split(":")[1]) for e in events
                    if e.get("name", "").startswith("train_step:")})
    require(steps == [0, 1], f"phase 12: the trace marks steps {steps}")
    kernels = collections.Counter(e["name"] for e in events
                                  if e.get("cat") == "kernel")
    found = {name: sum(n for k, n in kernels.items() if name in k)
             for name in ("encoder_attention_kernel",
                          "dynamic_conv_kernel")}
    if dev == "cuda":
        require(found["encoder_attention_kernel"] > 0,
                "phase 12: the trace has no encoder_attention_kernel")
    return {"steps": steps, "device_kernels": sum(kernels.values()),
            **found}


def _check_checkpoints(exp, dev, tmp) -> dict:
    """After train (its final flush): `keep` numbered checkpoints and best,
    nothing half-written, each restoring; then the last one's state on the
    card saved once, timed to save()'s return (the async save) and to its
    flush (a synchronous save), restoring bit for bit."""
    from tell_tpu_torch.bridge import tree_leaves
    from tell_tpu_torch.training.checkpoint import CheckpointManager
    ck_dir = os.path.join(exp.trainer.serialization_dir, "checkpoints")
    keep = exp.trainer.keep_checkpoints
    cm = CheckpointManager(ck_dir, keep=keep)
    tags = cm.list()
    require(sorted(os.listdir(ck_dir)) == ["best"] + [f"ckpt-{t}"
                                                      for t in tags]
            and len(tags) == keep, f"phase 12: checkpoints "
            f"{sorted(os.listdir(ck_dir))} with keep {keep}")
    for tag in tags + ["best"]:
        state, meta = cm.restore(tag)
        require(all(bool(torch.isfinite(x).all()) for x in tree_leaves(
            state["params"])), f"phase 12: checkpoint {tag} not finite")
    state, meta = cm.restore(tags[-1], device=dev)
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    out = {"tags": tags, "gb": nbytes / 1e9}
    m = CheckpointManager(os.path.join(tmp, "save_timed"), keep=1)
    if dev == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    m.save(0, state, meta)
    out["async_s"] = time.perf_counter() - t       # what training waits
    m.flush()
    out["sync_s"] = time.perf_counter() - t        # save() then flush()
    back, _ = m.restore(0, device=dev)
    require(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back), tree_leaves(state))),
        "phase 12: the timed save did not restore bit for bit")
    del back, state
    return out


def _pack_times(exp) -> dict:
    """The train split packed PACK_EPOCHS times through the C++ reader and
    gather and through the Python reader and numpy packing: equal batches,
    host ms per batch of each (reading and routing included)."""
    from tell_tpu_torch.data.bucketing import bucket_batches
    from tell_tpu_torch.data.records import RecordDataset
    batches, ms = {}, {}
    for route, native in (("native", True), ("python", False)):
        ds = RecordDataset(os.path.join(exp.data.shards_dir, "train-*.npz"),
                           seed=exp.data.seed, use_native=native)
        t = time.perf_counter()
        batches[route] = [b for e in range(PACK_EPOCHS) for b in
                          bucket_batches(ds.epoch(epoch_index=e, lazy=True),
                                         exp.bucketing)]
        ms[route] = 1e3 * (time.perf_counter() - t) / len(batches[route])
    for a, b in zip(*batches.values()):
        require(sorted(a) == sorted(b) and all(_same(a[k], b[k])
                                               for k in a),
                "phase 12: a C++-packed batch differs from the numpy one")
    b0 = batches["native"][0]
    return {"batches": len(batches["native"]),
            "shape": list(b0["context_ids"].shape),
            "native_ms_per_batch": ms["native"],
            "python_ms_per_batch": ms["python"],
            "speedup": ms["python"] / ms["native"]}


def _check_warm_start(expt, tmp, dev) -> dict:
    """One epoch warm-started from the first run's checkpoints/best, built
    as `train` builds it: before its first step its params equal the
    checkpoint's bit for bit."""
    from tell_tpu_torch.bridge import tree_leaves
    from tell_tpu_torch.commands import __main__ as cli
    from tell_tpu_torch.config_io import load_experiment
    best = os.path.join(tmp, "run", "checkpoints", "best")
    exp = load_experiment(expt, json.dumps(_cli_overrides(tmp, {"trainer": {
        "serialization_dir": os.path.join(tmp, "run_warm"),
        "num_epochs": 1, "warm_start": best}})))
    trainer = cli.build_trainer(exp, torch.device(dev))
    trainer.initialize()
    saved = torch.load(os.path.join(best, "state.pt"), map_location=dev,
                       weights_only=True)["params"]
    leaves = list(zip(tree_leaves(trainer.state["params"]),
                      tree_leaves(saved)))
    require(all(a.dtype == b.dtype and torch.equal(a, b)
                for a, b in leaves),
            "phase 12: the warm-started params differ from the checkpoint's")
    del saved
    t = time.perf_counter()
    result = trainer.train()
    seconds = time.perf_counter() - t
    hist = trainer.metrics_history
    require(result["epochs"] == 1 and math.isfinite(hist[-1]["loss"])
            and math.isfinite(hist[-1]["val_loss"]),
            f"phase 12: the warm-started run: {result} {hist}")
    del trainer
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"leaves_equal": len(leaves), "loss": hist[-1]["loss"],
            "val_loss": hist[-1]["val_loss"], "seconds": seconds,
            "ms_per_step": 1e3 * hist[-1]["epoch_seconds"]
            / hist[-1]["batches"]}


def _cli_cpu_vs_card(exp, cli, dev: str) -> list:
    from tell_tpu_torch.data.bucketing import bucket_batches
    from tell_tpu_torch.data.records import RecordDataset
    from tell_tpu_torch.models.captioner import (encode_contexts, generate,
                                                 predict_forced)
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = exp.model
    ds = RecordDataset(os.path.join(exp.data.shards_dir, "train-*.npz"))
    batch = next(bucket_batches(ds.epoch(lazy=True), exp.bucketing))
    batch.pop("real", None)
    batch = {k: v[:2] for k, v in batch.items()}
    preds, lps = {}, {}
    tokens = None
    for where in ("card", "cpu"):
        d = torch.device(dev if where == "card" else "cpu")
        t = time.perf_counter()
        params = cli._restore_params(exp, None, d)
        frozen = cli._frozen_towers(exp, d)
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            enc = encode_contexts(frozen, cfg, tb)
            if tokens is None:
                tokens = generate(params, cfg, enc)["token_ids"][:, :17].cpu()
            p, lp = predict_forced(params, cfg, enc, tokens.to(d),
                                   with_log_probs=True)
        preds[where], lps[where] = p.cpu(), lp.cpu()
        log(f"phase 12: checkpoint, encode + predict_forced on the {where} "
            f"({d}) in {time.perf_counter() - t:.2f} s")
        del params, frozen, enc
    out = []
    for i in range(2):
        agree = int((preds["cpu"][i] == preds["card"][i]).sum())
        lp_diff = (lps["cpu"][i] - lps["card"][i]).abs().max().item()
        log(f"phase 12: caption {i}: card vs CPU top-1 agreement "
            f"{agree}/16, max abs log-prob difference {lp_diff:.3e}")
        require(agree >= 15, f"phase 12: caption {i}: card vs CPU agreement "
                f"{agree}/16 < 15/16")
        out.append({"agree": agree, "lp_diff": lp_diff})
    return out


# ---------------------------------------------------------------------------
# phase 13: the flagship's siblings
# ---------------------------------------------------------------------------

SIBLING_EXPTS = ("expt/nytimes/4_no_image.yaml",
                 "expt/nytimes/5_transformer_roberta.yaml",
                 "expt/nytimes/8_transformer_faces.yaml",
                 "expt/nytimes/13_learned_positional.yaml")
QUALITY_DIR = os.path.join("tests", "fixtures", "quality")
MAP_TOL = 1e-5       # the engine's replay against the micro-batch maps


def _smoke_tokenizer(root: str, vocab_size: int):
    """The quality corpus's byte-BPE (its merges and 708 pieces), with one
    filler piece (" zN") for every other id below vocab_size, so that a
    random model's captions decode to words."""
    from tell_tpu_torch.data.tokenizer import ByteBPE, RobertaTokenizer
    bpe = ByteBPE.from_files(os.path.join(root, QUALITY_DIR, "vocab.json"),
                             os.path.join(root, QUALITY_DIR, "merges.txt"))
    vocab = dict(bpe.encoder)
    for i in range(len(vocab), vocab_size):
        vocab[f"Ġz{i}"] = i
    return RobertaTokenizer(ByteBPE(vocab, list(bpe.ranks)))


def _quality_articles(root: str) -> list[dict]:
    with open(os.path.join(root, QUALITY_DIR, "articles.jsonl"),
              encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _sections_request(article: dict, pos: int) -> dict:
    return {"title": article["headline"]["main"],
            "sections": [{"type": s["type"], "text": s["text"]}
                         for s in article["parsed_section"]],
            "image_position": pos}


def _sibling_request(rng, cfg, n_ids, vocab, n_faces=2, n_objs=10):
    """A /caption payload with n_ids token ids and the features of the
    contexts cfg has (some face/object rows absent)."""
    req = {"context_ids": [0] + rng.integers(3, vocab, n_ids - 2).tolist()
           + [2]}
    for c in cfg.decoder.contexts:
        if c.name == "image":
            req["image_grid"] = rng.normal(size=(c.max_len, c.kv_dim)
                                           ).round(4).tolist()
        elif c.name in ("faces", "obj"):
            rows = rng.normal(size=(c.max_len, c.kv_dim))
            rows[n_faces if c.name == "faces" else n_objs:] = np.nan
            req["face_embeds" if c.name == "faces" else "obj_embeds"] = \
                rows.round(4).tolist()
    return req


def _reset_counts():
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_q8)
    from tell_tpu_torch.ops.kernels.encoder_attention import (
        encoder_attention)
    from tell_tpu_torch.ops.kernels.topk_logits import topk_logits
    for fn in (decode_attention, decode_attention_q8):
        fn.launches, fn.rows = 0, collections.Counter()
    encoder_attention.launches = encoder_attention.sequences = 0
    topk_logits.launches, topk_logits.ks = 0, collections.Counter()


def _counts() -> dict:
    from tell_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_q8)
    from tell_tpu_torch.ops.kernels.encoder_attention import (
        encoder_attention)
    from tell_tpu_torch.ops.kernels.topk_logits import topk_logits
    return {"decode_attention": decode_attention.launches,
            "decode_attention_rows": dict(sorted(decode_attention.rows
                                                 .items())),
            "encoder_attention": encoder_attention.launches,
            "decode_attention_q8": decode_attention_q8.launches,
            "decode_attention_q8_rows": dict(sorted(decode_attention_q8.rows
                                                    .items())),
            "topk_logits": topk_logits.launches,
            "topk_logits_ks": dict(sorted(topk_logits.ks.items()))}


def _forced_rows(svc, reqs, captions, dev, steps=16):
    """The first `steps` teacher-forced top-1 predictions of each request
    along its caption, on `dev` with svc's weights (copied there)."""
    from tell_tpu_torch.bridge import to_torch
    from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
    from tell_tpu_torch.models.captioner import Captioner, encode_contexts
    batch, errors = svc._pack(reqs)
    require(errors == [None] * len(reqs), errors)
    tokens = torch.from_numpy(np.stack([c[:steps + 1] for c in captions]))
    if dev.type == svc.device.type:
        model, enc = svc.model, svc.roberta
    else:
        model = Captioner(to_torch(svc.model.tree(), dev), svc.cfg)
        enc = RobertaEncoder(to_torch(svc.roberta.frozen()["roberta"], dev),
                             svc.roberta.cfg)
    with torch.inference_mode():
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        e = encode_contexts(enc.frozen(), svc.cfg, tb)
        return model.predict_forced(e, tokens.to(dev)).cpu()


def _sibling_service(exp_path, rcfg, roberta, tok, seed, dev, shrink, rng,
                     articles, beam_articles):
    """Phase 13 for one configuration: random weights from the seed, a
    micro-batch CaptionService over HTTP with four /caption requests (one
    of them scraped sections), a one-shot beam 5 at B=8, and the card
    against the CPU along two captions. Returns its line's readings."""
    from tell_tpu_torch.bridge import init_captioner
    from tell_tpu_torch.config_io import load_experiment
    from tell_tpu_torch.data.readers import assemble_location_aware
    from tell_tpu_torch.models.captioner import encode_contexts
    from tell_tpu_torch.serving import CaptionService, serve
    t0 = time.perf_counter()
    exp = load_experiment(exp_path)
    cfg = shrink(dataclasses.replace(exp.model, compute_dtype="float32"))
    M = len(cfg.decoder.contexts)
    g = torch.Generator(device=dev).manual_seed(seed)
    svc = CaptionService(init_captioner(g, cfg), roberta, cfg, dev,
                         tokenizer=tok, max_batch=4)
    L = svc.article_len
    vocab = rcfg.vocab_size
    reqs = [_sibling_request(rng, cfg, n, vocab) for n in articles[:3]]
    art = _quality_articles(os.path.dirname(os.path.abspath(__file__)))[0]
    reqs.append(_sections_request(art, 1))
    paragraphs, _ = assemble_location_aware(
        {"parsed_section": art["parsed_section"],
         "headline": art["headline"]}, 1,
        lambda t: len(tok.bpe.encode(t)), budget=L - 2)
    want = tok.encode("\n".join(paragraphs).strip(), max_len=L)
    packed, errors = svc._pack([reqs[3]])
    require(errors == [None] and packed["context_ids"][0, :len(want)]
            .tolist() == want and (packed["context_ids"][0, len(want):]
                                   == rcfg.pad_id).all(),
            f"{exp.name}: the sections request's ids are not "
            "assemble_location_aware's window")
    httpd = serve(svc, port=0, block=False)
    port = httpd.server_address[1]
    status, body = _post(port, "/caption", reqs[0])    # warm-up
    require(status == 200 and "error" not in body, body)
    _reset_counts()
    answers = [None] * len(reqs)

    def post(i):
        answers[i] = _post(port, "/caption", reqs[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    require(not any(t.is_alive() for t in threads), "requests did not finish")
    captions = []
    for i, (status, body) in enumerate(answers):
        require(status == 200 and "error" not in body, (exp.name, i, body))
        ids = np.asarray(body["token_ids"])
        require(ids.shape == (cfg.gen_len + 1,) and ids.min() >= 0
                and ids.max() < cfg.decoder.vocab_size,
                f"{exp.name}: token ids {ids.shape} outside the vocabulary")
        captions.append(ids)
    served = _counts()
    beam_reqs = [_sibling_request(rng, cfg, n, vocab) for n in beam_articles]
    batch, errors = svc._pack(beam_reqs)
    require(errors == [None] * len(beam_reqs), errors)
    _reset_counts()
    with torch.inference_mode():
        t = time.perf_counter()
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        out = svc.model.beam_search(encode_contexts(svc.roberta.frozen(),
                                                    cfg, tb), beam_size=5)
        beam_ok = bool(torch.isfinite(out["scores"]).all())
        beam_s = time.perf_counter() - t
    require(beam_ok and out["token_ids"].shape
            == (len(beam_reqs), 5, cfg.gen_len + 1), f"{exp.name}: beam")
    beamed = _counts()
    status, _ = _post(port, "/shutdown", {})
    require(status == 200, f"/shutdown answered {status}")
    httpd.server_close()
    if dev == "cuda":
        for what, counts, mg in (("/caption", served, M),
                                 ("beam 5", beamed, 5 * M)):
            require(counts["decode_attention"] > 0
                    and counts["encoder_attention"] > 0,
                    f"{exp.name} {what}: kernels A and B must launch: "
                    f"{counts}")
            require(counts["decode_attention_rows"].get(mg, 0) > 0,
                    f"{exp.name} {what}: kernel A never ran at MG={mg}: "
                    f"{counts['decode_attention_rows']}")
        card = _forced_rows(svc, reqs[:2], captions[:2], svc.device)
        cpu = _forced_rows(svc, reqs[:2], captions[:2], torch.device("cpu"))
        agree = [int(a) for a in (card == cpu).sum(dim=1)]
        require(min(agree) >= 15, f"{exp.name}: card vs CPU agreement "
                f"{agree}/16 < 15/16")
    else:
        agree = None
    S = sum(c.max_len + 2 for c in cfg.decoder.contexts)
    line = {"expt": exp.name, "contexts": [c.name for c in
                                           cfg.decoder.contexts],
            "weigh_bert": cfg.weigh_bert,
            "positional": cfg.decoder.positional, "S": S,
            "caption_launches": served, "beam_launches": beamed,
            "beam_s": beam_s, "card_vs_cpu": agree,
            "seconds": time.perf_counter() - t0}
    log(f"phase 13: {json.dumps(line)}")
    return svc, reqs, line


def _check_maps(body, cfg, label):
    """A need_attention answer: per-step maps of every context that sum to
    1 (masked columns carry 0), and their word merge."""
    require({"attns", "caption_words", "word_attns", "article_words"}
            <= set(body), f"{label}: payload keys {sorted(body)}")
    require(set(body["attns"]) == {c.name for c in cfg.decoder.contexts},
            f"{label}: maps of {sorted(body['attns'])}")
    for name, maps in body["attns"].items():
        a = np.asarray(maps)
        require(a.shape[0] == cfg.gen_len and np.isfinite(a).all()
                and np.abs(a.sum(-1) - 1).max() < 1e-4,
                f"{label}: {name} maps {a.shape} do not sum to 1")
    require(len(body["word_attns"]) == len(body["caption_words"]),
            f"{label}: {len(body['word_attns'])} word maps for "
            f"{len(body['caption_words'])} words")


def phase_siblings(seed: int, rcfg, dev: str = "cuda",
                   shrink=lambda cfg: cfg, cpu_dev="cpu",
                   articles=(512, 300, 120), beam_articles=BEAM_ARTICLES
                   ) -> dict:
    """Phase 13: expts 4, 5, 8 and 13 (NYTimes) at full width on one shared
    RoBERTa (rcfg) with random weights from the seed, each through
    _sibling_service; the faces sibling also through the int8 engine
    (kernel D at MG=15); then the flagship's attention maps in micro-batch
    and engine mode and top-k sampling (k=4) on the exact and the fused
    route. shrink(cfg) makes a CPU rehearsal's configurations small.
    Returns the phase's readings."""
    from tell_tpu_torch.bridge import init_captioner, init_roberta
    from tell_tpu_torch.config import CaptionerConfig
    from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
    from tell_tpu_torch.models.captioner import (build_contexts,
                                                 encode_contexts, generate)
    from tell_tpu_torch.models.decoder import (decoder_log_probs,
                                               decoder_step, decoder_top_k,
                                               init_decode_state)
    from tell_tpu_torch.serving import CaptionService
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    g = torch.Generator(device=dev).manual_seed(seed)
    roberta = RobertaEncoder(init_roberta(g, rcfg), rcfg)
    tok = _smoke_tokenizer(root, rcfg.vocab_size)
    rng = np.random.default_rng(seed)
    lines = []
    for i, path in enumerate(SIBLING_EXPTS):
        svc, reqs, line = _sibling_service(
            path, rcfg, roberta, tok, seed + 100 + i, dev, shrink, rng,
            articles, beam_articles)
        lines.append(line)
        if path.endswith("8_transformer_faces.yaml"):
            esvc = CaptionService(svc.model.tree(), roberta, svc.cfg, dev,
                                  tokenizer=tok, engine_slots=2,
                                  engine_beam=5, kv_cache="int8")
            try:
                _reset_counts()
                outs = [esvc.caption(r) for r in reqs[:2]]
                eng = _counts()
            finally:
                esvc.close()
            for out in outs:
                require("error" not in out and len(out["alternatives"]) == 4,
                        f"faces engine: {out}")
            mg = 5 * len(svc.cfg.decoder.contexts)
            log(f"phase 13: {line['expt']} through the int8 engine (2 slots,"
                f" beam 5): launches {eng}")
            if dev == "cuda":
                require(eng["decode_attention_q8_rows"].get(mg, 0) > 0
                        and eng["decode_attention"] == 0,
                        f"faces engine: kernel D never ran at MG={mg}, or A "
                        f"ran: {eng}")
            lines[-1]["engine_launches"] = eng
        svc.close()
        del svc
        if dev == "cuda":
            torch.cuda.empty_cache()

    # the flagship's attention maps, micro-batch and engine
    cfg = shrink(CaptionerConfig())
    params = init_captioner(torch.Generator(device=dev).manual_seed(seed),
                            cfg)
    micro = CaptionService(params, roberta, cfg, dev, tokenizer=tok,
                           max_batch=4, need_attention=True)
    eng = CaptionService(micro.model.tree(), roberta, cfg, dev,
                         tokenizer=tok, engine_slots=2, engine_beam=5,
                         engine_buckets=True, need_attention=True)
    arts = _quality_articles(root)
    reqs = [_sibling_request(rng, cfg, 120, rcfg.vocab_size),
            _sections_request(arts[1], 1)]
    t = time.perf_counter()
    try:
        m_out = [micro.caption(r) for r in reqs]
        e_out = [eng.caption(r) for r in reqs]
        worst = 0.0
        for r, m, e in zip(reqs, m_out, e_out):
            _check_maps(m, cfg, "micro-batch")
            _check_maps(e, cfg, "engine")
            batch, errors = eng._pack([r], bucketed=True)
            require(errors == [None], errors)
            again = eng.replay_payload(eng._encode_many(batch),
                                       m["token_ids"],
                                       batch["context_ids"][0])
            for name, maps in m["attns"].items():
                a, b = np.asarray(again["attns"][name]), np.asarray(maps)
                require(a.shape == b.shape, f"{name}: replayed maps "
                        f"{a.shape}, micro-batch {b.shape}")
                worst = max(worst, float(np.abs(a - b).max()))
        require(worst <= MAP_TOL, f"the engine's replayed maps differ from "
                f"the micro-batch maps by {worst:.3e} > {MAP_TOL}")
        maps_s = time.perf_counter() - t
        log(f"phase 13: flagship attention maps: micro-batch and engine "
            f"answers carry {len(m_out[0]['caption_words'])} and "
            f"{len(e_out[0]['caption_words'])} caption words, every map sums"
            f" to 1; the engine's replay of the micro-batch captions is "
            f"within {worst:.3e} of their maps (limit {MAP_TOL}); "
            f"{maps_s:.1f} s")

        # top-k sampling, k=4: repeatable, within each step's top-4 on
        # both routes, kernel E at k=4 on the fused route only; along the
        # fused route's tokens, its candidates (kernel E at the path's
        # shapes) held to the exact route's and to the full log-probs
        scfg = dataclasses.replace(cfg, sampling_topk=SAMPLING_K)
        batch, errors = micro._pack(reqs)
        require(errors == [None] * SAMPLING_ROWS, errors)
        tree = micro.model.tree()
        runs = {}
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            enc = encode_contexts(roberta.frozen(), cfg, tb)
            for fused in (False, True):
                _reset_counts()
                runs[fused] = [generate(
                    tree, scfg, enc, fused_topk=fused,
                    gen=torch.Generator(device=dev).manual_seed(seed + 7))
                    for _ in range(2)]
                runs[fused].append(_counts())
            contexts = build_contexts(tree, cfg, enc)
            outside = {}
            fused_err, fused_diff = 0.0, 0
            for fused in (False, True):
                ids = runs[fused][0]["token_ids"]
                state = init_decode_state(tree["decoder"], cfg.decoder,
                                          contexts, ids.shape[0])
                outside[fused] = 0
                for step in range(cfg.gen_len):
                    x, state = decoder_step(tree["decoder"], cfg.decoder,
                                            ids[:, step], state)
                    lp, top = decoder_top_k(tree["decoder"], cfg.decoder, x,
                                            SAMPLING_K)
                    live = ids[:, step + 1] != cfg.decoder.pad_id
                    hit = (top == ids[:, step + 1, None]).any(dim=1)
                    outside[fused] += int((live & ~hit).sum())
                    if not fused:
                        continue
                    flp, ftop = decoder_top_k(tree["decoder"], cfg.decoder,
                                              x, SAMPLING_K, fused_topk=True)
                    full = decoder_log_probs(tree["decoder"], cfg.decoder, x)
                    at_ids = full.gather(1, ftop)
                    torch.testing.assert_close(flp, lp, **TOPK_TOL)
                    torch.testing.assert_close(at_ids, flp, **TOPK_TOL)
                    fused_err = max(fused_err, (flp - lp).abs().max().item(),
                                    (at_ids - flp).abs().max().item())
                    fused_diff += int((ftop != top).sum())
        for fused, (a, b, counts) in runs.items():
            require(torch.equal(a["token_ids"], b["token_ids"]),
                    f"sampling (fused={fused}) is not repeatable")
            require(outside[fused] == 0, f"sampling (fused={fused}): "
                    f"{outside[fused]} sampled tokens outside their step's "
                    "exact top-4")
        same_rows = int((runs[False][0]["token_ids"]
                         == runs[True][0]["token_ids"]).all(dim=1).sum())
        exact_counts, fused_counts = runs[False][2], runs[True][2]
        if dev == "cuda":
            require(exact_counts["topk_logits"] == 0
                    and fused_counts["topk_logits_ks"].get(SAMPLING_K, 0) > 0,
                    f"kernel E: exact route {exact_counts['topk_logits']} "
                    f"launches, fused route by k "
                    f"{fused_counts['topk_logits_ks']}")
        n_live = int((runs[False][0]["token_ids"][:, 1:]
                      != cfg.decoder.pad_id).sum())
        log(f"phase 13: sampling_topk=4: {n_live} sampled tokens (exact "
            f"route), the same tokens for one generator seed twice on each "
            f"route, every one within its step's exact top-4 on both; "
            f"{same_rows}/{ids.shape[0]} rows equal across the routes; "
            f"along the fused route's tokens its top-4 log-probs within "
            f"{fused_err:.3e} of the exact route's and of the full "
            f"log-probs at its ids (limit {TOPK_TOL}), {fused_diff} ids "
            f"ordered otherwise; kernel E launches: exact route "
            f"{exact_counts['topk_logits']}, fused route "
            f"{fused_counts['topk_logits_ks']} by k")
    finally:
        micro.close()
        eng.close()
    seconds = time.perf_counter() - t_phase
    log(f"phase 13: the flagship's siblings in {seconds:.1f} s")
    return {"lines": lines, "sampling": fused_counts, "seconds": seconds}


# --quality: the quality loop's acceptance thresholds
QUALITY_BEFORE_CIDER_MAX = 5.0
QUALITY_AFTER_CIDER_MIN = 900.0
QUALITY_AFTER_EXACT_MIN = 30          # of the 32 training captions


# ---------------------------------------------------------------------------
# phase 14: images in -- the ResNet-152 tower and raw-image requests
# ---------------------------------------------------------------------------

IMAGES_DIR = os.path.join("tests", "fixtures", "images")
NEWS_PHOTOS = ("news_a_320x240_420.jpg", "news_b_200x300_420.jpg")
# card vs CPU: max |diff| / max |CPU grid| with fp32 convs; read 1.5e-6
# on the H100, against ~1e-3 for the same tower with its convs in TF32
GRID_REL_TOL = 1e-5
RESIDUAL_BN = 0.3      # each bottleneck's last batch-norm scale (see below)
TOWER_REPEATS = 20     # timed forwards per batch size


def _read_fixture(root: str, name: str) -> bytes:
    with open(os.path.join(root, IMAGES_DIR, name), "rb") as f:
        return f.read()


def _b64(data: bytes) -> str:
    import base64
    return base64.b64encode(data).decode()


def _check_digests(root: str, names, label: str) -> dict:
    """The fixtures `names` through decode_image (the port's JPEG and PNG
    decoders) and the crop against the sha256 Pillow gave (manifest.json);
    every refused one refused with its form named, every corrupt one
    refused as corrupt data, every twin equal to its baseline file.
    Returns the counts."""
    import hashlib
    from tell_tpu_torch.config import NotPortedError
    from tell_tpu_torch.data.images import decode_image, resize_shortest_crop
    with open(os.path.join(root, IMAGES_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    n = collections.Counter()
    for name in sorted(names):
        want = manifest[name]
        data = _read_fixture(root, name)
        if "refused" in want or "corrupt" in want:
            kind = "refused" if "refused" in want else "corrupt"
            try:
                decode_image(data)
            except ValueError as e:
                require((kind == "refused") == isinstance(e, NotPortedError)
                        and want[kind] in str(e) and "item 8" in str(e),
                        f"{label}: {name} refused as {e}")
                n[kind] += 1
                continue
            raise CheckFailed(f"{label}: {name} decoded; it must be refused")
        rgb = decode_image(data)
        crop = resize_shortest_crop(rgb)
        for what, arr in (("rgb", rgb), ("crop", crop)):
            got = hashlib.sha256(arr.tobytes()).hexdigest()
            require(got == want[f"{what}_sha256"],
                    f"{label}: {name} {what} sha256 {got} is not Pillow's "
                    f"{want[f'{what}_sha256']}")
        if "twin_of" in want:
            require(np.array_equal(rgb, decode_image(_read_fixture(
                root, want["twin_of"]))),
                f"{label}: {name} is not its baseline's bytes")
            n["twins"] += 1
        n["equal"] += 1
    return dict(n)


def _manifest_names(root: str) -> list:
    with open(os.path.join(root, IMAGES_DIR, "manifest.json")) as f:
        return sorted(json.load(f))


def _check_fixture_digests(root: str) -> dict:
    """Every committed fixture through the port's decoders and crop
    against the sha256 Pillow gave (manifest.json), refusals named
    (_check_digests). Returns counts and the host ms of decode and crop of
    the news photos."""
    from tell_tpu_torch.data import jpeg, png
    from tell_tpu_torch.data.images import resize_shortest_crop
    t = time.perf_counter()
    found = jpeg.load_library() is not None and png.load_library() is not None
    build_s = time.perf_counter() - t
    counts = _check_digests(root, _manifest_names(root), "phase 14")
    n_equal, n_refused = counts.get("equal", 0), counts.get("refused", 0)
    times = {}
    for name in NEWS_PHOTOS:
        data = _read_fixture(root, name)
        dec, crp = [], []
        for _ in range(20):
            t = time.perf_counter()
            rgb = jpeg.decode_jpeg(data)
            dec.append(time.perf_counter() - t)
            t = time.perf_counter()
            resize_shortest_crop(rgb)
            crp.append(time.perf_counter() - t)
        times[name] = {"decode_ms": 1e3 * float(np.median(dec)),
                       "crop_ms": 1e3 * float(np.median(crp)),
                       "shape": list(rgb.shape)}
    log(f"phase 14: the JPEG and PNG decoders (g++, {jpeg.SOURCE.name}, "
        f"{png.SOURCE.name}) {'loaded' if found else 'built'} in "
        f"{build_s:.2f} s; {n_equal} fixtures' RGB and 224-crop sha256 equal "
        f"to Pillow's, {n_refused} refused forms named, "
        f"{counts.get('corrupt', 0)} corrupt files refused; host ms per "
        f"photo (median of 20): "
        + json.dumps(times))
    return {"equal": n_equal, "refused": n_refused, "host": times}


def _resnet_tower(seed: int, cfg) -> dict:
    """ResNet weights from the seed (init_resnet on the CPU, so the card
    and the CPU hold the same numbers), each bottleneck's last batch-norm
    scale set to RESIDUAL_BN: with every scale at init_resnet's 1 the grid
    of ResNet-152 grows to ~1e8 through its 50 residual sums; at 0.3 its
    values are of the order a trained tower gives (mean ~1, max ~10)."""
    from tell_tpu_torch.bridge import init_resnet
    tree = init_resnet(torch.Generator().manual_seed(seed), cfg)
    for stage in tree["stages"]:
        for block in stage:
            block["bn3"]["scale"].fill_(RESIDUAL_BN)
    return tree


def _torchvision_state(tree: dict) -> dict:
    """A torchvision-named state dict holding the tree's weights (OIHW
    convs; batch norm as weight = scale, bias, running mean 0 and variance
    1, which the converter folds back within one rounding)."""
    sd = {}

    def conv(name, w):
        sd[name + ".weight"] = w.permute(3, 2, 0, 1).contiguous()

    def bn(name, p):
        sd[name + ".weight"] = p["scale"].clone()
        sd[name + ".bias"] = p["bias"].clone()
        sd[name + ".running_mean"] = torch.zeros_like(p["scale"])
        sd[name + ".running_var"] = torch.ones_like(p["scale"])
        sd[name + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1", tree["stem"]["conv"])
    bn("bn1", tree["stem"]["bn"])
    for s, stage in enumerate(tree["stages"]):
        for b, block in enumerate(stage):
            pre = f"layer{s + 1}.{b}."
            for k in (1, 2, 3):
                conv(pre + f"conv{k}", block[f"conv{k}"])
                bn(pre + f"bn{k}", block[f"bn{k}"])
            if "down_conv" in block:
                conv(pre + "downsample.0", block["down_conv"])
                bn(pre + "downsample.1", block["down_bn"])
    return sd


def _tower_ms(params, cfg, x, n=TOWER_REPEATS) -> float:
    """ms per forward of x (CUDA events over n forwards after 3 warm-ups)."""
    from tell_tpu_torch.models.backbones.resnet import resnet_forward
    with torch.inference_mode():
        for _ in range(3):
            resnet_forward(params, cfg, x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            resnet_forward(params, cfg, x)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _check_tower(seed, rn_cfg, crops, dev, card) -> dict:
    """The tower from the seed on `dev` against the CPU on the news photos'
    crops; the TF32 switch; on the card, the same forward with its fp32 pin
    taken out under TF32 (the control GRID_REL_TOL must tell apart), ms
    per image at B=1 and B=16 in the tower's NCHW layout and in a
    channels-last copy, and the peak memory."""
    from tell_tpu_torch.bridge import to_torch, tree_map
    from tell_tpu_torch.models.backbones import resnet
    from tell_tpu_torch.models.backbones.resnet import (
        prepare_resnet, preprocess_image, resnet_forward)
    t = time.perf_counter()
    tree_cpu = _resnet_tower(seed, rn_cfg)
    tower = prepare_resnet(to_torch(tree_cpu, dev))
    init_s = time.perf_counter() - t
    x = preprocess_image(torch.from_numpy(crops) / 255.0)
    with torch.inference_mode():
        got = resnet_forward(tower, rn_cfg, x.to(dev)).cpu()
        t = time.perf_counter()
        ref = resnet_forward(prepare_resnet(tree_cpu), rn_cfg, x)
        cpu_s = time.perf_counter() - t
    require(got.shape == (len(crops), 49, rn_cfg.out_dim), got.shape)
    require(bool(torch.isfinite(got).all()), "phase 14: non-finite grid")
    abs_err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel_err = abs_err / scale
    require(rel_err <= GRID_REL_TOL, f"phase 14: the card's grid is "
            f"{rel_err:.3e} (max abs {abs_err:.3e}) off the CPU's")
    # the TF32 trap: PyTorch lets cuDNN use TF32 by default (phase 1 turned
    # it off); the tower pins fp32 itself, so the switch changes no bit
    before = torch.backends.cudnn.allow_tf32
    grids, stem = {}, {}
    with torch.inference_mode():
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            grids[flag] = resnet_forward(tower, rn_cfg, x.to(dev)).cpu()
            # an unpinned conv (the stem's) under the same switch
            stem[flag] = torch.nn.functional.conv2d(
                x.to(dev).permute(0, 3, 1, 2), tower["stem"]["conv"],
                stride=2, padding=3).cpu()
    torch.backends.cudnn.allow_tf32 = before
    require(torch.equal(grids[True], grids[False]),
            "phase 14: the grid changed with cudnn.allow_tf32")
    stem_diff = float((stem[True] - stem[False]).abs().max())
    out = {"abs_err": abs_err, "rel_err": rel_err, "max_abs_grid": scale,
           "tf32_bit_equal": True, "unpinned_stem_tf32_diff": stem_diff,
           "init_s": init_s, "cpu_forward_s": cpu_s}
    if card:
        # the control: the whole tower in TF32, its pin taken out
        pin = resnet.fp32_math
        resnet.fp32_math = contextlib.nullcontext
        try:
            torch.backends.cudnn.allow_tf32 = True
            with torch.inference_mode():
                tf32 = resnet_forward(tower, rn_cfg, x.to(dev)).cpu()
        finally:
            resnet.fp32_math = pin
            torch.backends.cudnn.allow_tf32 = before
        out["tf32_tower_rel_err"] = float((tf32 - ref).abs().max()) / scale
        require(out["tf32_tower_rel_err"] > GRID_REL_TOL,
                f"phase 14: the TF32 tower is {out['tf32_tower_rel_err']:.3e}"
                f" off the CPU, within GRID_REL_TOL {GRID_REL_TOL}: the "
                "limit cannot tell it from the fp32 tower")
        channels_last = tree_map(
            lambda w: (w.contiguous(memory_format=torch.channels_last)
                       if w.dim() == 4 else w), tower)
        x16 = x.repeat(8, 1, 1, 1)[:16].to(dev)
        ms = {}
        for label, params in (("nchw", tower),
                              ("channels_last", channels_last)):
            for B in (1, 16):
                ms[f"{label}_b{B}"] = _tower_ms(params, rn_cfg, x16[:B]) / B
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.inference_mode():
            resnet_forward(tower, rn_cfg, x16)
        torch.cuda.synchronize()
        out["ms_per_image"] = ms
        out["peak_mib_b16"] = torch.cuda.max_memory_allocated() / 2 ** 20
        out["peak_above_weights_mib_b16"] = (
            torch.cuda.max_memory_allocated() - base) / 2 ** 20
    log(f"phase 14 ({card or dev}): ResNet{sum(rn_cfg.block_counts) * 3 + 2}"
        f" width {rn_cfg.width} from seed {seed} (init {init_s:.1f} s): "
        f"grid of {len(crops)} news photos on {dev} vs CPU max abs err "
        f"{abs_err:.3e}, rel {rel_err:.3e} (of max |grid| {scale:.3f}; "
        f"limit {GRID_REL_TOL}); cudnn.allow_tf32 on and off: grids bit "
        f"equal (an unpinned stem conv moves by {stem_diff:.3e} under "
        "TF32)" + (f"; the tower unpinned under TF32 rel "
                   f"{out['tf32_tower_rel_err']:.3e}; ms per image "
                   + json.dumps(out["ms_per_image"])
                   + f"; peak memory at B=16 {out['peak_mib_b16']:.1f} MiB "
                   f"({out['peak_above_weights_mib_b16']:.1f} MiB above "
                   "what was allocated before)" if card else ""))
    return {"tree": tree_cpu, "tower": tower, **out}


def _engine_vs_one_shot(esvc, params, cfg, req, body, label):
    """The engine's answer to req against a one-shot beam 5 on the features
    the engine encodes for it: equal, or a near tie within TIE_TOL where
    the two searches split (phase 8's rule, ROADMAP section 3)."""
    from tell_tpu_torch.config import with_article_len
    from tell_tpu_torch.models.beam import beam_search
    batch, errors = esvc._pack([req])
    require(errors == [None], errors)
    cfg_w = with_article_len(cfg, batch["context_ids"].shape[1])
    with torch.inference_mode():
        enc = esvc._encode_many(batch)
        with _beam_trace() as steps:
            ref = beam_search(params, cfg_w, enc, beam_size=5)
    ref_ids = ref["token_ids"][0].cpu().numpy()
    paths = np.stack([b["token_ids"] for b in [body] + body["alternatives"]])
    if np.array_equal(paths[0], ref_ids[0]):
        return None
    split = _beam_split(steps, paths)
    gap = math.inf if split is None else split["gap"]
    log(f"{label}: the engine's best beam differs from the one-shot beam "
        f"search; gap where they split {gap:.3e} (split {split})")
    require(split is not None and gap <= TIE_TOL,
            f"{label}: engine answer off the one-shot beam search "
            f"(gap {gap:.3e}, near tie allowed: {TIE_TOL})")
    return gap


def _same_features(a: dict, b: dict, keys) -> bool:
    """The packed features `keys` of two packs equal bit for bit (NaN rows,
    absent faces and objects, in the same places)."""
    return all(np.array_equal(a[k], b[k], equal_nan=True) for k in keys)


def _photo_features(towers, data: bytes, keys, max_faces: int,
                    max_objects: int) -> dict:
    """The photo's features `keys` by the phases' own route, not through
    VisionPipeline: the grid of its 224 crop (decode_image,
    resize_shortest_crop, image_grid); on its letterbox canvas, the
    FaceNet rows of the faces detect_faces keeps and the pooled ResNet
    rows of nms_fixed's detections (_stage_rows), NaN at the absent
    rows."""
    from tell_tpu_torch.data.images import decode_image, resize_shortest_crop
    from tell_tpu_torch.models.backbones.mtcnn import MTCNNConfig, detect_faces
    from tell_tpu_torch.models.backbones.resnet import image_grid
    from tell_tpu_torch.models.backbones.yolov3 import (nms_fixed,
                                                        yolov3_forward,
                                                        yolov3_spp_module_defs)
    from tell_tpu_torch.serving.vision import _INV_255, DET_CANVAS, letterbox
    img = decode_image(data)
    out = {}
    if "image_grid" in keys:
        out["image_grid"] = image_grid(towers["resnet"], towers["resnet_cfg"],
                                       resize_shortest_crop(img).astype(
                                           np.float32))
    if "face_embeds" in keys or "obj_embeds" in keys:
        dev = towers["resnet"]["stem"]["conv"].device
        c = torch.from_numpy(letterbox(img.astype(np.float32),
                                       DET_CANVAS)[0])
        with torch.inference_mode():
            fb, _, fv = detect_faces(towers["mtcnn"], c.to(dev),
                                     MTCNNConfig(max_faces=max_faces))
            dets = yolov3_forward(towers["yolov3"],
                                  towers.get("yolov3_defs")
                                  or yolov3_spp_module_defs(),
                                  c.to(dev)[None] * _INV_255)[0]
            ob, _, ov = nms_fixed(dets, 0.3, 0.6, max_det=max_objects)
        rows = _stage_rows(towers, c, fb[fv], ob[ov])
        for key, valid, r in (("face_embeds", fv, rows[0]),
                              ("obj_embeds", ov, rows[1])):
            full = np.full((len(valid), r.shape[1]), np.nan, np.float32)
            full[valid.cpu().numpy()] = r.numpy()
            out[key] = full
    return {k: out[k] for k in keys}


def _check_image_service(seed, cfg, rcfg, towers, dev, root,
                         keys=("image_grid",), label="phase 14") -> dict:
    """The flagship micro-batch service with the vision towers: a photo as
    image_b64, as sections[pos].image_data, and the same texts with the
    photo's features `keys` (computed by _photo_features, outside the
    service's pipeline) sent precomputed; bad photos in one micro-batch;
    then the engine (beam 5) on the same weights."""
    from tell_tpu_torch.bridge import init_captioner, init_roberta
    from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
    from tell_tpu_torch.serving import CaptionService, serve
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 14)
    params = init_captioner(g, cfg)
    roberta = RobertaEncoder(init_roberta(g, rcfg), rcfg)
    tok = _smoke_tokenizer(root, rcfg.vocab_size)
    svc = CaptionService(params, roberta, cfg, dev, tokenizer=tok,
                         max_batch=8, towers=towers)
    stages = {"image_grid": svc.vision.has_grid,
              "face_embeds": svc.vision.has_faces,
              "obj_embeds": svc.vision.has_objects}
    require(all(stages[k] for k in keys),
            f"{label}: the service's stages are {stages}")
    photos = {n: _read_fixture(root, n) for n in NEWS_PHOTOS}
    feats = {n: _photo_features(towers, d, keys, svc.vision.max_faces,
                                svc.vision.max_objects)
             for n, d in photos.items()}

    def given(name):
        return {k: feats[name][k].tolist() for k in keys}
    arts = _quality_articles(root)
    text = "\n".join(s["text"] for s in arts[1]["parsed_section"]
                     if s["type"] == "paragraph")
    art = arts[0]
    pos = next(i for i, s in enumerate(art["parsed_section"])
               if s["type"] == "caption")
    scraped = _sections_request(art, pos)
    scraped["sections"][pos]["image_data"] = _b64(photos[NEWS_PHOTOS[1]])
    reqs = {
        "photo": {"context": text, "image_b64": _b64(
            photos[NEWS_PHOTOS[0]])},
        "features": {"context": text, **given(NEWS_PHOTOS[0])},
        "sections": scraped,
        "sections_features": {"context": svc._sections_text(scraped),
                              **given(NEWS_PHOTOS[1])},
    }
    for a, b in (("photo", "features"), ("sections", "sections_features")):
        pa, ea = svc._pack([reqs[a]])
        pb, eb = svc._pack([reqs[b]])
        require(ea == eb == [None], (ea, eb))
        require(np.array_equal(pa["context_ids"], pb["context_ids"]),
                f"{label}: {a} and {b} pack other ids")
        require(_same_features(pa, pb, keys)
                and all(np.nanmax(np.abs(pa[k])) > 0 for k in keys),
                f"{label}: the {a} request's packed {keys} are not its "
                "photo's")
    log(f"{label}: flagship service with the towers on {dev} in "
        f"{time.perf_counter() - t0:.1f} s; the image_b64 and sections "
        f"requests pack their photo's {', '.join(keys)} bit for bit")

    httpd = serve(svc, port=0, block=False)
    port = httpd.server_address[1]
    status, body = _post(port, "/caption", reqs["features"])   # warm-up
    require(status == 200 and "error" not in body, body)
    _reset_counts()
    answers, lat = {}, {}
    for name, req in reqs.items():
        t = time.perf_counter()
        status, body = _post(port, "/caption", req)
        lat[name] = time.perf_counter() - t
        require(status == 200 and "error" not in body, (name, body))
        answers[name] = body["token_ids"]
    counts = _counts()
    require(answers["photo"] == answers["features"],
            f"{label}: the image_b64 and precomputed answers differ")
    require(answers["sections"] == answers["sections_features"],
            f"{label}: sections and its precomputed answers differ")
    if dev == "cuda":
        for name in ("decode_attention", "encoder_attention"):
            require(counts[name] > 0, f"{label}: {name} never launched")
    # bad photos share a micro-batch with good requests
    with open(os.path.join(root, IMAGES_DIR,
                           "refused_progressive_unrefined.jpg"), "rb") as f:
        progressive = _b64(f.read())
    mixed = [reqs["photo"], {"context": text, "image_b64": "%%% bad"},
             reqs["features"], {"context": text, "image_b64": progressive},
             reqs["sections"], reqs["sections_features"]]
    out = svc._run(mixed)
    for i in (1, 3):
        require(out[i].get("error", "").startswith("bad request image:"),
                f"{label}: bad photo {i} answered {out[i]}")
    require("progressive" in out[3]["error"], out[3]["error"])
    for i in (0, 2, 4, 5):
        require("error" not in out[i], (i, out[i]))
    require(out[0]["token_ids"] == out[2]["token_ids"]
            and out[4]["token_ids"] == out[5]["token_ids"],
            f"{label}: the mixed micro-batch's photo and precomputed "
            "answers differ")
    status, _ = _post(port, "/shutdown", {})
    require(status == 200, f"/shutdown answered {status}")
    httpd.server_close()
    log(f"{label}: micro-batch /caption: image_b64 == its precomputed "
        f"features and sections == its window + features, token ids; "
        f"latencies (s) "
        + json.dumps({k: round(v, 3) for k, v in lat.items()})
        + f"; kernel A launches {counts['decode_attention']}, kernel B "
        f"{counts['encoder_attention']}; a bad base64 and a refused "
        f"progressive JPEG in a micro-batch of 6: {out[1]['error'][:60]!r}, "
        f"{out[3]['error'][:80]!r}; the other 4 answered")

    esvc = CaptionService(svc.model.tree(), roberta, cfg, dev,
                          tokenizer=tok, engine_slots=4, engine_beam=5,
                          towers=towers)
    try:
        eng = {}
        _reset_counts()
        for name, req in reqs.items():
            body = esvc.caption(req)
            require("error" not in body, (name, body))
            eng[name] = body
        n1 = _counts()
        require(eng["photo"]["token_ids"] == eng["features"]["token_ids"]
                and eng["sections"]["token_ids"]
                == eng["sections_features"]["token_ids"],
                f"{label}: the engine's photo and precomputed answers "
                "differ")
        gaps = {name: _engine_vs_one_shot(esvc, esvc.model.tree(), cfg,
                                          reqs[name], eng[name], label)
                for name in ("photo", "sections")}
    finally:
        esvc.close()
    eng_counts = {k: n1[k] for k in ("decode_attention",
                                     "encoder_attention")}
    if dev == "cuda":
        for name, n in eng_counts.items():
            require(n > 0, f"{label}: {name} never launched in the engine")
    log(f"{label}: engine (4 slots, beam 5): the photo and precomputed "
        f"requests answer the same beams; vs a one-shot beam 5 on the same "
        f"features: {gaps} (None: equal); kernel A launches "
        f"{eng_counts['decode_attention']}, kernel B "
        f"{eng_counts['encoder_attention']}")
    svc.close()
    return {"micro_batch_launches": {k: counts[k] for k in
                                     ("decode_attention",
                                      "encoder_attention")},
            "engine_launches": eng_counts, "engine_gaps": gaps,
            "latency_s": lat}


def _check_image_cli(rn_cfg, tree, dev, root) -> dict:
    """convert_towers --resnet on a torchvision-named state dict of the
    tower, then preprocess over an images_dir holding one fixture photo as
    the first article's <hash>.jpg: every example written carries the
    grid the converted tower gives that photo on `dev`, in fp16."""
    from tell_tpu_torch.config_io import load_experiment
    from tell_tpu_torch.data.images import resize_shortest_crop
    from tell_tpu_torch.data.jpeg import decode_jpeg
    from tell_tpu_torch.data.records import ShardReader
    from tell_tpu_torch.models.backbones.resnet import image_grid, load_tower
    from tell_tpu_torch.tools.gen_quality_corpus import (
        FEATURES_SEED, read_articles, write_features)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_images_")
    try:
        over = _cli_overrides(tmp)
        exp = load_experiment(QUALITY_EXPT, json.dumps(over))
        arts = read_articles(exp.data.articles_jsonl)
        write_features(arts, os.path.join(tmp, "features"), FEATURES_SEED)
        grids = os.path.join(tmp, "features", "grids")
        h = next(s["hash"] for s in arts[0]["parsed_section"]
                 if s["type"] == "caption")
        for name in os.listdir(grids):    # no precomputed grid: one photo
            os.remove(os.path.join(grids, name))
        photo = _read_fixture(root, NEWS_PHOTOS[0])
        with open(os.path.join(grids, h + ".jpg"), "wb") as f:
            f.write(photo)
        pth = os.path.join(tmp, "resnet152.pth")
        torch.save(_torchvision_state(tree), pth)
        _, convert_s, _ = _cli(["--out", os.path.join(tmp, "towers"),
                                "--resnet", pth], "phase 14",
                               "tell_tpu_torch.tools.convert_towers")
        out, pre_s, _ = _cli(["preprocess", QUALITY_EXPT, "-o",
                              json.dumps(over), "-s", "train", "--device",
                              dev], "phase 14")
        n = out["examples"]
        require(n >= 1, f"phase 14: preprocess wrote {n} examples")
        want = image_grid(load_tower(os.path.join(tmp, "towers",
                                                  "resnet152"), dev),
                          rn_cfg, resize_shortest_crop(
                              decode_jpeg(photo)).astype(np.float32))
        want16 = want.astype(np.float16)
        shards = sorted(p for p in os.listdir(exp.data.shards_dir)
                        if p.startswith("train-"))
        seen = 0
        for p in shards:
            reader = ShardReader(os.path.join(exp.data.shards_dir, p))
            for i in range(len(reader)):
                got = reader[i]["image_grid"]
                require(got.dtype == np.float16
                        and np.array_equal(got, want16),
                        f"phase 14: shard {p}[{i}]'s grid is not the "
                        "photo's grid in fp16")
                seen += 1
        require(seen == n, (seen, n))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 14: convert_towers --resnet in {convert_s:.1f} s, "
        f"preprocess --device {dev} over one <hash>.jpg in {pre_s:.1f} s: "
        f"{n} examples, each image_grid equal to the photo's grid in fp16")
    return {"examples": n}


def phase_images(seed: int, card: str, dev: str = "cuda", cfg=None,
                 rcfg=None) -> dict:
    """Phase 14 (see the module docstring): the fixtures' decode and crop
    on the host, ResNet-152 card vs CPU with its times and the TF32
    switch, the flagship service (micro-batch and engine) on raw photos,
    and convert_towers + preprocess through the command line. cfg / rcfg
    default to the flagship and RoBERTa-large (a CPU rehearsal passes
    small ones: an image context of 49 x 2048 and an article context of
    the RoBERTa's width)."""
    from tell_tpu_torch.config import CaptionerConfig
    from tell_tpu_torch.data.images import resize_shortest_crop
    from tell_tpu_torch.data.jpeg import decode_jpeg
    from tell_tpu_torch.models.backbones.resnet import ResNetConfig
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    cfg = cfg or CaptionerConfig()
    rcfg = rcfg or RobertaConfig.large()
    rn_cfg = ResNetConfig.resnet152()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = {"fixtures": _check_fixture_digests(root)}
    crops = np.stack([resize_shortest_crop(decode_jpeg(
        _read_fixture(root, n))) for n in NEWS_PHOTOS]).astype(np.float32)
    tower = _check_tower(seed, rn_cfg, crops, dev,
                         card if dev == "cuda" else None)
    tree, prepared = tower.pop("tree"), tower.pop("tower")
    res["tower"] = tower
    res["service"] = _check_image_service(
        seed, cfg, rcfg, {"resnet": prepared, "resnet_cfg": rn_cfg}, dev,
        root)
    res["cli"] = _check_image_cli(rn_cfg, tree, dev, root)
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 14: done in {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 15: faces and objects from a photo -- MTCNN + FaceNet, YOLOv3-SPP
# with pooled-ResNet crops, on the letterbox canvas
# ---------------------------------------------------------------------------

# At random init almost no box passes MTCNN's 0.6 / 0.7 / 0.7: each net's
# face logit bias is raised by FACE_BIAS (the news photos then show 7 and
# 13 faces). YOLOv3-SPP's 75 convs at init_yolov3's batch-norm scale 1
# reach head logits of ~7 and boxes of ~1e10 px; every scale at YOLO_BN
# (RESIDUAL_BN before each shortcut) keeps them near 0.5 and the boxes
# inside ~700 px; OBJ_BIAS on the objectness logits puts the scores of the
# 256 candidates well above conf 0.3. The served thresholds stay as they
# are.
FACE_BIAS = 3.0
YOLO_BN = 0.85
OBJ_BIAS = 1.0
# card vs CPU: each box within BOX_TOL_PX canvas pixels (read 0.0007 to
# 0.0023 on the H100); face and object rows on the same boxes within
# FEATURE_REL_TOL (read 2e-7 to 6.5e-7, against 5.5e-4 to 6.9e-4 with the
# towers in TF32)
BOX_TOL_PX = 0.02
FEATURE_REL_TOL = 1e-5
CPU_OBJECT_ROWS = 16     # object rows the CPU embeds (ResNet-152 on the CPU)
STAGE_REPEATS = 5        # timed calls per stage and photo, after 2 warm-ups


def _vision_towers(seed: int) -> dict:
    """MTCNN, FaceNet and YOLOv3-SPP trees (tell_tpu's layout) from the
    seed on the CPU, so the card and the CPU hold the same numbers, with
    the offsets above; phase 14's ResNet-152."""
    from tell_tpu_torch.bridge import init_facenet, init_mtcnn, init_yolov3
    from tell_tpu_torch.models.backbones.facenet import FaceNetConfig
    from tell_tpu_torch.models.backbones.resnet import ResNetConfig
    from tell_tpu_torch.models.backbones.yolov3 import yolov3_spp_module_defs
    g = torch.Generator().manual_seed(seed + 15)
    mtcnn = init_mtcnn(g)
    for net, name in (("pnet", "conv4_1"), ("rnet", "dense5_1"),
                      ("onet", "dense6_1")):
        mtcnn[net][name][1][1] += FACE_BIAS
    defs = yolov3_spp_module_defs()
    yolo = init_yolov3(g, defs)
    for i, d in enumerate(defs):
        if d["type"] == "convolutional" and d["bn"]:
            yolo["convs"][i]["scale"].fill_(YOLO_BN)
        elif d["type"] == "shortcut":
            yolo["convs"][i - 1]["scale"].fill_(RESIDUAL_BN)
        elif d["type"] == "yolo":
            yolo["convs"][i - 1]["b"].view(3, -1)[:, 4] += OBJ_BIAS
    return {"mtcnn": mtcnn, "facenet": init_facenet(g, FaceNetConfig()),
            "yolov3": yolo,
            "resnet": _resnet_tower(seed, ResNetConfig.resnet152())}


def _prepared_towers(trees: dict, dev) -> dict:
    """VisionPipeline's frozen dict: the trees on `dev` in their forwards'
    layouts."""
    from tell_tpu_torch.bridge import to_torch
    from tell_tpu_torch.models.backbones import facenet, mtcnn, yolov3
    from tell_tpu_torch.models.backbones.resnet import (ResNetConfig,
                                                        prepare_resnet)
    return {"mtcnn": mtcnn.prepare_mtcnn(to_torch(trees["mtcnn"], dev)),
            "facenet": facenet.prepare_facenet(to_torch(trees["facenet"],
                                                        dev)),
            "yolov3": yolov3.prepare_yolov3(to_torch(trees["yolov3"], dev)),
            "resnet": prepare_resnet(to_torch(trees["resnet"], dev)),
            "resnet_cfg": ResNetConfig.resnet152()}


def _match_boxes(got, want, label) -> dict:
    """Each of got's boxes within BOX_TOL_PX of a distinct one of want's
    (the same count): the largest distance and the rows that moved."""
    got, want = got.double().cpu(), want.double().cpu()
    require(len(got) == len(want), f"{label}: {len(got)} boxes on the card, "
            f"{len(want)} on the CPU")
    free = list(range(len(want)))
    moved, worst = [], 0.0
    for i in range(len(got)):
        d = (want[free] - got[i]).abs().amax(dim=1)
        j = int(torch.argmin(d)) if free else -1
        require(j >= 0 and float(d[j]) <= BOX_TOL_PX,
                f"{label}: card box {i} {got[i].tolist()} is "
                f"{float(d[j]) if j >= 0 else math.inf:.3e} px from the "
                "nearest CPU box")
        worst = max(worst, float(d[j]))
        if free[j] != i:
            moved.append((i, free[j]))
        free.pop(j)
    if moved:
        log(f"{label}: card rows at other places than the CPU's (card, "
            f"CPU): {moved}")
    return {"n": len(got), "max_px": worst, "moved": moved}


def _rel(got, want) -> float:
    return float((got.cpu() - want).abs().max() / want.abs().max())


def _stage_rows(towers, canvas, faces_boxes, obj_boxes):
    """The FaceNet rows of faces_boxes and the pooled ResNet rows of
    obj_boxes, cut from the canvas on the towers' device."""
    from tell_tpu_torch.models.backbones.facenet import facenet_forward
    from tell_tpu_torch.models.backbones.mtcnn import extract_faces
    from tell_tpu_torch.models.backbones.resnet import (preprocess_image,
                                                        resnet_forward)
    from tell_tpu_torch.models.backbones.yolov3 import crop_and_resize
    from tell_tpu_torch.serving.vision import _INV_255
    dev = towers["facenet"]["last_linear"].device
    with torch.inference_mode():
        c = canvas.to(dev)
        faces = facenet_forward(towers["facenet"], extract_faces(
            c, faces_boxes.to(dev)))
        objs = resnet_forward(towers["resnet"], towers["resnet_cfg"],
                              preprocess_image(crop_and_resize(
                                  c, obj_boxes.to(dev), 224) * _INV_255),
                              pool=True)
    return faces.cpu(), objs.cpu()


@contextlib.contextmanager
def _tf32_towers():
    """Every vision tower's fp32 pin taken out, TF32 on (the control)."""
    from tell_tpu_torch.models.backbones import (facenet, mtcnn, resnet,
                                                 yolov3)
    mods = (facenet, mtcnn, resnet, yolov3)
    pins = [m.fp32_math for m in mods]
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    for m in mods:
        m.fp32_math = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        for m, pin in zip(mods, pins):
            m.fp32_math = pin
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def _check_photo(name, canvas, card, cpu, dev) -> dict:
    """One photo's canvas through MTCNN and YOLOv3 + NMS on `dev` and on
    the CPU, the rows on the same boxes, the served stages' rows."""
    from tell_tpu_torch.models.backbones.mtcnn import MTCNNConfig, detect_faces
    from tell_tpu_torch.models.backbones.yolov3 import (nms_fixed,
                                                        yolov3_forward,
                                                        yolov3_spp_module_defs)
    from tell_tpu_torch.serving.vision import _INV_255, VisionPipeline
    defs = yolov3_spp_module_defs()
    c = torch.from_numpy(canvas)
    out = {}
    with torch.inference_mode():
        fd = detect_faces(card["mtcnn"], c.to(dev), MTCNNConfig())
        fc = detect_faces(cpu["mtcnn"], c, MTCNNConfig())
        out["faces"] = _match_boxes(fd[0][fd[2]], fc[0][fc[2]],
                                    f"phase 15: {name} faces")
        dd = yolov3_forward(card["yolov3"], defs, c.to(dev)[None] * _INV_255)
        dc = yolov3_forward(cpu["yolov3"], defs, c[None] * _INV_255)
        out["dets_rel_err"] = _rel(dd, dc)
        od = nms_fixed(dd[0], 0.3, 0.6, max_det=64)
        oc = nms_fixed(dc[0], 0.3, 0.6, max_det=64)
        out["objects"] = _match_boxes(od[0][od[2]], oc[0][oc[2]],
                                      f"phase 15: {name} objects")
    require(out["faces"]["n"] >= 1 and out["objects"]["n"] >= 2,
            f"phase 15: {name}: {out['faces']['n']} faces, "
            f"{out['objects']['n']} objects")
    fb = fd[0][fd[2]][:4]
    ob = od[0][od[2]][:CPU_OBJECT_ROWS]
    rows = _stage_rows(card, c, fb, ob)
    ref = _stage_rows(cpu, c, fb.cpu(), ob.cpu())
    out["face_rel_err"] = _rel(rows[0], ref[0])
    out["obj_rel_err"] = _rel(rows[1], ref[1])
    for what in ("face", "obj"):
        require(out[f"{what}_rel_err"] <= FEATURE_REL_TOL,
                f"phase 15: {name}: the card's {what} rows are "
                f"{out[what + '_rel_err']:.3e} off the CPU's on the same "
                f"boxes (limit {FEATURE_REL_TOL})")
    # the served stages give those rows, NaN past the detections
    vp = VisionPipeline(card)
    faces, objs = vp.faces(canvas), vp.objects(canvas)
    nf, no = len(fb), int(od[2].sum())
    require(np.isnan(faces[nf:]).all() and np.isnan(objs[no:]).all()
            and not np.isnan(faces[:nf]).any()
            and not np.isnan(objs[:no]).any(),
            f"phase 15: {name}: the stages' NaN rows are not the absent "
            "ones")
    out["stage_face_rel_err"] = _rel(torch.from_numpy(faces[:nf]), ref[0])
    out["stage_obj_rel_err"] = _rel(torch.from_numpy(objs[:len(ob)]), ref[1])
    for what in ("face", "obj"):
        require(out[f"stage_{what}_rel_err"] <= FEATURE_REL_TOL,
                f"phase 15: {name}: the served {what} rows are "
                f"{out['stage_' + what + '_rel_err']:.3e} off the CPU's")
    if dev == "cuda":
        with _tf32_towers():
            tf32 = _stage_rows(card, c, fb, ob)
        out["tf32_face_rel_err"] = _rel(tf32[0], ref[0])
        out["tf32_obj_rel_err"] = _rel(tf32[1], ref[1])
        for what in ("face", "obj"):
            require(out[f"tf32_{what}_rel_err"] > FEATURE_REL_TOL,
                    f"phase 15: {name}: the TF32 {what} rows are "
                    f"{out['tf32_' + what + '_rel_err']:.3e} off the CPU, "
                    f"within FEATURE_REL_TOL {FEATURE_REL_TOL}: the limit "
                    "cannot tell them from the fp32 rows")
    return out


def _sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _stage_ms(fn, dev, n=STAGE_REPEATS) -> float:
    """ms per call of fn() over n calls after 2 warm-ups: CUDA events on
    the card (each call ends on the host, so they span its host work
    too), the host clock on the CPU."""
    for _ in range(2):
        fn()
    if dev != "cuda":
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) * 1e3 / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _nms_share(vp, canvas, dev) -> dict:
    """Each stage once with every NMS call timed (synchronised before and
    after), beside the stage's own time in that run."""
    from tell_tpu_torch.models.backbones import mtcnn
    from tell_tpu_torch.serving import vision
    spent = {"ms": 0.0}

    def timed(fn):
        def wrapper(*a, **k):
            _sync(dev)
            t = time.perf_counter()
            r = fn(*a, **k)
            _sync(dev)
            spent["ms"] += (time.perf_counter() - t) * 1e3
            return r
        return wrapper
    out = {}
    for stage, mod, name in (("faces", mtcnn, "nms_mask"),
                             ("objects", vision, "nms_fixed")):
        orig = getattr(mod, name)
        setattr(mod, name, timed(orig))
        try:
            spent["ms"] = 0.0
            _sync(dev)
            t = time.perf_counter()
            getattr(vp, stage)(canvas)
            total = (time.perf_counter() - t) * 1e3
        finally:
            setattr(mod, name, orig)
        out[stage] = {"nms_ms": spent["ms"], "stage_ms": total,
                      "share": spent["ms"] / total}
    return out


def _time_stages(card, photos, dev) -> dict:
    """ms per photo of the letterbox (host), each stage, and process();
    the NMS share; each stage's and one process()'s peak memory above
    what was allocated before it (the towers, when phase 15 runs
    alone)."""
    from tell_tpu_torch.data.jpeg import decode_jpeg
    from tell_tpu_torch.serving.vision import (DET_CANVAS, VisionPipeline,
                                               center_crop_224, letterbox)
    vp = VisionPipeline(card)
    res = {}
    for name, data in photos.items():
        img = decode_jpeg(data).astype(np.float32)
        canvas, _ = letterbox(img, DET_CANVAS)
        crop = center_crop_224(img)
        req = {"image_b64": _b64(data)}
        ms = {"letterbox": _stage_ms(lambda: letterbox(img, DET_CANVAS),
                                     dev),
              "grid": _stage_ms(lambda: vp.grid(crop), dev),
              "faces": _stage_ms(lambda: vp.faces(canvas), dev),
              "objects": _stage_ms(lambda: vp.objects(canvas), dev),
              "process": _stage_ms(lambda: vp.process(req), dev)}
        res[name] = {"ms": ms, "nms": _nms_share(vp, canvas, dev)}
        if dev == "cuda":
            peak = {}
            for stage, fn in (("grid", lambda: vp.grid(crop)),
                              ("faces", lambda: vp.faces(canvas)),
                              ("objects", lambda: vp.objects(canvas)),
                              ("process", lambda: vp.process(req))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                fn()
                torch.cuda.synchronize()
                peak[stage] = (torch.cuda.max_memory_allocated()
                               - base) / 2 ** 20
            res[name]["peak_above_before_mib"] = peak
            res[name]["allocated_before_mib"] = base / 2 ** 20
    return res


def _tower_writers():
    """tests/tower_writers.py, loaded from its path: a `tests` package
    installed elsewhere on sys.path would shadow the repo's directory."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "tower_writers.py")
    spec = importlib.util.spec_from_file_location("tower_writers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_tower_convert(trees: dict, dev) -> dict:
    """convert_towers --facenet, --mtcnn and --yolo-cfg/--yolo-weights on
    files written from the trees; serve's loaders read back the
    converter's trees bit for bit, and those equal the trees within one
    rounding of the batch-norm fold."""
    from tell_tpu_torch.bridge import to_torch, tree_leaves, tree_map
    from tell_tpu_torch.models.backbones import facenet, mtcnn, yolov3
    tower_writers = _tower_writers()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_towers_")
    try:
        paths = {"facenet": os.path.join(tmp, "facenet.pt"),
                 "mtcnn": [os.path.join(tmp, f"{n}.pt")
                           for n in ("pnet", "rnet", "onet")],
                 "cfg": os.path.join(tmp, "yolov3-spp.cfg"),
                 "weights": os.path.join(tmp, "yolov3-spp.weights")}
        torch.save(tower_writers.facenet_pytorch_state(trees["facenet"]),
                   paths["facenet"])
        for sd, path in zip(tower_writers.mtcnn_states(trees["mtcnn"]),
                            paths["mtcnn"]):
            torch.save(sd, path)
        defs = yolov3.yolov3_spp_module_defs()
        with open(paths["cfg"], "w") as f:
            f.write(tower_writers.darknet_cfg(defs, yolov3.ANCHORS))
        tower_writers.write_darknet_weights(
            paths["weights"], tower_writers.darknet_parts(trees["yolov3"]))
        towers = os.path.join(tmp, "towers")
        _, convert_s, _ = _cli(["--out", towers, "--facenet",
                                paths["facenet"], "--mtcnn", *paths["mtcnn"],
                                "--yolo-cfg", paths["cfg"], "--yolo-weights",
                                paths["weights"]], "phase 15",
                               "tell_tpu_torch.tools.convert_towers")
        with open(paths["cfg"]) as f:
            parsed = yolov3.parse_darknet_cfg(f.read())
        require(yolov3.channel_plan(parsed) == yolov3.channel_plan(defs),
                "phase 15: the written cfg parses to another network")
        want = {
            "facenet": facenet.prepare_facenet(to_torch(
                facenet.convert_facenet(torch.load(
                    paths["facenet"], weights_only=True),
                    facenet.FaceNetConfig()), dev)),
            "mtcnn": mtcnn.prepare_mtcnn(to_torch(mtcnn.convert_mtcnn(
                *[torch.load(p, weights_only=True)
                  for p in paths["mtcnn"]]), dev)),
            "yolov3": yolov3.prepare_yolov3(to_torch(
                yolov3.load_darknet_weights(parsed, paths["weights"]), dev))}
        loaders = {"facenet": facenet.load_facenet, "mtcnn": mtcnn.load_mtcnn,
                   "yolov3": yolov3.load_yolov3}
        out = {"convert_s": convert_s}
        prepared = _prepared_towers(trees, dev)
        for name, load in loaders.items():
            got = load(os.path.join(towers, name), dev)
            same = tree_leaves(tree_map(
                lambda x, y: x.device == y.device and torch.equal(x, y),
                got, want[name]))
            require(len(same) == len(tree_leaves(want[name])) and all(same),
                    f"phase 15: the {name} tower serve loads is not the "
                    "converter's bit for bit")
            out[f"{name}_rel_to_tree"] = max(tree_leaves(tree_map(
                lambda x, y: float((x - y).abs().max()
                                   / y.abs().max().clamp(min=1e-30)),
                got, prepared[name])))
            require(out[f"{name}_rel_to_tree"] <= 1e-6,
                    f"phase 15: the converted {name} is "
                    f"{out[name + '_rel_to_tree']:.3e} off the tree")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 15: convert_towers --facenet --mtcnn --yolo-cfg/"
        f"--yolo-weights in {out['convert_s']:.1f} s; serve's loaders read "
        "the converter's trees bit for bit; relative to the random trees: "
        + json.dumps({k: v for k, v in out.items() if k != "convert_s"}))
    return out


def phase_faces_objects(seed: int, card: str, dev: str = "cuda", cfg=None,
                        rcfg=None) -> dict:
    """Phase 15 (see the module docstring): the vision towers card vs CPU
    on the news photos' canvases, the TF32 control, the stages' times,
    the flagship service with all four towers (micro-batch and engine),
    and convert_towers + serve's loaders. cfg / rcfg default to the
    flagship and RoBERTa-large (a CPU rehearsal passes small ones with
    faces 512 and objects 2048 wide)."""
    from tell_tpu_torch.config import CaptionerConfig
    from tell_tpu_torch.data.jpeg import decode_jpeg
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    from tell_tpu_torch.serving.vision import DET_CANVAS, letterbox
    cfg = cfg or CaptionerConfig()
    rcfg = rcfg or RobertaConfig.large()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    trees = _vision_towers(seed)
    card_towers = _prepared_towers(trees, dev)
    cpu_towers = _prepared_towers(trees, "cpu")
    log(f"phase 15: MTCNN, FaceNet (repeats 5/10/5), YOLOv3-SPP and "
        f"ResNet-152 from seed {seed} in {time.perf_counter() - t0:.1f} s "
        f"(FACE_BIAS {FACE_BIAS}, YOLO_BN {YOLO_BN}, OBJ_BIAS {OBJ_BIAS})")
    photos = {n: _read_fixture(root, n) for n in NEWS_PHOTOS}
    res = {"photos": {}}
    for name, data in photos.items():
        canvas, _ = letterbox(decode_jpeg(data).astype(np.float32),
                              DET_CANVAS)
        res["photos"][name] = _check_photo(name, canvas, card_towers,
                                           cpu_towers, dev)
        log(f"phase 15 ({card or dev}): {name} on the {DET_CANVAS} canvas, "
            f"{dev} vs CPU: " + json.dumps(res["photos"][name]))
    del cpu_towers
    res["stages"] = _time_stages(card_towers, photos, dev)
    log(f"phase 15 ({card or dev}): ms per photo, NMS share and peak "
        "memory: " + json.dumps(res["stages"]))
    res["service"] = _check_image_service(
        seed, cfg, rcfg, card_towers, dev, root,
        keys=("image_grid", "face_embeds", "obj_embeds"), label="phase 15")
    res["convert"] = _check_tower_convert(trees, dev)
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 15 ({card or dev}): done in {res['seconds']:.1f} s")
    res["trees"] = trees
    return res


# ---------------------------------------------------------------------------
# phase 16: what tell_tpu users hold -- the other photo forms, decoded as
# Pillow decodes them, served; towers verify on the card
# ---------------------------------------------------------------------------

# the twins of each news photo: its progressive JPEG and its PNG
FORM_TWINS = {name: (name.replace(".jpg", "_progressive.jpg"),
                     name.replace(".jpg", ".png")) for name in NEWS_PHOTOS}
# the fixtures phase 14's PR did not have: the forms added since
OLD_FIXTURE_PREFIXES = ("rgb_", "grey_", "restart_", "news_a_320x240_420.jpg",
                        "news_b_200x300_420.jpg")
FORM_DECODE_CALLS = 3    # host decodes timed per file (the median is kept)
# tell_tpu's probe output shapes (tell_tpu/commands/towers.py)
VERIFY_SHAPES = {
    "resnet152": {"grid": [1, 49, 2048], "pooled": [1, 2048]},
    "roberta": {"hiddens": [1, 16, 25, 1024]},
    "facenet": {"embedding": [1, 512]},
    "mtcnn": {"pnet": [1, 1, 1, 4], "rnet": [1, 4], "onet": [1, 4]},
    "yolov3": {"preds": [1, 1008, 85]},
}


def _form_decode_ms(root: str) -> dict:
    """ms per photo of decode_image on each news photo's baseline,
    progressive and PNG files (median of FORM_DECODE_CALLS calls)."""
    from tell_tpu_torch.data.images import decode_image
    out = {}
    for base, twins in FORM_TWINS.items():
        for name in (base, *twins):
            data = _read_fixture(root, name)
            times = []
            for _ in range(FORM_DECODE_CALLS):
                t = time.perf_counter()
                decode_image(data)
                times.append(time.perf_counter() - t)
            out[name] = 1e3 * float(np.median(times))
    return out


def _check_twin_service(seed, cfg, rcfg, towers, dev, root) -> dict:
    """The flagship with the four towers, micro-batch (over HTTP) and
    engine: each news photo's progressive and PNG twins as image_b64. A
    twin that decodes to its baseline's bytes answers the baseline's
    tokens; one that does not answers the tokens of the same text with
    its features computed by _photo_features."""
    from tell_tpu_torch.bridge import init_captioner, init_roberta
    from tell_tpu_torch.models.backbones.roberta import RobertaEncoder
    from tell_tpu_torch.serving import CaptionService, serve
    with open(os.path.join(root, IMAGES_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    keys = ("image_grid", "face_embeds", "obj_embeds")
    g = torch.Generator(device=dev).manual_seed(seed + 16)
    params = init_captioner(g, cfg)
    roberta = RobertaEncoder(init_roberta(g, rcfg), rcfg)
    tok = _smoke_tokenizer(root, rcfg.vocab_size)
    svc = CaptionService(params, roberta, cfg, dev, tokenizer=tok,
                         max_batch=8, towers=towers)
    arts = _quality_articles(root)
    text = "\n".join(s["text"] for s in arts[2]["parsed_section"]
                     if s["type"] == "paragraph")
    reqs, want_of = {}, {}
    for base, twins in FORM_TWINS.items():
        reqs[base] = {"context": text,
                      "image_b64": _b64(_read_fixture(root, base))}
        for twin in twins:
            data = _read_fixture(root, twin)
            reqs[twin] = {"context": text, "image_b64": _b64(data)}
            if manifest[twin].get("twin_of") == base:
                want_of[twin] = base
            else:
                feats = _photo_features(towers, data, keys,
                                        svc.vision.max_faces,
                                        svc.vision.max_objects)
                reqs[twin + ":features"] = {
                    "context": text,
                    **{k: v.tolist() for k, v in feats.items()}}
                want_of[twin] = twin + ":features"
    httpd = serve(svc, port=0, block=False)
    port = httpd.server_address[1]
    status, body = _post(port, "/caption", reqs[NEWS_PHOTOS[0]])  # warm-up
    require(status == 200 and "error" not in body, body)
    _reset_counts()
    answers, lat = {}, {}
    for name, req in reqs.items():
        t = time.perf_counter()
        status, body = _post(port, "/caption", req)
        lat[name] = time.perf_counter() - t
        require(status == 200 and "error" not in body, (name, body))
        answers[name] = body["token_ids"]
    counts = _counts()
    for twin, want in want_of.items():
        require(answers[twin] == answers[want],
                f"phase 16: the micro-batch answer to {twin} is not "
                f"{want}'s")
    status, _ = _post(port, "/shutdown", {})
    require(status == 200, f"/shutdown answered {status}")
    httpd.server_close()
    esvc = CaptionService(svc.model.tree(), roberta, cfg, dev,
                          tokenizer=tok, engine_slots=4, engine_beam=5,
                          towers=towers)
    try:
        _reset_counts()
        eng = {name: esvc.caption(req) for name, req in reqs.items()}
        n1 = _counts()
    finally:
        esvc.close()
    for name, body in eng.items():
        require("error" not in body, (name, body))
    for twin, want in want_of.items():
        require(eng[twin]["token_ids"] == eng[want]["token_ids"],
                f"phase 16: the engine's answer to {twin} is not {want}'s")
    svc.close()
    micro = {k: counts[k] for k in ("decode_attention", "encoder_attention")}
    engine = {k: n1[k] for k in ("decode_attention", "encoder_attention")}
    if dev == "cuda":
        for name in micro:
            require(micro[name] > 0 and engine[name] > 0,
                    f"phase 16: {name} never launched ({micro}, {engine})")
    log(f"phase 16: /caption with the news photos' progressive and PNG "
        f"twins, micro-batch and engine (4 slots, beam 5): each equal to "
        + json.dumps(want_of) + "; latencies (s) "
        + json.dumps({k: round(v, 3) for k, v in lat.items()})
        + f"; launches micro-batch {micro}, engine {engine}")
    return {"micro_batch_launches": micro, "engine_launches": engine,
            "equal_to": want_of, "latency_s": lat}


def _check_towers_verify(trees: dict, seed: int, dev) -> dict:
    """The five towers saved as convert_towers saves them (state.pt of
    the tree's tensors), `towers verify --json` through the command line
    on `dev`; each probe's outputs on `dev` against the CPU's, and the
    RoBERTa probe's kernel B launches."""
    from tell_tpu_torch.bridge import init_roberta, to_torch
    from tell_tpu_torch.commands import towers as verify
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_verify_")
    try:
        g = torch.Generator().manual_seed(seed + 16)
        saved = {**{k: trees[k] for k in ("mtcnn", "facenet", "yolov3")},
                 "resnet152": trees["resnet"],
                 "roberta": init_roberta(g, RobertaConfig.large())}
        for name, tree in saved.items():
            os.makedirs(os.path.join(tmp, name))
            torch.save(to_torch(tree, "cpu"),
                       os.path.join(tmp, name, "state.pt"))
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tell_tpu_torch.commands", "towers",
             "verify", tmp, "--json", "--device", dev], cwd=root,
            env={**os.environ, "PYTHONPATH": root}, capture_output=True,
            text=True)
        verify_s = time.perf_counter() - t
        require(proc.returncode == 0, "phase 16: towers verify exited "
                f"{proc.returncode}\n{proc.stdout[-3000:]}\n"
                f"{proc.stderr[-3000:]}")
        rows = {r["tower"]: r for r in json.loads(proc.stdout)}
        for name, shapes in VERIFY_SHAPES.items():
            require(rows[name]["status"] == "CONVERTED"
                    and rows[name]["outputs"] == shapes,
                    f"phase 16: towers verify's {name} row {rows[name]}")
        require("item 8, cut 4" in rows["vit"]["status"],
                f"phase 16: the vit row {rows['vit']}")
        rel, launches = {}, None
        for name in VERIFY_SHAPES:
            _reset_counts()
            _, _, card = verify.probe_outputs(tmp, name, dev)
            if name == "roberta":
                launches = _counts()["encoder_attention"]
            _, _, cpu = verify.probe_outputs(tmp, name, "cpu")
            rel[name] = max(_rel(torch.from_numpy(card[k]),
                                 torch.from_numpy(cpu[k])) for k in card)
            require(rel[name] <= FEATURE_REL_TOL,
                    f"phase 16: the {name} probe on {dev} is {rel[name]:.3e} "
                    "off the CPU's")
        if dev == "cuda":
            require(launches > 0, "phase 16: the RoBERTa probe never "
                    "launched kernel B")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"verify_s": verify_s, "rel_to_cpu": rel,
           "roberta_encoder_attention_launches": launches,
           "checksums": {k: r.get("checksum") for k, r in rows.items()}}
    log(f"phase 16: towers verify --json on {dev} in {verify_s:.1f} s: five "
        "CONVERTED rows with tell_tpu's shapes, vit not ported; probes vs "
        "the CPU (relative): " + json.dumps(rel) + f"; kernel B launches "
        f"in the RoBERTa probe {launches}; checksums "
        + json.dumps(res["checksums"]))
    return res


def phase_forms(seed: int, card: str, dev: str = "cuda", cfg=None,
                rcfg=None, trees=None) -> dict:
    """Phase 16 (see the module docstring): the new fixtures on the host,
    the host decode times of the news photos' forms, the flagship serving
    their twins (micro-batch and engine) with phase 15's towers, and
    towers verify on the card. cfg / rcfg default to the flagship and
    RoBERTa-large (a CPU rehearsal passes small ones with faces 512 and
    objects 2048 wide). trees: phase 15's _vision_towers(seed), made
    again when not given."""
    from tell_tpu_torch.config import CaptionerConfig
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    cfg = cfg or CaptionerConfig()
    rcfg = rcfg or RobertaConfig.large()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    new = [n for n in _manifest_names(root)
           if not n.startswith(OLD_FIXTURE_PREFIXES)]
    res = {"fixtures": _check_digests(root, new, "phase 16")}
    log(f"phase 16: {len(new)} fixtures of the other forms on the card's "
        "host: " + json.dumps(res["fixtures"]))
    res["decode_ms"] = _form_decode_ms(root)
    log(f"phase 16 ({card or 'host'}): host ms per photo of decode_image, "
        f"median of {FORM_DECODE_CALLS}: " + json.dumps(res["decode_ms"]))
    trees = trees or _vision_towers(seed)
    towers = _prepared_towers(trees, dev)
    res["service"] = _check_twin_service(seed, cfg, rcfg, towers, dev, root)
    del towers
    res["verify"] = _check_towers_verify(trees, seed, dev)
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 16 ({card or dev}): done in {res['seconds']:.1f} s")
    return res


def quality_run(card: str, out_dir: str | None) -> int:
    """tell_tpu_torch.tools.quality_loop on overfit_flagship.yaml as it is
    (200 epochs of 2 steps, trainer seed 0), runs and shards in a
    temporary directory; prints the before, after and A/B readings and
    fails below the thresholds. out_dir: where quality.json,
    quality-phases.json and the generation files are copied."""
    from tell_tpu_torch.config_io import load_experiment
    from tell_tpu_torch.tools import quality_loop
    seed = load_experiment(QUALITY_EXPT).trainer.seed
    tmp = tempfile.mkdtemp(prefix="chip_smoke_quality_")
    try:
        over = json.dumps(_cli_overrides(tmp))
        q_out = os.path.join(tmp, "quality.json")
        rc = quality_loop.main(["--expt", QUALITY_EXPT, "--overrides", over,
                                "--out", q_out, "--device", "cuda"])
        require(rc == 0, f"quality loop exited {rc}")
        with open(q_out) as f:
            q = json.load(f)
        run = os.path.join(tmp, "run")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for name in ["quality-phases.json"] + sorted(
                    n for n in os.listdir(run) if n.startswith(
                        "generations-") and n != "generations-train.jsonl"):
                shutil.copy(os.path.join(run, name), out_dir)
            shutil.copy(q_out, out_dir)
        before, after = q["before"], q["after_beam"]
        n = after["n"]
        exact = round(after["caption_reproduction_exact"] * n)
        readings = {
            "card": card, "seed": seed,
            "wall_seconds": q["wall_seconds"],
            "phase_seconds": {k: q[k] for k in (
                "preprocess_seconds", "before_seconds", "train_seconds",
                "evaluate_seconds")},
            "before": {k: before[k] for k in ("cider", "bleu-4", "rouge-l")},
            "before_beam": {k: q["before_beam"][k]
                            for k in ("cider", "bleu-4", "rouge-l")},
            "after_greedy": {k: q["after_greedy"][k] for k in (
                "cider", "bleu-4", "rouge-l", "caption_reproduction_exact")},
            "after_beam": {k: after[k] for k in (
                "cider", "bleu-4", "rouge-l", "meteor", "entity_precision",
                "entity_recall", "captions_per_sec")},
            "after_beam_exact": f"{exact}/{n}",
            "ab_kv8": q["ab_kv8"], "ab_fused_topk": q["ab_fused_topk"],
            "ab_fast_gelu": q["ab_fast_gelu"], "train": q["train"]}
        log("quality: " + json.dumps(readings))
        require(n == 32, f"quality: {n} samples")
        require(before["cider"] <= QUALITY_BEFORE_CIDER_MAX,
                f"quality: before CIDEr {before['cider']} > "
                f"{QUALITY_BEFORE_CIDER_MAX}")
        require(after["cider"] >= QUALITY_AFTER_CIDER_MIN,
                f"quality: after beam CIDEr {after['cider']} < "
                f"{QUALITY_AFTER_CIDER_MIN}")
        require(exact >= QUALITY_AFTER_EXACT_MIN,
                f"quality: {exact}/32 exact < {QUALITY_AFTER_EXACT_MIN}/32")
        for ab, name in (("ab_kv8", "decode_attention_q8"),
                         ("ab_fused_topk", "topk_logits")):
            require(q[ab]["kernel_launches"][name] > 0,
                    f"quality: {ab} never launched {name}")
        require(q["ab_fast_gelu"]["gelu_mode"] == "tanh",
                f"quality: ab_fast_gelu ran {q['ab_fast_gelu']['gelu_mode']}")
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def beam_timing(seed: int, n: int) -> None:
    """Phase 10's one-shot beam search (beam 5, B=8, fp32, 2048-token
    article context) n + 1 times on one set of random weights: the host
    clock around the encode and around beam_search, each ending in a
    synchronise; the first run is a warm-up."""
    from tell_tpu_torch.bridge import init_captioner, init_roberta
    from tell_tpu_torch.config import CaptionerConfig, with_article_len
    from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                         RobertaEncoder)
    from tell_tpu_torch.models.captioner import encode_contexts
    from tell_tpu_torch.serving import CaptionService
    cfg = with_article_len(CaptionerConfig(), LONG_ARTICLE)
    rcfg = RobertaConfig.large()
    g = torch.Generator(device="cuda").manual_seed(seed)
    svc = CaptionService(init_captioner(g, cfg),
                         RobertaEncoder(init_roberta(g, rcfg), rcfg), cfg,
                         "cuda", max_batch=8)
    rng = np.random.default_rng(seed)
    batch, errors = svc._pack([_request(rng, cfg, n_ids, 4, 64,
                                        rcfg.vocab_size)
                               for n_ids in LONG_BEAM_ARTICLES])
    require(errors == [None] * 8, errors)
    for i in range(n + 1):
        with torch.inference_mode():
            t0 = time.perf_counter()
            tb = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
            enc = encode_contexts(svc.roberta.frozen(), cfg, tb)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = svc.model.beam_search(enc, beam_size=5)
            require(bool(torch.isfinite(out["scores"]).all()),
                    "non-finite beam scores")
            t2 = time.perf_counter()
        log(f"beam: run {i}{' (warm-up)' if i == 0 else ''}: encode "
            f"{t1 - t0:.3f} s, beam_search beam=5 B=8 {t2 - t1:.3f} s")
    svc.close()


def engine_repeats(seed: int, n: int) -> None:
    """The engine checks of phases 8 and 10 over seeds seed..seed+n-1 (the
    int4 beam search left out); the first failure raises."""
    from tell_tpu_torch.config import CaptionerConfig, with_article_len
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    long_cfg = with_article_len(CaptionerConfig(), LONG_ARTICLE)
    for s in range(seed, seed + n):
        t = time.perf_counter()
        svc, _, _, _ = phase_engine(s, CaptionerConfig(),
                                    RobertaConfig.large(),
                                    label=f"phase 8 seed {s}", int4=False)
        del svc
        torch.cuda.empty_cache()
        svc, _, _, _ = phase_engine(s + 10, long_cfg, RobertaConfig.large(),
                                    **{**LONG_ENGINE,
                                       "label": f"phase 10 seed {s}"})
        del svc
        torch.cuda.empty_cache()
        log(f"engine repeats: seed {s} in {time.perf_counter() - t:.1f} s")


def engine_trace(seed: int, n: int) -> None:
    """Phase 8's engine run (int4 beam search left out) at one seed up to n
    times, until an answer differs from the one-shot search; phase_engine
    logs both searches' candidates where they split."""
    from tell_tpu_torch.config import CaptionerConfig
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    for r in range(n):
        svc, _, _, differing = phase_engine(
            seed, CaptionerConfig(), RobertaConfig.large(),
            label=f"phase 8 run {r}", int4=False)
        del svc
        torch.cuda.empty_cache()
        if differing:
            log(f"engine trace: run {r} split at requests "
                f"{[i for i, _ in differing]}")
            return
    log(f"engine trace: {n} runs at seed {seed}, every answer equal")


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel of nvcc's -Xptxas=-v report: its (mangled)
    name, registers and spill stores."""
    lines, name, spill = [], "?", ""
    for line in report.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            lines.append(f"{name[:110]}: {regs}, {spill or 'no spill'}")
            name, spill = "?", ""
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine-repeats", type=int, default=0,
                    help="after the build, only the engine checks of "
                    "phases 8 and 10, this many times (no result line)")
    ap.add_argument("--kernels", nargs="?", const="all",
                    help="phases 1-3 only (no result line); with a "
                    "comma-separated list of " + ", ".join(KERNEL_NAMES)
                    + " only those kernels' cases of phase 3")
    ap.add_argument("--trace-engine", type=int, default=0,
                    help="after the build, phase 8's engine run at --seed "
                    "up to this many times, until an answer differs, with "
                    "both searches' candidates where they split (no result "
                    "line)")
    ap.add_argument("--beam", type=int, default=0,
                    help="after the build, phase 10's beam search this "
                    "many times, timed (no result line)")
    ap.add_argument("--cli", action="store_true",
                    help="after the build, phase 12 only (no result line)")
    ap.add_argument("--siblings", action="store_true",
                    help="after the build, phase 13 only (no result line)")
    ap.add_argument("--images", action="store_true",
                    help="after the build, phase 14 only (no result line)")
    ap.add_argument("--faces-objects", action="store_true",
                    help="after the build, phase 15 only (no result line)")
    ap.add_argument("--forms", action="store_true",
                    help="after the build, phase 16 only (no result line)")
    ap.add_argument("--quality", action="store_true",
                    help="after the build, the full quality loop on "
                    f"{QUALITY_EXPT} with its acceptance thresholds (no "
                    "result line)")
    ap.add_argument("--quality-out", default=None, metavar="DIR",
                    help="with --quality: copy the loop's result, phase "
                    "journal and generation files into DIR")
    args = ap.parse_args()
    only = None
    if args.kernels not in (None, "all"):
        only = set(args.kernels.split(","))
        if not only <= set(KERNEL_NAMES):
            ap.error(f"--kernels: {sorted(only - set(KERNEL_NAMES))} not in "
                     f"{KERNEL_NAMES}")

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
        for line in ptxas_summary(report.read_text()):
            log("phase 2: ptxas: " + line)
    from tell_tpu_torch.data import native
    found = native.library_path().exists()
    t = time.perf_counter()
    native.load_library()
    log(f"phase 2: {'found' if found else 'built'} and loaded the host "
        f"library {native.library_path().name} (g++, native/*.cpp) in "
        f"{time.perf_counter() - t:.2f} s")

    if args.engine_repeats:
        engine_repeats(args.seed, args.engine_repeats)
        return 0
    if args.beam:
        beam_timing(args.seed, args.beam)
        return 0
    if args.trace_engine:
        engine_trace(args.seed, args.trace_engine)
        return 0
    if args.cli:
        phase_cli(smi)
        return 0
    if args.siblings:
        from tell_tpu_torch.models.backbones.roberta import RobertaConfig
        phase_siblings(args.seed, RobertaConfig.large())
        return 0
    if args.images:
        phase_images(args.seed, smi)
        return 0
    if args.faces_objects:
        phase_faces_objects(args.seed, smi)
        return 0
    if args.forms:
        phase_forms(args.seed, smi)
        return 0
    if args.quality:
        return quality_run(smi, args.quality_out)
    # phase 3
    res = phase_kernels(args.seed, only)
    if args.kernels:
        return 0
    # phase 4
    from tell_tpu_torch.config import CaptionerConfig
    from tell_tpu_torch.models.backbones.roberta import RobertaConfig
    svc, req0, caption0, launches = phase_service(
        args.seed, CaptionerConfig(), RobertaConfig.large(), "cuda",
        routes=True)
    launches.pop("routes")
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
    svc, reqs, eng_launches, _ = phase_engine(
        args.seed, CaptionerConfig(), RobertaConfig.large())
    for name in ("decode_attention_q8", "topk_logits"):
        launches[name] = eng_launches[name]
    # phase 9
    phase_numerics(svc, reqs)
    del svc
    torch.cuda.empty_cache()
    # phase 10: the long-article configuration
    from tell_tpu_torch.config import with_article_len
    long_cfg = with_article_len(CaptionerConfig(), LONG_ARTICLE)
    svc, req0, caption0, long_launches = phase_service(
        args.seed + 10, long_cfg, RobertaConfig.large(), "cuda", "phase 10",
        LONG_SERVICE_ARTICLES, LONG_BEAM_ARTICLES)
    phase_cpu_vs_card(svc, req0, caption0, "phase 10")
    del svc
    torch.cuda.empty_cache()
    svc, _, long_eng, _ = phase_engine(args.seed + 10, long_cfg,
                                    RobertaConfig.large(), **LONG_ENGINE)
    log(f"phase 10: launches: micro-batch service {long_launches}, engine "
        f"{long_eng}")
    del svc
    torch.cuda.empty_cache()
    # phase 11: the measurement tools
    tools = phase_tools(args.seed)
    for name in ("decode_attention_single", "decode_attention_q4split"):
        launches[name] = tools["launches"][name]
    torch.cuda.empty_cache()
    # phase 12: text in, scored captions out, through the command line
    phase_cli(smi)
    torch.cuda.empty_cache()
    # phase 13: the flagship's siblings
    siblings = phase_siblings(args.seed, RobertaConfig.large())
    torch.cuda.empty_cache()
    # phase 14: images in
    images = phase_images(args.seed, smi)
    torch.cuda.empty_cache()
    # phase 15: faces and objects from a photo
    faces_objects = phase_faces_objects(args.seed, smi)
    torch.cuda.empty_cache()
    # phase 16: what tell_tpu users hold
    forms = phase_forms(args.seed, smi, trees=faces_objects.pop("trees"))

    # MG=20/S=637, B=4 S=512, K=31 at T=32, int8 S=637, N=40 V=30265 k=5,
    # F S=637, F int4-split S=637
    main_case = {"decode_attention": 1, "encoder_attention": 1,
                 "fused_dynamic_conv": 3, "decode_attention_q8": 0,
                 "topk_logits": 2, "decode_attention_single": 0,
                 "decode_attention_q4split": 0}
    single = "tell_tpu_torch/csrc/decode_attention_single.cu"
    sources = {
        "decode_attention": ("tell_tpu_torch/csrc/decode_attention.cu",
                             "tell_tpu/ops/kernels/decode_attention.py:216"),
        "encoder_attention": ("tell_tpu_torch/csrc/encoder_attention.cu",
                              "tell_tpu/models/backbones/roberta.py:219"),
        "fused_dynamic_conv": ("tell_tpu_torch/csrc/dynamic_conv.cu",
                               "tell_tpu/ops/kernels/dynamic_conv.py:83"),
        "decode_attention_q8": (
            "tell_tpu_torch/csrc/decode_attention_q8.cu",
            "tell_tpu/ops/kernels/decode_attention.py:399"),
        "topk_logits": ("tell_tpu_torch/csrc/topk_logits.cu",
                        "tell_tpu/ops/kernels/topk_logits.py:126"),
        # kernel F: bb=2/4 replaces fused_batched, bb=1 the inline fn
        "decode_attention_single": (single, "tools/kernel_variants.py:51"),
        "decode_attention_q4split": (single,
                                     "tools/kernel_variants.py:111"),
    }
    # phase 13's own path: its launches of A and B (served and beam, every
    # sibling), D (the faces engine) and E (the fused sampling runs)
    sibling_launches = {
        name: sum(line[k][name] for line in siblings["lines"]
                  for k in ("caption_launches", "beam_launches"))
        for name in ("decode_attention", "encoder_attention")}
    sibling_launches["decode_attention_q8"] = sum(
        line.get("engine_launches", {}).get("decode_attention_q8", 0)
        for line in siblings["lines"])
    sibling_launches["topk_logits"] = siblings["sampling"]["topk_logits"]
    # phase 14's own path: A and B in micro-batch and engine mode
    image_launches = {
        name: images["service"]["micro_batch_launches"][name]
        + images["service"]["engine_launches"][name]
        for name in ("decode_attention", "encoder_attention")}
    # phase 15's own path: A and B in micro-batch and engine mode, the
    # photos' faces and objects among the contexts
    faces_objects_launches = {
        name: faces_objects["service"]["micro_batch_launches"][name]
        + faces_objects["service"]["engine_launches"][name]
        for name in ("decode_attention", "encoder_attention")}
    # phase 16's own path: A and B serving the photos' twins (micro-batch
    # and engine), B in towers verify's RoBERTa probe
    forms_launches = {
        name: forms["service"]["micro_batch_launches"][name]
        + forms["service"]["engine_launches"][name]
        for name in ("decode_attention", "encoder_attention")}
    forms_launches["encoder_attention"] += forms["verify"][
        "roberta_encoder_attention_launches"]
    kernels = []
    for name, (src, replaces) in sources.items():
        case = res[name][main_case[name]]
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["err32"] for c in res[name]),
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"]}
        if name == "decode_attention_single":
            entry["also_replaces"] = "tools/longctx_variants.py:52"
        if name in sibling_launches:
            entry["phase13_launches"] = sibling_launches[name]
        if name in image_launches:
            entry["phase14_launches"] = image_launches[name]
        if name in faces_objects_launches:
            entry["phase15_launches"] = faces_objects_launches[name]
        if name in forms_launches:
            entry["phase16_launches"] = forms_launches[name]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
