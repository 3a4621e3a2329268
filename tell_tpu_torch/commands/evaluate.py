"""The evaluate command: decode a split, write generations-<split>.jsonl,
score it (counterpart of tell_tpu/commands/evaluate.py:
persistent_analyze, evaluate_split, score_generations and score_file).

The model is the experiment's family (models/registry.py's get_model:
the captioner, the modern LM of expts 10 and 12, or the LSTM of expts 1
and 3 and the pointer models of expts a1-a3, which decode greedily only;
the pointer's batches carry the shards' proper_masks to its copy head).
Each batch is
encoded by its frozen towers (the adapter's encode: RoBERTa, kernel B on
the card) and decoded greedily (the adapter's generate) or by beam search
(its beam), through kernel A on the card, or kernel D with the int8/int4
K/V cache and kernel E with the fused top-k (the captioner's adaptive
softmax only) when those levers are asked for. The lines of
generations.jsonl and the metric keys are tell_tpu's; kv_cache_mode and
topk_mode report the levers as they ran.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import time

import numpy as np
import torch

from ..config_io import ExperimentConfig
from ..data.bucketing import META_FIELDS, bucket_batches
from ..data.records import RecordDataset
from ..data.tokenizer import RobertaTokenizer
from ..evalm import CiderScorer, bleu_scores, entity_precision_recall, rouge_l
from ..evalm.entities import reported_entity_metrics, spacy_analyze
from ..evalm.meteor import MeteorConfig, corpus_meteor
from ..evalm.readability import (get_narrative_productivity,
                                 get_readability_scores)
from ..models.registry import get_model

KV_CACHE_MODES = ("fp", "int8", "int4")


def persistent_analyze(analyze, cache_path: str):
    """Disk-persisted memo around a text -> analysis function (the spaCy
    parse behind the entity fields). Returns (cached_analyze, flush);
    flush() writes the cache back atomically iff new texts were parsed."""
    cache: dict = {}
    if os.path.exists(cache_path):
        try:
            with open(cache_path, "rb") as cf:
                cache = pickle.load(cf)
        except Exception:
            cache = {}
    n_loaded = len(cache)

    def cached(t):
        r = cache.get(t)
        if r is None:
            r = analyze(t)
            cache[t] = r
        return r

    def flush():
        if len(cache) == n_loaded:
            return
        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as cf:
            pickle.dump(cache, cf, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, cache_path)

    return cached, flush


def evaluate_split(exp: ExperimentConfig, params: dict, frozen: dict,
                   tokenizer: RobertaTokenizer, split: str = "test",
                   beam_size: int = 1, out_dir: str | None = None,
                   limit: int | None = None, *, device,
                   kv_cache: str = "fp", fused_topk: bool = False,
                   dec8: bool = False, dec8_sm: bool = False,
                   merged_vocab: bool = False) -> dict:
    """Decode <shards_dir>/<split>-*.npz and score it. params: the model's
    tree and frozen {"roberta", "roberta_cfg"} (and the towers the encode
    takes), both already on `device` (an int8 RoBERTa, ops/quant.py's
    maybe_quantize_frozen, is the enc8 lever). kv_cache ("fp", "int8",
    "int4"), fused_topk, dec8, dec8_sm and merged_vocab are the decode
    numerics levers (models/captioner.py::generate); a family refuses the
    ones it lacks (ModelAdapter.check_levers)."""
    if kv_cache not in KV_CACHE_MODES:
        raise ValueError(f"kv_cache {kv_cache!r} not in {KV_CACHE_MODES}")
    adapter = get_model(exp.model_type, exp.model)
    cfg = adapter.config
    adapter.check_levers(fused_topk, kv_cache, dec8, dec8_sm, merged_vocab)
    if beam_size > 1 and adapter.beam is None:
        # tell_tpu asserts the same (evaluate.py:86-87)
        raise ValueError("beam search is implemented for the captioner and "
                         "modern models (the reference likewise decodes "
                         f"pointer/LSTM greedily); {exp.model_type!r} decodes "
                         "with --beam 1")
    levers = {"kv_cache": kv_cache}
    for name, on in (("fused_topk", fused_topk), ("dec8", dec8),
                     ("dec8_sm", dec8_sm), ("merged_vocab", merged_vocab)):
        if on:
            levers[name] = True
    device = torch.device(device)
    out_dir = out_dir or exp.trainer.serialization_dir
    os.makedirs(out_dir, exist_ok=True)
    gen_path = os.path.join(out_dir, f"generations-{split}.jsonl")

    def decode(batch: dict) -> np.ndarray:
        with torch.inference_mode():
            tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            enc = adapter.encode(frozen, tb)
            if beam_size > 1:
                ids = adapter.beam(params, cfg, enc, beam_size=beam_size,
                                   **levers)["token_ids"][:, 0]
            else:
                ids = adapter.generate(params, cfg, enc,
                                       **levers)["token_ids"]
            return ids.cpu().numpy()

    ds = RecordDataset(os.path.join(exp.data.shards_dir, f"{split}-*.npz"),
                       seed=0)
    analyze = spacy_analyze()
    ner = propn = flush_cache = None
    if analyze is not None:
        analyze, flush_cache = persistent_analyze(
            analyze, os.path.join(exp.data.shards_dir,
                                  "evaluation_cache.pkl"))
        ner = lambda t: analyze(t)[0]      # noqa: E731
        propn = lambda t: analyze(t)[1]    # noqa: E731
    cands, refs, entries = [], [], []
    t0 = time.time()
    t_first, n_first = None, 0   # the end of the first batch
    n = batches_done = 0
    with open(gen_path, "w", encoding="utf-8") as f:
        for batch in bucket_batches(ds.epoch(lazy=True, limit=limit),
                                    exp.bucketing, include_meta=True):
            real = batch.pop("real", np.ones(len(batch["caption_ids"]),
                                             bool))
            captions, hashes, urls = (batch.pop(m, None)
                                      for m in META_FIELDS)
            gen_ids = decode(batch)
            for i in range(len(gen_ids)):
                if not real[i]:
                    continue
                gen_text = tokenizer.decode(gen_ids[i])
                ref_text = (str(captions[i]) if captions is not None else
                            tokenizer.decode(batch["caption_ids"][i]))
                entry = {
                    "caption": ref_text,
                    "generation": gen_text,
                    "image_hash": (str(hashes[i]) if hashes is not None
                                   else None),
                    "web_url": (str(urls[i]) if urls is not None else None),
                    "caption_readability": get_readability_scores(ref_text),
                    "gen_readability": get_readability_scores(gen_text),
                    "caption_np": get_narrative_productivity(ref_text),
                    "gen_np": get_narrative_productivity(gen_text),
                }
                if ner is not None:
                    entry["caption_entities"] = [
                        {"text": t, "label": l} for t, l in ner(ref_text)]
                    entry["generated_entities"] = [
                        {"text": t, "label": l} for t, l in ner(gen_text)]
                if propn is not None:
                    entry["caption_names"] = propn(ref_text)
                    entry["generated_names"] = propn(gen_text)
                entries.append(entry)
                f.write(json.dumps(entry) + "\n")
                cands.append(gen_text)
                refs.append([ref_text])
                n += 1
            batches_done += 1
            if t_first is None:
                t_first, n_first = time.time(), n
    dt = time.time() - t0

    if flush_cache is not None:
        flush_cache()

    metrics = score_generations(cands, refs)
    if entries and "caption_entities" in entries[0]:
        metrics.update(reported_entity_metrics(entries))
    metrics["n_samples"] = n
    metrics["captions_per_sec"] = n / dt if dt > 0 else 0.0
    # the rate after the first batch (its first launches and allocator
    # growth), where at least two more batches make a window
    steady_dt = dt - (t_first - t0) if t_first is not None else 0.0
    metrics["captions_per_sec_steady"] = (
        (n - n_first) / steady_dt
        if n > n_first and steady_dt > 0 and batches_done - 1 >= 2
        else metrics["captions_per_sec"])
    metrics["kv_cache_mode"] = kv_cache
    metrics["topk_mode"] = "fused" if fused_topk else "exact"
    metrics["gelu_mode"] = frozen["roberta_cfg"].gelu
    with open(os.path.join(out_dir, f"evaluate-metrics-{split}.json"),
              "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def score_generations(cands: list[str], refs: list[list[str]],
                      ner=None) -> dict:
    """BLEU-1..4, ROUGE-L, METEOR (with and without the synonym and
    paraphrase tables) and CIDEr-D on the displayed x100 scale, over
    punctuation-stripped text; entity P/R with `ner`."""
    strip = lambda t: re.sub(r"[^\w\s]", "", t)  # noqa: E731
    sc = [strip(c) for c in cands]
    sr = [[strip(r) for r in rs] for rs in refs]
    bleus = bleu_scores(sc, sr)
    cider = CiderScorer()
    for c, rs in zip(sc, sr):
        cider.append(c, rs)
    cider_mean, _ = cider.compute()
    mcfg = MeteorConfig.from_data_dir()
    metrics = {
        "bleu-1": bleus[0] * 100, "bleu-2": bleus[1] * 100,
        "bleu-3": bleus[2] * 100, "bleu-4": bleus[3] * 100,
        "rouge-l": rouge_l(sc, sr) * 100,
        "meteor_exact_stem": corpus_meteor(
            sc, sr, MeteorConfig(function_words=mcfg.function_words)) * 100,
        # CiderScorer.compute is on pycocoevalcap's scale (x10); the
        # reference's tables display that value x100
        "cider": cider_mean * 100,
    }
    if mcfg.full_stages:
        metrics["meteor"] = corpus_meteor(sc, sr, mcfg) * 100
    if ner is not None:
        gen_ents = [[t for t, _ in ner(c)] for c in cands]
        ref_ents = [[t for t, _ in ner(rs[0])] for rs in refs]
        pr = entity_precision_recall(gen_ents, ref_ents)
        metrics["entity_precision"] = pr["precision"] * 100
        metrics["entity_recall"] = pr["recall"] * 100
    return metrics


def score_file(path: str, counters_path: str | None = None) -> dict:
    """Re-score a generations.jsonl; with counters_path (the pickled name
    counters of tools/compute_statistics.py) also the rare-name families."""
    cands, refs, entries = [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            d = json.loads(line)
            cands.append(d["generation"])
            refs.append([d["caption"]])
            entries.append(d)
    metrics = score_generations(cands, refs)
    if entries and "caption_entities" in entries[0]:
        counters = None
        if counters_path:
            with open(counters_path, "rb") as cf:
                counters = pickle.load(cf)
        metrics.update(reported_entity_metrics(entries, counters))
    return metrics
