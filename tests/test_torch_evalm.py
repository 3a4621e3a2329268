"""The port's scorers against tell_tpu's, exactly.

Every scorer (BLEU, ROUGE-L, CIDEr-D, METEOR with and without the tables,
entity P/R and the reported entity families, readability and narrative
productivity) and score_file on the committed generations of
tests/fixtures/quality/r03, r04 and r05, and on seeded random strings;
METEOR reads the port's own copy of its tables.
"""
import glob
import json
import os
import random

import pytest

import tell_tpu.evalm as jev
import tell_tpu_torch.evalm as tev
from tell_tpu.commands.evaluate import score_file as j_score_file
from tell_tpu.commands.evaluate import score_generations as j_score
from tell_tpu.evalm import entities as j_ent
from tell_tpu.evalm import meteor as j_met
from tell_tpu.evalm import readability as j_read
from tell_tpu_torch.commands.evaluate import score_file, score_generations
from tell_tpu_torch.evalm import entities as t_ent
from tell_tpu_torch.evalm import meteor as t_met
from tell_tpu_torch.evalm import readability as t_read

QUALITY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "quality")
GENERATIONS = sorted(glob.glob(os.path.join(QUALITY, "r0*",
                                            "generations-*.jsonl")))
WORDS = ("the mayor spoke in Lisbon on Monday about grain exports and rail "
         "Zainab Weber Halcyon Labs speaks unveils a plan for housing reform "
         "café naïve ½ running runs ran 42 , . ! ? 's").split()


def _rows(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _random_pairs(seed, n=40):
    rng = random.Random(seed)

    def sent():
        return " ".join(rng.choice(WORDS)
                        for _ in range(rng.randint(0, 14)))
    return [sent() for _ in range(n)], [[sent()] for _ in range(n)]


def _cases():
    for path in GENERATIONS:
        rows = _rows(path)
        yield (os.path.relpath(path, QUALITY),
               [r["generation"] for r in rows], [[r["caption"]] for r in rows])
    for seed in range(3):
        yield (f"random-{seed}", *_random_pairs(seed))


CASES = list(_cases())


def test_fixtures_are_there():
    assert len(GENERATIONS) == 9     # before, after-greedy, after-beam5 x 3


@pytest.mark.parametrize("name, cands, refs", CASES,
                         ids=[c[0] for c in CASES])
def test_scorers_equal_jax(name, cands, refs):
    assert tev.bleu_scores(cands, refs) == jev.bleu_scores(cands, refs)
    assert tev.rouge_l(cands, refs) == jev.rouge_l(cands, refs)
    tc, jc = tev.CiderScorer(), jev.CiderScorer()
    for c, r in zip(cands, refs):
        tc.append(c, r)
        jc.append(c, r)
    assert tc.compute() == jc.compute()
    tcfg, jcfg = t_met.MeteorConfig.from_data_dir(), \
        j_met.MeteorConfig.from_data_dir()
    assert tcfg.full_stages and jcfg.full_stages
    assert t_met.corpus_meteor(cands, refs, tcfg) == j_met.corpus_meteor(
        cands, refs, jcfg)
    assert t_met.corpus_meteor(cands, refs) == j_met.corpus_meteor(
        cands, refs)
    assert score_generations(cands, refs) == j_score(cands, refs)
    for text in cands[:8] + [r[0] for r in refs[:8]]:
        assert t_read.get_readability_scores(text) == \
            j_read.get_readability_scores(text)
        assert t_read.get_narrative_productivity(text) == \
            j_read.get_narrative_productivity(text)


@pytest.mark.parametrize("path", GENERATIONS, ids=[
    os.path.relpath(p, QUALITY) for p in GENERATIONS])
def test_score_file_equals_jax(path):
    assert score_file(path) == j_score_file(path)


def test_entity_scores_equal_jax():
    rows = _rows(os.path.join(QUALITY, "r05", "generations-before.jsonl"))
    with open(os.path.join(QUALITY, "entities.json"), encoding="utf-8") as f:
        gaz = json.load(f)

    def ner(text):
        return [(n, gaz[n]) for n in sorted(gaz) if n in text]

    gens = [[t for t, _ in ner(r["generation"])] for r in rows]
    refs = [[t for t, _ in ner(r["caption"])] for r in rows]
    assert t_ent.entity_precision_recall(gens, refs) == \
        j_ent.entity_precision_recall(gens, refs)
    entries = [{**r, "caption_entities": [{"text": t, "label": l}
                                          for t, l in ner(r["caption"])],
                "generated_entities": [{"text": t, "label": l}
                                       for t, l in ner(r["caption"][:40])],
                "caption_names": r["caption"].split()[:2],
                "generated_names": r["caption"].split()[:1]}
               for r in rows]
    assert t_ent.reported_entity_metrics(entries) == \
        j_ent.reported_entity_metrics(entries)
    cands = [r["generation"] for r in rows]
    refs1 = [[r["caption"]] for r in rows]
    assert score_generations(cands, refs1, ner) == j_score(cands, refs1, ner)
    # spaCy is optional: without it the hooks return None in both
    assert (t_ent.spacy_analyze() is None) == (j_ent.spacy_analyze() is None)


def test_meteor_reads_the_ports_own_tables():
    tdir, jdir = t_met.SHIPPED_DATA_DIR, j_met.SHIPPED_DATA_DIR
    assert os.path.realpath(tdir).endswith(
        os.path.join("tell_tpu_torch", "evalm", "data", "meteor"))
    assert os.path.realpath(tdir) != os.path.realpath(jdir)
    for name in ("synonyms.tsv", "paraphrases.tsv"):
        with open(os.path.join(tdir, name), "rb") as a, \
                open(os.path.join(jdir, name), "rb") as b:
            assert a.read() == b.read()
    cfg = t_met.MeteorConfig.from_data_dir()
    assert cfg.synonyms == t_met.load_synonyms(
        os.path.join(tdir, "synonyms.tsv"))
    assert not t_met.MeteorConfig.from_data_dir("none").full_stages
