"""The port's YAML reader and experiment configs against PyYAML and
tell_tpu.config_io.

parse_yaml equals yaml.safe_load on every expt/*/*.yaml and on the edge
cases of the subset; every YAML of the captioner family (the GloVe
captioner, expt 2, among them), of the pointer family (expts a1-a3), of
the LSTM family (expts 1 and 3) and of the modern family (expts 10 and
12, an LLMConfig) loads, overrides included, into configs equal field by
field to tell_tpu's, and data.glove_file is taken as tell_tpu takes it;
a mesh is refused with the ROADMAP queue item that ports it; an unknown
key fails as it does in tell_tpu.
"""
import dataclasses
import glob
import os

import pytest
import yaml

from tell_tpu.config_io import load_experiment as j_load
from tell_tpu_torch.config_io import (_deep_merge, load_experiment,
                                      parse_yaml)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, ROOT)
               for p in glob.glob(os.path.join(ROOT, "expt", "*", "*.yaml")))

# the YAMLs of the captioner, pointer and LSTM families (a CaptionerConfig)
LOADS = {
    "expt/goodnews/1_lstm_glove.yaml",
    "expt/goodnews/2_transformer_glove.yaml",
    "expt/goodnews/3_lstm_roberta.yaml", "expt/nytimes/1_lstm_glove.yaml",
    "expt/nytimes/2_transformer_glove.yaml",
    "expt/nytimes/3_lstm_roberta.yaml",
    "expt/goodnews/4_no_image.yaml",
    "expt/goodnews/5_transformer_roberta.yaml",
    "expt/goodnews/6_transformer_weighted_roberta.yaml",
    "expt/goodnews/8_transformer_faces.yaml",
    "expt/goodnews/9_transformer_objects.yaml",
    "expt/nytimes/4_no_image.yaml", "expt/nytimes/5_transformer_roberta.yaml",
    "expt/nytimes/6_transformer_weighted_roberta.yaml",
    "expt/nytimes/7_transformer_location_aware.yaml",
    "expt/nytimes/8_transformer_faces.yaml",
    "expt/nytimes/9_transformer_objects.yaml",
    "expt/nytimes/11_long_article.yaml",
    "expt/nytimes/13_learned_positional.yaml",
    "expt/quality/overfit_flagship.yaml", "expt/quality/overfit_small.yaml",
    "expt/goodnews/a1_pointer.yaml", "expt/goodnews/a2_copy_fix.yaml",
    "expt/goodnews/a3_pointer_2.yaml", "expt/nytimes/a1_pointer.yaml",
    "expt/nytimes/a2_copy_fix.yaml", "expt/nytimes/a3_pointer_2.yaml",
}
# the modern family's YAMLs: an LLMConfig
MODERN = {"expt/nytimes/10_vit_modern.yaml",
          "expt/nytimes/12_moe_modern.yaml"}
OVERRIDES = ('{"trainer": {"serialization_dir": "/tmp/x", "num_epochs": 2},'
             ' "data": {"shards_dir": "/tmp/s"}, "model": {"gen_len": 7,'
             ' "decoder": {"dropout": 0.0}}, "bucketing": {"max_batch": 8}}')


def _assert_configs_equal(exp, jexp):
    assert (exp.name, exp.model_type) == (jexp.name, jexp.model_type)
    for f in ("model", "trainer", "data", "reader", "bucketing"):
        got, want = getattr(exp, f), getattr(jexp, f)
        assert ([x.name for x in dataclasses.fields(got)]
                == [x.name for x in dataclasses.fields(want)]), f
        assert dataclasses.asdict(got) == dataclasses.asdict(want), f


def test_every_yaml_is_covered():
    assert len(YAMLS) == 29
    assert set(YAMLS) == LOADS | MODERN


@pytest.mark.parametrize("path", YAMLS)
def test_parse_yaml_equals_pyyaml(path):
    with open(os.path.join(ROOT, path), encoding="utf-8") as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", sorted(LOADS))
def test_captioner_yamls_load_as_jax_does(path):
    full = os.path.join(ROOT, path)
    _assert_configs_equal(load_experiment(full), j_load(full))
    _assert_configs_equal(load_experiment(full, OVERRIDES),
                          j_load(full, OVERRIDES))


MODERN_OVERRIDES = ('{"trainer": {"serialization_dir": "/tmp/x"}, "model":'
                    ' {"gen_len": 7, "num_kv_heads": 8, "moe_top_k": 1,'
                    ' "contexts": "faces"}}')


@pytest.mark.parametrize("path", sorted(MODERN))
def test_modern_yamls_load_as_jax_does(path):
    """Expts 10 and 12 (model_type transformer_modern) load into an
    LLMConfig equal to tell_tpu's, with and without overrides, where the
    port refused them before."""
    from tell_tpu_torch.config import LLMConfig
    full = os.path.join(ROOT, path)
    exp = load_experiment(full)
    assert isinstance(exp.model, LLMConfig)
    _assert_configs_equal(exp, j_load(full))
    over = load_experiment(full, MODERN_OVERRIDES)
    _assert_configs_equal(over, j_load(full, MODERN_OVERRIDES))
    assert (over.model.kv_heads, len(over.model.contexts)) == (8, 3)


@pytest.mark.parametrize("over, item", [
    ({"trainer": {"n_data": 2, "n_model": 2}}, "queue 1 item 10"),
    ({"trainer": {"n_model": 2}}, "queue 1 item 10"),
])
def test_keys_the_port_cannot_honour_are_refused(over, item):
    """A config tell_tpu honours loads equal to tell_tpu's. The name is
    from when the port refused these keys; it is kept, with its case, so
    that the suite's record of this test runs on. Tensor parallelism
    (n_model > 1), once refused as item 10's rest, loads as tell_tpu
    loads it: every command reads the config, and
    train runs it on n_data x n_model ranks."""
    path = os.path.join(ROOT, "expt/nytimes/9_transformer_objects.yaml")
    exp = load_experiment(path, over)
    _assert_configs_equal(exp, j_load(path, over))
    assert exp.trainer.n_model == 2


@pytest.mark.parametrize("path", ["expt/nytimes/a1_pointer.yaml",
                                  "expt/nytimes/a3_pointer_2.yaml",
                                  "expt/nytimes/12_moe_modern.yaml"])
def test_data_parallel_pointer_and_moe_are_refused(path):
    """The pointer models and the MoE at n_data > 1 load equal to
    tell_tpu's. The name is from when the port refused them; it is kept,
    with its cases, so that the suite's record of this test runs on. Once
    refused as item 10's rest (their objectives are not means over tokens), load as
    tell_tpu loads them: the port's losses take their means and routing
    over the global batch."""
    path = os.path.join(ROOT, path)
    over = {"trainer": {"n_data": 2}}
    exp = load_experiment(path, over)
    _assert_configs_equal(exp, j_load(path, over))
    assert exp.trainer.n_data == 2


@pytest.mark.parametrize("n_data", [None, 2, 8])
def test_n_data_loads_as_jax_does(n_data):
    """trainer.n_data, refused before data parallelism was ported, loads
    into the TrainerConfig tell_tpu's loader gives."""
    path = os.path.join(ROOT, "expt/nytimes/9_transformer_objects.yaml")
    over = {"trainer": {"n_data": n_data}}
    exp = load_experiment(path, over)
    assert exp.trainer.n_data == j_load(path, over).trainer.n_data == n_data
    _assert_configs_equal(exp, j_load(path, over))


@pytest.mark.parametrize("path", ["expt/goodnews/1_lstm_glove.yaml",
                                  "expt/nytimes/2_transformer_glove.yaml"])
def test_glove_file_is_honoured_as_in_jax(path):
    """data.glove_file (refused before data/glove.py) loads into the same
    DataConfig as tell_tpu's; preprocess reads it (tests/
    test_torch_glove.py)."""
    full = os.path.join(ROOT, path)
    over = {"data": {"glove_file": "/data/glove.840B.300d.txt"}}
    exp = load_experiment(full, over)
    assert exp.data.glove_file == "/data/glove.840B.300d.txt"
    _assert_configs_equal(exp, j_load(full, over))


@pytest.mark.parametrize("over", [
    {"trainer": {"warm_start": "runs/x/checkpoints/best"}},
    {"trainer": {"summary_interval": 100}},
    {"trainer": {"profile_steps": 5, "profile_at": 2}},
])
def test_training_options_load_as_jax_does(over):
    """The trainer options the port once refused (warm start, TensorBoard
    scalars at another interval, the profiler window) load as in
    tell_tpu."""
    path = os.path.join(ROOT, "expt/nytimes/9_transformer_objects.yaml")
    _assert_configs_equal(load_experiment(path, over), j_load(path, over))


@pytest.mark.parametrize("over", [
    {"model": {"decoder": {"positional": "learned"}}},
    {"model": {"decoder": {"conv_type": "lightweight"}}},
    {"model": {"decoder": {"normalize_before": True, "final_norm": True}}},
    {"model": {"sampling_topk": 4, "sampling_temp": 0.7}},
])
def test_decoder_options_load_as_jax_does(over):
    """The options the port once refused (learned positions, the
    lightweight conv, the final norm, top-k sampling) load as in tell_tpu."""
    path = os.path.join(ROOT, "expt/nytimes/9_transformer_objects.yaml")
    _assert_configs_equal(load_experiment(path, over), j_load(path, over))


def test_defaults_the_port_runs_are_accepted():
    path = os.path.join(ROOT, "expt/nytimes/9_transformer_objects.yaml")
    over = {"trainer": {"n_data": 1, "n_model": 1, "summary_interval": 512,
                        "profile_steps": 0, "profile_at": 3}}
    _assert_configs_equal(load_experiment(path, over), j_load(path, over))


@pytest.mark.parametrize("over", [{"trainer": {"bogus": 1}},
                                  {"model": {"decoder": {"bogus": 1}}},
                                  {"bucketing": {"bogus": 1}}])
def test_unknown_key_fails_as_in_jax(over):
    path = os.path.join(ROOT, "expt/nytimes/9_transformer_objects.yaml")
    with pytest.raises(KeyError):
        j_load(path, over)
    with pytest.raises(KeyError, match="bogus"):
        load_experiment(path, over)


SUBSET = """
# a comment
a: 1            # trailing comment
b: -0.5
c: 1e-5
d: 1.0e-5
e: [3, 7, 15]
f: {name: image, kv_dim: 2048, max_len: 49}
g:
  - {x: 1, y: [a, b]}
  - {x: 2, y: []}
h:
- plain
- 'quoted # not a comment'
- "dq \\t \\u00e9"
i: ~
j: null
k: true
l: No
m: 0x1F
n: 017
o: 'it''s'
p: .5
q: +3
r:
s: a:b
t: 'x: y'
u: -.inf
v: 1_000
w:
  nested:
    deeper: [1, {z: 2}]
"""


def test_subset_edge_cases_equal_pyyaml():
    assert parse_yaml(SUBSET) == yaml.safe_load(SUBSET)
    assert parse_yaml("x: .nan")["x"] != parse_yaml("x: .nan")["x"]
    assert _deep_merge({"a": {"b": 1, "c": 2}}, {"a": {"b": 3}}) == {
        "a": {"b": 3, "c": 2}}


@pytest.mark.parametrize("text", ["a: &x 1", "a: |\n  text", "--- \na: 1",
                                  "a: 1\n\ta: 2", "a: [1,\n  2]",
                                  "a: 1\na: 2"])
def test_outside_the_subset_is_refused(text):
    with pytest.raises(ValueError):
        parse_yaml(text)
