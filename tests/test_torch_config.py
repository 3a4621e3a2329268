"""tell_tpu_torch's own config dataclasses against tell_tpu.config.

The port keeps a copy of the dataclasses so that it imports nothing of the
JAX package. Here every class's fields, types and defaults, the module
constants and small_test_config() must equal tell_tpu.config's (LLMConfig
and VIT_CONTEXTS: tell_tpu.models.llm_decoder's), and the port's
long-article configuration must equal the model that
expt/nytimes/11_long_article.yaml loads to, apart from compute_dtype (a
training setting; the service runs in the params' dtype).
"""
import dataclasses

import pytest

import tell_tpu.config as jcfg
import tell_tpu.models.llm_decoder as jllm
import tell_tpu_torch.config as tcfg
from tell_tpu.config_io import load_experiment

CLASSES = ("ContextSpec", "DecoderConfig", "CaptionerConfig")


def _plain(x):
    """Dataclass instances (also inside tuples) as dicts, so that the two
    packages' classes compare by value."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


def _fields(cls):
    return [(f.name, str(f.type), _plain(
        f.default_factory() if f.default_factory is not dataclasses.MISSING
        else f.default)) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_equal_jax(name):
    t, j = getattr(tcfg, name), getattr(jcfg, name)
    assert _fields(t) == _fields(j)
    assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen


def test_constants_properties_and_small_config_equal_jax():
    for name in ("FACES_OBJECTS_CONTEXTS", "FACES_CONTEXTS",
                 "FLATTENED_CONTEXTS", "NO_IMAGE_CONTEXTS"):
        assert _plain(getattr(tcfg, name)) == _plain(getattr(jcfg, name))
    for over in ({}, {"gen_len": 3, "num_heads": 2}):
        t, j = tcfg.small_test_config(**over), jcfg.small_test_config(**over)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.decoder.num_layers == j.decoder.num_layers
        assert t.decoder.full_cutoffs == j.decoder.full_cutoffs
        assert t.decoder.context("faces") == tcfg.ContextSpec(
            **dataclasses.asdict(j.decoder.context("faces")))
    with pytest.raises(KeyError):
        tcfg.DecoderConfig().context("audio")
    hash(tcfg.CaptionerConfig())          # usable as a static key


def test_long_article_config_equals_the_yaml_model():
    model = load_experiment("expt/nytimes/11_long_article.yaml").model
    port = tcfg.with_article_len(tcfg.CaptionerConfig(), 2048)
    want = dataclasses.asdict(model)
    got = dataclasses.asdict(port)
    assert want.pop("compute_dtype") == "bfloat16"
    assert got.pop("compute_dtype") == "float32"
    assert got == want
    assert port.decoder.context("article").max_len == 2048
    # the JAX class rebuilt from the port's fields is the YAML's model
    back = jcfg.CaptionerConfig(**{
        **dataclasses.asdict(port), "compute_dtype": "bfloat16",
        "decoder": jcfg.DecoderConfig(**{
            **dataclasses.asdict(port.decoder),
            "contexts": tuple(jcfg.ContextSpec(**dataclasses.asdict(c))
                              for c in port.decoder.contexts)})})
    assert back == model


def test_llm_config_equals_jax():
    """LLMConfig field for field and default for default, its properties,
    context() and VIT_CONTEXTS; with_article_len on an LLMConfig."""
    assert _fields(tcfg.LLMConfig) == _fields(jllm.LLMConfig)
    assert tcfg.LLMConfig.__dataclass_params__.frozen
    assert _plain(tcfg.VIT_CONTEXTS) == _plain(jllm.VIT_CONTEXTS)
    for over in ({}, {"num_kv_heads": None}, {"dim": 48, "num_heads": 6,
                                              "num_kv_heads": 2}):
        t, j = tcfg.LLMConfig(**over), jllm.LLMConfig(**over)
        assert (t.head_dim, t.kv_heads) == (j.head_dim, j.kv_heads)
    assert _plain(tcfg.LLMConfig().context("obj")) == _plain(
        jllm.LLMConfig().context("obj"))
    with pytest.raises(KeyError):
        tcfg.LLMConfig().context("audio")
    hash(tcfg.LLMConfig())
    long = tcfg.with_article_len(tcfg.LLMConfig(
        contexts=tcfg.VIT_CONTEXTS), 128)
    assert [c.max_len for c in long.contexts] == [197, 128, 4, 64]
