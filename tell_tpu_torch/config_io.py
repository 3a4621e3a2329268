"""YAML experiment configs -> the port's config dataclasses (counterpart of
tell_tpu/config_io.py: DataConfig, ExperimentConfig, _deep_merge,
load_experiment and the named context sets).

One YAML per experiment (expt/), plus a JSON object of overrides merged
over it. An unknown key fails. A key the JAX package knows and the port
cannot honour yet is refused with the ROADMAP queue item that ports it,
never dropped.

The files are read by `parse_yaml`, a reader for the YAML subset expt/
uses (PyYAML is not a dependency of the port): block mappings, block
sequences, flow lists and flow mappings, `#` comments, and plain or
quoted scalars typed as YAML 1.1 types them (int, float with a dot, bool,
null; `1e-5` without a dot is a string, as in PyYAML). Anchors, tags,
block scalars (| and >), multi-line flow collections and multiple
documents are refused.
"""
from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field

from .config import (CaptionerConfig, ContextSpec, DecoderConfig,
                     FACES_CONTEXTS, FACES_OBJECTS_CONTEXTS,
                     FLATTENED_CONTEXTS, LLMConfig, NO_IMAGE_CONTEXTS)
from .data.bucketing import BucketingConfig
from .data.readers import ReaderConfig
from .training.trainer import TrainerConfig

CONTEXT_PRESETS = {
    "faces_objects": FACES_OBJECTS_CONTEXTS,
    "faces": FACES_CONTEXTS,
    "flattened": FLATTENED_CONTEXTS,
    "no_image": NO_IMAGE_CONTEXTS,
}

# the model types of tell_tpu/models/registry.py::get_model whose YAML
# model: builds a CaptionerConfig: the captioner family (with the GloVe
# captioner), the pointer family (its adapter wraps the CaptionerConfig
# in a PointerConfig; the YAML's reader.emit_copy_masks writes its masks)
# and the LSTM family
CAPTIONER_TYPES = ("captioner", "transformer_faces_objects",
                   "transformer_faces", "transformer_flattened",
                   "transformer_glove", "pointer", "transformer_pointer",
                   "pointer_2", "transformer_pointer_2", "lstm",
                   "baseline_glove", "lstm_decoder_flattened")
# the modern family: the YAML's model: builds an LLMConfig
MODERN_TYPES = ("modern", "transformer_modern", "vit_modern")


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), sexagesimal forms apart
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(
    r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ",
            '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
            "L": " ", "P": " "}


def _plain_scalar(s: str):
    if _SEXAGESIMAL.match(s):
        raise ValueError(f"YAML: sexagesimal number {s!r} is not supported")
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith(".nan"):
            return float("nan")
        return float(v)
    if s[0] in "&*!|>%@`":
        raise ValueError(f"YAML: {s!r} uses a feature outside the subset")
    return s


def _quoted(line: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at line[i]; returns (value, end)."""
    q = line[i]
    out = []
    j = i + 1
    while j < len(line):
        c = line[j]
        if q == "'" and c == "'":
            if line.startswith("''", j):
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = line[j + 1:j + 2]
            if e in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[e]
                out.append(chr(int(line[j + 2:j + 2 + n], 16)))
                j += 2 + n
                continue
            if e not in _ESCAPES:
                raise ValueError(f"YAML: unknown escape \\{e}")
            out.append(_ESCAPES[e])
            j += 2
            continue
        out.append(c)
        j += 1
    raise ValueError(f"YAML: unterminated quoted scalar in {line!r}")


def _strip_comment(line: str) -> str:
    """line without its comment (a # at the start or after white space,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow(s: str, i: int, flow: bool):
    """Parse a value at s[i]: a flow collection, a quoted scalar or a plain
    scalar (which ends at , ] } inside a flow collection). Returns
    (value, end)."""
    while i < len(s) and s[i] == " ":
        i += 1
    if i < len(s) and s[i] == "[":
        out = []
        i += 1
        while True:
            while s[i] == " ":
                i += 1
            if s[i] == "]":
                return out, i + 1
            v, i = _flow(s, i, True)
            out.append(v)
            while s[i] == " ":
                i += 1
            if s[i] == ",":
                i += 1
            elif s[i] != "]":
                raise ValueError(f"YAML: expected , or ] in {s!r}")
    if i < len(s) and s[i] == "{":
        out = {}
        i += 1
        while True:
            while s[i] == " ":
                i += 1
            if s[i] == "}":
                return out, i + 1
            k, i = _flow_key(s, i)
            v, i = _flow(s, i, True)
            if k in out:
                raise ValueError(f"YAML: duplicate key {k!r}")
            out[k] = v
            while s[i] == " ":
                i += 1
            if s[i] == ",":
                i += 1
            elif s[i] != "}":
                raise ValueError(f"YAML: expected , or }} in {s!r}")
    if i < len(s) and s[i] in "'\"":
        return _quoted(s, i)
    j = i
    stops = ",]}" if flow else ""
    while j < len(s) and s[j] not in stops:
        j += 1
    return _plain_scalar(s[i:j].strip()), j


def _flow_key(s: str, i: int) -> tuple[str, int]:
    if s[i] in "'\"":
        k, i = _quoted(s, i)
    else:
        j = s.index(":", i)
        k, i = _plain_scalar(s[i:j].strip()), j
    while s[i] == " ":
        i += 1
    if s[i] != ":":
        raise ValueError(f"YAML: expected ':' after key in {s!r}")
    return k, i + 1


def _split_key(text: str) -> tuple[str, str] | None:
    """'key: rest' -> (key, rest); None when text is not a mapping entry."""
    if text[0] in "'\"":
        k, i = _quoted(text, 0)
        rest = text[i:]
        if not rest.startswith(":"):
            return None
        return k, rest[1:].strip()
    m = re.match(r"^([^\s:'\"\[\]{},#][^:]*?)\s*:(?:\s+(.*))?$", text)
    if m is None:
        return None
    return _plain_scalar(m.group(1)), (m.group(2) or "").strip()


def _value(text: str):
    try:
        v, end = _flow(text, 0, False)
    except IndexError:
        raise ValueError(f"YAML: unterminated flow collection in {text!r} "
                         "(multi-line flow collections are not supported)"
                         ) from None
    if text[end:].strip():
        raise ValueError(f"YAML: trailing text in {text!r}")
    return v


def parse_yaml(text: str):
    """The document of `text` (the subset described above) as dicts, lists
    and scalars, equal to yaml.safe_load's for that subset."""
    lines = []
    for raw in text.splitlines():
        if raw.startswith(("---", "...", "%")):
            raise ValueError("YAML: directives and document markers are not "
                             "supported")
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("YAML: tabs in indentation")
        line = _strip_comment(raw)
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"YAML: unexpected indentation at {lines[pos][1]!r}")
    return value


def _block(lines, pos, indent):
    """The block node whose lines start at lines[pos] with `indent`."""
    if lines[pos][1] == "-" or lines[pos][1].startswith("- "):
        out = []
        while pos < len(lines) and lines[pos][0] == indent and (
                lines[pos][1] == "-" or lines[pos][1].startswith("- ")):
            item = lines[pos][1][1:].strip()
            pos += 1
            if item:
                if _split_key(item) is not None and not item.startswith(
                        ("{", "[")):
                    raise ValueError("YAML: block mappings inside "
                                     "sequence items are not supported")
                out.append(_value(item))
            elif pos < len(lines) and lines[pos][0] > indent:
                v, pos = _block(lines, pos, lines[pos][0])
                out.append(v)
            else:
                out.append(None)
        return out, pos
    if _split_key(lines[pos][1]) is None:
        if pos + 1 < len(lines) and lines[pos + 1][0] >= indent:
            raise ValueError(f"YAML: multi-line scalar at {lines[pos][1]!r}")
        return _value(lines[pos][1]), pos + 1
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        kv = _split_key(lines[pos][1])
        if kv is None:
            raise ValueError(f"YAML: expected 'key: value' at "
                             f"{lines[pos][1]!r}")
        key, rest = kv
        if key in out:
            raise ValueError(f"YAML: duplicate key {key!r}")
        pos += 1
        if rest:
            out[key] = _value(rest)
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and (lines[pos][1] == "-"
                                             or lines[pos][1].startswith(
                                                 "- ")))):
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def load_yaml(path: str):
    with open(path, encoding="utf-8") as f:
        return parse_yaml(f.read())


# ---------------------------------------------------------------------------
# experiment configs
# ---------------------------------------------------------------------------

@dataclass
class DataConfig:
    shards_dir: str = "data/shards"
    articles_jsonl: str = ""
    # preprocess image features: a dir of precomputed <hash>.npy grids (raw
    # images need the ResNet-152 tower, not ported yet)
    images_dir: str = ""
    # per-hash object store (tools/annotate_objects.py's output); empty =
    # no object features in the shards
    objects_jsonl: str = ""
    vocab_file: str = "data/vocab.json"
    merges_file: str = "data/merges.txt"
    seed: int = 1234
    instances_per_epoch: int | None = 65536
    val_limit: int | None = None
    # frozen article tower: "large", "base" or "tiny"
    roberta: str = "large"
    # GloVe vectors file for the GloVe experiments (expts 1-2): preprocess
    # writes each article's [S, 300] features into the shards
    glove_file: str = ""


@dataclass
class ExperimentConfig:
    name: str = "experiment"
    model_type: str = "captioner"
    # an LLMConfig for the modern family (MODERN_TYPES)
    model: CaptionerConfig | LLMConfig = field(
        default_factory=CaptionerConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    reader: ReaderConfig = field(default_factory=ReaderConfig)
    bucketing: BucketingConfig = field(default_factory=BucketingConfig)


def _build(cls, spec: dict, path: str):
    if spec is None:
        return cls()
    kwargs = {}
    fields = {f.name for f in dataclasses.fields(cls)}
    for key, value in spec.items():
        if key not in fields:
            raise KeyError(f"unknown config key {path}.{key} for"
                           f" {cls.__name__}")
        if key == "contexts" and isinstance(value, str):
            value = CONTEXT_PRESETS[value]
        elif key == "contexts" and isinstance(value, list):
            value = tuple(ContextSpec(**c) for c in value)
        elif key == "decoder":
            value = _build(DecoderConfig, value, f"{path}.decoder")
        elif isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v
                          for v in value)
        kwargs[key] = value
    return cls(**kwargs)


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_experiment(path: str, overrides: str | dict | None = None
                    ) -> ExperimentConfig:
    """The experiment of the YAML at `path` with `overrides` (a JSON
    string or a dict) merged over it."""
    spec = load_yaml(path) or {}
    if overrides:
        if isinstance(overrides, str):
            overrides = json.loads(overrides)
        spec = _deep_merge(spec, overrides)
    model_type = spec.get("model_type", "captioner")
    name = spec.get("name", "experiment")
    if model_type.lower() not in CAPTIONER_TYPES + MODERN_TYPES:
        raise KeyError(f"unknown model_type {model_type!r}")
    model_cls = (LLMConfig if model_type.lower() in MODERN_TYPES
                 else CaptionerConfig)
    exp = ExperimentConfig(
        name=name,
        model_type=model_type,
        model=_build(model_cls, spec.get("model"), "model"),
        trainer=_build(TrainerConfig, spec.get("trainer"), "trainer"),
        data=_build(DataConfig, spec.get("data"), "data"),
        reader=_build(ReaderConfig, spec.get("reader"), "reader"),
        bucketing=_build(BucketingConfig, spec.get("bucketing"), "bucketing"),
    )
    return exp
