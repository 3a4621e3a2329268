"""`towers verify` in the port (tell_tpu_torch/commands/towers.py) against
tell_tpu's (tell_tpu/commands/towers.py) on the CPU: the probe inputs
drawn without JAX equal jax.random's (ids exactly, normals within 1e-6),
each tower's probe outputs within PROBE_TOL of tell_tpu's probes on the
same weights (RoBERTa, ResNet-152 and ViT-L/16 here; MTCNN, FaceNet and
YOLOv3 in test_torch_towers_probes.py), the rows' schema and `_checksum`
equal, the values whose 1e-3 rounding differs between the two packages
counted and logged, and the statuses and exit codes of missing, broken,
orbax-form and converted trees.

The towers are the full probes' architectures with small weights where
the forward reads its width from them: ResNet-152's block counts at base
width 2 (its kernels rescaled to He's std; without batch-norm statistics
its residual stack still reaches ~1e8, so PROBE_TOL is relative to the
largest output), RoBERTa-large's and ViT-L's widths at 2 layers, seeded
with the port's initialisers.
"""
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from tell_tpu.commands import towers as jt
from tell_tpu_torch.bridge import init_resnet, init_roberta, init_vit
from tell_tpu_torch.bridge import to_numpy, tree_map
from tell_tpu_torch.commands import jax_random
from tell_tpu_torch.commands import towers as tt
from tell_tpu_torch.commands.__main__ import main
from tell_tpu_torch.models.backbones.resnet import ResNetConfig
from tell_tpu_torch.models.backbones.roberta import RobertaConfig
from tell_tpu_torch.models.backbones.vit import ViTConfig

torch.set_num_threads(2)
PROBE_TOL = 1e-5     # |port - tell_tpu| <= PROBE_TOL * (1 + max|tell_tpu|)
log = logging.getLogger(__name__)


def unit_scale(tree, gain=1.0):
    """Each conv kernel (a 4-d leaf) rescaled to `gain` times He's std, so
    a deep random tower's activations stay bounded."""
    def fix(t):
        if t.dim() != 4:
            return t
        fan_in = t.shape[0] * t.shape[1] * t.shape[2]    # HWIO
        return t * (gain * (2.0 / fan_in) ** 0.5 / float(t.std()))
    return tree_map(fix, tree)


def small_towers():
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    return {"resnet152": unit_scale(init_resnet(
                g(), ResNetConfig((3, 8, 36, 3), 2))),
            "roberta": init_roberta(g(), RobertaConfig(vocab_size=1000,
                                                       num_layers=2)),
            "vit": init_vit(g(), ViTConfig(num_layers=2))}


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    d = tmp_path_factory.mktemp("towers")
    trees = small_towers()
    for name, tree in trees.items():
        os.makedirs(d / name)
        torch.save(tree, d / name / "state.pt")
    return str(d), trees


def compare(name, want: dict, got: dict) -> int:
    """Outputs within PROBE_TOL; returns the values whose rounding to 1e-3
    (the checksum's) differs."""
    assert set(want) == set(got)
    flipped = 0
    for k in want:
        w, g = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        assert w.shape == g.shape, (name, k)
        assert np.isfinite(w).all() and np.isfinite(g).all()
        bound = PROBE_TOL * (1 + np.abs(w).max())
        assert np.abs(w - g).max() <= bound, (name, k, np.abs(w - g).max())
        flipped += int((np.round(w, 3) != np.round(g, 3)).sum())
    return flipped


def test_probe_inputs_equal_jax():
    key = jax.random.PRNGKey(1)
    got = tt.probe_inputs()
    ids = np.asarray(jax.random.randint(key, (1, 16), 4, 1000))
    np.testing.assert_array_equal(got["roberta"], ids)
    assert got["roberta"].dtype == ids.dtype == np.int32
    for name, shape in (("resnet152", (1, 224, 224, 3)),
                        ("vit", (1, 224, 224, 3)),
                        ("facenet", (1, 160, 160, 3)),
                        ("pnet", (1, 12, 12, 3)), ("rnet", (1, 24, 24, 3)),
                        ("onet", (1, 48, 48, 3)),
                        ("yolov3", (1, 128, 128, 3))):
        want = np.asarray(jax.random.normal(key, shape))
        assert got[name].dtype == want.dtype == np.float32
        assert np.abs(got[name] - want).max() <= 1e-6, name


def test_split_and_bits_equal_jax():
    key = jax.random.PRNGKey(123456789)
    np.testing.assert_array_equal(jax_random.prng_key(123456789),
                                  np.asarray(key))
    np.testing.assert_array_equal(
        jax_random.split(np.asarray(key), 3),
        np.asarray(jax.random.split(key, 3)))
    np.testing.assert_array_equal(
        jax_random.random_bits(np.asarray(key), (5, 7)),
        np.asarray(jax.random.bits(key, (5, 7), np.uint32)))


def check_probe(d, trees, name):
    """The port's probe of towers/<name> against tell_tpu's (jitted) on
    the same tree; logs the values whose 1e-3 rounding differs."""
    status, _, got = tt.probe_outputs(d, name, "cpu")
    want = jax.jit(lambda p: jt.PROBES[name](p)[2])(to_numpy(trees[name]))
    assert status == "CONVERTED"
    flipped = compare(name, {k: np.asarray(v) for k, v in want.items()},
                      got)
    n = sum(np.asarray(v).size for v in want.values())
    log.warning("towers verify %s: %d of %d outputs round to another 1e-3 "
                "step in the port than in tell_tpu", name, flipped, n)
    return flipped, n


@pytest.mark.parametrize("name", ["resnet152", "roberta", "vit"])
def test_probe_outputs_match_tell_tpu(towers, name):
    check_probe(*towers, name)


def test_rows_and_checksum_are_tell_tpus(towers):
    d, trees = towers
    rows = tt.rows(d, ["roberta"], "cpu")
    for row, name in zip(rows, ["roberta"]):
        params = to_numpy(trees[name])
        outs = jax.jit(lambda p: jt.PROBES[name](p)[2])(params)
        assert set(row) == {"tower", "status", "params", "outputs",
                            "checksum"}
        assert row["params"] == jt._param_count(params)
        assert row["outputs"] == {k: list(np.asarray(v).shape)
                                  for k, v in outs.items()}
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(3, 5)).astype(np.float32),
              rng.normal(size=(7,))]
    assert tt._checksum(*arrays) == jt._checksum(*arrays)
    assert tt._checksum(arrays[0]) != tt._checksum(arrays[0] + 1e-2)


def test_statuses_and_exit_codes(tmp_path, towers, capsys):
    d, _ = towers
    rows = {r["tower"]: r for r in tt.rows(str(tmp_path), ["facenet",
                                                           "mtcnn"])}
    assert rows["facenet"]["status"] == rows["mtcnn"]["status"] == \
        "NO CHECKPOINT (converter-only tower)"
    # a converted ViT: probed like the other towers, tell_tpu's shapes
    vit = tt.rows(d, ["vit"], "cpu")[0]
    assert vit["status"] == "CONVERTED"
    assert vit["outputs"] == {"features": [1, 197, 1024]}
    assert vit["params"] == tt._param_count(towers[1]["vit"])
    # broken trees and an orbax-form one: ERROR rows, exit 1
    for name in ("mtcnn", "vit"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "state.pt").write_bytes(b"not a torch file")
    (tmp_path / "roberta").mkdir()
    (tmp_path / "roberta" / "_METADATA").write_text("{}")
    assert main(["towers", "verify", str(tmp_path), "--json", "--device",
                 "cpu", "-t", "mtcnn", "-t", "roberta", "-t", "vit"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [r["tower"] for r in out] == ["mtcnn", "roberta", "vit"]
    assert out[0]["status"].startswith("ERROR")
    assert out[2]["status"].startswith("ERROR")
    assert out[1]["status"].startswith("ERROR") and \
        "migrate/orbax_to_torch.py towers" in out[1]["status"]
    assert main(["towers", "verify", d, "--device", "cpu", "-t", "roberta",
                 "-t", "vit"]) == 0
    text = capsys.readouterr().out
    assert text.count("CONVERTED") == 2 and "NOT PORTED" not in text


def test_verify_needs_the_card_or_device_cpu(towers):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["towers", "verify", towers[0]])
