"""tell_tpu's orbax towers through migrate/orbax_to_torch.py on the CPU:
for each tower, tools/convert_towers.py (orbax) and then the converter
give the tree, bit for bit and dtype for dtype, that
tell_tpu_torch.tools.convert_towers writes from the same seeded source
file; a `vit` tower is refused by name, and the CLI reads the result.

tools/convert_towers.py fixes RoBERTa-large's 24 layers, ResNet-152's
block counts and FaceNet's repeats, so the sources have those depths at
narrow widths (RoBERTa 16 wide, ResNet base width 2); MTCNN is its own
size and YOLOv3 a reduced darknet cfg (tests/test_torch_yolov3.py's).
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from tell_tpu_torch.bridge import init_facenet, init_mtcnn, to_numpy
from tell_tpu_torch.bridge import tree_leaves
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.models.backbones.facenet import FaceNetConfig
from tell_tpu_torch.models.backbones.resnet import ResNetConfig
from tell_tpu_torch.tools import convert_towers as port_convert
from tests import tower_writers
from tests.test_torch_resnet import torchvision_state_dict
from tests.test_torch_yolov3 import SMALL_CFG, _small_defs, _write_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "migrate"))
import orbax_to_torch  # noqa: E402

torch.set_num_threads(2)


def _jax_tools():
    """tools/convert_towers.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_convert_towers", os.path.join(ROOT, "tools",
                                           "convert_towers.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hf_roberta(layers=24, dim=16, ffn=32, vocab=50, positions=20):
    g = torch.Generator().manual_seed(6)
    t = lambda *s: torch.randn(s, generator=g) * 0.05  # noqa: E731
    sd = {"embeddings.word_embeddings.weight": t(vocab, dim),
          "embeddings.position_embeddings.weight": t(positions, dim),
          "embeddings.token_type_embeddings.weight": t(1, dim),
          "embeddings.LayerNorm.weight": 1 + t(dim),
          "embeddings.LayerNorm.bias": t(dim)}
    for i in range(layers):
        pre = f"encoder.layer.{i}."
        for name, (dout, din) in (
                ("attention.self.query", (dim, dim)),
                ("attention.self.key", (dim, dim)),
                ("attention.self.value", (dim, dim)),
                ("attention.output.dense", (dim, dim)),
                ("intermediate.dense", (ffn, dim)),
                ("output.dense", (dim, ffn))):
            sd[pre + name + ".weight"] = t(dout, din)
            sd[pre + name + ".bias"] = t(dout)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + name + ".weight"] = 1 + t(dim)
            sd[pre + name + ".bias"] = t(dim)
    return sd


def _sources(tmp):
    """{tower: (tools/convert_towers.py call, the port's call)}, each
    reading the same seeded source files."""
    tools = _jax_tools()
    src = {}
    torch.save(_hf_roberta(), tmp / "roberta.pt")
    src["roberta"] = (lambda o: tools.convert_roberta(str(tmp / "roberta.pt"),
                                                      o),
                      lambda o: port_convert.convert_roberta(
                          str(tmp / "roberta.pt"), o))
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          torchvision_state_dict(ResNetConfig((3, 8, 36, 3), 2),
                                 seed=7).items()}
    torch.save(sd, tmp / "resnet.pth")
    src["resnet152"] = (lambda o: tools.convert_resnet(
        str(tmp / "resnet.pth"), o), lambda o: port_convert.convert_resnet(
        str(tmp / "resnet.pth"), o))
    tree = init_facenet(torch.Generator().manual_seed(8), FaceNetConfig())
    torch.save(tower_writers.facenet_pytorch_state(
        to_numpy(tree), np.random.default_rng(8)), tmp / "facenet.pt")
    src["facenet"] = (lambda o: tools.convert_facenet(
        str(tmp / "facenet.pt"), o), lambda o: port_convert.convert_facenet(
        str(tmp / "facenet.pt"), o))
    paths = []
    for net, sd in zip(("pnet", "rnet", "onet"), tower_writers.mtcnn_states(
            to_numpy(init_mtcnn(torch.Generator().manual_seed(9))))):
        torch.save(sd, tmp / f"{net}.pt")
        paths.append(str(tmp / f"{net}.pt"))
    src["mtcnn"] = (lambda o: tools.convert_mtcnn(paths, o),
                    lambda o: port_convert.convert_mtcnn(paths, o))
    (tmp / "yolo.cfg").write_text(SMALL_CFG)
    _write_weights(str(tmp / "yolo.weights"), _small_defs(), (0, 2, 5))
    src["yolov3"] = (lambda o: tools.convert_yolo(
        str(tmp / "yolo.cfg"), str(tmp / "yolo.weights"), o),
        lambda o: port_convert.convert_yolo(
            str(tmp / "yolo.cfg"), str(tmp / "yolo.weights"), o))
    return src


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(tell_tpu's orbax towers converted by the migrator, the port's
    convert_towers output)."""
    tmp = tmp_path_factory.mktemp("towers")
    orbax, port = tmp / "orbax", tmp / "port"
    for jax_side, port_side in _sources(tmp).values():
        jax_side(str(orbax))
        port_side(str(port))
    written = orbax_to_torch.convert_towers(str(orbax), str(tmp / "out"))
    assert len(written) == 5
    return tmp / "out", port, orbax


def _same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (set(a) ^ set(b))
        for k in a:
            assert type(k) is type(next(x for x in b if x == k))
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["roberta", "resnet152", "facenet",
                                  "mtcnn", "yolov3"])
def test_migrated_tower_equals_the_ports_conversion(converted, name):
    out, port, _ = converted
    got = torch.load(out / name / "state.pt", weights_only=True)
    want = torch.load(port / name / "state.pt", weights_only=True)
    _same_tree(got, want)
    assert len(tree_leaves(got)) > 3


def test_in_place_conversion_and_the_cli_reads_it(converted, tmp_path):
    import shutil

    from tell_tpu_torch.commands import towers
    _, port, orbax = converted
    inplace = tmp_path / "towers"
    shutil.copytree(orbax / "mtcnn", inplace / "mtcnn")
    rows = towers.rows(str(inplace), ["mtcnn"], "cpu")
    assert rows[0]["status"].startswith("ERROR") and \
        "orbax_to_torch.py towers" in rows[0]["status"]
    assert orbax_to_torch.main(["towers", str(inplace)]) == 0
    assert (inplace / "mtcnn" / "_METADATA").exists()
    rows = towers.rows(str(inplace), ["mtcnn"], "cpu")
    assert rows[0]["status"] == "CONVERTED"


def test_vit_is_refused_by_name(tmp_path):
    (tmp_path / "vit").mkdir()
    with pytest.raises(NotPortedError, match="ViT.*item 8, cut 4"):
        orbax_to_torch.convert_towers(str(tmp_path))
