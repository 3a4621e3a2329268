"""tell_tpu's orbax towers through migrate/orbax_to_torch.py on the CPU:
for each tower, tools/convert_towers.py (orbax) and then the converter
give the tree, bit for bit and dtype for dtype, that
tell_tpu_torch.tools.convert_towers writes from the same seeded source
file, ViT-L/16 included, and the CLI reads the result.

tools/convert_towers.py fixes RoBERTa-large's 24 layers, ResNet-152's
block counts, ViT-L's 24 layers and 197 tokens and FaceNet's repeats, so
the sources have those depths at narrow widths (RoBERTa 16 wide, ResNet
base width 2, ViT 16 wide); MTCNN is its own size and YOLOv3 a reduced
darknet cfg (tests/test_torch_yolov3.py's).
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
from tell_tpu_torch.models.backbones.vit import ViTConfig
from tell_tpu_torch.tools import convert_towers as port_convert
from tests import tower_writers
from tests.test_torch_resnet import torchvision_state_dict
from tests.test_torch_vit import _hf_state
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
    torch.save({k: torch.from_numpy(v) for k, v in _hf_state(
        10, ViTConfig(dim=16, ffn_dim=32)).items()}, tmp / "vit.pt")
    src["vit"] = (lambda o: tools.convert_vit(str(tmp / "vit.pt"), o),
                  lambda o: port_convert.convert_vit(str(tmp / "vit.pt"), o))
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
    assert len(written) == 6
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
                                  "mtcnn", "yolov3", "vit"])
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


def test_vit_is_refused_by_name(converted, tmp_path):
    """A vit tower is no longer refused: alone in a towers directory it
    converts, load_vit reads it, and it encodes ViT-L's 197 tokens."""
    import shutil

    from tell_tpu_torch.models.backbones.vit import load_vit, vit_encode
    _, _, orbax = converted
    shutil.copytree(orbax / "vit", tmp_path / "vit")
    assert orbax_to_torch.convert_towers(str(tmp_path)) == [
        str(tmp_path / "vit" / "state.pt")]
    tree = load_vit(str(tmp_path / "vit"), "cpu")
    assert len(tree["layers"]) == 24 and tree["pos_embed"].shape == (197, 16)
    with torch.inference_mode():
        out = vit_encode(tree, ViTConfig(dim=16, num_heads=2, ffn_dim=32),
                         torch.zeros(1, 224, 224, 3))
    assert out.shape == (1, 197, 16) and bool(torch.isfinite(out).all())
    with pytest.raises(NotPortedError, match="orbax_to_torch.py towers"):
        load_vit(str(orbax / "vit"), "cpu")


def test_a_modern_runs_params_convert(tmp_path):
    """`run` on a modern family's checkpoint (expt 12's form: the stacked
    experts [E, D, F], the router, the tied embedding) carries every
    leaf across bit for bit, and the port decodes it."""
    import jax
    import orbax.checkpoint as ocp

    from tell_tpu.config import ContextSpec as JSpec
    from tell_tpu.models import llm_decoder as J
    from tell_tpu_torch.config import ContextSpec, LLMConfig
    from tell_tpu_torch.models.llm_decoder import llm_generate
    fields = dict(vocab_size=50, dim=16, num_layers=1, num_heads=4,
                  num_kv_heads=2, ffn_dim=24, gen_len=3, moe_experts=4)
    ctx = (("article", 8, 5),)
    params = J.init_llm_decoder(jax.random.PRNGKey(0), J.LLMConfig(
        **fields, contexts=tuple(JSpec(*c) for c in ctx)))
    best = tmp_path / "run" / "checkpoints" / "best"
    ocp.PyTreeCheckpointer().save(str(best), {"params": params})
    written = orbax_to_torch.convert_run(str(tmp_path / "run"))
    assert written == [str(best)]
    got = torch.load(best / "state.pt", weights_only=True)["params"]
    assert got["layers"][0]["ffn"]["w1"].shape == (4, 16, 24)
    _same_tree(got, orbax_to_torch._torch(jax.tree.map(np.asarray, params)))
    batch = {"article": torch.randn(2, 5, 8),
             "article_mask": torch.zeros(2, 5, dtype=torch.bool)}
    out = llm_generate(got, LLMConfig(**fields, contexts=tuple(
        ContextSpec(*c) for c in ctx)), batch)
    assert out["token_ids"].shape == (2, 4)
