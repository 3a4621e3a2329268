"""Raw photos through the port's service, encode and preprocess against
tell_tpu's, on the CPU at a small size.

A captioner with an image context of 49 x 256 (the grid of a ResNet of
blocks (1, 1, 1, 1) and width 8 on a 224 crop), a 24-token article, and
face and object rows from the requests; weights from tell_tpu's
initialisers and one ResNet tree carried across; the quality corpus's
tokenizer. Tolerances: grids within atol 1e-5 + rtol 1e-5 (fp32, two conv
libraries), caption token ids equal.
"""
import base64
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tell_tpu.config import ContextSpec, small_test_config
from tell_tpu.data.images import resize_shortest_crop as j_crop
from tell_tpu.data.tokenizer import RobertaTokenizer as JTokenizer
from tell_tpu.models.backbones import resnet as jr
from tell_tpu.models.backbones.roberta import (
    RobertaConfig as JRobertaConfig, init_roberta as j_init_roberta)
from tell_tpu.models.captioner import (encode_contexts as j_encode,
                                       init_captioner as j_init)
from tell_tpu.serving.server import CaptionService as JService
from tell_tpu.serving.vision import VisionPipeline as JVision
from tell_tpu_torch.bridge import init_resnet, to_numpy, to_torch, tree_leaves
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.data.images import resize_shortest_crop
from tell_tpu_torch.data.jpeg import decode_jpeg
from tell_tpu_torch.data.pipeline import make_image_grid_fn
from tell_tpu_torch.data.tokenizer import RobertaTokenizer
from tell_tpu_torch.models.backbones import resnet as tr
from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                     RobertaEncoder)
from tell_tpu_torch.models.captioner import encode_contexts
from tell_tpu_torch.serving import CaptionService
from tell_tpu_torch.serving.vision import VisionPipeline

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
HERE = os.path.dirname(os.path.abspath(__file__))
QUALITY = os.path.join(HERE, "fixtures", "quality")
IMAGES = os.path.join(HERE, "fixtures", "images")
BLOCKS, WIDTH = (1, 1, 1, 1), 8
_base = small_test_config(gen_len=5)
CFG = dataclasses.replace(_base, decoder=dataclasses.replace(
    _base.decoder, contexts=(ContextSpec("image", 256, 49),
                             ContextSpec("article", 32, 24),
                             ContextSpec("faces", 16, 4),
                             ContextSpec("obj", 32, 8))))
RK = dict(vocab_size=708, dim=32, num_layers=2, num_heads=2, ffn_dim=64,
          max_positions=30)
TEXT = "Anna Smith went to Milan to open the new museum of modern art."


def _b64(name):
    with open(os.path.join(IMAGES, name), "rb") as f:
        return base64.b64encode(f.read()).decode()


def _resnet_tree():
    """The port's init with batch-norm scales of a trained tower's order,
    so activations stay of order 1 (numpy leaves)."""
    tree = to_numpy(init_resnet(torch.Generator().manual_seed(7),
                                tr.ResNetConfig(BLOCKS, WIDTH)))
    rng = np.random.default_rng(7)

    def bn(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias"}:
                c = node["scale"].shape
                return {"scale": rng.uniform(0.3, 0.6, c).astype(np.float32),
                        "bias": rng.normal(0, 0.05, c).astype(np.float32)}
            return {k: bn(v) for k, v in node.items()}
        if isinstance(node, list):
            return [bn(v) for v in node]
        return node
    return bn(tree)


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, jax.jit(lambda r: j_init(r, CFG))(
        jax.random.PRNGKey(0)))
    rparams = jax.tree.map(np.asarray, jax.jit(
        lambda r: j_init_roberta(r, JRobertaConfig(**RK)))(
            jax.random.PRNGKey(1)))
    resnet = _resnet_tree()
    jfrozen = {"roberta": rparams, "roberta_cfg": JRobertaConfig(**RK),
               "resnet": resnet, "resnet_cfg": jr.ResNetConfig(BLOCKS, WIDTH)}
    towers = {"resnet": tr.prepare_resnet(to_torch(resnet, "cpu")),
              "resnet_cfg": tr.ResNetConfig(BLOCKS, WIDTH)}
    vocab, merges = (os.path.join(QUALITY, "vocab.json"),
                     os.path.join(QUALITY, "merges.txt"))
    jsvc = JService(params, jfrozen, CFG,
                    JTokenizer.from_files(vocab, merges, use_native=False),
                    max_batch=4, article_len=24)
    svc = CaptionService(
        params, RobertaEncoder(to_torch(rparams, "cpu"), RobertaConfig(**RK)),
        CFG, "cpu", tokenizer=RobertaTokenizer.from_files(vocab, merges),
        max_batch=4, article_len=24, towers=towers)
    yield dict(params=params, resnet=resnet, jfrozen=jfrozen, jsvc=jsvc,
               svc=svc, towers=towers)
    svc.close()
    jsvc.close()


def _requests():
    img = decode_jpeg(base64.b64decode(_b64("news_b_200x300_420.jpg")))
    return [
        {"context": TEXT, "image_b64": _b64("news_a_320x240_420.jpg")},
        {"context": "A crowd gathers in the square.", "image": img.tolist()},
        {"title": "Museum opens", "image_position": 1,
         "sections": [{"type": "paragraph", "text": TEXT},
                      {"type": "caption", "text": "",
                       "image_data": _b64("rgb_101x67_444.jpg")},
                      {"type": "paragraph", "text": "Crowds came early."}]},
    ]


def test_vision_process_equals_tell_tpu(models):
    jv = JVision(models["jfrozen"])
    tv = VisionPipeline(models["towers"],
                        wanted={"image": 49, "faces": 4, "obj": 8})
    for req in _requests()[:2] + [{"image_b64": _b64("grey_67x101.jpg")}]:
        want, got = jv.process(req), tv.process(req)
        assert set(got) == set(want) == {"image_grid"}
        assert got["image_grid"].shape == (49, 256)
        np.testing.assert_allclose(got["image_grid"], want["image_grid"],
                                   **TOL)
    assert tv.process({"context": "x"}) == {}
    assert tv.process({**_requests()[1], "image_grid": [[0.0]]}) == {}
    off = VisionPipeline(models["towers"],
                         wanted={"image": 0})
    assert off.process(_requests()[1]) == {}


def test_pack_grids_and_caption_ids_equal_tell_tpu(models):
    reqs = _requests()
    jbatch, jerr = models["jsvc"]._pack(reqs)
    batch, err = models["svc"]._pack(reqs)
    assert jerr == err == [None] * 3
    np.testing.assert_array_equal(batch["context_ids"],
                                  np.asarray(jbatch["context_ids"]))
    assert (np.abs(batch["image_grid"]).max(axis=(1, 2)) > 0).all()
    np.testing.assert_allclose(batch["image_grid"], jbatch["image_grid"],
                               **TOL)
    for req in reqs:
        want, got = models["jsvc"].caption(req), models["svc"].caption(req)
        assert "error" not in got
        assert got["token_ids"] == list(want["token_ids"])


def test_sections_photo_is_embedded_not_zero(models):
    """The scrape flow's sections[image_position].image_data decodes to the
    grid of that photo (it was a zero grid before the tower was ported)."""
    req = _requests()[2]
    batch, err = models["svc"]._pack([req])
    assert err == [None]
    img = decode_jpeg(base64.b64decode(_b64("rgb_101x67_444.jpg")))
    want = tr.image_grid(models["towers"]["resnet"],
                         tr.ResNetConfig(BLOCKS, WIDTH),
                         resize_shortest_crop(img).astype(np.float32))
    np.testing.assert_array_equal(batch["image_grid"][0], want)
    assert np.abs(want).max() > 0.1
    # the positions without image_data carry no photo
    for pos in (0, 2):
        b, e = models["svc"]._pack([{**req, "image_position": pos}])
        assert e == [None] and not b["image_grid"].any()


def test_bad_image_is_isolated_in_its_micro_batch(models):
    svc = models["svc"]
    good = _requests()[:2]
    with open(os.path.join(IMAGES, "refused_progressive.jpg"), "rb") as f:
        progressive = base64.b64encode(f.read()).decode()
    batch = [good[0], {"context": TEXT, "image_b64": "%%% not base64"},
             {"context": TEXT, "image_b64": progressive}, good[1]]
    out = svc._run(batch)
    assert "error" not in out[0] and "error" not in out[3]
    assert out[1]["error"].startswith("bad request image:")
    assert "progressive" in out[2]["error"] and "item 8" in out[2]["error"]
    for i in (0, 3):
        assert out[i]["token_ids"] == svc.caption(batch[i])["token_ids"]
    # the failed rows keep their text and an empty image, as tell_tpu's
    want = models["jsvc"]._run([batch[1]])[0]
    assert out[1]["token_ids"] == list(want["token_ids"])
    assert want["error"].startswith("bad request image:")


@pytest.mark.parametrize("sections,pos", [
    (["just text", {"image_data": "x"}], 0),
    ([[1, 2]], 0),
    ({"1": {"image_data": "x"}}, 1),
    ([{"type": "paragraph", "text": TEXT}], 5),
    ([{"type": "paragraph", "text": TEXT}], "first"),
])
def test_malformed_section_is_judged_as_tell_tpu_judges_it(models, sections,
                                                          pos):
    """A section that is not a dict, or sections that are not a list, make
    a bad request image in both packages (never a silent zero grid); a
    position past the sections, or not a number, means no photo."""
    req = {"context": TEXT, "sections": sections, "image_position": pos}
    _, jerr = models["jsvc"]._pack([req])
    _, err = models["svc"]._pack([req])
    assert (err[0] is None) == (jerr[0] is None)
    if jerr[0] is not None:
        assert err[0].startswith("bad request image:")
        assert jerr[0].startswith("bad request image:")


def _port_form_towers(root, monkeypatch):
    """mtcnn, facenet, yolov3 and resnet152 as convert_towers writes them
    (state.pt of tell_tpu's trees as torch tensors) under root/towers:
    MTCNN at its full size, FaceNet at repeats (1, 1, 1), the reduced
    YOLOv3 of tests/test_torch_yolov3.py and the small ResNet, which the
    loader and the pipeline take in place of the full-size defaults;
    random inits from the port's initialisers."""
    from tell_tpu_torch.bridge import init_facenet, init_mtcnn, init_yolov3
    from tell_tpu_torch.models.backbones.facenet import FaceNetConfig
    from tell_tpu_torch.serving import vision
    from tests.test_torch_yolov3 import _small_defs
    monkeypatch.setattr(tr.ResNetConfig, "resnet152",
                        staticmethod(lambda: tr.ResNetConfig(BLOCKS, WIDTH)))
    monkeypatch.setattr(vision, "yolov3_spp_module_defs", _small_defs)
    monkeypatch.setattr(vision, "DET_CANVAS", 64)
    g = torch.Generator().manual_seed(3)
    mtcnn = init_mtcnn(g)
    for net, name in (("pnet", "conv4_1"), ("rnet", "dense5_1"),
                      ("onet", "dense6_1")):
        mtcnn[net][name][1][1] += 3.0      # faces pass at random init
    trees = {"mtcnn": mtcnn,
             "facenet": init_facenet(g, FaceNetConfig(repeats=(1, 1, 1))),
             "yolov3": init_yolov3(g, _small_defs()),
             "resnet152": to_torch(_resnet_tree(), "cpu")}
    for name, tree in trees.items():
        (root / "towers" / name).mkdir(parents=True)
        torch.save(tree, root / "towers" / name / "state.pt")


def test_towers_in_the_ports_form_are_loaded_and_used(tmp_path, monkeypatch):
    """serve's loader reads the three towers (and the ResNet) from the
    towers directory onto the device in their forwards' layouts, and the
    service built from them, as cmd_serve builds it, computes a photo's
    faces and objects."""
    from tell_tpu_torch.commands.__main__ import _frozen_towers, _load
    from tests.test_torch_cli import write_e2e_config
    cfg = write_e2e_config(tmp_path)
    _port_form_towers(tmp_path, monkeypatch)
    exp = _load(type("A", (), {"config": cfg, "overrides": None})())
    frozen = _frozen_towers(exp, "cpu")
    assert {"mtcnn", "facenet", "yolov3", "resnet"} <= set(frozen)
    assert frozen["mtcnn"]["pnet"]["conv1"][0].shape == (10, 3, 3, 3)  # OIHW
    assert list(frozen["yolov3"]["convs"]) == [0, 1, 2, 3, 5, 10, 15]
    tv = VisionPipeline({k: frozen[k] for k in ("resnet", "resnet_cfg",
                                                "mtcnn", "facenet",
                                                "yolov3")})
    assert tv.has_grid and tv.has_faces and tv.has_objects
    out = tv.process({"image_b64": _b64("news_a_320x240_420.jpg")})
    assert out["face_embeds"].shape == (4, 512)
    assert out["obj_embeds"].shape == (64, 256)
    assert not np.isnan(out["face_embeds"][0]).any()
    assert not np.isnan(out["obj_embeds"][0]).any()


@pytest.mark.parametrize("name", ["mtcnn", "facenet", "yolov3"])
def test_a_tell_tpu_form_tower_is_refused_by_name(tmp_path, name):
    """A towers/<name> without state.pt (tell_tpu's orbax tree) is refused
    by serve, naming the directory and the converter's flag; it is never
    skipped."""
    from tell_tpu_torch.commands.__main__ import main
    from tests.test_torch_cli import write_e2e_config
    cfg = write_e2e_config(tmp_path)
    (tmp_path / "towers" / name / "checkpoint").mkdir(parents=True)
    flag = {"mtcnn": "--mtcnn", "facenet": "--facenet",
            "yolov3": "--yolo-cfg"}[name]
    with pytest.raises(NotPortedError, match=f"towers/{name} holds no "
                       f"state.pt.*item 6.*{flag}"):
        main(["serve", cfg, "--device", "cpu"])


def test_encode_contexts_image_branch_equals_tell_tpu(models):
    rng = np.random.default_rng(3)
    image = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(3, 700, (2, 24))
    ids[:, 0] = 0
    want = jax.jit(lambda b: j_encode(models["jfrozen"], CFG, b))(
        {"context_ids": jnp.asarray(ids), "image": jnp.asarray(image)})
    tree = tr.prepare_resnet(to_torch(models["resnet"], "cpu"))
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    frozen = {**models["svc"].roberta.frozen(), "resnet": tree,
              "resnet_cfg": tr.ResNetConfig(BLOCKS, WIDTH)}
    cap_params = to_torch(models["params"], "cpu")
    for leaf in tree_leaves(cap_params):
        leaf.requires_grad_(True)
    out = encode_contexts(frozen, CFG, {"context_ids": torch.from_numpy(ids),
                                        "image": torch.from_numpy(image)})
    assert out["image_grid"].shape == (2, 4, 256)
    assert not out["image_grid"].requires_grad
    np.testing.assert_allclose(out["image_grid"].numpy(),
                               np.asarray(want["image_grid"]), **TOL)
    # a grid given with the batch is kept, and no tower runs
    given = torch.ones(2, 4, 256)
    kept = encode_contexts(frozen, CFG, {"image": torch.zeros(2, 8, 8, 3),
                                         "image_grid": given})
    assert kept["image_grid"] is given
    # the loss reaches the captioner, never the tower
    batch = {**out, "caption_ids": torch.from_numpy(
                 rng.integers(3, 100, (2, 6))),
             "image_grid": torch.nn.functional.pad(
                 out["image_grid"], (0, 0, 0, 45)),
             "face_embeds": torch.full((2, 4, 16), float("nan")),
             "obj_embeds": torch.full((2, 8, 32), float("nan"))}
    from tell_tpu_torch.models.captioner import captioner_loss
    loss, _ = captioner_loss(cap_params, CFG, batch)
    loss.backward()
    assert all(leaf.grad is not None for leaf in tree_leaves(cap_params)
               if leaf.requires_grad and leaf.dim() > 1)
    assert all(leaf.grad is None for leaf in tree_leaves(tree))


def test_make_image_grid_fn_equals_tell_tpus_pieces(models, tmp_path,
                                                    monkeypatch):
    """The port's preprocess embed against tell_tpu's crop (Pillow),
    preprocess_image and resnet_forward on the same tree."""
    monkeypatch.setattr(tr.ResNetConfig, "resnet152",
                        staticmethod(lambda: tr.ResNetConfig(BLOCKS, WIDTH)))
    (tmp_path / "imgs").mkdir()
    (tmp_path / "towers" / "resnet152").mkdir(parents=True)
    torch.save(to_torch(models["resnet"], "cpu"),
               tmp_path / "towers" / "resnet152" / "state.pt")
    for name, ext in (("news_a_320x240_420.jpg", ".jpg"),
                      ("rgb_67x101_422.jpg", ".jpeg")):
        with open(os.path.join(IMAGES, name), "rb") as f:
            (tmp_path / "imgs" / (name[:-4] + ext)).write_bytes(f.read())
    fn = make_image_grid_fn(str(tmp_path / "imgs"), str(tmp_path / "towers"),
                            "cpu")
    forward = jax.jit(lambda img: jr.resnet_forward(
        models["resnet"], jr.ResNetConfig(BLOCKS, WIDTH),
        jr.preprocess_image(img[None] / 255.0))[0])
    for name in ("news_a_320x240_420", "rgb_67x101_422"):
        got = fn(name)
        crop = np.asarray(j_crop(Image.open(os.path.join(
            IMAGES, name + ".jpg")).convert("RGB")), np.float32)
        want = forward(jnp.asarray(crop))
        assert got.shape == (49, 256)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
