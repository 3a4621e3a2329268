"""The port's tower-side dataset tools against tell_tpu's, on the CPU at a
small size, each run in-process through its main(): detect_faces
(tell_tpu_torch/tools/detect_faces.py against tools/detect_faces.py) and
annotate_objects (tell_tpu_torch/tools/annotate_objects.py against
tools/annotate_objects.py) over processed news photos.

The towers are the small ones of tests/test_torch_vision_towers.py, drawn
here by the port's initialisers (no JAX compile): MTCNN with its face
logits raised (tests/test_torch_mtcnn.py's FACE_BIAS), FaceNet at repeats
(1, 1, 1), the reduced YOLOv3 of tests/test_torch_yolov3.py and the small
ResNet of tests/test_torch_vision.py, each with its test's batch-norm
scales. tell_tpu's tools get them in place of their orbax restores and
full-width configs; the port's read them from state.pt files as its
loaders do. Tolerances: face boxes, confidences and
embeddings within 1e-5 absolute + 1e-5 relative; object boxes and scores
the same, their int() crops equal but for a coordinate within 1e-3 px of
an integer (a flip, counted), object rows on equal crops within 1e-5 +
1e-5. Face boxes and confidences come out of MTCNN's three-stage cascade,
which amplifies the nets' 1e-5 (tests/test_torch_mtcnn.py): they are held
within its BOX_TOL px and PROB_TOL. The photos are the processed news
photos' centre 96 x 96 (the tools take any size). tell_tpu's
detect_and_embed runs detect_faces, extract_faces and facenet_forward
eagerly, one compile per primitive; the test hands it their jitted forms,
as tests/test_torch_mtcnn.py runs them. Also: the objects line's keys, and which package's
load_objects_jsonl reads which tool's file."""
import json
import os
import sys

import jax
import numpy as np
import orbax.checkpoint
import pytest
import torch

import tell_tpu.data.pipeline as jpipeline
import tell_tpu.models.backbones.facenet as jf
import tell_tpu.models.backbones.mtcnn as jm
import tell_tpu.models.backbones.resnet as jr
import tell_tpu.models.backbones.yolov3 as jy
import tell_tpu_torch.data.pipeline as tpipeline
from tell_tpu_torch.bridge import (init_facenet, init_mtcnn, init_yolov3,
                                   to_numpy, to_torch)
from tell_tpu_torch.config import NotPortedError
from tell_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
from tell_tpu_torch.models.backbones import facenet as tf
from tell_tpu_torch.models.backbones import resnet as tr
from tell_tpu_torch.tools import annotate_objects as port_objects
from tell_tpu_torch.tools import detect_faces as port_faces
from tests import test_torch_facenet as ftest
from tests import test_torch_mtcnn as mtest
from tests import test_torch_vision as vtest
from tests import test_torch_yolov3 as ytest
from tools import annotate_objects as ref_objects
from tools import detect_faces as ref_faces

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
SIDE = 96
FLIP_PX = 1e-3
MAX_OBJECTS = 8      # tell_tpu's crops resize eagerly, a compile per size
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "images")
# processed news photos (tell_tpu's process_images output) as <hash>.jpg
PHOTOS = {"0a" * 12: "processed/news_a_320x240_420.jpg",
          "0b" * 12: "processed/news_b_200x300_420.jpg",
          "0c" * 12: "processed/news_b_200x300_420_png.jpg"}


def _towers() -> dict:
    """The small towers as tell_tpu's trees (numpy leaves)."""
    g = torch.Generator().manual_seed(0)
    mt = to_numpy(init_mtcnn(g))
    for net, name in (("pnet", "conv4_1"), ("rnet", "dense5_1"),
                      ("onet", "dense6_1")):
        w, b = mt[net][name]
        mt[net][name] = (w, b + np.float32([0.0, mtest.FACE_BIAS]))
    defs = ytest._small_defs()
    return {"mtcnn": mt,
            "facenet": ftest._bn_scaled(to_numpy(init_facenet(
                g, tf.FaceNetConfig(repeats=ftest.SMALL))), 0),
            "yolov3": ytest.bn_scaled(to_numpy(init_yolov3(g, defs)), 0),
            "yolov3_defs": defs, "resnet": vtest._resnet_tree(),
            "resnet_cfg": jr.ResNetConfig(vtest.BLOCKS, vtest.WIDTH)}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The towers in both forms, an images dir and an articles JSONL whose
    sections name the photos (one twice, one missing)."""
    root = tmp_path_factory.mktemp("dataset")
    jt = _towers()
    for name, key in (("mtcnn", "mtcnn"), ("facenet", "facenet"),
                      ("yolov3", "yolov3"), ("resnet152", "resnet")):
        os.makedirs(root / "towers" / name)
        torch.save(to_torch(jt[key], "cpu"),
                   root / "towers" / name / "state.pt")
    os.makedirs(root / "images")
    for h, name in PHOTOS.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            rgb = decode_jpeg(f.read())
        at = (rgb.shape[0] - SIDE) // 2
        (root / "images" / f"{h}.jpg").write_bytes(
            encode_jpeg(rgb[at:at + SIDE, at:at + SIDE]))
    hashes = list(PHOTOS)
    arts = [{"_id": "a", "parsed_section": [
                {"type": "paragraph", "text": "P."},
                {"type": "caption", "text": "A.", "hash": hashes[0]},
                {"type": "caption", "text": "B.", "hash": hashes[1]}],
             "image_positions": [1, 2]},
            {"_id": "b", "parsed_section": [
                {"type": "caption", "text": "A again.", "hash": hashes[0]},
                {"type": "caption", "text": "Gone.", "hash": "f" * 24},
                {"type": "caption", "text": "C.", "hash": hashes[2]}],
             "image_positions": [0, 1, 2]}]
    with open(root / "articles.jsonl", "w") as f:
        for a in arts:
            f.write(json.dumps(a) + "\n\n")
    return root, jt


def _run(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    assert main() == 0
    return capsys.readouterr().out


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def faces(dataset):
    root, jt = dataset
    small = jf.FaceNetConfig(repeats=ftest.SMALL)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_faces, "load_towers", lambda d: {
            "mtcnn": jt["mtcnn"], "facenet": jt["facenet"]})
        mp.setattr(jf, "FaceNetConfig", lambda: small)
        mp.setattr(jm, "detect_faces", jax.jit(jm.detect_faces,
                                               static_argnums=2))
        mp.setattr(jm, "extract_faces", jax.jit(jm.extract_faces))
        mp.setattr(jf, "facenet_forward", jax.jit(jf.facenet_forward,
                                                  static_argnums=1))
        for name, tool, extra in (("ref", ref_faces, []),
                                  ("port", port_faces, ["--device", "cpu"])):
            mp.setattr(sys, "argv", [
                "tool", "--articles", str(root / "articles.jsonl"),
                "--images", str(root / "images"), "--towers",
                str(root / "towers"), "--out", str(root / f"{name}.jsonl"),
                *extra])
            assert tool.main() == 0
            out[name] = _read(root / f"{name}.jsonl")
    return out


def test_faces_equal_tell_tpu(faces):
    ref, port = faces["ref"], faces["port"]
    assert len(port) == len(ref) == 2
    n = 0
    for ra, pa in zip(ref, port):
        assert ra.keys() == pa.keys()
        for rs, ps in zip(ra["parsed_section"], pa["parsed_section"]):
            assert rs.keys() == ps.keys()
            if "facenet_details" not in rs:
                continue
            rd, pd = rs["facenet_details"], ps["facenet_details"]
            assert pd["n_faces"] == rd["n_faces"] == len(pd["embeddings"])
            for rf, pf in zip(rd["frame_faces"], pd["frame_faces"]):
                np.testing.assert_allclose(pf["bbox"], rf["bbox"], rtol=0,
                                           atol=mtest.BOX_TOL)
                np.testing.assert_allclose(pf["confidence"],
                                           rf["confidence"], rtol=0,
                                           atol=mtest.PROB_TOL)
            np.testing.assert_allclose(pd["embeddings"], rd["embeddings"],
                                       **TOL)
            n += pd["n_faces"]
    assert n >= 3


def test_faces_written_for_the_images_found(dataset, faces):
    """Every image position whose <hash>.jpg exists gets its details (the
    photo named twice both times); a missing one is left as it is."""
    sections = [s for a in faces["port"] for s in a["parsed_section"]
                if s["type"] == "caption"]
    assert ["facenet_details" in s for s in sections] == [
        True, True, True, False, True]


@pytest.fixture(scope="module")
def objects(dataset):
    root, jt = dataset

    class Checkpointer:
        def restore(self, path):
            return {"yolov3": jt["yolov3"],
                    "resnet152": jt["resnet"]}[os.path.basename(path)]

    small_cfg = jt["resnet_cfg"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(orbax.checkpoint, "PyTreeCheckpointer", Checkpointer)
        mp.setattr(jy, "yolov3_spp_module_defs", lambda: jt["yolov3_defs"])
        mp.setattr(jr.ResNetConfig, "resnet152",
                   staticmethod(lambda: small_cfg))
        mp.setattr(port_objects, "yolov3_spp_module_defs",
                   lambda: jt["yolov3_defs"])
        mp.setattr(port_objects.ResNetConfig, "resnet152", staticmethod(
            lambda: tr.ResNetConfig(vtest.BLOCKS, vtest.WIDTH)))
        for name, tool, extra in (("ref", ref_objects, []),
                                  ("port", port_objects,
                                   ["--device", "cpu"])):
            mp.setattr(sys, "argv", [
                "tool", "--articles", str(root / "articles.jsonl"),
                "--images", str(root / "images"), "--towers",
                str(root / "towers"), "--out", str(root / f"obj_{name}.jsonl"),
                "--max-objects", str(MAX_OBJECTS), *extra])
            assert tool.main() == 0
            out[name] = _read(root / f"obj_{name}.jsonl")
    return out


def _spans(boxes):
    return [[int(v) for v in b] for b in boxes]


def test_objects_equal_tell_tpu(objects):
    ref, port = objects["ref"], objects["port"]
    assert [p["_id"] for p in port] == [p["hash"] for p in port] == list(
        PHOTOS)
    flips = rows = 0
    for r, p in zip(ref, port):
        rb, pb = np.asarray(r["boxes"]), np.asarray(p["boxes"])
        assert rb.shape == pb.shape and len(rb) >= 1
        np.testing.assert_allclose(pb, rb, **TOL)
        np.testing.assert_allclose(p["scores"], r["scores"], **TOL)
        for i, (rs, ps) in enumerate(zip(_spans(rb), _spans(pb))):
            if rs != ps:
                # a flip: the coordinates that differ lie within FLIP_PX
                # of an integer in tell_tpu's box
                near = np.abs(rb[i] - np.round(rb[i])) <= FLIP_PX
                assert all(near[j] for j in range(4) if rs[j] != ps[j])
                flips += 1
                continue
            np.testing.assert_allclose(p["object_features"][i],
                                       r["object_features"][i], **TOL)
            rows += 1
    assert rows >= 3 and flips <= 1


def test_objects_line_is_read_by_both_packages(dataset, objects):
    """tell_tpu's tool keys its lines by "_id", which its own reader (and
    the port's, keyed as tell_tpu's) cannot read; the port's lines carry
    "hash" as well, which both read."""
    root, _ = dataset
    port_line = objects["port"][0]
    assert list(port_line) == ["_id", "hash", "object_features", "boxes",
                               "scores"]
    assert port_line["_id"] == port_line["hash"]
    # tell_tpu's "_id" is the photo's height: the tool reuses `h`, the
    # hash, for img.shape[0] before it writes the line
    assert [r["_id"] for r in objects["ref"]] == [SIDE] * len(PHOTOS)
    assert "hash" not in objects["ref"][0]
    for reader in (jpipeline.load_objects_jsonl,
                   tpipeline.load_objects_jsonl):
        with pytest.raises(KeyError, match="hash"):
            reader(str(root / "obj_ref.jsonl"))
        lookup = reader(str(root / "obj_port.jsonl"))
        for line in objects["port"]:
            assert lookup(line["hash"]) == line


def test_tools_refuse_orbax_towers_and_a_missing_card(dataset, tmp_path,
                                                      monkeypatch, capsys):
    root, _ = dataset
    orbax_dir = tmp_path / "towers"
    for name in ("mtcnn", "facenet", "yolov3", "resnet152"):
        os.makedirs(orbax_dir / name)
        (orbax_dir / name / "_METADATA").write_text("{}")
    argv = ["--articles", str(root / "articles.jsonl"), "--images",
            str(root / "images"), "--towers", str(orbax_dir), "--out",
            str(tmp_path / "out.jsonl"), "--device", "cpu"]
    for tool in (port_faces, port_objects):
        with pytest.raises(NotPortedError, match="orbax_to_torch"):
            _run(tool.main, argv, monkeypatch, capsys)
    if not torch.cuda.is_available():
        argv[argv.index("--towers") + 1] = str(root / "towers")
        for tool in (port_faces, port_objects):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                _run(tool.main, argv[:-2], monkeypatch, capsys)
