"""Faces and objects from a raw photo: the port's VisionPipeline with every
vision tower against tell_tpu's, and the port's CaptionService on such
photos, on the CPU at a small size.

The towers are tell_tpu's initialisers (drawn from rbg keys, which
compile faster than threefry) carried across: MTCNN with its face logits'
biases raised (tests/test_torch_mtcnn.py's FACE_BIAS, so faces pass the
thresholds at random init), FaceNet at repeats (1, 1, 1), the reduced
YOLOv3 of tests/test_torch_yolov3.py (its defs given as "yolov3_defs", as
tell_tpu's pipeline takes them) and the small ResNet of
tests/test_torch_vision.py; the detection canvas is 96 px in both
packages. Tolerances: grids, face and object rows within 1e-5 absolute +
1e-5 relative, the same rows absent (NaN) in the same places; caption
token ids equal."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tell_tpu.config import ContextSpec
from tell_tpu.models.backbones import facenet as jf
from tell_tpu.models.backbones import mtcnn as jm
from tell_tpu.models.backbones import resnet as jr
from tell_tpu.models.backbones import yolov3 as jy
from tell_tpu.serving import vision as jvision
from tell_tpu_torch.bridge import init_captioner, init_roberta, to_torch
from tell_tpu_torch.models.backbones import facenet as tf
from tell_tpu_torch.models.backbones import mtcnn as tm
from tell_tpu_torch.models.backbones import resnet as tr
from tell_tpu_torch.models.backbones import yolov3 as ty
from tell_tpu_torch.serving import CaptionService
from tell_tpu_torch.serving import vision as tvision
from tests import test_torch_facenet as ftest
from tests import test_torch_mtcnn as mtest
from tests import test_torch_vision as vtest
from tests import test_torch_yolov3 as ytest

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
CANVAS = 96
PHOTOS = ("news_a_320x240_420.jpg", "news_b_200x300_420.jpg",
          "rgb_101x67_444.jpg")
# faces 512 and objects 256 wide: the small ResNet's pooled rows
CFG = dataclasses.replace(vtest.CFG, decoder=dataclasses.replace(
    vtest.CFG.decoder, contexts=(ContextSpec("image", 256, 49),
                                 ContextSpec("article", 32, 24),
                                 ContextSpec("faces", 512, 4),
                                 ContextSpec("obj", 256, 8))))


def jax_towers() -> dict:
    """Every tower as tell_tpu's tree (numpy leaves)."""
    key = jax.random.key(0, impl="unsafe_rbg")
    mt = jax.tree.map(np.asarray, jax.jit(jm.init_mtcnn)(key))
    for net, name in (("pnet", "conv4_1"), ("rnet", "dense5_1"),
                      ("onet", "dense6_1")):
        w, b = mt[net][name]
        mt[net][name] = (w, b + np.float32([0.0, mtest.FACE_BIAS]))
    cfg = jf.FaceNetConfig(repeats=ftest.SMALL)
    fn = ftest._bn_scaled(jax.tree.map(np.asarray, jax.jit(
        lambda r: jf.init_facenet(r, cfg))(key)), 0)
    defs = ytest._small_defs()
    yolo = jax.tree.map(np.asarray, jax.jit(
        lambda r: jy.init_yolov3(r, defs))(key))
    return {"mtcnn": mt, "facenet": fn,
            "yolov3": ytest.bn_scaled(yolo, 0),
            "yolov3_defs": defs, "resnet": vtest._resnet_tree(),
            "resnet_cfg": jr.ResNetConfig(vtest.BLOCKS, vtest.WIDTH)}


def port_towers(jt: dict) -> dict:
    """The same trees in the port's forward layouts."""
    return {"mtcnn": tm.prepare_mtcnn(to_torch(jt["mtcnn"], "cpu")),
            "facenet": tf.prepare_facenet(to_torch(jt["facenet"], "cpu")),
            "yolov3": ty.prepare_yolov3(to_torch(jt["yolov3"], "cpu")),
            "yolov3_defs": jt["yolov3_defs"],
            "resnet": tr.prepare_resnet(to_torch(jt["resnet"], "cpu")),
            "resnet_cfg": tr.ResNetConfig(vtest.BLOCKS, vtest.WIDTH)}


@pytest.fixture(scope="module")
def towers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvision, "DET_CANVAS", CANVAS)
        mp.setattr(tvision, "DET_CANVAS", CANVAS)
        jt = jax_towers()
        yield jt, port_towers(jt)


def _rows_equal(got, want):
    absent = np.isnan(want).any(axis=1)
    np.testing.assert_array_equal(np.isnan(got).any(axis=1), absent)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~absent], want[~absent], **TOL)
    return int((~absent).sum())


def test_process_with_every_tower_equals_tell_tpu(towers):
    jt, pt = towers
    jv = jvision.VisionPipeline(jt)
    tv = tvision.VisionPipeline(pt)
    assert tv.has_grid and tv.has_faces and tv.has_objects
    for name in PHOTOS[:2]:          # landscape and portrait
        req = {"image_b64": vtest._b64(name)}
        want, got = jv.process(req), tv.process(req)
        assert set(got) == set(want) == {"image_grid", "face_embeds",
                                         "obj_embeds"}
        assert got["face_embeds"].shape == (4, 512)
        assert got["obj_embeds"].shape == (64, 256)
        np.testing.assert_allclose(got["image_grid"], want["image_grid"],
                                   **TOL)
        assert _rows_equal(got["face_embeds"], want["face_embeds"]) >= 1
        assert _rows_equal(got["obj_embeds"], want["obj_embeds"]) >= 1


def test_stages_run_only_when_towers_and_contexts_are_there(towers):
    """A feature the request carries wins; a stage whose context the model
    lacks, or whose tower is missing, is off; max_faces and max_objects
    bound the rows."""
    _, pt = towers
    req = {"image_b64": vtest._b64(PHOTOS[0])}
    tv = tvision.VisionPipeline(pt, wanted={"image": 49, "faces": 4,
                                            "obj": 8})
    assert set(tv.process({**req, "face_embeds": [[0.0]],
                           "obj_embeds": [[0.0]]})) == {"image_grid"}
    off = tvision.VisionPipeline(pt, wanted={"image": 0, "faces": 0,
                                             "obj": 8})
    assert (off.has_grid, off.has_faces, off.has_objects) == (False, False,
                                                              True)
    for missing, flags in ((("facenet",), (True, False, True)),
                           (("mtcnn",), (True, False, True)),
                           (("yolov3",), (True, True, False)),
                           (("resnet", "resnet_cfg"), (False, True, False))):
        tv = tvision.VisionPipeline({k: v for k, v in pt.items()
                                     if k not in missing})
        assert (tv.has_grid, tv.has_faces, tv.has_objects) == flags
    out = tvision.VisionPipeline(pt, max_faces=2, max_objects=5).process(
        {**req, "image_grid": [[0.0]]})
    assert out["face_embeds"].shape == (2, 512)
    assert out["obj_embeds"].shape == (5, 256)


@pytest.fixture(scope="module")
def service(towers):
    from tell_tpu_torch.data.tokenizer import RobertaTokenizer
    from tell_tpu_torch.models.backbones.roberta import (RobertaConfig,
                                                         RobertaEncoder)
    g = torch.Generator().manual_seed(0)
    rcfg = RobertaConfig(**vtest.RK)
    svc = CaptionService(
        init_captioner(g, CFG), RobertaEncoder(init_roberta(g, rcfg), rcfg),
        CFG, "cpu", tokenizer=RobertaTokenizer.from_files(
            os.path.join(vtest.QUALITY, "vocab.json"),
            os.path.join(vtest.QUALITY, "merges.txt")),
        max_batch=4, article_len=24, towers=towers[1])
    yield svc
    svc.close()


def test_photo_requests_answer_as_their_features_sent_precomputed(service):
    """A photo as image_b64 and as sections[pos].image_data packs the
    pipeline's grid, face and object rows (cut to the model's 4 faces and
    8 objects) and answers the ids of the same text with those features
    sent precomputed."""
    svc = service
    photos = [vtest._b64(PHOTOS[0]), vtest._b64(PHOTOS[1])]
    reqs = [{"context": vtest.TEXT, "image_b64": photos[0]},
            {"title": "Museum opens", "image_position": 1,
             "sections": [{"type": "paragraph", "text": vtest.TEXT},
                          {"type": "caption", "text": "",
                           "image_data": photos[1]}]}]
    batch, err = svc._pack(reqs)
    assert err == [None, None]
    feats = svc.vision.process({"image_b64": photos[1]})
    for key, n in (("image_grid", 49), ("face_embeds", 4),
                   ("obj_embeds", 8)):
        np.testing.assert_array_equal(batch[key][1], feats[key][:n])
    assert not np.isnan(batch["face_embeds"][:, 0]).any()
    assert not np.isnan(batch["obj_embeds"][:, 0]).any()
    pre = [{"context": text, **{k: batch[k][i].tolist() for k in (
               "image_grid", "face_embeds", "obj_embeds")}}
           for i, text in enumerate((vtest.TEXT,
                                     svc._sections_text(reqs[1])))]
    got = svc._run(reqs + pre)
    assert all("error" not in body for body in got)
    assert got[0]["token_ids"] == got[2]["token_ids"]
    assert got[1]["token_ids"] == got[3]["token_ids"]


def test_a_stage_that_fails_fails_only_its_request(service, monkeypatch):
    """The faces stage raising for one photo (as a device error would)
    gives that request `bad request image: ...`; the other request of the
    micro-batch answers as it does alone."""
    svc = service
    faces = svc.vision.faces
    bad = vtest._b64(PHOTOS[2])
    bad_canvas = tvision.letterbox(tvision.decode_request_image(
        {"image_b64": bad}), CANVAS)[0]

    def failing(canvas):
        if np.array_equal(canvas, bad_canvas):
            raise RuntimeError("the faces stage failed")
        return faces(canvas)
    monkeypatch.setattr(svc.vision, "faces", failing)
    batch = [{"context": vtest.TEXT, "image_b64": vtest._b64(PHOTOS[0])},
             {"context": vtest.TEXT, "image_b64": bad}]
    out = svc._run(batch)
    assert out[1]["error"] == ("bad request image: the faces stage "
                               "failed")
    assert "error" not in out[0]
    assert out[0]["token_ids"] == svc.caption(batch[0])["token_ids"]
