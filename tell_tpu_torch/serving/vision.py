"""Image features from raw request images for the caption service
(counterpart of tell_tpu/serving/vision.py).

A request's photo comes as `image_b64` (an encoded JPEG, decoded by the
port's own decoder, data/jpeg.py) or `image` (a nested [H, W, 3] list in
the uint8 range). VisionPipeline turns it into the contexts tell_tpu's
computes, on the towers' device:

* the grid: the dataset's resize and centre crop (data/images.py, equal to
  tell_tpu's Pillow path byte for byte) and the ResNet-152 grid;
* the faces: MTCNN on the DET_CANVAS letterbox, then FaceNet on the 160 x
  160 crops of the max_faces largest faces -> [max_faces, 512];
* the objects: YOLOv3-SPP on the same canvas (conf 0.3, IoU 0.6), then
  the pooled ResNet-152 on the 224 x 224 crops -> [max_objects, 2048].

NaN rows mean "absent". Only the rows of detected faces and objects go
through FaceNet and the ResNet (each row's embedding is its own; tell_tpu's
fixed shapes embed every row and mask the rest). A stage is active only
when its towers are loaded and the model has its context; a request that
carries a feature itself keeps it.
"""
from __future__ import annotations

import base64

import numpy as np
import torch

from ..data.images import resize_pillow, resize_shortest_crop
from ..data.jpeg import decode_jpeg
from ..models.backbones.facenet import facenet_forward
from ..models.backbones.mtcnn import MTCNNConfig, detect_faces, extract_faces
from ..models.backbones.resnet import (image_grid, preprocess_image,
                                       resnet_forward)
from ..models.backbones.yolov3 import (crop_and_resize, nms_fixed,
                                       yolov3_forward,
                                       yolov3_spp_module_defs)

DET_CANVAS = 416  # detection canvas (YOLO's letterbox size; MTCNN reuses it)
# x / 255 as XLA compiles tell_tpu's: a product with the fp32 reciprocal
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def decode_request_image(req: dict) -> np.ndarray | None:
    """The request's raw image: `image_b64` (an encoded JPEG) or `image`
    (a nested [H, W, 3] list or array, uint8 range). Returns float32
    [H, W, 3] in 0..255, or None."""
    if "image_b64" in req:
        raw = base64.b64decode(req["image_b64"])
        return decode_jpeg(raw).astype(np.float32)
    if "image" in req:
        arr = np.asarray(req["image"], np.float32)
        if arr.ndim == 3 and arr.shape[-1] == 3:
            return arr
    return None


def center_crop_224(img: np.ndarray) -> np.ndarray:
    """float [H, W, 3] in 0..255 -> float32 [224, 224, 3]: the shortest
    side to 256, the centre 224 (the dataset's preprocessing, so serve-time
    grids equal train-time grids). Values are cast to uint8 first, as
    tell_tpu's Image.fromarray(img.astype(np.uint8)) does."""
    return resize_shortest_crop(img.astype(np.uint8)).astype(np.float32)


def letterbox(img: np.ndarray, size: int) -> tuple[np.ndarray, float]:
    """float [H, W, 3] in 0..255 -> (float32 [size, size, 3] canvas, scale
    original -> canvas): the photo (cast to uint8 first) resized keeping
    its aspect to max(int(round(side * scale)), 1) pixels a side, Pillow's
    BOX when shrinking and BILINEAR when enlarging, centred on grey 128
    (tell_tpu's letterbox, byte for byte)."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    im = resize_pillow(img.astype(np.uint8), nw, nh,
                       "box" if scale < 1.0 else "bilinear")
    canvas = np.full((size, size, 3), 128.0, np.float32)
    top, left = (size - nh) // 2, (size - nw) // 2
    canvas[top:top + nh, left:left + nw] = im
    return canvas, scale


def _embed_valid(valid: torch.Tensor, boxes: torch.Tensor, embed,
                 dim: int) -> np.ndarray:
    """[N, dim] numpy: embed(the valid rows' boxes) at those rows, NaN
    elsewhere."""
    out = torch.full((valid.shape[0], dim), float("nan"),
                     device=boxes.device)
    if bool(valid.any()):
        out[valid] = embed(boxes[valid]).to(out.dtype)
    return out.cpu().numpy()


class VisionPipeline:
    """Per-request image features from the frozen towers."""

    def __init__(self, frozen: dict, wanted: dict | None = None,
                 max_faces: int = 4, max_objects: int = 64):
        """frozen: the towers on the service's device, each in its
        forward's layout ({"resnet": load_tower's tree, "resnet_cfg":
        ResNetConfig} for the grid and the object crops; "mtcnn" and
        "facenet" for the faces; "yolov3" for the objects, its module defs
        "yolov3_defs" or yolov3_spp_module_defs()); wanted: the serving
        model's context capacities ({"image": n, "faces": n, "obj": n}); a
        stage whose context the model lacks is off even when its towers
        are loaded."""
        def want(key):
            return wanted is None or wanted.get(key, 0) > 0

        self.frozen = frozen
        self.max_faces, self.max_objects = max_faces, max_objects
        self.has_grid = "resnet" in frozen and want("image")
        self.has_faces = ("mtcnn" in frozen and "facenet" in frozen
                          and want("faces"))
        self.has_objects = ("yolov3" in frozen and "resnet" in frozen
                            and want("obj"))
        self.yolov3_defs = (frozen.get("yolov3_defs")
                            or yolov3_spp_module_defs())

    def grid(self, img224: np.ndarray) -> np.ndarray:
        """float [224, 224, 3] in 0..255 -> [49, 2048] ResNet grid."""
        return image_grid(self.frozen["resnet"], self.frozen["resnet_cfg"],
                          img224)

    def faces(self, canvas: np.ndarray) -> np.ndarray:
        """[DET, DET, 3] 0..255 -> [max_faces, 512], NaN rows absent: the
        largest faces MTCNN finds, embedded by FaceNet."""
        fn = self.frozen["facenet"]
        with torch.inference_mode():
            img = torch.from_numpy(canvas).to(fn["last_linear"].device)
            boxes, _, valid = detect_faces(
                self.frozen["mtcnn"], img,
                MTCNNConfig(max_faces=self.max_faces))
            return _embed_valid(valid, boxes, lambda b: facenet_forward(
                fn, extract_faces(img, b)), fn["last_linear"].shape[1])

    def objects(self, canvas: np.ndarray) -> np.ndarray:
        """[DET, DET, 3] 0..255 -> [max_objects, 2048], NaN rows absent:
        YOLOv3's detections (conf 0.3, IoU 0.6), their 224 x 224 crops
        embedded by the pooled ResNet."""
        rn, rn_cfg = self.frozen["resnet"], self.frozen["resnet_cfg"]
        with torch.inference_mode():
            img = torch.from_numpy(canvas).to(rn["stem"]["conv"].device)
            dets = yolov3_forward(self.frozen["yolov3"], self.yolov3_defs,
                                  img[None] * _INV_255)[0]
            boxes, _, valid = nms_fixed(dets, 0.3, 0.6,
                                        max_det=self.max_objects)
            return _embed_valid(valid, boxes, lambda b: resnet_forward(
                rn, rn_cfg, preprocess_image(
                    crop_and_resize(img, b, 224) * _INV_255), pool=True),
                rn_cfg.out_dim)

    def process(self, req: dict) -> dict:
        """The features the request lacks and the towers give: only the
        newly computed keys."""
        img = decode_request_image(req)
        if img is None:
            return {}
        out = {}
        if self.has_grid and "image_grid" not in req:
            out["image_grid"] = self.grid(center_crop_224(img))
        if self.has_faces or self.has_objects:
            canvas, _ = letterbox(img, DET_CANVAS)
            if self.has_faces and "face_embeds" not in req:
                out["face_embeds"] = self.faces(canvas)
            if self.has_objects and "obj_embeds" not in req:
                out["obj_embeds"] = self.objects(canvas)
        return out
