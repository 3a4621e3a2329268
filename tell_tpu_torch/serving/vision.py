"""Image features from raw request images for the caption service
(counterpart of tell_tpu/serving/vision.py).

A request's photo comes as `image_b64` (an encoded JPEG, decoded by the
port's own decoder, data/jpeg.py) or `image` (a nested [H, W, 3] list in
the uint8 range). VisionPipeline turns it into the image context: the
dataset's resize and centre crop (data/images.py, equal to tell_tpu's
Pillow path byte for byte) and the ResNet-152 grid on the service's device.
A stage is active only when its tower is loaded and the model has its
context; a request that carries the features itself keeps them.

The face (MTCNN + FaceNet) and object (YOLOv3 + pooled ResNet) stages and
their letterbox canvas are not ported yet (ROADMAP queue 1 item 8): a
towers directory that holds them is refused where the towers are loaded,
and requests bring their own face and object rows, as they do to tell_tpu
without those towers.
"""
from __future__ import annotations

import base64

import numpy as np

from ..config import NotPortedError
from ..data.images import resize_shortest_crop
from ..data.jpeg import decode_jpeg
from ..models.backbones.resnet import image_grid


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


UNPORTED_TOWERS = ("mtcnn", "facenet", "yolov3")


def refuse_unported_towers(names) -> None:
    """tell_tpu computes face and object rows from these towers; the port
    has none of them yet and must not serve as if they were absent."""
    found = sorted(set(names) & set(UNPORTED_TOWERS))
    if found:
        raise NotPortedError(
            f"the {', '.join(found)} tower(s) are not ported yet (ROADMAP "
            "queue 1 item 8, the remaining towers): remove them from the "
            "towers directory, and send face and object rows with the "
            "requests")


class VisionPipeline:
    """Per-request image features from the frozen towers."""

    def __init__(self, frozen: dict, wanted: dict | None = None):
        """frozen: the towers ({"resnet": load_tower's tree on the service's
        device, "resnet_cfg": ResNetConfig} for the grid); wanted: the serving
        model's context capacities ({"image": n, ...}); a stage whose
        context the model lacks is off even when its tower is loaded."""
        refuse_unported_towers(frozen)
        self.has_grid = ("resnet" in frozen
                         and (wanted is None or wanted.get("image", 0) > 0))
        if self.has_grid:
            self.resnet = frozen["resnet"]
            self.resnet_cfg = frozen["resnet_cfg"]

    def grid(self, img224: np.ndarray) -> np.ndarray:
        """float [224, 224, 3] in 0..255 -> [49, 2048] ResNet grid."""
        return image_grid(self.resnet, self.resnet_cfg, img224)

    def process(self, req: dict) -> dict:
        """The features the request lacks and the towers give: only the
        newly computed keys."""
        img = decode_request_image(req)
        if img is None:
            return {}
        out = {}
        if self.has_grid and "image_grid" not in req:
            out["image_grid"] = self.grid(center_crop_224(img))
        return out
