"""Object detection and crop embedding over article images (counterpart
of tools/annotate_objects.py, step 5 of docs/getting_data.md).

For each image hash of --articles (once each) whose processed <hash>.jpg
is in --images, on --device: the photo letterboxed onto the 416 canvas
(serving/vision.py's letterbox), YOLOv3-SPP and class-aware NMS
(yolov3_forward, nms_fixed: --conf, --iou, at most --max-objects boxes);
the boxes mapped back onto the photo and clipped to it; each box cut from
the photo with int() truncation (at least one pixel a side), resized to
224 x 224 as jax.image.resize(..., "linear") does (ops/image_resize.py's
resize_linear, antialias on) and normalised with the ImageNet mean and
std; the crops embedded by the pooled ResNet-152. One JSON line per image
with detections: {"_id", "hash", "object_features", "boxes", "scores"}.
tell_tpu's tool writes the hash only as "_id", which its own reader
(data/pipeline.py's load_objects_jsonl, keyed on "hash") cannot read; the
port writes both keys, so both packages' readers take the file.

The towers are the port's (<towers>/yolov3 and <towers>/resnet152, each a
state.pt); a tell_tpu orbax tree is refused by name.

    python -m tell_tpu_torch.tools.annotate_objects \
        --articles articles.jsonl --images images/ --towers towers/ \
        --out objects.jsonl [--conf 0.3] [--iou 0.6] [--max-objects 64] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..data.images import decode_image
from ..models.backbones.resnet import ResNetConfig, load_tower, resnet_forward
from ..models.backbones.yolov3 import (load_yolov3, nms_fixed,
                                       yolov3_forward, yolov3_spp_module_defs)
from ..ops.image_resize import resize_linear
from ..serving.vision import letterbox

CANVAS = 416
CROP = 224
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def load_towers(towers_dir: str, device) -> dict:
    """YOLOv3-SPP and ResNet-152 from <towers_dir>/yolov3 and /resnet152
    on `device`, with their module defs and config."""
    return {"yolov3": load_yolov3(os.path.join(towers_dir, "yolov3"),
                                  device),
            "yolov3_defs": yolov3_spp_module_defs(),
            "resnet": load_tower(os.path.join(towers_dir, "resnet152"),
                                 device),
            "resnet_cfg": ResNetConfig.resnet152()}


def detect(towers: dict, img: np.ndarray, conf: float = 0.3,
           iou: float = 0.6, max_objects: int = 64):
    """img: float32 [H, W, 3] in 0..255 -> (boxes [n, 4] on the photo,
    float64, clipped; scores [n]), numpy."""
    dev = towers["resnet"]["stem"]["conv"].device
    canvas, r = letterbox(img, CANVAS)
    h, w = img.shape[:2]
    nh, nw = max(int(round(h * r)), 1), max(int(round(w * r)), 1)
    top, left = (CANVAS - nh) // 2, (CANVAS - nw) // 2
    with torch.inference_mode():
        x = torch.from_numpy(canvas).to(dev) / 255.0
        dets = yolov3_forward(towers["yolov3"], towers["yolov3_defs"],
                              x[None])[0]
        boxes, scores, valid = nms_fixed(dets, conf, iou,
                                         max_det=max_objects)
        nv = int(valid.sum())
        boxes, scores = boxes[:nv].cpu().numpy(), scores[:nv].cpu().numpy()
    boxes = (boxes - np.array([left, top, left, top])) / r
    # both edges clipped to the photo: a box in the letterbox's border
    # would otherwise give an empty crop
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w - 1)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h - 1)
    return boxes, scores


def embed_crops(towers: dict, img: np.ndarray, spans) -> np.ndarray:
    """The pooled ResNet-152 rows [len(spans), 2048] of the photo's crops
    at `spans` (x0, y0, x1, y1)."""
    dev = towers["resnet"]["stem"]["conv"].device
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev)
        mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
        std = torch.tensor(STD, dtype=torch.float32, device=dev)
        crops = [(resize_linear(x[y0:y1, x0:x1] / 255.0, CROP, CROP) - mean)
                 / std for x0, y0, x1, y1 in spans]
        feats = resnet_forward(towers["resnet"], towers["resnet_cfg"],
                               torch.stack(crops), pool=True)
        return feats.cpu().numpy()


def annotate(towers: dict, img: np.ndarray, conf: float = 0.3,
             iou: float = 0.6, max_objects: int = 64):
    """(features [n, 2048], boxes [n, 4], scores [n]) of one photo, or
    None when nothing is detected."""
    boxes, scores = detect(towers, img, conf, iou, max_objects)
    if not len(boxes):
        return None
    spans = []
    for b in boxes:          # int() truncation, at least a pixel a side
        x0, y0, x1, y1 = [int(v) for v in b]
        spans.append((x0, y0, max(x1, x0 + 1), max(y1, y0 + 1)))
    return embed_crops(towers, img, spans), boxes, scores


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--articles", required=True)
    ap.add_argument("--images", required=True)
    ap.add_argument("--towers", required=True,
                    help="dir with the converted yolov3/ and resnet152/")
    ap.add_argument("--out", required=True, help="objects.jsonl")
    ap.add_argument("--conf", type=float, default=0.3)
    ap.add_argument("--iou", type=float, default=0.6)
    ap.add_argument("--max-objects", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    towers = load_towers(args.towers, args.device)
    seen = set()
    n = 0
    with open(args.articles, encoding="utf-8") as fin, \
            open(args.out, "w", encoding="utf-8") as fout:
        for line in fin:
            if not line.strip():
                continue
            art = json.loads(line)
            for pos in art.get("image_positions", []):
                h = art["parsed_section"][pos].get("hash", "")
                if not h or h in seen:
                    continue
                seen.add(h)
                path = os.path.join(args.images, f"{h}.jpg")
                if not os.path.exists(path):
                    continue
                with open(path, "rb") as f:
                    img = decode_image(f.read()).astype(np.float32)
                got = annotate(towers, img, args.conf, args.iou,
                               args.max_objects)
                if got is None:
                    continue
                feats, boxes, scores = got
                fout.write(json.dumps({
                    "_id": h,
                    "hash": h,
                    "object_features": feats.tolist(),
                    "boxes": boxes.tolist(),
                    "scores": scores.tolist(),
                }) + "\n")
                n += 1
    print(f"objects written for {n} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
