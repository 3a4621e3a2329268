"""Face detection and embedding over article images (counterpart of
tools/detect_faces.py, step 4 of docs/getting_data.md).

For every image position of --articles whose processed <hash>.jpg is in
--images: MTCNN (models/backbones/mtcnn.py's detect_faces, the largest
--max-faces faces by box area), the faces cut and prewhitened
(extract_faces) and FaceNet (facenet_forward), on --device. The section
gets `facenet_details` {n_faces, frame_faces (bbox, confidence),
embeddings}, the field the readers take face embeddings from; an image
with no face is left as it is. Every article is written to --out.

The towers are the port's (<towers>/mtcnn and <towers>/facenet, each a
state.pt from tell_tpu_torch.tools.convert_towers or
migrate/orbax_to_torch.py towers); a tell_tpu orbax tree is refused by
name.

    python -m tell_tpu_torch.tools.detect_faces --articles articles.jsonl \
        --images images/ --towers towers/ --out articles_faces.jsonl \
        [--max-faces 10] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..data.images import decode_image
from ..models.backbones.facenet import facenet_forward, load_facenet
from ..models.backbones.mtcnn import (MTCNNConfig, detect_faces,
                                      extract_faces, load_mtcnn)


def load_towers(towers_dir: str, device) -> dict:
    """MTCNN and FaceNet from <towers_dir>/mtcnn and /facenet on
    `device` (load_state refuses an orbax tree, and "cuda" without a
    card)."""
    return {"mtcnn": load_mtcnn(os.path.join(towers_dir, "mtcnn"), device),
            "facenet": load_facenet(os.path.join(towers_dir, "facenet"),
                                    device)}


def detect_and_embed(towers: dict, img: np.ndarray, max_faces: int = 10):
    """img: float32 [H, W, 3] in 0..255 -> (boxes [n, 4], probs [n],
    embeddings [n, 512], n), numpy, the largest faces first."""
    fn = towers["facenet"]
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
            fn["last_linear"].device)
        boxes, probs, valid = detect_faces(towers["mtcnn"], x,
                                           MTCNNConfig(max_faces=max_faces))
        n = int(valid.sum())
        boxes, probs = boxes[:n], probs[:n]
        embeds = (facenet_forward(fn, extract_faces(x, boxes)) if n else
                  torch.zeros(0, fn["last_linear"].shape[1]))
        return (boxes.cpu().numpy(), probs.cpu().numpy(),
                embeds.cpu().numpy(), n)


def facenet_details(boxes, probs, embeds, n: int) -> dict:
    return {"n_faces": n,
            "frame_faces": [{"bbox": boxes[i].tolist(),
                             "confidence": float(probs[i])}
                            for i in range(n)],
            "embeddings": embeds.tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--articles", required=True)
    ap.add_argument("--images", required=True,
                    help="processed 224x224 image dir, <hash>.jpg")
    ap.add_argument("--towers", required=True,
                    help="dir with the converted mtcnn/ and facenet/")
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-faces", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    towers = load_towers(args.towers, args.device)
    n_img = 0
    with open(args.articles, encoding="utf-8") as fin, \
            open(args.out, "w", encoding="utf-8") as fout:
        for line in fin:
            if not line.strip():
                continue
            art = json.loads(line)
            for pos in art.get("image_positions", []):
                section = art["parsed_section"][pos]
                path = os.path.join(args.images,
                                    f"{section.get('hash', '')}.jpg")
                if not os.path.exists(path):
                    continue
                with open(path, "rb") as f:
                    img = decode_image(f.read()).astype(np.float32)
                boxes, probs, embeds, n = detect_and_embed(
                    towers, img, args.max_faces)
                if n == 0:
                    continue
                section["facenet_details"] = facenet_details(
                    boxes, probs, embeds, n)
                n_img += 1
            fout.write(json.dumps(art) + "\n")
    print(f"faces written for {n_img} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
