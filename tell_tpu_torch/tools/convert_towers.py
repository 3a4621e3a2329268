"""Convert pretrained frozen towers into the port's torch format
(counterpart of tools/convert_towers.py).

    python -m tell_tpu_torch.tools.convert_towers --out data/towers \
        [--roberta roberta-large.pt] [--resnet resnet152.pth] \
        [--facenet 20180402-114759-vggface2.pt] \
        [--mtcnn pnet.pt rnet.pt onet.pt] \
        [--yolo-cfg yolov3-spp.cfg --yolo-weights yolov3-spp.weights] \
        [--vit vit-large-patch16-224.pt]

--roberta is a file torch.load reads as a RobertaModel or
RobertaForMaskedLM state dict (bare or "roberta."-prefixed keys), of any
depth; its tree goes to <out>/roberta/state.pt. --resnet is torchvision's
ResNet-152 state dict (the ImageNet .pth), --facenet facenet-pytorch's
InceptionResnetV1 state dict and --mtcnn its three P/R/O-net state dicts;
--yolo-cfg and --yolo-weights are a darknet cfg and its binary .weights.
--vit is a HuggingFace ViTModel or ViTForImageClassification state dict
(bare or "vit."-prefixed keys) of ViT-L/16, as torch.load reads it.
Their trees (batch norm folded, tell_tpu's layout as torch tensors) go to
<out>/resnet152, facenet, mtcnn, yolov3 and vit, each as state.pt.
`python -m tell_tpu_torch.commands` reads them from
<shards_dir>/../towers. Each is optional; give at least one.
"""
from __future__ import annotations

import argparse
import os
import re
import sys

import torch

from ..bridge import to_torch
from ..models.backbones import facenet, mtcnn, yolov3
from ..models.backbones.resnet import ResNetConfig, convert_torchvision_resnet
from ..models.backbones.roberta import RobertaConfig, convert_hf_roberta
from ..models.backbones.vit import ViTConfig, convert_hf_vit


def _save(tree, out: str, name: str) -> str:
    path = os.path.join(out, name)
    os.makedirs(path, exist_ok=True)
    torch.save(tree, os.path.join(path, "state.pt"))
    return os.path.join(path, "state.pt")


def convert_roberta(src: str, out: str) -> str:
    """The state dict at `src` as <out>/roberta/state.pt; returns the
    path."""
    sd = torch.load(src, map_location="cpu", weights_only=True)
    layers = {int(m.group(1)) for k in sd
              if (m := re.search(r"encoder\.layer\.(\d+)\.", k))}
    params = convert_hf_roberta(sd, RobertaConfig(num_layers=len(layers)))
    return _save(params, out, "roberta")


def convert_resnet(src: str, out: str) -> str:
    """torchvision's ResNet-152 state dict at `src` as
    <out>/resnet152/state.pt (torch tensors); returns the path."""
    sd = torch.load(src, map_location="cpu", weights_only=True)
    params = convert_torchvision_resnet(sd, ResNetConfig.resnet152())
    return _save(to_torch(params, "cpu"), out, "resnet152")


def convert_facenet(src: str, out: str) -> str:
    """facenet-pytorch's InceptionResnetV1 state dict at `src` as
    <out>/facenet/state.pt; returns the path."""
    sd = torch.load(src, map_location="cpu", weights_only=True)
    params = facenet.convert_facenet(sd, facenet.FaceNetConfig())
    return _save(to_torch(params, "cpu"), out, "facenet")


def convert_mtcnn(srcs: list[str], out: str) -> str:
    """facenet-pytorch's pnet, rnet and onet state dicts as
    <out>/mtcnn/state.pt; returns the path."""
    sds = [torch.load(p, map_location="cpu", weights_only=True)
           for p in srcs]
    return _save(to_torch(mtcnn.convert_mtcnn(*sds), "cpu"), out, "mtcnn")


def convert_yolo(cfg: str, weights: str, out: str) -> str:
    """A darknet cfg and its .weights as <out>/yolov3/state.pt; returns the
    path."""
    with open(cfg) as f:
        defs = yolov3.parse_darknet_cfg(f.read())
    params = yolov3.load_darknet_weights(defs, weights)
    return _save(to_torch(params, "cpu"), out, "yolov3")


def convert_vit(src: str, out: str) -> str:
    """A HuggingFace ViT-L/16 state dict at `src` as <out>/vit/state.pt;
    returns the path. (tell_tpu's tool also takes a model name, which
    needs the transformers package and the network.)"""
    sd = torch.load(src, map_location="cpu", weights_only=True)
    params = convert_hf_vit(sd, ViTConfig.large())
    return _save(to_torch(params, "cpu"), out, "vit")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="the towers directory")
    ap.add_argument("--roberta",
                    help="a HuggingFace RoBERTa state dict saved by torch")
    ap.add_argument("--resnet",
                    help="torchvision's ResNet-152 state dict (.pth)")
    ap.add_argument("--facenet",
                    help="facenet-pytorch's InceptionResnetV1 state dict")
    ap.add_argument("--mtcnn", nargs=3, metavar=("PNET", "RNET", "ONET"),
                    help="facenet-pytorch's P/R/O-net state dicts")
    ap.add_argument("--yolo-cfg", help="a darknet cfg (yolov3-spp.cfg)")
    ap.add_argument("--yolo-weights", help="its darknet .weights")
    ap.add_argument("--vit", help="a HuggingFace ViT-L/16 state dict "
                    "saved by torch (google/vit-large-patch16-224)")
    args = ap.parse_args(argv)
    if bool(args.yolo_cfg) != bool(args.yolo_weights):
        ap.error("--yolo-cfg and --yolo-weights go together")
    if not (args.roberta or args.resnet or args.facenet or args.mtcnn
            or args.yolo_cfg or args.vit):
        ap.error("give at least one of --roberta, --resnet, --facenet, "
                 "--mtcnn, --yolo-cfg/--yolo-weights, --vit")
    written = []
    if args.roberta:
        written.append(convert_roberta(args.roberta, args.out))
    if args.resnet:
        written.append(convert_resnet(args.resnet, args.out))
    if args.facenet:
        written.append(convert_facenet(args.facenet, args.out))
    if args.mtcnn:
        written.append(convert_mtcnn(args.mtcnn, args.out))
    if args.yolo_cfg:
        written.append(convert_yolo(args.yolo_cfg, args.yolo_weights,
                                    args.out))
    if args.vit:
        written.append(convert_vit(args.vit, args.out))
    for path in written:
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
