"""Convert pretrained frozen towers into the port's torch format
(counterpart of tools/convert_towers.py's RoBERTa and ResNet parts).

    python -m tell_tpu_torch.tools.convert_towers --out data/towers \
        [--roberta roberta-large.pt] [--resnet resnet152.pth]

--roberta is a file torch.load reads as a RobertaModel or
RobertaForMaskedLM state dict (bare or "roberta."-prefixed keys), of any
depth; its tree goes to <out>/roberta/state.pt. --resnet is torchvision's
ResNet-152 state dict (the ImageNet .pth); its tree, batch norm folded,
goes to <out>/resnet152/state.pt. `python -m tell_tpu_torch.commands`
reads both from <shards_dir>/../towers. Each is optional; give at least
one. The other vision towers are not ported (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import argparse
import os
import re
import sys

import torch

from ..bridge import to_torch
from ..models.backbones.resnet import ResNetConfig, convert_torchvision_resnet
from ..models.backbones.roberta import RobertaConfig, convert_hf_roberta


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="the towers directory")
    ap.add_argument("--roberta",
                    help="a HuggingFace RoBERTa state dict saved by torch")
    ap.add_argument("--resnet",
                    help="torchvision's ResNet-152 state dict (.pth)")
    args = ap.parse_args(argv)
    if not (args.roberta or args.resnet):
        ap.error("give --roberta, --resnet or both")
    if args.roberta:
        print(f"wrote {convert_roberta(args.roberta, args.out)}")
    if args.resnet:
        print(f"wrote {convert_resnet(args.resnet, args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
