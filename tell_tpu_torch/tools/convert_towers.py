"""Convert a HuggingFace RoBERTa state dict into the port's frozen tower
(counterpart of tools/convert_towers.py --roberta).

    python -m tell_tpu_torch.tools.convert_towers --out data/towers \
        --roberta roberta-large.pt

--roberta is a file torch.load reads as a RobertaModel or
RobertaForMaskedLM state dict (bare or "roberta."-prefixed keys), of any
depth; the tree goes to <out>/roberta/state.pt (torch.save), which
`python -m tell_tpu_torch.commands` reads from <shards_dir>/../towers.
The vision towers are not ported (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import argparse
import os
import re
import sys

import torch

from ..models.backbones.roberta import RobertaConfig, convert_hf_roberta


def convert_roberta(src: str, out: str) -> str:
    """The state dict at `src` as <out>/roberta/state.pt; returns the
    path."""
    sd = torch.load(src, map_location="cpu", weights_only=True)
    layers = {int(m.group(1)) for k in sd
              if (m := re.search(r"encoder\.layer\.(\d+)\.", k))}
    params = convert_hf_roberta(sd, RobertaConfig(num_layers=len(layers)))
    path = os.path.join(out, "roberta")
    os.makedirs(path, exist_ok=True)
    torch.save(params, os.path.join(path, "state.pt"))
    return os.path.join(path, "state.pt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="the towers directory")
    ap.add_argument("--roberta", required=True,
                    help="a HuggingFace RoBERTa state dict saved by torch")
    args = ap.parse_args(argv)
    print(f"wrote {convert_roberta(args.roberta, args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
