"""Frozen towers (counterparts of tell_tpu/models/backbones/), and what the
vision towers share: `fp32_math`, the TF32 pin their forwards run under,
and `load_state`, which reads a converted tower's state.pt."""
from __future__ import annotations

import contextlib
import os
import threading

import torch

from ...bridge import tree_map
from ...config import NotPortedError

# the TF32 switches are one per process: forwards on other threads (the
# service's request threads) take turns, so none restores them under
# another; re-entrant, so a stage may run a tower inside its own pin
_TF32_SWITCH = threading.RLock()


@contextlib.contextmanager
def fp32_math():
    """cuDNN convs and cuBLAS matmuls in fp32 inside, whatever the global
    TF32 switches say (PyTorch lets cuDNN use TF32 by default, and a
    detector's threshold can flip on TF32's error)."""
    with _TF32_SWITCH:
        before = (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = before


def load_state(path: str, device, flag: str):
    """The tree at <path>/state.pt (as tools/convert_towers.py writes it)
    on `device`. A directory without one (a tell_tpu orbax tree) is
    refused, naming the converter's `flag`; no card without `device`
    "cpu" raises."""
    state = os.path.join(path, "state.pt")
    if not os.path.exists(state):
        raise NotPortedError(
            f"{path} holds no state.pt (a tell_tpu orbax tree?): reading "
            "tell_tpu checkpoints needs the JAX-side conversion step of "
            "ROADMAP queue 1 item 6; convert the weights with python -m "
            f"tell_tpu_torch.tools.convert_towers {flag}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "--device cpu to run on the CPU")
    tree = torch.load(state, map_location="cpu", weights_only=True)
    return tree_map(lambda t: t.to(device), tree)
