"""`towers verify`'s MTCNN, FaceNet and YOLOv3 probes in the port against
tell_tpu's on the same weights, on the CPU (the RoBERTa and ResNet-152
probes, the inputs, rows and statuses are in
test_torch_towers_verify.py): FaceNet and YOLOv3-SPP at their full
architectures from the port's seeded initialisers (YOLOv3's kernels
rescaled to half He's std, so its residual stack and the boxes' exp stay
finite), MTCNN's three nets; outputs
within PROBE_TOL, and the values whose 1e-3 rounding differs between the
packages logged.
"""
import os

import pytest
import torch

from tell_tpu_torch.bridge import init_facenet, init_mtcnn, init_yolov3
from tell_tpu_torch.models.backbones.facenet import FaceNetConfig
from tell_tpu_torch.models.backbones.yolov3 import yolov3_spp_module_defs
from tests.test_torch_towers_verify import check_probe, unit_scale

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    d = tmp_path_factory.mktemp("towers")
    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    trees = {"mtcnn": init_mtcnn(g()),
             "facenet": init_facenet(g(), FaceNetConfig()),
             "yolov3": unit_scale(init_yolov3(
                 g(), yolov3_spp_module_defs()), gain=0.5)}
    for name, tree in trees.items():
        os.makedirs(d / name)
        torch.save(tree, d / name / "state.pt")
    return str(d), trees


@pytest.mark.parametrize("name", ["mtcnn", "facenet", "yolov3"])
def test_probe_outputs_match_tell_tpu(towers, name):
    check_probe(*towers, name)
