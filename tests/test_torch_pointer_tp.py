"""The pointer models' loss under tensor parallelism on 2 gloo ranks at
n_model 2 (tell_tpu_torch/models/pointer.py's pointer_loss with tp: the
captioner's leaves the rules' shards, the pointer heads replicated, each
rank on the whole batch), against tell_tpu's pointer_loss on the CPU:
v1 (expt a1) and v2 (expt a3), with tests/test_torch_pointer_dp.py's
batch and limits (the loss and its parts within 1e-6 relative, the
gradients gathered whole within 1e-5 relative L2 per leaf).
"""
import pytest

from tests.test_torch_pointer_dp import VERSIONS, held_to_tell_tpu
from tests.test_torch_pointer_dp import pointer_runs


@pytest.fixture(scope="module")
def runs():
    return pointer_runs(2)


@pytest.mark.parametrize("version", VERSIONS)
def test_pointer_loss_at_n_model_2_equals_tell_tpu(runs, version):
    held_to_tell_tpu(runs, version)
    # the ranks ran on shards: fc1's columns are half of tell_tpu's
    fc1 = runs[2][0][VERSIONS.index(version)]["shards"]["captioner"][
        "decoder"]["layers"][0]["fc1"]
    key = "v" if "v" in fc1 else "w"
    full = runs[1][version][1].captioner.decoder.ffn_dim
    assert fc1[key].shape[1] * 2 == full
