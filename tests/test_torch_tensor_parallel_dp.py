"""The flagship's tensor-parallel training on a grid of n_data 2 x
n_model 2 gloo ranks (four), held to tell_tpu's unsharded train step as
tests/test_torch_tensor_parallel.py holds n_model 2: the losses, the
first step's reduced and gathered gradients, each rank's shard against
tell_tpu's rules, and the params after the steps. The tail capacity's
budget is the global batch's across the two "data" ranks.
"""
from tests.test_torch_tensor_parallel import check_grid


def test_flagship_data_and_tensor_parallel_equals_tell_tpu(tmp_path):
    check_grid(tmp_path, 4, 2)
