"""tests/test_torch_pointer_training.py's three Trainer steps against
tell_tpu's, for the v2 copy loss (transformer_pointer_2, expts a2 and
a3)."""
import torch

from tests.test_torch_pointer_training import (check_trainer_steps,
                                               roberta, shards)

__all__ = ["roberta", "shards"]
torch.set_num_threads(2)


def test_trainer_steps_v2_equal_jax(shards, roberta, tmp_path):
    check_trainer_steps(shards, roberta, tmp_path, "transformer_pointer_2")
