"""One train step of the variant zoo against JAX's `Trainer.train_step` on
the CPU: ``TRAIN_ENTRIES[2::3]``, by the rules of
`test_torch_zoo_train.py`."""
import pytest
import torch

from test_torch_zoo_train import TRAIN_ENTRIES, check_train_step

torch.set_num_threads(2)


@pytest.mark.parametrize("name", TRAIN_ENTRIES[2::3])
def test_zoo_train_step_matches_jax(name):
    check_train_step(name)
