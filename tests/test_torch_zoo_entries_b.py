"""The variant zoo's registry entries against the JAX package on the CPU:
``ENTRIES[1::3]``, by the rules of `test_torch_zoo_entries.py` (key map
against `export_cvit`; logits at batch 1, folded and unfolded, within 1e-3
of JAX's)."""
import pytest
import torch

from test_torch_zoo_entries import ENTRIES, check_keys, check_logits

torch.set_num_threads(2)

PART = ENTRIES[1::3]


@pytest.mark.parametrize("name", PART)
def test_entry_state_dict_matches_export_cvit(name):
    check_keys(name)


@pytest.mark.parametrize("name", PART)
def test_entry_logits_match_jax_folded_and_unfolded(name):
    check_logits(name)
