"""The port's ``sample_spectrum_slicing``, ``sample_tfi`` and
``sample_tpu_hybrid`` against the JAX package's, on the CPU (see
``tests/test_torch_samples.py``): a file apart because they take long."""

import pytest
import torch

from _torch_samples import check_sample

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["spectrum_slicing", "tfi", "tpu_hybrid"])
def test_sample_matches_reference(name):
    check_sample(name)
