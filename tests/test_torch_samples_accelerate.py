"""The port's ``sample_accelerate`` against the JAX package's, on the CPU (see
``tests/test_torch_samples.py``): a file of its own because it is one of
the samples that take longest."""

import torch

from _torch_samples import check_sample

torch.set_num_threads(1)


def test_sample_matches_reference():
    check_sample("accelerate")
