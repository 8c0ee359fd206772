"""The port's samples against the JAX package's, on the CPU: each sample of
``samples/`` run as a script beside its counterpart in
``eigenex_tpu_torch/samples`` (``main(device="cpu")``), the printed numbers
held together at the tolerances of ``tests/_torch_samples.py``.  The
samples that take longest are in ``test_torch_samples_solvers.py``,
``test_torch_samples_accelerate.py`` and ``test_torch_samples_tebd.py``, so
that the four files can run on different test workers."""

import pytest
import torch

from _torch_samples import check_sample

torch.set_num_threads(1)

SAMPLES = ["arnoldi", "block_tensor", "dtensor", "lanczos1", "lanczos2", "lobpcg",
           "matrix_market", "product_indices"]


@pytest.mark.parametrize("name", SAMPLES)
def test_sample_matches_reference(name):
    check_sample(name)
