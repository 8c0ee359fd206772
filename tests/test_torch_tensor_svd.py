"""The tensor SVD of the port (``ops/tensor_svd.py``, ``ops/tensor_util.py``)
against the JAX package's, f64 on the CPU, on the same numpy-seeded tensors.

Singular values 1e-12 relative; the factors are compared through what does
not depend on the sign of a singular vector: ``reconstruct()`` (1e-12) and
|U^T U_ref| = I (1e-10).  ``truncated`` keeps the reference's shapes and
zeros, with and without padding; ``get_rank`` and ``truncation_error`` are
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.ops import tensor_util as jtu
from eigenex_tpu.ops.tensor_svd import tensor_svd as j_tensor_svd
from eigenex_tpu.ops.tensor_svd import truncated_tensor_svd as j_truncated_tensor_svd
from eigenex_tpu_torch import (
    contract_vector_as_diagonal,
    tensor_svd,
    transform_tensor_with_matrix,
    truncated_tensor_svd,
    zerowisely_resized,
)
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def close(x, ref, rel=1e-12):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ref = np.asarray(ref)
    assert x.shape == ref.shape, (x.shape, ref.shape)
    assert np.linalg.norm(x - ref) <= rel * max(np.linalg.norm(ref), 1e-300)


@pytest.fixture
def tensor():
    return np.random.default_rng(8).standard_normal((6, 8, 7, 5))


@pytest.mark.parametrize("left_axes", [1, 2, 3])
def test_tensor_svd_matches_reference(tensor, left_axes):
    got = tensor_svd(torch.as_tensor(tensor), left_axes)
    ref = j_tensor_svd(jnp.asarray(tensor), left_axes)
    assert got.left_dims == ref.left_dims and got.right_dims == ref.right_dims
    assert got.rank == ref.rank
    close(got.singular_values, ref.singular_values)
    close(got.reconstruct(), ref.reconstruct())
    close(got.reconstruct(), tensor)
    k = got.rank
    U = got.tensor_u.reshape(-1, k).numpy()
    Ur = np.asarray(ref.tensor_u).reshape(-1, k)
    np.testing.assert_allclose(np.abs(U.T @ Ur), np.eye(k), atol=1e-10)


@pytest.mark.parametrize("pad", [True, False])
def test_truncated_matches_reference(tensor, pad):
    got = tensor_svd(torch.as_tensor(tensor), 2)
    ref = j_tensor_svd(jnp.asarray(tensor), 2)
    threshold = float(np.asarray(ref.singular_values)[10])
    assert got.get_rank(threshold) == ref.get_rank(threshold) == 10
    assert got.truncation_error(4) == pytest.approx(ref.truncation_error(4), rel=1e-12)
    g4, r4 = got.truncated(rank=4, pad=pad), ref.truncated(rank=4, pad=pad)
    assert tuple(g4.tensor_u.shape) == r4.tensor_u.shape
    close(g4.singular_values, r4.singular_values)
    close(g4.reconstruct(), r4.reconstruct())
    gt, rt = got.truncated(threshold=threshold, pad=pad), ref.truncated(threshold=threshold, pad=pad)
    close(gt.reconstruct(), rt.reconstruct())
    with pytest.raises(EigenexError):
        got.truncated(pad=pad)


def test_truncated_tensor_svd_and_errors(tensor):
    got = truncated_tensor_svd(torch.as_tensor(tensor), 2, rank=3)
    ref = j_truncated_tensor_svd(jnp.asarray(tensor), 2, rank=3)
    assert tuple(got.tensor_v.shape) == ref.tensor_v.shape == (7, 5, 3)
    close(got.reconstruct(), ref.reconstruct())
    with pytest.raises(EigenexError):
        tensor_svd(torch.as_tensor(tensor), 4)


def test_tensor_util_matches_reference(tensor):
    t = torch.as_tensor(tensor)
    close(zerowisely_resized(t, (3, 9, 7, 2)), jtu.zerowisely_resized(jnp.asarray(tensor), (3, 9, 7, 2)))
    v = np.random.default_rng(1).standard_normal(7)
    close(contract_vector_as_diagonal(t, torch.as_tensor(v), 2),
          jtu.contract_vector_as_diagonal(jnp.asarray(tensor), jnp.asarray(v), 2))
    m = np.random.default_rng(2).standard_normal((4, 8))
    close(transform_tensor_with_matrix(t, torch.as_tensor(m), 1),
          jtu.transform_tensor_with_matrix(jnp.asarray(tensor), jnp.asarray(m), 1))
    with pytest.raises(EigenexError):
        zerowisely_resized(t, (3, 9))
