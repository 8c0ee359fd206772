"""Truncated SVD by Lanczos on the Gram operator (``ops/sparse_svd.py``)
against the JAX package's, f64 on the CPU: BASELINE config 4 (a rank-4
(6, 8, 7, 5) tensor split after two axes, rank 3) and the cases of
``tests/test_cg_svd.py::TestLanczosSVD``, on numpy-seeded tensors.

Tolerances: singular values 1e-10 against ``numpy.linalg.svd`` (config 4's
target) and against the reference; the rank-3 reconstruction 1e-8 against
the reference's and the dense optimum; U orthonormal to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.ops import sparse_svd as jss
from eigenex_tpu_torch import gram_operator, truncated_svd_via_lanczos
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def test_gram_operator():
    m = np.random.default_rng(3).standard_normal((7, 5))
    x = np.random.default_rng(4).standard_normal(5)
    g = gram_operator(torch.as_tensor(m))
    assert g.shape == (5, 5) and g.device.type == "cpu"
    np.testing.assert_allclose(g.matvec(torch.as_tensor(x)).numpy(), m.T @ m @ x, atol=1e-12)
    np.testing.assert_allclose(g.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jss.gram_operator(jnp.asarray(m)).matvec(jnp.asarray(x))),
                               atol=1e-12)


def test_config4_truncated_svd_via_gram_lanczos():
    t = np.random.default_rng(42).standard_normal((6, 8, 7, 5))
    out = truncated_svd_via_lanczos(torch.as_tensor(t), left_axes=2, rank=3, tolerance=1e-14)
    ref = jss.truncated_svd_via_lanczos(jnp.asarray(t), left_axes=2, rank=3, tolerance=1e-14)
    u_np, s_np, vt_np = np.linalg.svd(t.reshape(48, 35), full_matrices=False)
    s = out.singular_values.numpy()
    assert np.max(np.abs(s - s_np[:3])) <= 1e-10
    assert np.max(np.abs(s - np.asarray(ref.singular_values))) <= 1e-10
    # tensor_v stored conjugated, the reference's convention
    U = out.tensor_u.reshape(48, 3).numpy()
    V = out.tensor_v.reshape(35, 3).numpy()
    M3 = (U * s) @ V.T
    assert np.linalg.norm(M3 - (u_np[:, :3] * s_np[:3]) @ vt_np[:3]) <= 1e-8
    np.testing.assert_allclose(out.reconstruct().numpy(), np.asarray(ref.reconstruct()), atol=1e-8)
    np.testing.assert_allclose(U.T @ U, np.eye(3), atol=1e-8)
    t2 = out.truncated(rank=2, pad=False)
    np.testing.assert_allclose(t2.reconstruct().numpy(),
                               np.asarray(ref.truncated(rank=2, pad=False).reconstruct()), atol=1e-8)


@pytest.mark.parametrize("shape,left", [((6, 4, 5, 3), 2), ((40, 12), 1), ((5, 30), 1)],
                         ids=["rank4_tensor", "tall", "wide_left_gram"])
def test_top_singular_triplets(shape, left):
    t = np.random.default_rng(5).standard_normal(shape)
    rank = 3 if shape != (5, 30) else 2
    out = truncated_svd_via_lanczos(torch.as_tensor(t), left, rank, tolerance=1e-14)
    mr = int(np.prod(shape[:left]))
    m = t.reshape(mr, -1)
    u, s, vh = np.linalg.svd(m, full_matrices=False)
    np.testing.assert_allclose(out.singular_values.numpy(), s[:rank], atol=1e-9)
    U = out.tensor_u.reshape(mr, rank).numpy()
    np.testing.assert_allclose(np.abs(U.T @ u[:, :rank]), np.eye(rank), atol=1e-6)
    rec = out.reconstruct().numpy().reshape(mr, -1)
    np.testing.assert_allclose(np.linalg.norm(m - rec), np.sqrt((s[rank:] ** 2).sum()), atol=1e-7)


def test_rank_and_split_errors():
    t = torch.as_tensor(np.random.default_rng(6).standard_normal((4, 3)))
    with pytest.raises(EigenexError):
        truncated_svd_via_lanczos(t, 1, 4)
    with pytest.raises(EigenexError):
        truncated_svd_via_lanczos(t, 2, 1)
