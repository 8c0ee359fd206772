"""The port's CSR container (``sparse/csr.py``) against the JAX
package's on the same numpy-seeded operators: the arrays of
``csr_from_coo``/``csr_from_dense`` exactly, products and Gershgorin
bounds to 1e-12 relative, and the Lanczos route on a CSR operator to
1e-10 of the closed form.  Every product goes through the container's
COO view, whose int64 indices are converted once per container."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.sparse.coo import coo_from_dense as j_coo_from_dense
from eigenex_tpu.sparse.csr import csr_from_coo as j_csr_from_coo
from eigenex_tpu.sparse.csr import csr_from_dense as j_csr_from_dense
from eigenex_tpu_torch import (
    COOBuilder,
    CSRMatrix,
    LanczosEigenSolver,
    LanczosOptions,
    coo_from_dense,
    csr_from_coo,
    csr_from_dense,
    eigsh,
)
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def close(got, want, rel=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rel * max(np.linalg.norm(want), 1e-300)


def sparse_dense(seed, m, n, density=0.25, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((m, n))
    A[rng.random((m, n)) > density] = 0
    return A.astype(dtype)


@pytest.mark.parametrize("shape,dtype", [((20, 20), np.float64), ((17, 9), np.float64),
                                         ((12, 12), np.complex128)])
def test_arrays_and_products_match_reference(shape, dtype):
    A = sparse_dense(1, *shape, dtype=dtype)
    got = csr_from_dense(A, device="cpu")
    want = j_csr_from_dense(jnp.asarray(A))
    assert isinstance(got, CSRMatrix) and got.shape == want.shape and got.nnz == want.nnz
    for name in ("indptr", "indices", "data", "row_ids"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape[1])
    X = rng.standard_normal((shape[1], 3))
    close(got.matvec(torch.as_tensor(x)), want.matvec(jnp.asarray(x)))
    close(got.matmat(torch.as_tensor(X)), want.matmat(jnp.asarray(X)))
    close(got.to_dense(), want.to_dense())
    close(got.to_scipy().toarray(), A)
    op = got.as_linear_operator()
    y = rng.standard_normal(shape[0])
    close(op.rmatvec(torch.as_tensor(y)), A.conj().T @ y)


def test_csr_from_coo_sorts_like_reference():
    """Unsorted triplets: the row-major order and the row pointers."""
    rng = np.random.default_rng(3)
    r = rng.integers(0, 9, 40).astype(np.int32)
    c = rng.integers(0, 7, 40).astype(np.int32)
    keys = np.unique(r.astype(np.int64) * 7 + c)
    r, c = (keys // 7).astype(np.int32), (keys % 7).astype(np.int32)
    perm = rng.permutation(len(r))
    v = rng.standard_normal(len(r))
    from eigenex_tpu.sparse.coo import COOMatrix as JCOO
    from eigenex_tpu_torch import COOMatrix

    got = csr_from_coo(COOMatrix(torch.as_tensor(r[perm]), torch.as_tensor(c[perm]),
                                 torch.as_tensor(v[perm]), (9, 7)))
    want = j_csr_from_coo(JCOO(jnp.asarray(r[perm]), jnp.asarray(c[perm]),
                               jnp.asarray(v[perm]), (9, 7)))
    for name in ("indptr", "indices", "data", "row_ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(
        csr_from_dense(np.array([[1.0, 0, 2], [0, 0, 0], [3, 4, 0]]), device="cpu").indptr.numpy(),
        [0, 2, 2, 4])


def test_gershgorin_matches_reference():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((20, 20)) + np.diag(8 + np.arange(20.0))
    A[np.abs(A) < 0.8] = 0.0
    got = csr_from_dense(A, device="cpu")
    want = j_csr_from_dense(jnp.asarray(A))
    for g, w in zip(got.gershgorin_discs(), want.gershgorin_discs()):
        close(g, w)
    for g, w in zip(got.estimate_eigenvalue_range(), want.estimate_eigenvalue_range()):
        assert abs(float(g) - float(w)) <= 1e-12 * abs(float(w))
    with pytest.raises(EigenexError):
        csr_from_dense(np.ones((2, 3)), device="cpu").gershgorin_discs()


def test_int64_indices_are_converted_once_and_int32_fields_kept():
    A = sparse_dense(4, 30, 30)
    csr = csr_from_dense(A, device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(30))
    csr.matvec(x)
    coo = csr.to_coo()
    cached = coo._index64()
    csr.matvec(x)
    csr.matmat(x[:, None])
    assert csr.to_coo() is coo and coo._index64() is cached
    assert cached[0].dtype == torch.int64 and coo.row.dtype == torch.int32
    assert csr.indices.dtype == torch.int32 and csr.row_ids.dtype == torch.int32
    plain = coo_from_dense(A, device="cpu")
    plain.matvec(x)
    assert plain._index64() is plain._index64() and plain.row.dtype == torch.int32


def test_laplacian_csr_lanczos():
    """BASELINE config 1 in miniature through CSR storage."""
    n = 64
    b = COOBuilder(n, n, np.float64)
    for i in range(n):
        b.append(i, i, 2.0)
        if i + 1 < n:
            b.append(i, i + 1, -1.0)
            b.append(i + 1, i, -1.0)
    csr = csr_from_coo(b.build(device="cpu"))
    res = LanczosEigenSolver(csr.as_linear_operator(), LanczosOptions(
        max_eigenvalues=3, tolerance=1e-14, max_subspace=n, seed=0)).compute()
    exact = 2 - 2 * np.cos(np.arange(1, 4) * np.pi / (n + 1))
    np.testing.assert_allclose(np.asarray(res.eigenvalues), exact, atol=1e-10)
    res2 = eigsh(csr, k=2, which="SA", tol=1e-12)
    np.testing.assert_allclose(np.asarray(res2.eigenvalues), exact[:2], atol=1e-10)
