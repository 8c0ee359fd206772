"""Jacobi preconditioner parity: the diagonal the port extracts from each
operand kind, and the preconditioner built from it, against the JAX package
on the same numpy-seeded operator.  f64 on the CPU; tolerance 1e-14 (the two
sides read the same stored entries and divide once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.solvers import precond as jp
from eigenex_tpu.sparse.bsr import bsr_from_dense as j_bsr_from_dense
from eigenex_tpu.sparse.coo import coo_from_dense as j_coo_from_dense
from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr as j_sym_bsr_from_bsr
from eigenex_tpu_torch.solvers import precond as tp
from eigenex_tpu_torch.sparse.bsr import bsr_from_dense
from eigenex_tpu_torch.sparse.coo import coo_from_dense
from eigenex_tpu_torch.sparse.sym_bsr import sym_bsr_from_bsr
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def matrix(n=48, seed=0):
    rng = np.random.default_rng(seed)
    A = np.triu(np.tril(rng.standard_normal((n, n)), 9), -9)
    A = (A + A.T) / 2
    A[5, 5] = 0.0  # a zero diagonal entry: passed through unscaled
    return A


def operand_pair(kind, A):
    if kind == "coo":
        return j_coo_from_dense(A), coo_from_dense(A, device="cpu")
    if kind == "bsr":
        return j_bsr_from_dense(A, (8, 8)), bsr_from_dense(A, (8, 8), device="cpu")
    if kind == "sym_bsr":
        return (j_sym_bsr_from_bsr(j_bsr_from_dense(A, (8, 8))),
                sym_bsr_from_bsr(bsr_from_dense(A, (8, 8), device="cpu")))
    if kind == "dense":
        return jnp.asarray(A), torch.as_tensor(A)
    return jnp.asarray(np.diag(A).copy()), torch.as_tensor(np.diag(A).copy())  # "vector"


KINDS = ["coo", "bsr", "sym_bsr", "dense", "vector"]


@pytest.mark.parametrize("kind", KINDS)
def test_extract_diagonal_matches_reference(kind):
    A = matrix()
    jop, top = operand_pair(kind, A)
    d_ref = np.asarray(jp._extract_diagonal(jop))
    d = tp._extract_diagonal(top).numpy()
    assert d.dtype == np.float64 and d.shape == (A.shape[0],)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=1e-14)
    np.testing.assert_allclose(d, np.diag(A), rtol=0, atol=1e-14)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sigma", [0.0, 0.3])
def test_jacobi_preconditioner_matches_reference(kind, sigma):
    A = matrix(seed=1)
    jop, top = operand_pair(kind, A)
    rng = np.random.default_rng(2)
    r1, R = rng.standard_normal(A.shape[0]), rng.standard_normal((A.shape[0], 3))
    jT = jp.jacobi_preconditioner(jop, sigma=sigma)
    tT = tp.jacobi_preconditioner(top, sigma=sigma)
    for r in (r1, R):  # a vector and an (n, b) block
        got = tT(torch.as_tensor(r)).numpy()
        np.testing.assert_allclose(got, np.asarray(jT(jnp.asarray(r))), rtol=1e-14, atol=0)
    if sigma == 0.0:
        assert tT(torch.as_tensor(r1))[5] == r1[5]  # zero diagonal: unscaled


def test_host_operand_goes_where_it_is_told_and_bad_shapes_raise():
    A = matrix(seed=3)
    T = tp.jacobi_preconditioner(A, device="cpu")  # numpy operand
    r = np.random.default_rng(4).standard_normal(A.shape[0])
    d = np.diag(A)
    want = np.where(np.abs(d) > 1e-30, r / np.where(np.abs(d) > 1e-30, d, 1), r)
    np.testing.assert_allclose(T(r).numpy(), want, rtol=1e-14)
    with pytest.raises(EigenexError):
        tp.jacobi_preconditioner(torch.ones(3, 4))
    with pytest.raises(EigenexError, match="square blocks"):
        tp.jacobi_preconditioner(bsr_from_dense(np.ones((8, 16)), (4, 8), device="cpu"))


def test_coo_diagonal_sums_duplicates_like_the_reference():
    from eigenex_tpu.sparse.coo import COOMatrix as JCOO
    from eigenex_tpu_torch.convert import coo_from_numpy

    row, col = np.array([0, 0, 1, 3, 4], np.int32), np.array([0, 0, 2, 3, 4], np.int32)
    val = np.array([1.0, 2.5, 9.0, -1.0, 0.5])
    jcoo = JCOO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(val), (5, 5))
    d = coo_from_numpy(row, col, val, (5, 5), device="cpu").diagonal().numpy()
    np.testing.assert_allclose(d, np.asarray(jcoo.diagonal()), rtol=0, atol=0)
    np.testing.assert_allclose(d, [3.5, 0.0, 0.0, -1.0, 0.5])
