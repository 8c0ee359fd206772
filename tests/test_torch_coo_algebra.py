"""COOMatrix algebra and norms of the port against the JAX package: the
transpose and adjoint (re-sorted row-major), scalar multiples, sums and
differences (entries appended, duplicates merged, explicit zeros dropped),
the shape check, and the three norms (largest column sum, Frobenius, largest
row sum).

Both packages get the same numpy-seeded triplets, with duplicates and
explicit zeros, in f64 and complex128, on the CPU.  Triplets are compared
after a sort, norms as scalars, to 1e-14 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.sparse.coo import COOMatrix as JCOOMatrix
from eigenex_tpu.utils.exceptions import EigenexError as JEigenexError
from eigenex_tpu_torch.sparse.coo import COOMatrix
from eigenex_tpu_torch.utils.exceptions import EigenexError

TOL = 1e-14
SHAPE = (13, 9)


def triplets(seed, dtype, nnz=60, shape=SHAPE):
    """Unsorted triplets with duplicate positions and explicit zeros."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, shape[0], nnz).astype(np.int32)
    c = rng.integers(0, shape[1], nnz).astype(np.int32)
    v = rng.standard_normal(nnz)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(nnz)
    v = v.astype(dtype)
    v[rng.random(nnz) < 0.15] = 0
    r[-6:], c[-6:] = r[:6], c[:6]  # duplicate positions
    return r, c, v


def pair(seed, dtype, shape=SHAPE):
    r, c, v = triplets(seed, dtype, shape=shape)
    ref = JCOOMatrix(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), shape)
    port = COOMatrix(torch.as_tensor(r), torch.as_tensor(c), torch.as_tensor(v), shape)
    return ref, port


def sorted_triplets(coo):
    r, c, v = (np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
               for a in (coo.row, coo.col, coo.val))
    order = np.lexsort((c, r))
    return r[order], c[order], v[order]


def same_matrix(port, ref):
    assert isinstance(port, COOMatrix)
    assert port.shape == ref.shape
    assert port.device == torch.device("cpu")
    pr, pc, pv = sorted_triplets(port)
    rr, rc, rv = sorted_triplets(ref)
    np.testing.assert_array_equal(pr, rr)
    np.testing.assert_array_equal(pc, rc)
    assert pv.dtype == rv.dtype
    assert np.linalg.norm(pv - rv) <= TOL * max(np.linalg.norm(rv), 1e-300)


DTYPES = [np.float64, np.complex128]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["T", "H", "transpose", "adjoint"])
def test_transpose_and_adjoint_match_the_reference(dtype, op):
    ref, port = pair(0, dtype)
    out = getattr(port, op)
    out = out() if callable(out) else out
    want = getattr(ref, op)
    same_matrix(out, want() if callable(want) else want)
    row, col = out.row.numpy().astype(np.int64), out.col.numpy().astype(np.int64)
    assert np.all(np.diff(row * out.shape[1] + col) >= 0)  # re-sorted row-major


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scalar", [2.0, -0.5, 1.5 - 2j])
def test_scalar_multiples_match_the_reference(dtype, scalar):
    ref, port = pair(1, dtype)
    same_matrix(scalar * port, scalar * ref)
    same_matrix(port * scalar, ref * scalar)


@pytest.mark.parametrize("dtypes", [(np.float64, np.float64), (np.complex128, np.complex128),
                                    (np.float64, np.complex128)])
@pytest.mark.parametrize("op", ["add", "sub"])
def test_sums_merge_duplicates_and_drop_zeros_as_the_reference(dtypes, op):
    ref_a, port_a = pair(2, dtypes[0])
    ref_b, port_b = pair(3, dtypes[1])
    name = f"__{op}__"
    out = getattr(port_a, name)(port_b)
    same_matrix(out, getattr(ref_a, name)(ref_b))
    flat = out.row.numpy().astype(np.int64) * SHAPE[1] + out.col.numpy()
    assert np.all(np.diff(flat) > 0)  # merged: one entry a position, row-major
    assert np.all(out.val.numpy() != 0)
    # A - A: the positions without duplicates cancel exactly and drop; where
    # duplicates were summed, the rounding left in both packages is the same
    same_matrix(port_a - port_a, ref_a - ref_a)


def test_a_sum_of_other_shapes_raises_as_the_reference():
    ref_a, port_a = pair(4, np.float64)
    ref_b, port_b = pair(5, np.float64, shape=(SHAPE[1], SHAPE[0]))
    with pytest.raises(JEigenexError, match="shape mismatch"):
        ref_a + ref_b
    with pytest.raises(EigenexError, match="shape mismatch"):
        port_a + port_b
    with pytest.raises(EigenexError, match="shape mismatch"):
        port_a - port_b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["l1norm", "l2norm", "linorm"])
def test_norms_match_the_reference(dtype, norm):
    ref, port = pair(6, dtype)
    got = getattr(port, norm)()
    want = float(getattr(ref, norm)())
    assert isinstance(got, torch.Tensor) and got.ndim == 0 and got.device == port.device
    assert not got.is_complex()
    assert abs(float(got) - want) <= TOL * abs(want)
