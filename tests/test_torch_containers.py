"""Container parity: COO, BSR and SymBSR of the port against the JAX
package on the same numpy-seeded data, and the ``convert`` round trips.

Tolerances: f64 products agree to 1e-13 relative (same arithmetic, other
summation order); conversions and packs are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.sparse.bsr import bsr_from_coo_arrays as j_bsr_from_coo_arrays
from eigenex_tpu.sparse.bsr import bsr_from_dense as j_bsr_from_dense
from eigenex_tpu.sparse.coo import COOBuilder as JCOOBuilder
from eigenex_tpu.sparse.coo import coo_from_dense as j_coo_from_dense
from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr as j_sym_bsr_from_bsr
from eigenex_tpu_torch.convert import (
    bsr_from_numpy,
    coo_from_numpy,
    sym_bsr_from_numpy,
    to_numpy,
)
from eigenex_tpu_torch.sparse.bsr import BSRMatrix, bsr_from_coo_arrays, bsr_from_dense
from eigenex_tpu_torch.sparse.coo import COOBuilder, COOMatrix, coo_from_dense, coo_identity
from eigenex_tpu_torch.sparse.sym_bsr import SymBSRMatrix, sym_bsr_from_bsr
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def sym_dense(n, seed, density=0.25):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A[rng.random((n, n)) > density] = 0
    return (A + A.T) / 2


def close(a, b, tol=1e-13):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b), 1e-300)


def canonical_slots(cols, data):
    """Slots of every block row sorted by column, padding (zero blocks) last:
    the reference's native packer and its numpy packer fill a row's slots in
    different orders, and the order carries no meaning."""
    cols, data = np.asarray(cols), np.asarray(data)
    empty = ~data.reshape(*cols.shape, -1).any(axis=2)
    order = np.lexsort((cols, empty), axis=1)
    return (np.take_along_axis(cols, order, axis=1),
            np.take_along_axis(data, order[:, :, None, None], axis=1))


def same_slots(got_cols, got_data, ref_cols, ref_data):
    gc, gd = canonical_slots(got_cols.numpy(), got_data.numpy())
    rc, rd = canonical_slots(ref_cols, ref_data)
    return np.array_equal(gc, rc) and np.array_equal(gd, rd)


# -- COO ---------------------------------------------------------------------
class TestCOO:
    def test_triplets_merge_and_sort_like_reference(self):
        rng = np.random.default_rng(0)
        r = rng.integers(0, 12, 60)
        c = rng.integers(0, 9, 60)
        v = rng.standard_normal(60)
        ref = JCOOBuilder(12, 9).extend(r, c, v).build()
        got = COOBuilder(12, 9).extend(r, c, v).build(device="cpu")
        assert got.shape == (12, 9) and got.nnz == ref.nnz
        assert np.array_equal(got.row.numpy(), np.asarray(ref.row))
        assert np.array_equal(got.col.numpy(), np.asarray(ref.col))
        close(got.val, ref.val, 1e-15)
        with pytest.raises(EigenexError):
            COOBuilder(3, 3).append(3, 0, 1.0)

    @pytest.mark.parametrize("complex_", [False, True])
    def test_products_match_reference(self, complex_):
        rng = np.random.default_rng(1)
        A = rng.standard_normal((14, 10))
        if complex_:
            A = A + 1j * rng.standard_normal((14, 10))
        A[np.abs(A) < 0.8] = 0
        ref, got = j_coo_from_dense(A), coo_from_dense(A, device="cpu")
        x = rng.standard_normal(10) + (1j * rng.standard_normal(10) if complex_ else 0)
        y = rng.standard_normal(14) + (1j * rng.standard_normal(14) if complex_ else 0)
        X = rng.standard_normal((10, 3)).astype(A.dtype)
        close(got.matvec(torch.as_tensor(x)), ref.matvec(jnp.asarray(x)))
        close(got.rmatvec(torch.as_tensor(y)), ref.rmatvec(jnp.asarray(y)))
        close(got.matmat(torch.as_tensor(X)), ref.matmat(jnp.asarray(X)))
        close(got.to_dense(), A, 0)
        assert abs(got.to_scipy() - ref.to_scipy()).max() == 0
        op = got.as_linear_operator()
        close(op.matvec(torch.as_tensor(x)), A @ x)
        close(op.H.matvec(torch.as_tensor(y)), A.conj().T @ y)

    def test_gershgorin_matches_reference(self):
        A = sym_dense(16, 2)
        ref, got = j_coo_from_dense(A), coo_from_dense(A, device="cpu")
        for g, r in zip(got.gershgorin_discs(), ref.gershgorin_discs()):
            close(g, r)
        lo, hi = got.estimate_eigenvalue_range()
        rlo, rhi = ref.estimate_eigenvalue_range()
        assert abs(float(lo) - float(rlo)) < 1e-12 and abs(float(hi) - float(rhi)) < 1e-12
        ev = np.linalg.eigvalsh(A)
        assert float(lo) <= ev[0] and ev[-1] <= float(hi)
        with pytest.raises(EigenexError):
            coo_from_dense(np.ones((2, 3)), device="cpu").gershgorin_discs()

    def test_identity(self):
        x = torch.arange(5, dtype=torch.float64)
        assert torch.equal(coo_identity(5, device="cpu").matvec(x), x)


# -- BSR ---------------------------------------------------------------------
class TestBSR:
    def test_pack_matches_reference_layout(self):
        A = sym_dense(22, 3)  # 22 is no multiple of 4: rows and cols are padded
        r, c = np.nonzero(A)
        ref = j_bsr_from_coo_arrays(r, c, A[r, c], A.shape, (4, 8))
        got = bsr_from_coo_arrays(r, c, A[r, c], A.shape, (4, 8), device="cpu")
        assert got.shape == ref.shape and got.block_shape == (4, 8)
        assert got.block_cols.dtype == torch.int32
        assert same_slots(got.block_cols, got.data, ref.block_cols, ref.data)
        assert got.k_max == ref.k_max and got.nnz == ref.nnz

    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_products_and_dense_match_reference(self, dtype):
        A = sym_dense(24, 4).astype(dtype)
        ref, got = j_bsr_from_dense(A, (4, 4)), bsr_from_dense(A, (4, 4), device="cpu")
        rng = np.random.default_rng(5)
        x = rng.standard_normal(24).astype(dtype)
        X = rng.standard_normal((24, 5)).astype(dtype)
        tol = 1e-13 if dtype == np.float64 else 1e-6
        close(got.matvec(torch.as_tensor(x)), ref.matvec(jnp.asarray(x)), tol)
        close(got.matmat(torch.as_tensor(X)), ref.matmat(jnp.asarray(X)), tol)
        close(got.to_dense(), A, 0)
        close(got.as_linear_operator().matvec(torch.as_tensor(x)), A @ x, tol)

    def test_bf16_storage_accumulates_in_f32(self):
        A = sym_dense(16, 6).astype(np.float32)
        got = bsr_from_dense(A, (4, 4), device="cpu").astype(torch.bfloat16)
        ref = j_bsr_from_dense(A, (4, 4)).astype(jnp.bfloat16)
        x = np.random.default_rng(7).standard_normal(16).astype(np.float32)
        y = got.matvec(torch.as_tensor(x))
        assert y.dtype == torch.float32 and got.as_linear_operator().dtype == torch.float32
        close(y, ref.matvec(jnp.asarray(x)), 1e-6)

    def test_transpose_and_adjoint(self):
        rng = np.random.default_rng(8)
        A = rng.standard_normal((12, 16)) + 1j * rng.standard_normal((12, 16))
        A[np.abs(A) < 1.2] = 0
        got = bsr_from_dense(A, (4, 8), device="cpu")
        close(got.transpose().to_dense(), A.T, 0)
        close(got.adjoint().to_dense(), A.conj().T, 0)
        ref_t = j_bsr_from_dense(A, (4, 8)).transpose()
        got_t = got.transpose()
        assert same_slots(got_t.block_cols, got_t.data, ref_t.block_cols, ref_t.data)

    def test_gershgorin_matches_reference(self):
        A = sym_dense(24, 9)
        ref, got = j_bsr_from_dense(A, (4, 4)), bsr_from_dense(A, (4, 4), device="cpu")
        for g, r in zip(got.gershgorin_discs(), ref.gershgorin_discs()):
            close(g, r)
        with pytest.raises(EigenexError):
            bsr_from_dense(np.ones((8, 8)), (2, 4), device="cpu").gershgorin_discs()


# -- SymBSR ------------------------------------------------------------------
class TestSymBSR:
    @pytest.mark.parametrize("complex_", [False, True])
    def test_pack_products_and_dense_match_reference(self, complex_):
        rng = np.random.default_rng(10)
        A = sym_dense(24, 11)
        if complex_:
            B = rng.standard_normal((24, 24))
            B[np.abs(B) < 1.0] = 0
            A = A + 1j * (B - B.T) / 2
        ref = j_sym_bsr_from_bsr(j_bsr_from_dense(A, (4, 4)), check=True, atol=1e-12)
        got = sym_bsr_from_bsr(bsr_from_dense(A, (4, 4), device="cpu"), check=True, atol=1e-12)
        assert got.band_reach == ref.band_reach and got.shape == ref.shape
        assert same_slots(got.upper_cols, got.upper_data, ref.upper_cols, ref.upper_data)
        assert np.array_equal(got.diag_data.numpy(), np.asarray(ref.diag_data))
        assert got.nnz_stored == ref.nnz_stored and got.nnz_applied == ref.nnz_applied
        x = rng.standard_normal(24) + (1j * rng.standard_normal(24) if complex_ else 0)
        X = (rng.standard_normal((24, 3)) + 0j) if complex_ else rng.standard_normal((24, 3))
        close(got.matvec(torch.as_tensor(x)), ref._xla_matvec(jnp.asarray(x)))
        close(got.matvec(torch.as_tensor(x)), A @ x)
        close(got.matmat(torch.as_tensor(X)), ref._xla_matmat(jnp.asarray(X)))
        close(got.to_dense(), A, 0)
        op = got.as_linear_operator()
        close(op.rmatvec(torch.as_tensor(x)), A @ x)  # Hermitian: A == A^H

    def test_gershgorin_matches_reference(self):
        A = sym_dense(24, 12)
        ref = j_sym_bsr_from_bsr(j_bsr_from_dense(A, (4, 4)))
        got = sym_bsr_from_bsr(bsr_from_dense(A, (4, 4), device="cpu"))
        for g, r in zip(got.gershgorin_discs(), ref.gershgorin_discs()):
            close(g, r)
        lo, hi = got.estimate_eigenvalue_range()
        ev = np.linalg.eigvalsh(A)
        assert float(lo) <= ev[0] and ev[-1] <= float(hi)

    def test_astype_keeps_metadata(self):
        got = sym_bsr_from_bsr(bsr_from_dense(sym_dense(16, 13), (4, 4), device="cpu"))
        low = got.astype(torch.bfloat16)
        assert low.dtype == torch.bfloat16 and low.band_reach == got.band_reach
        assert low.as_linear_operator().dtype == torch.float32

    @pytest.mark.parametrize(
        "matrix",
        [
            np.triu(np.ones((8, 8))),  # upper blocks without mirrors
            np.tril(np.ones((8, 8)) + 7 * np.eye(8)),  # stored lower-triangle-only
            np.diag(np.ones(8)) + np.eye(8, k=1),  # asymmetric diagonal block
        ],
        ids=["upper_only", "lower_only", "diag_block"],
    )
    def test_check_rejects_asymmetric(self, matrix):
        with pytest.raises(EigenexError):
            sym_bsr_from_bsr(bsr_from_dense(matrix, (4, 4), device="cpu"), check=True)

    def test_rejects_non_square(self):
        with pytest.raises(EigenexError):
            sym_bsr_from_bsr(bsr_from_dense(np.ones((4, 8)), (4, 4), device="cpu"))
        with pytest.raises(EigenexError):
            sym_bsr_from_bsr(bsr_from_dense(np.ones((8, 8)), (2, 4), device="cpu"))


# -- convert -----------------------------------------------------------------
class TestConvert:
    def test_bsr_round_trip_from_reference_arrays(self):
        A = sym_dense(24, 14).astype(np.float32)
        ref = j_bsr_from_dense(A, (4, 4))
        got = bsr_from_numpy(np.asarray(ref.data), np.asarray(ref.block_cols), ref.shape,
                             device="cpu")
        assert isinstance(got, BSRMatrix) and got.dtype == torch.float32
        back = to_numpy(got)
        assert np.array_equal(back["data"], np.asarray(ref.data))
        assert np.array_equal(back["block_cols"], np.asarray(ref.block_cols))
        assert back["shape"] == ref.shape
        again = bsr_from_numpy(**back, device="cpu")
        assert torch.equal(again.data, got.data)

    def test_bf16_operator_crosses_losslessly(self):
        A = (np.round(sym_dense(16, 15) * 8) / 8).astype(np.float32)  # bf16-exact values
        ref = j_sym_bsr_from_bsr(j_bsr_from_dense(A, (4, 4))).astype(jnp.bfloat16)
        got = sym_bsr_from_numpy(
            np.asarray(ref.diag_data.astype(jnp.float32)),
            np.asarray(ref.upper_data.astype(jnp.float32)),
            np.asarray(ref.upper_cols), ref.shape, ref.band_reach,
            dtype=torch.bfloat16, device="cpu",
        )
        assert isinstance(got, SymBSRMatrix) and got.dtype == torch.bfloat16
        assert got.band_reach == ref.band_reach
        close(got.to_dense().float(), A, 0)
        back = to_numpy(got)
        assert back["upper"].dtype == np.float32 and back["band_reach"] == ref.band_reach
        assert np.array_equal(back["upper"], np.asarray(ref.upper_data.astype(jnp.float32)))

    def test_coo_round_trip(self):
        A = sym_dense(10, 16)
        ref = j_coo_from_dense(A)
        got = coo_from_numpy(np.asarray(ref.row), np.asarray(ref.col), np.asarray(ref.val),
                             ref.shape, device="cpu")
        assert isinstance(got, COOMatrix) and got.row.dtype == torch.int32
        close(got.to_dense(), A, 0)
        back = to_numpy(got)
        assert np.array_equal(back["val"], np.asarray(ref.val))

    def test_to_numpy_rejects_other_objects(self):
        with pytest.raises(TypeError):
            to_numpy(np.ones(3))


def test_linear_operator_lives_on_the_card_unless_told_otherwise():
    """Every constructor resolves ``device=None`` to the CUDA device; only the
    attribute is read here, so no card is needed."""
    from eigenex_tpu_torch import LinearOperator

    op = LinearOperator(lambda _, x: x, None, (4, 4), torch.float32)
    assert op.device.type == "cuda"
    assert op.shifted(1.0).device.type == "cuda" and (2.0 * op).device.type == "cuda"
    assert LinearOperator(lambda _, x: x, None, (4, 4), torch.float32, "cpu").device.type == "cpu"


def test_dense_operator_matmat_is_one_fused_product():
    """``aslinearoperator(dense).matmat`` is the fused ``A @ X`` of the
    reference's ``_dense_matmat``, not a column-by-column stack of matvecs."""
    from eigenex_tpu.core.operators import aslinearoperator as j_aslinearoperator
    from eigenex_tpu_torch.core import operators as top

    rng = np.random.default_rng(0)
    A, X = rng.standard_normal((12, 9)), rng.standard_normal((9, 5))
    op = top.aslinearoperator(torch.as_tensor(A))
    assert op._matmat_fn is top._dense_matmat
    calls = []
    op._matvec_fn = lambda m, x: calls.append(1) or m @ x  # a stacked fallback would land here
    Y = op.matmat(torch.as_tensor(X))
    assert not calls and Y.shape == (12, 5)
    np.testing.assert_allclose(Y.numpy(), A @ X, rtol=0, atol=1e-13)
    ref = j_aslinearoperator(jnp.asarray(A)).matmat(jnp.asarray(X))
    np.testing.assert_allclose(Y.numpy(), np.asarray(ref), rtol=0, atol=1e-13)
    # an operator without a fused product still stacks matvecs
    bare = top.LinearOperator(lambda m, x: m @ x, torch.as_tensor(A), A.shape, torch.float64, "cpu")
    np.testing.assert_allclose(bare.matmat(torch.as_tensor(X)).numpy(), A @ X, atol=1e-13)
