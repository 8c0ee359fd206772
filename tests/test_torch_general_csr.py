"""Row-compressed storage of general (non-symmetric) square operators
(``sparse/sym_csr.py`` with ``hermitian`` False) and the storage rule of
``accelerate()``'s general path on the CPU.

The rule runs only on the card; here it is switched on by replacing
``_storage_rule_applies``, as ``test_torch_sym_csr.py`` does, so that the
row-compressed route, its transposed storage and the general block pack made
on first need run on the CPU with the plain product.  Tolerances: products
1e-6 relative against a float64 dense product of the same stored values (f32
sums of at most five entries a row); eigenvalues 1e-6 relative between the
two storages, which sum each product in another order (Krylov-Schur at
tol 1e-7 on a stencil of 400 rows at convection 0.2, where they agree to
3e-8; at 0.4 the dominant pairs are so ill-conditioned that two
backward-stable f32 solves part by 6e-5).
"""

import sys

import numpy as np
import pytest
import torch

import eigenex_tpu_torch as ext
import eigenex_tpu_torch.sparse.accelerate  # noqa: F401  (the module, not the function)
from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.parallel import make_mesh
from eigenex_tpu_torch.solvers.precond import _extract_diagonal
from eigenex_tpu_torch.sparse.bsr import BSRMatrix
from eigenex_tpu_torch.sparse.sym_csr import SymCSRMatrix

from _stencil import stencil

acc_mod = sys.modules["eigenex_tpu_torch.sparse.accelerate"]


def both_storages(A, monkeypatch, **kw):
    """(row-compressed, block) accelerated operators of the same triplets on
    the CPU, with one RCM ordering."""
    trip = (A.row, A.col, A.data, A.shape)
    block = ext.accelerate(trip, device="cpu", **kw)
    monkeypatch.setattr(acc_mod, "_storage_rule_applies", lambda device, dtype: True)
    csr = ext.accelerate(trip, device="cpu", **kw)
    monkeypatch.undo()
    return csr, block


def dense_of(mat) -> np.ndarray:
    return mat.to_dense().double().numpy()


def test_a_stencil_is_stored_row_compressed(monkeypatch):
    """The nx = 64 stencil fills 1 % of its 32x128 pack: the rule stores it by
    rows, and the byte counts it compared are those of the two storages."""
    A = stencil(64)
    csr, block = both_storages(A, monkeypatch)
    mat = csr.matrix
    assert isinstance(mat, SymCSRMatrix) and not mat.hermitian and mat.dtype == torch.float32
    assert isinstance(block.matrix, BSRMatrix) and "storage_bytes" not in block.stats
    assert csr.stats["storage"] == "row_compressed" and not csr.symmetric
    assert mat.shape == block.shape and np.array_equal(csr.perm, block.perm)
    nnz, n_pad = A.nnz, block.shape[0]
    sizes = csr.stats["storage_bytes"]
    assert sizes == {"row_compressed": nnz * 8 + (n_pad + 1) * 4,
                     "block": block.matrix.data.numel() * 4}
    assert csr.stats["bytes"] == sizes["row_compressed"] < sizes["block"]
    for key in ("fill", "kmax", "nnz", "dtype", "bandwidth_after"):
        assert csr.stats[key] == block.stats[key], key  # the block pack the rule compared
    assert csr.host_triplets is None and block.host_triplets is not None
    np.testing.assert_array_equal(dense_of(mat), dense_of(block.matrix))


def test_dense_blocks_keep_the_block_pack(monkeypatch):
    """An operator whose 32x128 blocks are full reads fewer bytes as blocks."""
    n, rng = 1024, np.random.default_rng(2)
    r, c = np.nonzero(np.arange(n)[:, None] // 128 == np.arange(n)[None, :] // 128)
    monkeypatch.setattr(acc_mod, "_storage_rule_applies", lambda device, dtype: True)
    acc = ext.accelerate((r, c, rng.standard_normal(len(r)), (n, n)), reorder=False, device="cpu")
    assert not acc.symmetric and isinstance(acc.matrix, BSRMatrix)
    assert acc.stats["storage"] == "block" and acc.stats["fill"] == 1.0
    sizes = acc.stats["storage_bytes"]
    assert sizes == {"row_compressed": len(r) * 8 + (n + 1) * 4,
                     "block": acc.matrix.data.numel() * 4}
    assert sizes["block"] < sizes["row_compressed"] and acc.stats["bytes"] == sizes["block"]
    assert acc.block_matrix() is acc.matrix


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_product_and_transpose_equal_the_dense_ones(dtype, monkeypatch):
    csr, _ = both_storages(stencil(24), monkeypatch, dtype=dtype)
    mat = csr.matrix
    assert mat.dtype == dtype
    A = dense_of(mat)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(mat.shape[0]), dtype=torch.float32)
    for got, want in ((mat.matvec(x), A @ x.double().numpy()),
                      (mat.rmatvec(x), A.T @ x.double().numpy())):
        assert got.dtype == torch.float32
        assert np.linalg.norm(got.double().numpy() - want) <= 1e-6 * np.linalg.norm(want)
    adj = csr.adjoint_matrix()
    assert adj is mat.kernel_adjoint() and isinstance(adj, SymCSRMatrix) and not adj.hermitian
    assert adj.dtype == dtype and adj.shape == mat.shape[::-1]
    np.testing.assert_array_equal(dense_of(adj), A.T)
    rows, cols, _ = adj.triplets()  # row-major, columns ascending within each row
    assert np.all(np.diff(rows * adj.shape[1] + cols) > 0)
    op = mat.as_linear_operator()
    assert not op.capturable  # the plain version: nothing to capture on the CPU
    assert torch.equal(op.rmatvec(x), adj.matvec(x))
    X = torch.stack([x, 2 * x], 1)
    assert torch.equal(mat.matmat(X), torch.stack([mat.matvec(x), mat.matvec(2 * x)], 1))
    np.testing.assert_array_equal(_extract_diagonal(mat).numpy(), np.diag(A))


def test_block_pack_on_first_need_is_the_general_pack(monkeypatch):
    csr, block = both_storages(stencil(40), monkeypatch)
    got = csr.block_matrix()
    assert got is csr.block_matrix()  # cached
    want = block.matrix
    assert isinstance(got, BSRMatrix) and got.block_shape == (32, 128)
    assert got.data.shape == want.data.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(dense_of(got), dense_of(want))


def test_backward_launches_on_the_transposed_storage(monkeypatch):
    """Through the autograd Function, as on the card: the backward launches the
    same kernel on the cached transpose."""
    calls = []

    def launch(op, x):
        calls.append(op)
        with torch.no_grad():
            return cuda_spmv.csr_spmv_plain(op, x)

    csr, _ = both_storages(stencil(16), monkeypatch)
    monkeypatch.setitem(cuda_spmv._LAUNCH, "csr_spmv", launch)
    mat = csr.matrix
    x = torch.randn(mat.shape[0], requires_grad=True)
    y = cuda_spmv._product("csr_spmv", mat, x)
    g = torch.randn(mat.shape[0])
    (grad,) = torch.autograd.grad(y, x, g)
    assert len(calls) == 2 and calls[0] is mat and calls[1] is mat.kernel_adjoint()
    torch.testing.assert_close(grad, cuda_spmv.csr_spmv_plain(mat.kernel_adjoint(), g))


def test_save_load_round_trip(monkeypatch, tmp_path):
    csr, _ = both_storages(stencil(20), monkeypatch)
    path = tmp_path / "general_csr.npz"
    csr.save(path)
    back = ext.AcceleratedOperator.load(path, device="cpu")
    assert isinstance(back.matrix, SymCSRMatrix) and not back.matrix.hermitian
    for name in ("rowptr", "col", "val"):
        assert torch.equal(getattr(back.matrix, name), getattr(csr.matrix, name))
    assert np.array_equal(back.perm, csr.perm) and back.stats == csr.stats
    assert not back.symmetric and back.matrix.shape == csr.matrix.shape
    x = torch.randn(back.shape[0])
    assert torch.equal(back.adjoint_matrix().matvec(x), csr.adjoint_matrix().matvec(x))
    np.testing.assert_array_equal(dense_of(back.block_matrix()), dense_of(csr.block_matrix()))


@pytest.mark.parametrize("sigma", [None, 8.5])
def test_eigs_on_row_compressed_matches_block_route(sigma, monkeypatch):
    csr, block = both_storages(stencil(20, conv=0.2), monkeypatch)
    v0 = np.random.default_rng(3).standard_normal(csr.orig_shape[0])
    kw = dict(k=2, which="LM", tol=1e-7, v0=v0, sigma=sigma)
    got, want = ext.eigs(csr, **kw), ext.eigs(block, **kw)
    assert got.converged and want.converged
    key = lambda z: np.sort_complex(np.asarray(z).real + 1j * np.abs(np.asarray(z).imag))
    np.testing.assert_allclose(key(got.eigenvalues), key(want.eigenvalues), rtol=1e-6)


@pytest.mark.parametrize("on_mesh", [False, True], ids=["one_device", "mesh"])
def test_svds_on_row_compressed_matches_block_route(on_mesh, monkeypatch):
    """svds' Gram pipeline runs on the transposed storage on one device, and
    on the block pack made on first need and its adjoint on a mesh."""
    csr, block = both_storages(stencil(12), monkeypatch)
    kw = dict(k=3, tol=1e-7, return_singular_vectors=False)
    if on_mesh:
        kw["mesh"] = make_mesh(devices=["cpu"] * 2)
    np.testing.assert_allclose(ext.svds(csr, **kw), ext.svds(block, **kw), rtol=1e-6)
