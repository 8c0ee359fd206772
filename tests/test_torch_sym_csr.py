"""Row-compressed storage of symmetric operators (``sparse/sym_csr.py``) and
the storage rule of ``accelerate()`` on the CPU.

The rule runs only on the card; here it is switched on by replacing
``_storage_rule_applies``, so that the row-compressed route, its container
and the block pack made on first need are exercised on the CPU with the
plain product.  Tolerances: products 1e-6 relative against the block pack's
plain product and a float64 dense product of the same stored values (f32
sums over at most a few dozen entries a row); the on-demand block pack is
bit-equal to ``accelerate``'s; eigenvalues 1e-6 relative between the two
storages (the parity tolerance of the f32 accelerated solves).
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import eigenex_tpu_torch as ext
import eigenex_tpu_torch.sparse.accelerate  # noqa: F401  (the module, not the function)
from eigenex_tpu_torch.block.hamiltonians import heisenberg_sector_coo
from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.solvers.precond import _extract_diagonal
from eigenex_tpu_torch.sparse.sym_csr import SymCSRMatrix, sym_csr_from_triplets

acc_mod = sys.modules["eigenex_tpu_torch.sparse.accelerate"]


@pytest.fixture
def rule_on(monkeypatch):
    """The storage rule of the card, run on the CPU."""
    monkeypatch.setattr(acc_mod, "_storage_rule_applies", lambda device, dtype: True)


def random_symmetric(n: int, per_row: int, seed: int):
    """Triplets of a random symmetric operator with a dense diagonal; n is not
    a multiple of the pad, so the packs end in padding rows."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), per_row)
    c = rng.integers(0, n, size=len(r))
    keep = r < c
    r, c = r[keep], c[keep]
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    v = np.round(rng.standard_normal(len(r)) * 64) / 64
    d = np.round(rng.standard_normal(n) * 16) / 16
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    return rows, cols, np.concatenate([v, v, d]), (n, n)


def heisenberg(L: int):
    coo = heisenberg_sector_coo(L, L // 2, 1.0, 1.0, False, device="cpu")
    return (coo.row.numpy().astype(np.int64), coo.col.numpy().astype(np.int64),
            coo.val.numpy(), coo.shape)


OPERATORS = {
    "heisenberg_L8": lambda: heisenberg(8),
    "heisenberg_L10": lambda: heisenberg(10),
    "heisenberg_L12": lambda: heisenberg(12),
    "random_padded": lambda: random_symmetric(3000, 12, 4),
}


def both_storages(trip, dtype, monkeypatch):
    """(row-compressed, block) accelerated operators of the same triplets on
    the CPU, with one RCM ordering."""
    block = ext.accelerate(trip, symmetric=True, dtype=dtype, device="cpu")
    monkeypatch.setattr(acc_mod, "_storage_rule_applies", lambda device, dtype: True)
    csr = ext.accelerate(trip, symmetric=True, dtype=dtype, device="cpu")
    monkeypatch.undo()
    return csr, block


@pytest.mark.parametrize("name", sorted(OPERATORS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_product_matches_block_pack_and_dense(name, dtype, monkeypatch):
    trip = OPERATORS[name]()
    csr, block = both_storages(trip, dtype, monkeypatch)
    assert isinstance(csr.matrix, SymCSRMatrix) and csr.stats["storage"] == "row_compressed"
    assert block.stats["storage"] == "block" and np.array_equal(csr.perm, block.perm)
    for key in ("fill", "ku", "band_reach", "nnz", "dtype", "bandwidth_after"):
        assert csr.stats[key] == block.stats[key], key  # the block pack the rule compared
    mat = csr.matrix
    assert mat.dtype == dtype and mat.shape == block.shape
    assert mat.rowptr.dtype == mat.col.dtype == torch.int32 and mat.nnz == len(trip[2])
    # both triangles, columns ascending within each row
    rows, cols, _ = mat.triplets()
    assert np.all(np.diff(rows * mat.shape[1] + cols) > 0)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(mat.shape[0]), dtype=torch.float32)
    x[csr.n_work:] = 0
    y = cuda_spmv.csr_spmv(mat, x)
    assert y.dtype == torch.float32
    ref_block = cuda_spmv.sym_bsr_spmv_plain(block.matrix, x)
    dense = mat.to_dense().double()
    ref_dense = dense @ x.double()
    assert float((y - ref_block).norm() / ref_block.norm()) <= 1e-6
    assert float((y.double() - ref_dense).norm() / ref_dense.norm()) <= 1e-6
    assert torch.equal(dense, dense.T)
    assert torch.equal(y, cuda_spmv.csr_spmv(mat, x))  # the same sums in the same order


@pytest.mark.parametrize("value_bytes", [2, 4])
def test_storage_rule_at_both_sides_of_its_crossover(value_bytes):
    nnz, n_pad, block = 1_000_000, 262_144, 128
    csr_bytes = nnz * (value_bytes + 4) + (n_pad + 1) * 4
    per_block = block * block * value_bytes
    at = -(-csr_bytes // per_block)  # fewest blocks whose bytes reach the row-compressed ones
    slots = block * block  # of one real block of the half-storage pack
    below, sizes = acc_mod.choose_storage(nnz, n_pad, (at - 1) * slots, value_bytes)
    assert below == "block" and sizes == {"row_compressed": csr_bytes, "block": (at - 1) * per_block}
    above, _ = acc_mod.choose_storage(nnz, n_pad, at * slots, value_bytes)
    assert above == ("block" if at * per_block == csr_bytes else "row_compressed")
    assert acc_mod.choose_storage(nnz, n_pad, (at + 1) * slots, value_bytes)[0] == "row_compressed"
    # the L = 24 sector: 221.7 MB against 5.27 GB
    l24, sizes = acc_mod.choose_storage(35_154_028, 2_707_456, 160_828 * slots, 2)
    assert l24 == "row_compressed" and sizes["row_compressed"] == 221_753_996


def far_reach(n_blocks: int = 1100, pairs: int = 2000, seed: int = 5):
    """A symmetric operator whose few entries lie far from the diagonal: its
    band bitmap would be larger than its entries, so the count sorts."""
    rng = np.random.default_rng(seed)
    n = 128 * n_blocks
    r, c = rng.integers(0, n, pairs), rng.integers(0, n, pairs)
    key = np.unique(np.minimum(r, c) * n + np.maximum(r, c))
    r, c = key // n, key % n
    return np.concatenate([r, c]), np.concatenate([c, r]), np.ones(2 * len(r)), (n, n)


@pytest.mark.parametrize("name", ["heisenberg_L10", "random_padded", "far_reach"])
def test_block_census_matches_the_block_pack(name):
    """The real blocks, widest block row and band reach the storage rule reads
    (a band bitmap, or np.unique for a far reach) are those of the block pack."""
    r, c, v, shape = far_reach() if name == "far_reach" else OPERATORS[name]()
    block = ext.accelerate((r, c, v, shape), symmetric=True, reorder=False, device="cpu")
    nbr = block.shape[0] // 128
    cols = block.matrix.upper_cols
    blocks, ku, reach = acc_mod._block_census(r, c, 128, nbr)
    assert blocks == nbr + int((cols > torch.arange(nbr)[:, None]).sum())
    assert (ku, reach) == (cols.shape[1], block.matrix.band_reach)


def test_a_full_banded_pack_keeps_its_blocks(rule_on):
    """A banded operator that fills its blocks moves fewer bytes as blocks."""
    n, w = 2048, 200
    r, c = np.nonzero(np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= w)
    acc = ext.accelerate((r, c, np.ones(len(r)), (n, n)), symmetric=True, device="cpu")
    assert acc.stats["storage"] == "block" and acc.stats["storage_bytes"]["block"] < \
        acc.stats["storage_bytes"]["row_compressed"]
    assert acc.block_matrix() is acc.matrix


def test_cpu_keeps_the_reference_block_pack():
    acc = ext.accelerate(heisenberg(10), symmetric=True, device="cpu")
    assert acc.stats["storage"] == "block" and "storage_bytes" not in acc.stats
    assert acc.block_matrix() is acc.matrix and acc.adjoint_matrix() is acc.matrix


@pytest.mark.parametrize("name", ["heisenberg_L12", "random_padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_pack_on_first_need_is_bit_equal(name, dtype, monkeypatch):
    csr, block = both_storages(OPERATORS[name](), dtype, monkeypatch)
    got = csr.block_matrix()
    assert got is csr.block_matrix()  # cached
    bits = (lambda t: t.view(torch.int16)) if dtype == torch.bfloat16 else (lambda t: t)
    want = block.matrix
    assert got.shape == want.shape and got.band_reach == want.band_reach
    assert torch.equal(bits(got.diag_data), bits(want.diag_data))
    assert torch.equal(bits(got.upper_data), bits(want.upper_data))
    assert torch.equal(got.upper_cols, want.upper_cols)
    assert csr.stats["blocks"] == want.n_block_rows + int(
        (want.upper_cols > torch.arange(want.n_block_rows)[:, None]).sum())


def test_save_load_round_trip(rule_on, tmp_path):
    acc = ext.accelerate(heisenberg(10), symmetric=True, device="cpu")
    assert acc.matrix.dtype == torch.bfloat16
    path = tmp_path / "csr.npz"
    acc.save(path)
    back = ext.AcceleratedOperator.load(path, device="cpu")
    assert isinstance(back.matrix, SymCSRMatrix) and back.matrix.shape == acc.matrix.shape
    assert torch.equal(back.matrix.rowptr, acc.matrix.rowptr)
    assert torch.equal(back.matrix.col, acc.matrix.col)
    assert torch.equal(back.matrix.val.view(torch.int16), acc.matrix.val.view(torch.int16))
    assert np.array_equal(back.perm, acc.perm) and back.stats == acc.stats
    assert back.symmetric and not back.complexified


@pytest.mark.parametrize("which,k", [("SA", 1), ("SA", 4), ("LA", 2)])
def test_eigsh_on_row_compressed_matches_block_route(which, k, monkeypatch):
    csr, block = both_storages(heisenberg(12), "auto", monkeypatch)
    v0 = np.random.default_rng(2).standard_normal(csr.orig_shape[0])
    got = ext.eigsh(csr, k=k, which=which, tol=1e-6, max_subspace=40, v0=v0)
    want = ext.eigsh(block, k=k, which=which, tol=1e-6, max_subspace=40, v0=v0)
    assert got.converged and want.converged
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, rtol=1e-6, atol=1e-6)
    # eigenvectors restored to original coordinates through the same permutation
    overlap = np.abs(np.sum(got.eigenvectors * want.eigenvectors, axis=0))
    assert np.all(overlap > 1 - 1e-4)


def test_sigma_and_complex_hermitian_routes(rule_on):
    """Shift-invert on the row-compressed container, and a complex Hermitian
    operator through its real embedding (which is symmetric)."""
    r, c, v, shape = random_symmetric(600, 6, 9)
    acc = ext.accelerate((r, c, v, shape), symmetric=True, device="cpu")
    assert acc.stats["storage"] == "row_compressed"
    dense = np.zeros(shape)
    np.add.at(dense, (r, c), v)
    lam = np.linalg.eigvalsh(dense)
    sigma = float(lam[0]) - 0.5  # below the spectrum: a definite shifted operator
    got = ext.eigsh(acc, k=2, sigma=sigma, tol=1e-6, seed=1)
    np.testing.assert_allclose(np.sort(got.eigenvalues), lam[:2], rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(3)
    im = np.round(rng.standard_normal(len(v)) * 8) / 8
    im[r == c] = 0
    hv = v + 1j * np.where(r < c, im, 0)
    hv = np.where(r > c, np.conj(v + 1j * 0), hv)
    upper = r < c
    mirror = {(int(a), int(b)): val for a, b, val in zip(r[upper], c[upper], hv[upper])}
    hv = np.array([np.conj(mirror[(int(b), int(a))]) if a > b else val
                   for a, b, val in zip(r, c, hv)])
    accc = ext.accelerate((r, c, hv, shape), symmetric=True, device="cpu")
    assert accc.complexified and isinstance(accc.matrix, SymCSRMatrix)
    H = np.zeros(shape, complex)
    np.add.at(H, (r, c), hv)
    res = ext.eigsh(accc, k=2, which="SA", tol=1e-6, seed=2)
    np.testing.assert_allclose(res.eigenvalues, np.linalg.eigvalsh(H)[:2], rtol=1e-4, atol=1e-4)


def test_block_routes_take_the_block_pack(rule_on):
    """The window filter runs on the pack made on first need and gives the
    block route's numbers bit for bit."""
    trip = heisenberg(10)
    acc = ext.accelerate(trip, symmetric=True, device="cpu")
    assert isinstance(acc.matrix, SymCSRMatrix)
    block = dataclasses.replace(acc, matrix=acc.block_matrix())
    window = (-4.3, -3.5)
    got = ext.eigsh_window(acc, window, block_size=4, degree=30, seed=1)
    want = ext.eigsh_window(block, window, block_size=4, degree=30, seed=1)
    assert np.array_equal(got.eigenvalues, want.eigenvalues)


def test_container_helpers():
    r, c, v, shape = random_symmetric(500, 8, 11)
    mat = sym_csr_from_triplets(r, c, v, shape[0], torch.float64, "cpu", hermitian=True)
    dense = np.zeros(shape)
    np.add.at(dense, (r, c), v)
    centers, radii = mat.gershgorin_discs()
    np.testing.assert_array_equal(centers.numpy(), np.diag(dense))
    np.testing.assert_allclose(radii.numpy(), np.abs(dense).sum(1) - np.abs(np.diag(dense)))
    lo, hi = mat.estimate_eigenvalue_range()
    lam = np.linalg.eigvalsh(dense)
    assert float(lo) <= lam[0] and lam[-1] <= float(hi)
    np.testing.assert_array_equal(_extract_diagonal(mat).numpy(), np.diag(dense))
    X = torch.as_tensor(np.random.default_rng(0).standard_normal((shape[0], 3)))
    np.testing.assert_allclose(mat.matmat(X).numpy(), dense @ X.numpy(), rtol=1e-12, atol=1e-12)
    op = mat.as_linear_operator()
    assert not op.capturable and op.dtype == torch.float64
    np.testing.assert_allclose(op.rmatvec(X[:, 0]).numpy(), dense @ X[:, 0].numpy(), rtol=1e-12)
    assert mat.astype(torch.float32).dtype == torch.float32 and mat.to("cpu").nnz == mat.nnz


@pytest.mark.parametrize("nnz,rows,group", [(35_154_028, 2_707_456, 4), (3, 4, 1), (9, 2, 2),
                                             (700, 10, 32), (100, 0, 32)])
def test_lanes_a_row_follow_the_mean_row_length(nnz, rows, group):
    assert cuda_spmv.csr_group(nnz, rows) == group


def test_wrapper_refuses_what_the_kernel_does_not_take():
    mat = sym_csr_from_triplets(*random_symmetric(200, 4, 1)[:3], 200, torch.float64, "cpu",
                                hermitian=True)
    with pytest.raises(ext.EigenexError, match="float32/bfloat16"):
        cuda_spmv._check_csr(mat, "csr_spmv")
    f32 = mat.astype(torch.float32)
    cuda_spmv._check_csr(f32, "csr_spmv")
    bad = dataclasses.replace(f32, rowptr=f32.rowptr.long())
    with pytest.raises(ext.EigenexError, match="rowptr must be int32"):
        cuda_spmv._check_csr(bad, "csr_spmv")
    col = f32.col.clone()
    col[-1] = f32.shape[1]
    with pytest.raises(ext.EigenexError, match="outside"):
        cuda_spmv._check_csr(dataclasses.replace(f32, col=col), "csr_spmv")
    rowptr = f32.rowptr.clone()
    rowptr[3] = rowptr[5]
    with pytest.raises(ext.EigenexError, match="row pointer"):
        cuda_spmv._check_csr(dataclasses.replace(f32, rowptr=rowptr), "csr_spmv")


def test_backward_is_the_same_product(monkeypatch):
    """Through the autograd Function, as on the card: the backward launches
    the same kernel on the same container (A = A^T)."""
    calls = []

    def launch(op, x):
        calls.append(op)
        with torch.no_grad():
            return cuda_spmv.csr_spmv_plain(op, x)

    monkeypatch.setitem(cuda_spmv._LAUNCH, "csr_spmv", launch)
    r, c, v, shape = random_symmetric(300, 6, 2)
    mat = sym_csr_from_triplets(r, c, v, shape[0], torch.float32, "cpu", hermitian=True)
    x = torch.randn(shape[0], requires_grad=True)
    y = cuda_spmv._product("csr_spmv", mat, x)
    g = torch.randn(shape[0])
    (grad,) = torch.autograd.grad(y, x, g)
    assert len(calls) == 2 and calls[0] is mat and calls[1] is mat
    torch.testing.assert_close(grad, cuda_spmv.csr_spmv_plain(mat, g))
