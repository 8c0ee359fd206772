"""The port's Matrix Market IO (``sparse/io.py``) against the JAX
package's: the same files load to the same triplets (exactly), files
written by either package load in the other, the writer's mirror checks
raise where the reference's do, and ``expand_symmetry=False`` (the
native parser's route) keeps the stored triangle as the reference does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.native as j_native
import eigenex_tpu_torch.native as t_native
from eigenex_tpu.sparse.coo import coo_from_dense as j_coo_from_dense
from eigenex_tpu.sparse.io import load_matrix_market as j_load
from eigenex_tpu.sparse.io import save_matrix_market as j_save
from eigenex_tpu_torch import COOMatrix, coo_from_dense, eigsh, load_matrix_market, save_matrix_market
from eigenex_tpu_torch.utils.exceptions import EigenexError

from _reference_native import ensure_reference_native

ensure_reference_native()

torch.set_num_threads(1)

FILES = {
    "general": "%%MatrixMarket matrix coordinate real general\n% a comment\n3 4 4\n"
               "1 1 2.5\n2 3 -1.0\n3 4 7\n1 2 1e-3\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n3 3 4\n"
                 "1 1 1.0\n2 1 5.0\n3 2 -2.0\n3 3 4.0\n",
    "hermitian": "%%MatrixMarket matrix coordinate complex hermitian\n2 2 2\n"
                 "1 1 3.0 0.0\n2 1 1.0 -2.0\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n2 2 2\n1 2\n2 1\n",
    "skew": "%%MatrixMarket matrix coordinate integer skew-symmetric\n2 2 1\n2 1 3\n",
    "array": "%%MatrixMarket matrix array real general\n2 2\n1.0\n3.0\n2.0\n4.0\n",
}


def triplets(A):
    """Sorted (row, col, val) host triplets of either package's COO."""
    host = (lambda t: t.numpy()) if isinstance(A.val, torch.Tensor) else np.asarray
    r, c, v = host(A.row), host(A.col), host(A.val)
    order = np.lexsort((c, r))
    return r[order], c[order], v[order]


def same(got: COOMatrix, want, exact=True):
    assert got.shape == want.shape and got.dtype == torch.as_tensor(np.array(want.val)).dtype
    for g, w in zip(triplets(got), triplets(want)):
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-15)


@pytest.mark.parametrize("name", sorted(FILES))
def test_files_load_like_reference(tmp_path, name):
    p = tmp_path / f"{name}.mtx"
    p.write_text(FILES[name])
    got = load_matrix_market(str(p), device="cpu")
    assert isinstance(got, COOMatrix) and got.device.type == "cpu"
    assert got.row.dtype == torch.int32
    same(got, j_load(str(p)))
    same(load_matrix_market(p, dtype=np.complex128, device="cpu"), j_load(p, dtype=np.complex128))


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("symmetry", ["general", "symmetric", "skew-symmetric", "hermitian"])
def test_files_cross_between_packages(tmp_path, writer, symmetry):
    rng = np.random.default_rng(3)
    D = rng.standard_normal((9, 9))
    if symmetry == "hermitian":
        D = D + 1j * rng.standard_normal((9, 9))
    D[np.abs(D) < 0.9] = 0.0
    D = {"general": D, "symmetric": D + D.T, "skew-symmetric": D - D.T,
         "hermitian": D + D.conj().T}[symmetry]
    p = str(tmp_path / "x.mtx")
    if writer == "port":
        save_matrix_market(p, coo_from_dense(D, device="cpu"), symmetry=symmetry, comment="port")
        port_text = open(p).read()
        j_save(p, j_coo_from_dense(jnp.asarray(D)), symmetry=symmetry, comment="port")
        assert open(p).read() == port_text  # byte-equal files
    else:
        j_save(p, j_coo_from_dense(jnp.asarray(D)), symmetry=symmetry)
    got, want = load_matrix_market(p, device="cpu"), j_load(p)
    same(got, want)
    np.testing.assert_array_equal(got.to_dense(), D)


def test_scipy_reads_what_the_port_writes(tmp_path):
    import scipy.io

    D = np.random.default_rng(1).standard_normal((8, 8))
    D[np.abs(D) < 0.8] = 0.0
    D = D + D.T
    p = str(tmp_path / "rt.mtx")
    save_matrix_market(p, coo_from_dense(D, device="cpu"), symmetry="symmetric")
    np.testing.assert_array_equal(scipy.io.mmread(p).toarray(), D)


def test_writer_checks_raise_like_reference(tmp_path):
    p = str(tmp_path / "bad.mtx")
    cases = [
        (np.array([[1.0, 2.0], [5.0, 3.0]]), "symmetric", "mirror"),
        (np.array([[0.0, 2.0], [0.0, 0.0]]), "symmetric", "no stored"),
        (np.array([[1.0, 3.0], [-3.0, 0.0]]), "skew-symmetric", "diagonal"),
        (np.array([[0.0, 4.0], [-3.0, 0.0]]), "skew-symmetric", "mirror"),
        (np.array([[2.0 + 1j, 1 - 2j], [1 + 2j, 5.0]]), "hermitian", "diagonal"),
        (np.ones((2, 3)), "symmetric", "square"),
        (np.ones((2, 2)), "banded", "unknown"),
    ]
    for D, symmetry, match in cases:
        with pytest.raises(EigenexError, match=match) as got:
            save_matrix_market(p, coo_from_dense(D, device="cpu"), symmetry=symmetry)
        with pytest.raises(Exception) as want:
            j_save(p, j_coo_from_dense(jnp.asarray(D)), symmetry=symmetry)
        assert str(got.value).replace("--", "—") == str(want.value)


def test_loader_errors(tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("not a matrix market file\n1 2 3\n")
    skew = tmp_path / "badskew.mtx"
    skew.write_text("%%MatrixMarket matrix coordinate real skew-symmetric\n2 2 2\n1 1 9.0\n2 1 3.0\n")
    trunc = tmp_path / "trunc.mtx"
    trunc.write_text("%%MatrixMarket matrix coordinate real general\n3 3 5\n1 1 1.0\n")
    oob = tmp_path / "oob.mtx"
    oob.write_text("%%MatrixMarket matrix coordinate real general\n2 2 1\n5 1 1.0\n")
    for p in (bad, skew, trunc, oob):
        with pytest.raises(EigenexError):
            load_matrix_market(p, device="cpu")
    with pytest.raises(EigenexError, match="skew"):
        load_matrix_market(skew, device="cpu")
    sym = tmp_path / "s.mtx"
    sym.write_text(FILES["symmetric"])
    # the stored triangle needs the native parser: without it the loader
    # says so, as the reference's does
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_native, "native_available", lambda: False)
        mp.setattr(j_native, "native_available", lambda: False)
        with pytest.raises(EigenexError, match="native parser") as got:
            load_matrix_market(sym, expand_symmetry=False, device="cpu")
        with pytest.raises(Exception) as want:
            j_load(sym, expand_symmetry=False)
        assert str(got.value) == str(want.value)
    raw = load_matrix_market(sym, expand_symmetry=False, device="cpu")
    assert raw.nnz == 4 and bool((raw.row >= raw.col).all())
    dense = tmp_path / "d.mtx"
    dense.write_text(FILES["array"])
    with pytest.raises(EigenexError, match="coordinate-format"):
        load_matrix_market(dense, expand_symmetry=False, device="cpu")


def test_large_chunked_writer_round_trips(tmp_path):
    rng = np.random.default_rng(7)
    nnz, n = 200_000, 50_000
    r, c, v = rng.integers(0, n, nnz), rng.integers(0, n, nnz), rng.standard_normal(nnz)

    class Raw:
        row, col, val = torch.as_tensor(r), torch.as_tensor(c), torch.as_tensor(v)
        shape = (n, n)

    p = str(tmp_path / "big.mtx")
    save_matrix_market(p, Raw)
    B = load_matrix_market(p, device="cpu")
    assert B.shape == (n, n)
    np.testing.assert_allclose(float(B.val.sum()), v.sum(), rtol=1e-12)


def test_load_feeds_eigsh(tmp_path):
    n = 30
    D = np.random.default_rng(3).standard_normal((n, n))
    D = (D + D.T) / 2
    D[np.abs(D) < 1.0] = 0.0
    p = str(tmp_path / "op.mtx")
    save_matrix_market(p, coo_from_dense(D, device="cpu"), symmetry="symmetric")
    res = eigsh(load_matrix_market(p, device="cpu"), k=2, which="SA", tol=1e-12)
    np.testing.assert_allclose(np.asarray(res.eigenvalues), np.linalg.eigvalsh(D)[:2], atol=1e-9)


@pytest.mark.parametrize("name", ["general", "symmetric", "hermitian", "pattern", "skew"])
def test_stored_triangle_matches_reference(tmp_path, name):
    """``expand_symmetry=False``: the native parser's raw triplets, in file
    order, exactly as the reference returns them."""
    p = tmp_path / f"{name}.mtx"
    p.write_text(FILES[name])
    got = load_matrix_market(p, expand_symmetry=False, device="cpu")
    want = j_load(str(p), expand_symmetry=False)
    assert got.shape == want.shape
    for g, w in ((got.row, want.row), (got.col, want.col), (got.val, want.val)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_sector_file_stored_triangle_expands_to_the_sector(tmp_path):
    """What the card's ``mtx_raw`` phase checks, at L = 10: the S_z = 0
    sector saved symmetric, read back raw, holds (nnz + diag) / 2 entries,
    and mirroring its off-diagonal entries gives the sector bit for bit."""
    from eigenex_tpu_torch import heisenberg_sector_coo

    sector = heisenberg_sector_coo(10, 5, device="cpu")
    p = tmp_path / "sector.mtx"
    save_matrix_market(p, sector, symmetry="symmetric")
    raw = load_matrix_market(p, expand_symmetry=False, device="cpu")
    n_diag = int((sector.row == sector.col).sum())
    assert raw.nnz == (sector.nnz + n_diag) // 2 and bool((raw.row >= raw.col).all())
    r, c, v = raw.row.numpy(), raw.col.numpy(), raw.val.numpy()
    off = r != c
    full = (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]), np.concatenate([v, v[off]]))
    order = np.lexsort((full[1], full[0]))
    for g, w in zip(full, (sector.row, sector.col, sector.val)):
        assert np.array_equal(g[order], w.numpy())
