"""``svds`` of the port against the JAX package's, f64 on the CPU, on the
same numpy-seeded operands: the plain front end (the cases of
``tests/test_api.py::TestSvds``), the rectangular ``accelerate()`` pack
and its pipeline (the cases of ``tests/test_accelerate.py``'s
``TestRectangularAcceleration``), and ``AcceleratedOperator.save``/``load``
across the two packages.  Both packages run their numpy/scipy pack (native
packers off), so both run the same bipartite RCM and the same packer.

Tolerances:
- the pack is integer and copy work: ``row_perm``, ``perm``, blocks and
  block columns equal (atol 0), the adjoint repack too;
- singular values: plain routes 1e-10 absolute against numpy (the
  reference's own test); accelerated f64 1e-8 relative (the packs hold f32
  values in both packages) and complex general 1e-7 relative, against the
  reference and numpy; triplets A v = s u to the reference's atol;
- a pack saved by either package loads in the other, and its matvec there
  is bit-equal to that package's matvec of its own pack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import eigenex_tpu.native as j_native
import eigenex_tpu_torch.native as t_native
from eigenex_tpu import coo_from_dense as j_coo_from_dense
from eigenex_tpu.solvers.api import svds as j_svds
from eigenex_tpu.sparse.accelerate import AcceleratedOperator as JAcceleratedOperator
from eigenex_tpu.sparse.accelerate import accelerate as j_accelerate
from eigenex_tpu_torch import LinearOperator, coo_from_dense, svds
from eigenex_tpu_torch.convert import accelerated_from_numpy
from eigenex_tpu_torch.sparse.accelerate import (
    AcceleratedOperator,
    accelerate,
    bipartite_band_permutation,
)
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


@pytest.fixture
def numpy_route(monkeypatch):
    """Both packages without their native packers: scipy RCM + numpy packer."""
    monkeypatch.setattr(j_native, "native_available", lambda: False)
    monkeypatch.setattr(t_native, "native_available", lambda: False)


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def banded_rect(m=700, n=500, bw=60, seed=51, dyadic=True):
    """Entries near the matched diagonal j ~ i n/m, then shuffled on both
    sides, so that the bipartite RCM has to find the band again."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 4)
    c = (r * n) // m + rng.integers(-bw, bw, size=len(r))
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r))
    if dyadic:
        v = np.round(v * 8) / 8
    pr, pc = rng.permutation(m), rng.permutation(n)
    return pr[r], pc[c], v, (m, n)


def scipy_of(trip):
    r, c, v, shape = trip
    return sp.coo_matrix((v, (r, c)), shape=shape).tocsr()


# -- the plain front end (tests/test_api.py::TestSvds) ------------------------
class TestSvds:
    def test_tall_dense(self):
        A = np.random.default_rng(42).standard_normal((40, 12))
        U, s, Vh = svds(torch.as_tensor(A), k=3, tol=1e-14)
        ref = np.linalg.svd(A, compute_uv=False)[:3]
        np.testing.assert_allclose(s, ref, atol=1e-10)
        np.testing.assert_allclose(s, j_svds(jnp.asarray(A), k=3, tol=1e-14)[1], atol=1e-10)
        np.testing.assert_allclose(A @ host(Vh).conj().T, host(U) * s[None, :], atol=1e-8)

    def test_wide_coo(self):
        A = np.random.default_rng(43).standard_normal((10, 50))
        A[np.abs(A) < 0.5] = 0
        U, s, Vh = svds(coo_from_dense(A, device="cpu"), k=2, tol=1e-14)
        ref = np.linalg.svd(A, compute_uv=False)[:2]
        np.testing.assert_allclose(s, ref, atol=1e-10)
        np.testing.assert_allclose(s, j_svds(j_coo_from_dense(A), k=2, tol=1e-14)[1], atol=1e-10)
        np.testing.assert_allclose(A.conj().T @ host(U), host(Vh).conj().T * s[None, :], atol=1e-8)

    def test_values_only_and_restarted(self):
        A = np.random.default_rng(44).standard_normal((300, 200))
        s = svds(torch.as_tensor(A), k=4, max_subspace=40, return_singular_vectors=False, tol=1e-13)
        ref = np.linalg.svd(A, compute_uv=False)[:4]
        np.testing.assert_allclose(s, ref, atol=1e-8)

    def test_linear_operator_with_adjoint(self):
        A = np.random.default_rng(45).standard_normal((30, 20))
        At = torch.as_tensor(A)
        op = LinearOperator(lambda m, x: m @ x, At, A.shape, torch.float64, "cpu",
                            rmatvec_fn=lambda m, x: m.T @ x)
        U, s, Vh = svds(op, k=2, tol=1e-14)
        np.testing.assert_allclose(s, np.linalg.svd(A, compute_uv=False)[:2], atol=1e-10)
        np.testing.assert_allclose(A @ host(Vh).T, host(U) * s, atol=1e-8)

    def test_requires_adjoint(self):
        op = LinearOperator(lambda p, x: x, None, (5, 5), torch.float64, "cpu")
        with pytest.raises(EigenexError, match="adjoint"):
            svds(op, k=1)

    def test_k_too_large(self):
        with pytest.raises(EigenexError):
            svds(torch.as_tensor(np.random.default_rng(46).standard_normal((6, 4))), k=5)

    def test_mesh_is_not_ported(self):
        """mesh= is ported for sparse operands; a dense one is refused with
        the reference's error."""
        from eigenex_tpu_torch.parallel import make_mesh

        with pytest.raises(EigenexError, match="mesh= requires a sparse operand"):
            svds(torch.eye(4, dtype=torch.float64), k=1, mesh=make_mesh(devices=["cpu"] * 2))


# -- the rectangular pack ----------------------------------------------------
class TestRectangularPack:
    def test_pack_equals_reference(self, numpy_route):
        trip = banded_rect()
        ref = j_accelerate(trip, dtype=jnp.float64)
        got = accelerate(trip, dtype=torch.float64, device="cpu")
        assert got.row_perm is not None and len(got.row_perm) == 700 and got.m_work == 700
        np.testing.assert_array_equal(got.row_perm, ref.row_perm)
        np.testing.assert_array_equal(got.perm, ref.perm)
        np.testing.assert_array_equal(got.matrix.data.numpy(), np.asarray(ref.matrix.data))
        np.testing.assert_array_equal(got.matrix.block_cols.numpy(), np.asarray(ref.matrix.block_cols))
        assert got.shape == ref.shape == (768, 512)  # both sides padded to lcm(32, 128)
        for key in ("nnz", "slots", "fill", "bytes", "dtype", "bandwidth_before",
                    "bandwidth_after", "kmax", "symmetric", "complexified"):
            assert got.stats[key] == ref.stats[key], key
        r, c, _, (m, n) = trip
        rp, cp = bipartite_band_permutation(r, c, m, n)
        np.testing.assert_array_equal(rp, got.row_perm)
        np.testing.assert_array_equal(cp, got.perm)

    def test_auto_dtype_and_adjoint_repack_equal_reference(self, numpy_route):
        trip = banded_rect()
        ref = j_accelerate(trip)
        got = accelerate(trip, device="cpu")
        assert got.matrix.dtype == torch.bfloat16 and got.stats["dtype"] == ref.stats["dtype"]
        np.testing.assert_array_equal(got.matrix.data.float().numpy(),
                                      np.asarray(ref.matrix.data.astype(jnp.float32)))
        radj, gadj = ref.adjoint_matrix(), got.adjoint_matrix()
        assert gadj.block_shape == (32, 128) and gadj.shape == (512, 768)
        assert gadj is got.adjoint_matrix()  # cached
        np.testing.assert_array_equal(gadj.data.float().numpy(), np.asarray(radj.data.astype(jnp.float32)))
        np.testing.assert_array_equal(gadj.block_cols.numpy(), np.asarray(radj.block_cols))

    def test_embed_restore_both_sides_against_scipy(self):
        trip = banded_rect()
        A = scipy_of(trip)
        acc = accelerate(trip, dtype=torch.float64, device="cpu")
        x = np.random.default_rng(0).standard_normal(500)
        y = acc.restore(acc.matrix.as_linear_operator().matvec(acc.embed(x)))
        np.testing.assert_allclose(y, A @ x, atol=1e-10)
        u = np.random.default_rng(1).standard_normal(700)
        z = acc.restore_right(acc.adjoint_matrix().as_linear_operator().matvec(acc.embed_left(u)))
        np.testing.assert_allclose(z, A.T @ u, atol=1e-10)
        Z = acc.restore_right(acc.adjoint_matrix().matmat(acc.embed_left(np.stack([u, 2 * u], 1))))
        np.testing.assert_allclose(Z[:, 1], 2 * (A.T @ u), atol=1e-10)
        with pytest.raises(EigenexError):
            acc.embed_left(np.zeros(500))
        with pytest.raises(EigenexError):
            acc.restore_right(np.zeros(768))

    def test_rejects_symmetric_claim_and_complex(self):
        r, c, v = np.array([0, 1]), np.array([1, 2]), np.array([1.0, 2.0])
        with pytest.raises(EigenexError, match="rectangular"):
            accelerate((r, c, v, (4, 6)), symmetric=True, device="cpu")
        with pytest.raises(EigenexError, match="complex rectangular"):
            accelerate((r, c, v + 1j, (4, 6)), device="cpu")


# -- svds on accelerated operands ----------------------------------------------
class TestSvdsAccelerated:
    @pytest.mark.parametrize("shape", [(700, 500), (500, 700)], ids=["tall_right_gram", "wide_left_gram"])
    def test_f64_pack_matches_reference(self, numpy_route, shape):
        trip = banded_rect(*shape)
        A = scipy_of(trip)
        s_np = np.linalg.svd(A.toarray(), compute_uv=False)[:4]
        acc = accelerate(trip, dtype=torch.float64, device="cpu")
        U, s, Vh = svds(acc, k=4, tol=1e-11)
        _, s_ref, _ = j_svds(j_accelerate(trip, dtype=jnp.float64), k=4, tol=1e-11)
        np.testing.assert_allclose(s, s_ref, rtol=1e-8)
        np.testing.assert_allclose(s, s_np, rtol=1e-8)
        for j in range(4):
            np.testing.assert_allclose(A @ np.conj(Vh[j]), s[j] * U[:, j], atol=1e-7 * s[0])
            np.testing.assert_allclose(A.T @ U[:, j], s[j] * np.conj(Vh[j]), atol=1e-7 * s[0])
        np.testing.assert_allclose(U.T @ U, np.eye(4), atol=1e-8)
        np.testing.assert_allclose(Vh @ Vh.T.conj(), np.eye(4), atol=1e-8)

    def test_one_call_route_auto_dtype(self, numpy_route):
        trip = banded_rect()
        s_np = np.linalg.svd(scipy_of(trip).toarray(), compute_uv=False)[:4]
        s = svds(trip, k=4, accelerate=True, tol=1e-8, return_singular_vectors=False, device="cpu")
        np.testing.assert_allclose(s, s_np, rtol=1e-5)

    def test_complex_general(self, numpy_route):
        n = 120
        m = (sp.random(n, n, density=0.06, random_state=55)
             + 1j * sp.random(n, n, density=0.06, random_state=56) + sp.eye(n)).tocoo()
        dense = m.toarray()
        s_np = np.linalg.svd(dense, compute_uv=False)[:3]
        trip = (m.row, m.col, m.data, m.shape)
        acc = accelerate(trip, dtype=torch.float64, device="cpu")
        assert acc.complexified and not acc.symmetric
        U, s, Vh = svds(acc, k=3, tol=1e-11)
        _, s_ref, _ = j_svds(j_accelerate(trip, dtype=jnp.float64), k=3, tol=1e-11)
        np.testing.assert_allclose(s, s_ref, rtol=1e-7)
        np.testing.assert_allclose(s, s_np, rtol=1e-7)
        for j in range(3):
            np.testing.assert_allclose(dense @ np.conj(Vh[j]), s[j] * U[:, j], atol=1e-6 * s_np[0])
        s2 = svds(acc, k=3, tol=1e-11, return_singular_vectors=False)
        np.testing.assert_allclose(s2, s_np, rtol=1e-7)

    def test_complexified_hermitian_is_rejected(self):
        n = 20
        h = sp.random(n, n, density=0.2, random_state=3) * (1 + 1j)
        h = (h + h.conj().T + sp.eye(n)).tocoo()
        acc = accelerate((h.row, h.col, h.data, h.shape), device="cpu")
        assert acc.complexified and acc.symmetric
        with pytest.raises(EigenexError, match="use eigsh"):
            svds(acc, k=1)

    def test_loaded_pack_keeps_the_kernel_block_shape(self, tmp_path):
        """A loaded pack has no host triplets: A^H is packed from its blocks at
        (32, 128), never the block transpose's (128, 32), and svds agrees."""
        trip = banded_rect(m=300, n=200, bw=30)
        acc = accelerate(trip, dtype=torch.float64, device="cpu")
        acc.save(tmp_path / "rect.npz")
        back = AcceleratedOperator.load(tmp_path / "rect.npz", device="cpu")
        assert back.host_triplets is None
        adj = back.adjoint_matrix()
        assert adj.block_shape == (32, 128) and adj.shape == (256, 384)
        u = np.random.default_rng(3).standard_normal(300)
        np.testing.assert_allclose(back.restore_right(adj.matvec(back.embed_left(u))),
                                   scipy_of(trip).T @ u, atol=1e-10)
        np.testing.assert_allclose(svds(back, k=3, tol=1e-11, return_singular_vectors=False),
                                   svds(acc, k=3, tol=1e-11, return_singular_vectors=False),
                                   rtol=1e-10)


# -- save / load across the packages --------------------------------------------
def sym_triplets(n=300, seed=0):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 2)
    c = r + rng.integers(1, 9, size=len(r))
    keep = c < n
    r, c = r[keep], c[keep]
    key, first = np.unique(r * n + c, return_index=True)
    r, c = r[first], c[first]
    v = np.round(rng.standard_normal(len(r)) * 8) / 8
    relabel = rng.permutation(n)
    return (relabel[np.concatenate([r, c, np.arange(n)])],
            relabel[np.concatenate([c, r, np.arange(n)])],
            np.concatenate([v, v, np.full(n, 4.0)]), (n, n))


PACKS = {
    "rect_f64": (lambda: banded_rect(m=300, n=200, bw=30), dict(dtype="float64")),
    "rect_bf16": (lambda: banded_rect(m=300, n=200, bw=30), {}),
    "sym_bf16": (sym_triplets, dict(symmetric=True, block=8)),
}


def jax_matvec(acc, x):
    return np.asarray(acc.restore(np.asarray(acc.matrix.as_linear_operator().matvec(acc.embed(x)))))


def torch_matvec(acc, x):
    return acc.restore(acc.matrix.as_linear_operator().matvec(acc.embed(x)))


@pytest.mark.parametrize("case", list(PACKS))
def test_save_in_the_port_load_in_the_reference(numpy_route, tmp_path, case):
    make, kw = PACKS[case]
    trip = make()
    dt = kw.get("dtype")
    got = accelerate(trip, device="cpu", **{**kw, "dtype": getattr(torch, dt) if dt else "auto"})
    ref = j_accelerate(trip, **{**kw, "dtype": getattr(jnp, dt) if dt else "auto"})
    got.save(tmp_path / "port")  # numpy appends .npz, as for the reference
    loaded = JAcceleratedOperator.load(tmp_path / "port.npz")
    assert loaded.orig_shape == ref.orig_shape and loaded.stats["dtype"] == ref.stats["dtype"]
    np.testing.assert_array_equal(loaded.perm, ref.perm)
    if ref.row_perm is not None:
        np.testing.assert_array_equal(loaded.row_perm, ref.row_perm)
    x = np.random.default_rng(7).standard_normal(trip[3][1])
    np.testing.assert_array_equal(jax_matvec(loaded, x), jax_matvec(ref, x))


@pytest.mark.parametrize("case", list(PACKS))
def test_save_in_the_reference_load_in_the_port(numpy_route, tmp_path, case):
    make, kw = PACKS[case]
    trip = make()
    dt = kw.get("dtype")
    ref = j_accelerate(trip, **{**kw, "dtype": getattr(jnp, dt) if dt else "auto"})
    got = accelerate(trip, device="cpu", **{**kw, "dtype": getattr(torch, dt) if dt else "auto"})
    ref.save(tmp_path / "ref.npz")
    loaded = AcceleratedOperator.load(tmp_path / "ref.npz", device="cpu")
    assert loaded.matrix.dtype == got.matrix.dtype and loaded.shape == got.shape
    assert loaded.symmetric == got.symmetric and loaded.stats["nnz"] == got.stats["nnz"]
    x = np.random.default_rng(8).standard_normal(trip[3][1])
    np.testing.assert_array_equal(torch_matvec(loaded, x), torch_matvec(got, x))


def test_accelerated_from_numpy_carries_a_reference_pack(numpy_route):
    trip = banded_rect(m=300, n=200, bw=30)
    ref = j_accelerate(trip)  # bf16 blocks
    meta = dict(orig_shape=ref.orig_shape, symmetric=ref.symmetric, complexified=ref.complexified,
                stats=ref.stats, shape=ref.matrix.shape, dtype="bfloat16")
    acc = accelerated_from_numpy(meta, ref.perm, row_perm=ref.row_perm,
                                 data=np.asarray(ref.matrix.data.astype(jnp.float32)),
                                 bcols=np.asarray(ref.matrix.block_cols), device="cpu")
    got = accelerate(trip, device="cpu")
    assert acc.matrix.dtype == torch.bfloat16
    x = np.random.default_rng(9).standard_normal(200)
    np.testing.assert_array_equal(torch_matvec(acc, x), torch_matvec(got, x))
