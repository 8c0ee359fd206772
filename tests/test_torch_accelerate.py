"""``accelerate()`` parity: the port's square routes (symmetric, general,
complex through the real embedding) against the JAX package's numpy/scipy
route (the native C++ packers of both packages switched off, so both run the
same RCM and the same packer) on the same numpy-seeded triplets, and against
its native route with both packages' native packers on; and the accelerated ``eigs``
and ``eigsh`` routes against the reference's (mirrors
``tests/test_accelerate.py:302-390``).

The pack is integer and copy work: permutation, band reach, slot count,
storage dtype and the dense operator are compared exactly, ELL slots without
regard to their order in a block row.  Solves on f64 packs: eigenvalues
1e-10 against the reference with the same explicit start vector; one-call
routes on auto (f32) packs against ``numpy.linalg.eig`` at f32 grade.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import eigenex_tpu.native as j_native
import eigenex_tpu_torch.native as t_native

from _reference_native import NOT_LOADED, ensure_reference_native

ensure_reference_native()
import eigenex_tpu_torch as ext
from eigenex_tpu.solvers.api import eigs as j_eigs
from eigenex_tpu.solvers.api import eigsh as j_eigsh
from eigenex_tpu.sparse.accelerate import accelerate as j_accelerate
from eigenex_tpu.sparse.accelerate import dedup_embedded_pairs as j_dedup
from eigenex_tpu_torch.sparse.accelerate import (
    AcceleratedOperator,
    _bf16_lossless,
    _padding_safe_v0,
    accelerate,
    band_permutation,
    dedup_embedded_pairs,
)
from eigenex_tpu_torch.sparse.coo import coo_from_dense
from eigenex_tpu_torch.utils.exceptions import EigenexError
from test_torch_containers import canonical_slots

torch.set_num_threads(1)


@pytest.fixture
def numpy_route(monkeypatch):
    """Both packages without their native packers: scipy RCM + numpy packer."""
    monkeypatch.setattr(j_native, "native_available", lambda: False)
    monkeypatch.setattr(t_native, "native_available", lambda: False)


def band_triplets(n, seed, dyadic=True):
    """Random symmetric band pattern with a heavy diagonal, shuffled by a
    random relabelling so that RCM has work to do."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 2)
    c = r + rng.integers(1, 9, size=len(r))
    keep = c < n
    r, c = r[keep], c[keep]
    key, first = np.unique(r * n + c, return_index=True)
    r, c = r[first], c[first]
    v = rng.standard_normal(len(r))
    if dyadic:
        v = np.round(v * 8) / 8
        v[v == 0] = 0.125
    relabel = rng.permutation(n)
    rows = relabel[np.concatenate([r, c, np.arange(n)])]
    cols = relabel[np.concatenate([c, r, np.arange(n)])]
    vals = np.concatenate([v, v, np.full(n, 4.0)])
    return rows, cols, vals, (n, n)


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic_bf16", "gaussian_f32"])
def test_pack_matches_reference_numpy_route(numpy_route, dyadic):
    trip = band_triplets(300, 0, dyadic)
    ref = j_accelerate(trip, block=8)
    got = accelerate(trip, block=8, device="cpu")
    assert isinstance(got, AcceleratedOperator)
    assert np.array_equal(got.perm, ref.perm)
    assert got.matrix.band_reach == ref.matrix.band_reach
    assert got.stats["ku"] == ref.stats["ku"] == got.matrix.upper_cols.shape[1]
    assert got.stats["dtype"] == ref.stats["dtype"] == ("bfloat16" if dyadic else "float32")
    for key in ("nnz", "slots", "fill", "bytes", "bandwidth_before", "bandwidth_after",
                "band_reach", "symmetric", "complexified"):
        assert got.stats[key] == ref.stats[key], key
    assert got.shape == ref.shape == (512, 512)  # padded to 32 block rows of 8
    assert got.n_work == 300 and got.orig_shape == (300, 300) and got.symmetric
    dense_ref = np.asarray(ref.matrix.to_dense().astype(jnp.float32))
    assert np.array_equal(got.matrix.to_dense().float().numpy(), dense_ref)
    assert np.array_equal(got.matrix.upper_cols.numpy(), np.asarray(ref.matrix.upper_cols))
    # the packed operator is P A P^T, zero-padded
    A = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3]).toarray()
    want = np.zeros((512, 512), np.float32)
    want[:300, :300] = A[np.ix_(got.perm, got.perm)]
    assert np.array_equal(dense_ref, want)
    assert got.stats["bandwidth_after"] < got.stats["bandwidth_before"]


def test_f64_pack_matches_reference(numpy_route):
    trip = band_triplets(200, 1)
    ref = j_accelerate(trip, block=8, dtype=jnp.float64)
    got = accelerate(trip, block=8, dtype=torch.float64, device="cpu")
    assert got.matrix.dtype == torch.float64 and got.stats["dtype"] == ref.stats["dtype"]
    assert np.array_equal(got.matrix.to_dense().numpy(), np.asarray(ref.matrix.to_dense()))
    x = np.random.default_rng(2).standard_normal(200)
    e_ref, e_got = ref.embed(x), got.embed(x)
    assert e_got.dtype == torch.float64 and np.array_equal(e_got.numpy(), np.asarray(e_ref))


def test_operands_and_options(numpy_route):
    trip = band_triplets(120, 3)
    A = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3])
    base = accelerate(trip, block=8, device="cpu")
    for operand in (A, A.tocsr(), coo_from_dense(A.toarray(), device="cpu")):
        other = accelerate(operand, block=8, device="cpu")
        assert torch.equal(other.matrix.to_dense(), base.matrix.to_dense())
    # duplicate triplets are merged before the symmetry check
    r, c, v, shape = trip
    split = (np.concatenate([r, r]), np.concatenate([c, c]), np.concatenate([v / 2, v / 2]), shape)
    assert torch.equal(accelerate(split, block=8, device="cpu").matrix.to_dense(),
                       base.matrix.to_dense())
    flat = accelerate(trip, block=8, reorder=False, device="cpu")
    assert np.array_equal(flat.perm, np.arange(120))
    assert accelerate(trip, block=8, dtype="float32", device="cpu").matrix.dtype == torch.float32
    assert accelerate(trip, block=8, symmetric=True, device="cpu").stats["symmetric"]


def test_band_permutation_is_scipy_rcm_and_reduces_bandwidth():
    r, c, _, (n, _) = band_triplets(150, 4)
    perm = band_permutation(r, c, n)
    assert sorted(perm.tolist()) == list(range(n))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    assert np.abs(inv[r] - inv[c]).max() < np.abs(r - c).max()


def test_embed_restore_round_trip():
    trip = band_triplets(100, 5)
    acc = accelerate(trip, block=8, device="cpu")
    rng = np.random.default_rng(6)
    x, X = rng.standard_normal(100).astype(np.float32), rng.standard_normal((100, 3))
    e = acc.embed(x)
    assert e.shape == (acc.shape[0],) and e.dtype == torch.float32
    assert torch.all(e[100:] == 0)  # zero on the padding rows
    assert np.array_equal(acc.restore(e), x)
    assert np.array_equal(acc.restore(acc.embed(X)), X.astype(np.float32))
    assert np.array_equal(acc.restore(acc.embed(torch.as_tensor(x))), x)
    # the embedded operator acts like the original on embedded vectors
    A = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3]).toarray()
    y = acc.restore(acc.as_linear_operator().matvec(e))
    np.testing.assert_allclose(y, A @ x, rtol=0, atol=1e-4)
    with pytest.raises(EigenexError):
        acc.embed(np.ones(99))
    with pytest.raises(EigenexError):
        acc.restore(np.ones(100))
    with pytest.raises(EigenexError):
        acc.embed(np.ones(100) * 1j)


def test_padding_safe_start_vector():
    v = _padding_safe_v0(100, 256, torch.float32, seed=3, device="cpu")
    assert v.shape == (256,) and torch.all(v[100:] == 0) and float(v[:100].abs().min()) > 0
    assert torch.equal(v, _padding_safe_v0(100, 256, torch.float32, seed=3, device="cpu"))


def test_bf16_lossless_probe():
    assert _bf16_lossless(np.array([0.5, -0.25, 4.0, 1.625, 0.0]))
    assert not _bf16_lossless(np.array([0.1]))
    assert not _bf16_lossless(np.array([1.0 + 2.0**-9]))


@pytest.mark.parametrize("how", ["auto_detect", "claimed_symmetric"])
def test_non_hermitian_input_raises(how):
    r, c, v, shape = band_triplets(80, 7)
    v = v.copy()
    v[0] += 1.0  # one entry no longer equals its mirror
    if how == "auto_detect":  # detected exactly -> the general pack, no error
        acc = accelerate((r, c, v, shape), block=8, device="cpu")
        assert not acc.symmetric and isinstance(acc.matrix, ext.BSRMatrix)
    else:  # the sampled probe behind symmetric=True catches the claim
        with pytest.raises(EigenexError, match="not Hermitian|not equal"):
            accelerate((r, c, v, shape), block=8, symmetric=True, device="cpu")
    upper = r < c
    with pytest.raises(EigenexError, match="not Hermitian"):
        accelerate((r[upper], c[upper], v[upper], shape), block=8, symmetric=True, device="cpu")


@pytest.mark.parametrize(
    "build",
    [
        # svds(mesh=) on a rectangular pack
        lambda pkg, acc, mesh: pkg.svds(
            acc((np.array([0, 1]), np.array([1, 2]), np.array([1.0, 2.0]), (2, 3))),
            k=1, mesh=mesh, return_singular_vectors=False),
        # eigsh_range(mesh=) on a complexified pack
        lambda pkg, acc, mesh: pkg.eigsh_range(
            acc((np.array([0, 1]), np.array([1, 0]), np.array([1j, -1j]), (2, 2)), block=8),
            (0.5, 1.5), mesh=mesh).eigenvalues,
        # eigs(mesh=) on a general pack
        lambda pkg, acc, mesh: pkg.eigs(
            acc((np.array([0]), np.array([1]), np.array([1.0]), (2, 2))), k=1,
            mesh=mesh).eigenvalues,
    ],
    ids=["rectangular", "complex", "general"],
)
def test_unported_routes_say_so(build):
    """The mesh routes of the accelerated operands are ported: each gives the
    reference's mesh result, or raises the reference's own error."""
    import jax
    import eigenex_tpu as jpkg
    from jax.sharding import Mesh as JMesh

    jmesh = JMesh(np.array(jax.devices("cpu")[:2]), ("rows",))
    tmesh = ext.make_mesh(devices=["cpu"] * 2)
    try:
        want = build(jpkg, j_accelerate, jmesh)
    except Exception as e:  # the reference refuses: the port must say the same
        with pytest.raises(EigenexError) as got:
            build(ext, lambda *a, **k: accelerate(*a, device="cpu", **k), tmesh)
        assert str(got.value) == str(e)
        return
    have = build(ext, lambda *a, **k: accelerate(*a, device="cpu", **k), tmesh)
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), atol=1e-6)


def test_bad_operand_raises():
    with pytest.raises(EigenexError):
        accelerate(np.eye(3), device="cpu")


# -- the general and complex packs ---------------------------------------------
def general_triplets(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, density=0.03, random_state=seed) + sp.eye(n)
    if complex_:
        m = m + 1j * sp.random(n, n, density=0.03, random_state=seed + 1)
    m = m.tocoo()
    relabel = rng.permutation(n)  # so that RCM has work to do
    return relabel[m.row], relabel[m.col], m.data, m.shape


@pytest.mark.parametrize("kind", ["real_general", "complex_general", "complex_hermitian"])
def test_general_and_complex_packs_match_reference(numpy_route, kind):
    if kind == "complex_hermitian":
        r, c, v, shape = band_triplets(150, 9)
        rng = np.random.default_rng(9)
        phase = np.exp(1j * rng.uniform(0, 2 * np.pi, len(v)))
        v = np.where(r < c, v * phase, v + 0j)
        mirror = {(a, b): x for a, b, x in zip(r, c, v) if a < b}
        v = np.array([np.conj(mirror[(b, a)]) if a > b else x for a, b, x in zip(r, c, v)])
        trip = (r, c, v, shape)
    else:
        trip = general_triplets(300, 4, complex_=kind == "complex_general")
    ref = j_accelerate(trip, block=8)
    got = accelerate(trip, block=8, device="cpu")
    assert got.symmetric == ref.symmetric == (kind == "complex_hermitian")
    assert got.complexified == ref.complexified == kind.startswith("complex")
    assert np.array_equal(got.perm, ref.perm) and got.shape == ref.shape
    for key in ("nnz", "slots", "fill", "bytes", "dtype", "bandwidth_before", "bandwidth_after",
                "symmetric", "complexified"):
        assert got.stats[key] == ref.stats[key], key
    if got.symmetric:
        assert got.stats["ku"] == ref.stats["ku"]
        assert np.array_equal(got.matrix.to_dense().float().numpy(),
                              np.asarray(ref.matrix.to_dense().astype(jnp.float32)))
    else:
        assert got.matrix.block_shape == ref.matrix.block_shape == (32, 128)
        assert got.shape[0] % 128 == 0 and got.stats["kmax"] == ref.stats["kmax"]
        gc, gd = canonical_slots(got.matrix.block_cols.numpy(), got.matrix.data.float().numpy())
        rc, rd = canonical_slots(ref.matrix.block_cols, np.asarray(ref.matrix.data, np.float32))
        assert np.array_equal(gc, rc) and np.array_equal(gd, rd)
        for g, w in zip(got.host_triplets, ref.host_triplets):
            assert np.array_equal(g, np.asarray(w))
    # embed / restore carry complex vectors through the real embedding
    n = trip[3][0]
    z = np.random.default_rng(5).standard_normal(n)
    if got.complexified:
        z = z + 1j * np.random.default_rng(6).standard_normal(n)
    e = got.embed(z)
    assert e.dtype == torch.float32 and np.array_equal(e.numpy(), np.asarray(ref.embed(z)))
    np.testing.assert_allclose(got.restore(e), z, rtol=0, atol=1e-6)
    A = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3]).toarray()
    y = got.restore(got.as_linear_operator().matvec(e))
    np.testing.assert_allclose(y, A @ got.restore(e), rtol=0, atol=1e-4)


def hermitian_triplets(n, seed):
    """A complex Hermitian band operator (phases on the off-diagonal)."""
    r, c, v, shape = band_triplets(n, seed)
    phase = np.exp(1j * np.random.default_rng(seed).uniform(0, 2 * np.pi, len(v)))
    key = np.minimum(r, c) * n + np.maximum(r, c)  # one phase per mirrored pair
    _, pair = np.unique(key, return_inverse=True)
    p = phase[pair]
    v = np.where(r < c, v * p, np.where(r > c, v * np.conj(p), v + 0j))
    return r, c, v, shape


def rect_triplets(m, n, seed):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 4)
    c = (r * n) // m + rng.integers(-60, 60, size=len(r))
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = np.round(rng.standard_normal(len(r)) * 8) / 8 + 0.0625  # dyadic: a bf16 pack
    pr, pc = rng.permutation(m), rng.permutation(n)
    return pr[r], pc[c], v, (m, n)


def host_blocks(t) -> np.ndarray:
    """Packed blocks of either package, bit patterns kept (bf16 as uint16)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


NATIVE_KINDS = {
    "sym_bf16": lambda: (band_triplets(3000, 21), dict(symmetric=True)),
    "sym_f32": lambda: (band_triplets(2500, 22, dyadic=False), dict()),
    "general": lambda: (general_triplets(1500, 23), dict()),
    "rectangular": lambda: (rect_triplets(2000, 1200, 24), dict()),
    "complex_hermitian": lambda: (hermitian_triplets(1200, 25), dict(symmetric=True)),
}


@pytest.mark.parametrize("kind", sorted(NATIVE_KINDS))
def test_native_route_packs_match_reference(kind):
    """Both packages on their native route (RCM, block sort, threaded
    packers): the same permutations and the same packs, bit for bit, at the
    default block shapes, and the stages the native route adds."""
    assert j_native.native_available(), NOT_LOADED
    trip, kw = NATIVE_KINDS[kind]()
    t_native.reset_native_calls()
    ref = j_accelerate(trip, **kw)
    got = accelerate(trip, device="cpu", **kw)
    calls = t_native.native_calls()
    assert calls.get("blk_widths") == 1 and calls.get("rcm_permutation") == 1, calls
    assert {"blk_sort", "pack_scatter", "device_put"} <= set(got.stats["pack_stages"])
    assert np.array_equal(got.perm, ref.perm) and got.shape == ref.shape
    if kind == "rectangular":
        assert np.array_equal(got.row_perm, ref.row_perm)
    for key in ("nnz", "slots", "fill", "bytes", "dtype", "bandwidth_before", "bandwidth_after",
                "symmetric", "complexified", "ku", "band_reach", "kmax"):
        assert got.stats.get(key) == ref.stats.get(key), key
    want_dtype = "bfloat16" if kind in ("sym_bf16", "rectangular") else "float32"
    assert got.stats["dtype"] == want_dtype
    if got.symmetric:
        assert got.matrix.band_reach == ref.matrix.band_reach
        pairs = [(got.matrix.diag_data, ref.matrix.diag_data),
                 (got.matrix.upper_data, ref.matrix.upper_data),
                 (got.matrix.upper_cols, ref.matrix.upper_cols)]
    else:
        pairs = [(got.matrix.data, ref.matrix.data), (got.matrix.block_cols, ref.matrix.block_cols),
                 (got.adjoint_matrix().data, ref.adjoint_matrix().data),
                 (got.adjoint_matrix().block_cols, ref.adjoint_matrix().block_cols)]
    for g, w in pairs:
        g, w = host_blocks(g), host_blocks(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_general_pack_adjoint_for_the_kernels():
    """A^H of a general pack keeps its (32, 128) block shape, the SpMV
    kernel's (the block transpose would give (128, 32))."""
    r, c, v, shape = general_triplets(250, 7)
    acc = accelerate((r, c, v, shape), dtype=torch.float64, device="cpu")
    adj = acc.matrix.kernel_adjoint()
    assert adj.block_shape == (32, 128) and adj is acc.matrix.kernel_adjoint()  # cached
    np.testing.assert_array_equal(adj.to_dense().numpy(), acc.matrix.to_dense().numpy().T)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(acc.shape[0]))
    np.testing.assert_allclose(acc.as_linear_operator().rmatvec(x).numpy(),
                               acc.matrix.to_dense().numpy().T @ x.numpy(), rtol=0, atol=1e-12)
    odd = ext.bsr_from_dense(np.random.default_rng(9).standard_normal((12, 8)), (4, 8), device="cpu")
    assert odd.kernel_adjoint().block_shape == (8, 4)  # 8 columns do not tile by 4 rows of 8
    # CGLS, the fallback of the general shift-invert, takes the adjoint from here
    b = np.random.default_rng(10).standard_normal(acc.shape[0])
    x, _, it = ext.cgls_solve(acc.as_linear_operator(), b, tol=1e-12, max_iters=8)
    x_d, _, it_d = ext.cgls_solve(acc.matrix.to_dense(), b, tol=1e-12, max_iters=8)
    assert int(it) == int(it_d) == 8
    assert np.linalg.norm(x.numpy() - x_d.numpy()) <= 1e-10 * np.linalg.norm(x_d.numpy())


def test_dedup_embedded_pairs_matches_reference():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((30, 3)) + 1j * rng.standard_normal((30, 3))
    vecs = np.stack([v[:, 0], 1j * v[:, 0], v[:, 1], v[:, 2], (1 + 1j) * v[:, 2]], axis=1)
    lam = np.array([1.0, 1.0 + 1e-6, 2.0, 3.0, 3.0])
    assert dedup_embedded_pairs(lam, vecs) == j_dedup(lam, vecs) == [0, 2, 3]
    assert dedup_embedded_pairs(lam, vecs, keep_max=2) == j_dedup(lam, vecs, keep_max=2)
    assert dedup_embedded_pairs(lam, None) == j_dedup(lam, None)


# -- eigs / eigsh on accelerated operands ----------------------------------------
def test_eigs_accelerate_real_general(numpy_route):
    trip = general_triplets(200, 51)
    n = 200
    v0 = np.random.default_rng(3).standard_normal(n)
    rj = j_eigs(j_accelerate(trip, dtype=jnp.float64), k=2, tol=1e-10, v0=v0)
    rt = ext.eigs(accelerate(trip, dtype=torch.float64, device="cpu"), k=2, tol=1e-10, v0=v0)
    assert isinstance(rt.eigenvectors, np.ndarray) and rt.eigenvectors.shape == (n, 2)
    key = lambda a: np.sort_complex(a.real + 1j * np.abs(a.imag))  # noqa: E731
    np.testing.assert_allclose(key(rt.eigenvalues), key(np.asarray(rj.eigenvalues)), atol=1e-10)
    # the one-call route on the auto (f32) pack, against numpy
    res = ext.eigs(trip, k=2, tol=1e-6, accelerate=True, v0=v0, device="cpu")
    dense = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3]).toarray()
    ref = np.linalg.eigvals(dense)
    ref = ref[np.argsort(-np.abs(ref))][:2]
    np.testing.assert_allclose(key(res.eigenvalues), key(ref), atol=2e-5)
    for j in range(2):
        z = res.eigenvectors[:, j] / np.linalg.norm(res.eigenvectors[:, j])
        assert np.linalg.norm(dense @ z - res.eigenvalues[j] * z) < 1e-4


def test_eigs_accelerate_seeded_start_stays_out_of_the_padding():
    """200 rows pad to 256: the padding adds a zero eigenvalue of
    multiplicity 56, which "SM" would return if the seeded start had any
    component on the padding rows."""
    n = 200
    m = (sp.random(n, n, density=0.04, random_state=8) + 2 * sp.eye(n)).tocoo()
    acc = accelerate((m.row, m.col, m.data, m.shape), dtype=torch.float64, device="cpu")
    assert acc.shape == (256, 256) and not acc.symmetric
    res = ext.eigs(acc, k=2, which="SM", tol=1e-10, max_subspace=256, seed=4)
    lam = np.linalg.eigvals(m.toarray().astype(np.float32).astype(np.float64))
    want = lam[np.argsort(np.abs(lam))][:2]
    # the second pair is one of a conjugate pair, whose members tie in |lambda|:
    # which one "SM" returns depends on the pack's RCM ordering
    unconj = lambda z: np.sort_complex(z.real + 1j * np.abs(z.imag))
    np.testing.assert_allclose(unconj(res.eigenvalues), unconj(want), atol=1e-8)


def test_eigs_accelerate_sigma_on_the_general_pack(numpy_route):
    """GMRES shift-invert on the packed general operand (sigma below the
    spectrum, where GMRES(48) converges in one cycle)."""
    trip = general_triplets(120, 12)
    v0 = np.random.default_rng(5).standard_normal(120)
    kw = dict(k=2, sigma=-0.5, tol=1e-8, v0=v0)
    rj = j_eigs(j_accelerate(trip, dtype=jnp.float64), **kw)
    rt = ext.eigs(accelerate(trip, dtype=torch.float64, device="cpu"), **kw)
    assert rt.converged and rt.termination != "inner_solve_failure"
    key = lambda a: np.sort_complex(a.real + 1j * np.abs(a.imag))  # noqa: E731
    np.testing.assert_allclose(key(rt.eigenvalues), key(np.asarray(rj.eigenvalues)), atol=1e-10)
    assert rt.inner_stats["fallbacks"] == 0
    dense = sp.coo_matrix((trip[2].astype(np.float32), (trip[0], trip[1])), shape=trip[3]).toarray()
    d = np.sort(np.abs(np.linalg.eigvals(dense.astype(np.float64)) + 0.5))[:2]
    np.testing.assert_allclose(np.sort(np.abs(rt.eigenvalues + 0.5)), d, atol=1e-8)


@pytest.mark.parametrize("refine", [False, True], ids=["plain", "refined"])
def test_eigs_accelerate_complex_general(numpy_route, refine):
    n = 120
    trip = general_triplets(n, 5, complex_=True)
    v0 = np.random.default_rng(6).standard_normal(n) + 0j
    m = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3])
    if refine:  # one call: raw complex COO, auto (f32) pack, f64 polish
        coo = ext.COOMatrix(torch.as_tensor(m.row.astype(np.int32)),
                            torch.as_tensor(m.col.astype(np.int32)), torch.as_tensor(m.data), m.shape)
        rt = ext.eigs(coo, k=4, tol=1e-6, accelerate=True, refine=True, v0=v0, device="cpu")
    else:
        acc = accelerate(trip, dtype=torch.float64, device="cpu")
        assert acc.complexified and not acc.symmetric and acc.n_work == 2 * n
        rt = ext.eigs(acc, k=4, tol=1e-10, v0=v0)
        rj = j_eigs(j_accelerate(trip, dtype=jnp.float64), k=4, tol=1e-10, v0=v0)
        np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    ev = np.linalg.eigvals(m.toarray())
    want = ev[np.argsort(-np.abs(ev))[:4]]
    np.testing.assert_allclose(np.sort(np.abs(rt.eigenvalues)), np.sort(np.abs(want)), rtol=1e-6)
    A, V, lam = m.tocsr(), rt.eigenvectors, rt.eigenvalues
    scale = float(np.abs(lam).max())
    # the numpy route packs through f32 entries; the refinement reads the f64 COO
    limit = 1e-10 if refine else 1e-6
    for j in range(4):
        assert np.linalg.norm(A @ V[:, j] - lam[j] * V[:, j]) < limit * scale


def hopping_chain(n, seed=0):
    """The complex Hermitian chain of ``benchmarks/bench_complex.py``."""
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal(n)
    t1 = np.exp(1j * rng.uniform(0, 2 * np.pi, n - 1))
    t2 = 0.5 * np.exp(1j * rng.uniform(0, 2 * np.pi, n - 2))
    ar = np.arange
    r = np.concatenate([ar(n), ar(n - 1), ar(1, n), ar(n - 2), ar(2, n)])
    c = np.concatenate([ar(n), ar(1, n), ar(n - 1), ar(2, n), ar(n - 2)])
    v = np.concatenate([diag.astype(complex), t1, np.conj(t1), t2, np.conj(t2)])
    return r, c, v, (n, n)


@pytest.mark.parametrize("route", ["SA", "sigma"])
def test_eigsh_accelerate_complex_hermitian(numpy_route, route):
    """The real embedding on the symmetric pack; the doubled spectrum deduped,
    also behind MINRES shift-invert (every eigenvalue of the embedding twice
    on both sides of sigma)."""
    n = 300 if route == "SA" else 60
    trip = hopping_chain(n)
    v0 = np.random.default_rng(1).standard_normal(n) + 0j
    kw = dict(k=2, which="SA", tol=1e-10, v0=v0) if route == "SA" else dict(
        k=2, sigma=0.1, tol=1e-10, max_subspace=32, v0=v0)
    rj = j_eigsh(j_accelerate(trip, symmetric=True, dtype=jnp.float64), **kw)
    rt = ext.eigsh(accelerate(trip, symmetric=True, dtype=torch.float64, device="cpu"), **kw)
    assert rt.eigenvectors.shape == (n, 2) and np.iscomplexobj(rt.eigenvectors)
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    # against the operator's f32-rounded entries, which the numpy route packs
    v32 = trip[2].real.astype(np.float32) + 1j * trip[2].imag.astype(np.float32)
    H = sp.coo_matrix((v32, (trip[0], trip[1])), shape=trip[3]).toarray()
    ev = np.linalg.eigvalsh(H)
    want = ev[:2] if route == "SA" else np.sort(ev[np.argsort(np.abs(ev - 0.1))[:2]])
    np.testing.assert_allclose(rt.eigenvalues, want, atol=1e-10)
    for j in range(2):
        z = rt.eigenvectors[:, j]
        assert np.linalg.norm(H @ z - rt.eigenvalues[j] * z) < 1e-8
