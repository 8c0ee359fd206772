"""Every ``mesh=`` front end of the port against the JAX package's mesh result,
on the CPU: ``eigsh`` (each matvec mode, ``sigma``, a 2-axis mesh, an
accelerated operand), ``eigs`` (including the 2-axis mesh against the
reference's single-device ``eigs``), ``svds``, ``eigsh_window``,
``eigsh_range`` and the KPM moments, BASELINE configs 5a and 5b at their CI
sizes on an 8-shard mesh, and ``load_state(mesh=)`` / ``shard_state``.

The JAX side runs on its virtual CPU devices, the port on
``make_mesh(devices=["cpu"] * n)``; operators are numpy-seeded.
Tolerances: eigenvalues to 1e-10 (configs 5a/5b to 1e-9, as
``tests/test_baseline_configs.py`` holds the reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh as JMesh

import eigenex_tpu.solvers.api as japi
import eigenex_tpu_torch as ext
from eigenex_tpu.sparse.bsr import bsr_from_coo_arrays as j_bsr
from eigenex_tpu.sparse.coo import coo_from_dense as j_coo_from_dense
from eigenex_tpu_torch.parallel import Mesh, make_mesh
from eigenex_tpu_torch.parallel.shard_map import Sharded
from eigenex_tpu_torch.sparse.bsr import bsr_from_coo_arrays as t_bsr
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)

EIG_TOL = 1e-10


def jmesh(n=4, shape=None, names=("rows",)):
    devs = np.array(jax.devices("cpu")[:n])
    return JMesh(devs.reshape(shape) if shape else devs, names)


def tmesh(n=4, shape=None, names=("rows",)):
    devs = np.array(["cpu"] * n)
    return Mesh(devs.reshape(shape) if shape else devs, names)


def banded(n=90, seed=0, bw=6):
    """A banded symmetric matrix with dyadic entries."""
    rng = np.random.default_rng(seed)
    A = np.round(rng.standard_normal((n, n)) * 8) / 8
    A = np.triu(np.tril(A, bw), -bw)
    A = (A + A.T) / 2
    return A + np.diag(np.round(np.linspace(0, 6, n) * 16) / 16)


def coo_pair(A):
    return j_coo_from_dense(A), ext.coo_from_dense(A, device="cpu")


@pytest.mark.parametrize("mode", ["allgather", "colsplit", "halo", "sym_halo"])
def test_eigsh_mesh_modes(mode):
    A = banded()
    jc, tc = coo_pair(A)
    kw = dict(k=3, which="SA", tol=1e-12, max_subspace=40, matvec_mode=mode)
    jr = japi.eigsh(jc, mesh=jmesh(), **kw)
    tr = ext.eigsh(tc, mesh=tmesh(), **kw)
    np.testing.assert_allclose(tr.eigenvalues, np.asarray(jr.eigenvalues), atol=EIG_TOL)
    np.testing.assert_allclose(tr.eigenvalues, np.linalg.eigvalsh(A)[:3], atol=EIG_TOL)
    assert tr.eigenvectors.shape == (A.shape[0], 3)


def test_eigsh_mesh_2axis_and_lm():
    A = banded(seed=1)
    jc, tc = coo_pair(A)
    kw = dict(k=2, which="LM", tol=1e-12, max_subspace=40)
    jr = japi.eigsh(jc, mesh=jmesh(8, (2, 4), ("rows", "cols")), **kw)
    tr = ext.eigsh(tc, mesh=tmesh(8, (2, 4), ("rows", "cols")), **kw)
    np.testing.assert_allclose(tr.eigenvalues, np.asarray(jr.eigenvalues), atol=EIG_TOL)


@pytest.mark.parametrize("two_axis", [False, True], ids=["1axis", "2axis"])
def test_eigsh_sigma_mesh(two_axis):
    A = banded(n=48, seed=2)
    jc, tc = coo_pair(A)
    ev = np.linalg.eigvalsh(A)
    sigma = float(ev[0] - 0.3)
    kw = dict(k=2, sigma=sigma, tol=1e-12, inner_tol=1e-13)
    if two_axis:
        jm, tm = jmesh(4, (2, 2), ("rows", "cols")), tmesh(4, (2, 2), ("rows", "cols"))
    else:
        jm, tm = jmesh(), tmesh()
    jr = japi.eigsh(jc, mesh=jm, **kw)
    tr = ext.eigsh(tc, mesh=tm, **kw)
    np.testing.assert_allclose(tr.eigenvalues, np.asarray(jr.eigenvalues), atol=1e-9)
    np.testing.assert_allclose(tr.eigenvalues, ev[:2], atol=1e-9)
    assert tr.converged == jr.converged
    assert tr.termination != "inner_solve_failure"


def test_eigsh_mesh_rejections_match():
    A = banded(n=32)
    jc, tc = coo_pair(A)
    for kw in (dict(v0=np.ones(32)), dict(M=np.eye(32))):
        with pytest.raises(Exception) as ej:
            japi.eigsh(jc, k=2, mesh=jmesh(), **kw)
        with pytest.raises(EigenexError) as et:
            ext.eigsh(tc, k=2, mesh=tmesh(), **kw)
        assert str(et.value) == str(ej.value)
    with pytest.raises(EigenexError, match="sparse operand"):
        ext.eigsh(torch.as_tensor(A), k=2, mesh=tmesh())


def config5b_triplets():
    rng = np.random.default_rng(53)
    n, bw = 1200, 64
    r = np.repeat(np.arange(n), 4)
    c = r + rng.integers(1, bw, size=len(r))
    keep = c < n
    r, c = r[keep], c[keep]
    v = np.round(rng.standard_normal(len(r)) * 8) / 8
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 4.0)])
    shuf = rng.permutation(n)
    return (shuf[rows], shuf[cols], vals, (n, n))


def test_config5b_accelerate_mesh_composition():
    """BASELINE config 5b at its CI size: the RCM + half-storage pack
    row-partitioned over an 8-shard mesh in one call (the sym_halo ring),
    to 1e-9 against eigvalsh, and against the reference's mesh result."""
    trip = config5b_triplets()
    n = trip[3][0]
    acc = ext.accelerate(trip, block=8, dtype=np.float64, device="cpu")
    res = ext.eigsh(acc, k=3, which="SA", tol=1e-10, mesh=tmesh(8))
    dense = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=(n, n)).toarray()
    ev = np.sort(np.linalg.eigvalsh(dense))
    err = np.abs(np.asarray(res.eigenvalues) - ev[:3]).max()
    assert err <= 1e-9 * max(np.abs(ev).max(), 1.0), f"composition error {err:.2e}"
    V = np.asarray(res.eigenvectors)
    assert V.shape == (n, 3)
    assert np.abs(dense @ V - V * res.eigenvalues).max() < 1e-6


def test_config5a_distributed_halo_shift_invert():
    """BASELINE config 5a at its CI size: n = 512 Laplacian, halo mode, 32
    shift-invert Lanczos steps with a CG inner solve to 1e-13, to 1e-9 against
    the closed form.  On the CPU every inner CG iteration is four
    collectives, each a turn of every shard thread, so the mesh has 2 shards;
    the 8-shard form runs on the card (``chip_smoke.py --phases config5``)."""
    from eigenex_tpu_torch.parallel.distributed import distributed_lanczos_steps, pad_bsr_for_mesh
    from eigenex_tpu_torch.solvers.lanczos import init_lanczos_state, tridiagonal_eigh

    n = 512
    r = np.arange(n)
    rows = np.concatenate([r, r[:-1], r[1:]])
    cols = np.concatenate([r, r[1:], r[:-1]])
    vals = np.concatenate([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    bsr = pad_bsr_for_mesh(t_bsr(rows, cols, vals, (n, n), (4, 4), device="cpu"), 8)
    sigma = -1e-4
    state = init_lanczos_state(bsr.as_linear_operator(), 32, seed=0)
    state = distributed_lanczos_steps(bsr, state, 32, tmesh(2), matvec_mode="halo",
                                      shift_invert_sigma=sigma, cg_tol=1e-13, cg_max_iters=3000)
    k = int(state.k)
    theta = tridiagonal_eigh(state.alpha[:k].numpy(), state.beta[:k].numpy(), eigvals_only=True)
    lam_min = sigma + 1.0 / theta[-1]
    exact = 2 - 2 * np.cos(np.pi / (n + 1))
    assert abs(lam_min - exact) <= 1e-9


def conj_free(lam):
    """Eigenvalues sorted with conjugate pairs made equal: a pair ties in
    |lambda|, so which member a solver returns is not fixed."""
    lam = np.asarray(lam, np.complex128)
    lam = lam.real + 1j * np.abs(lam.imag)
    return lam[np.lexsort((lam.imag, np.round(lam.real, 8)))]


def general(n=80, seed=4):
    rng = np.random.default_rng(seed)
    A = np.round(rng.standard_normal((n, n)) * 4) / 8
    A = np.triu(np.tril(A, 3), -3) + np.diag(np.linspace(1, 5, n))
    return A


@pytest.mark.parametrize("mode", ["allgather", "colsplit"])
def test_eigs_mesh_modes(mode):
    A = general()
    jc, tc = coo_pair(A)
    kw = dict(k=3, which="LM", tol=1e-12, matvec_mode=mode)
    jr = japi.eigs(jc, mesh=jmesh(), **kw)
    tr = ext.eigs(tc, mesh=tmesh(), **kw)
    np.testing.assert_allclose(conj_free(tr.eigenvalues), conj_free(jr.eigenvalues),
                               atol=EIG_TOL)


def test_eigs_2axis_matches_reference_single_device():
    """The port's eigs on a 2x4 mesh against the reference's SINGLE-device
    eigs (the reference's own 2-axis test of this is red)."""
    A = general(seed=5)
    jc, tc = coo_pair(A)
    kw = dict(k=3, which="LM", tol=1e-12)
    jr = japi.eigs(jc, **kw)
    tr = ext.eigs(tc, mesh=tmesh(8, (2, 4), ("rows", "cols")), **kw)
    np.testing.assert_allclose(conj_free(tr.eigenvalues), conj_free(jr.eigenvalues),
                               atol=EIG_TOL)


def test_eigs_sigma_mesh():
    A = general(n=48, seed=6)
    jc, tc = coo_pair(A)
    kw = dict(k=2, sigma=2.0, tol=1e-12, inner_tol=1e-13)
    jr = japi.eigs(jc, mesh=jmesh(2), **kw)
    tr = ext.eigs(tc, mesh=tmesh(2), **kw)
    np.testing.assert_allclose(conj_free(tr.eigenvalues), conj_free(jr.eigenvalues), atol=1e-9)
    assert tr.converged


def test_svds_mesh():
    rng = np.random.default_rng(7)
    A = np.round(rng.standard_normal((72, 40)) * 8) / 8 * (rng.random((72, 40)) < 0.2)
    jc, tc = coo_pair(A)
    js = japi.svds(jc, k=3, tol=1e-12, mesh=jmesh(8, (2, 4), ("rows", "cols")),
                   return_singular_vectors=False)
    U, s, Vh = ext.svds(tc, k=3, tol=1e-12, mesh=tmesh(8, (2, 4), ("rows", "cols")))
    np.testing.assert_allclose(s, np.asarray(js), atol=EIG_TOL)
    np.testing.assert_allclose(s, np.linalg.svd(A, compute_uv=False)[:3], atol=EIG_TOL)
    assert U.shape == (72, 3) and Vh.shape == (3, 40)
    np.testing.assert_allclose((A @ Vh.T.numpy()), U.numpy() * s, atol=1e-8)


def test_svds_accelerated_mesh():
    rng = np.random.default_rng(8)
    m, n = 160, 96
    r = rng.integers(0, m, 700)
    c = np.clip(r * n // m + rng.integers(-4, 5, 700), 0, n - 1)
    v = np.round(rng.standard_normal(700) * 8) / 8
    trip = (r, c, v, (m, n))
    dense = sp.coo_matrix((v, (r, c)), shape=(m, n)).toarray()
    acc = ext.accelerate(trip, dtype=np.float64, device="cpu")
    U, s, Vh = ext.svds(acc, k=3, tol=1e-12, mesh=tmesh(2))
    # the pack holds f32-rounded values: hold to the rounded operator
    ref = np.linalg.svd(dense.astype(np.float32).astype(np.float64), compute_uv=False)[:3]
    np.testing.assert_allclose(s, ref, atol=EIG_TOL)
    np.testing.assert_allclose(s, ext.svds(acc, k=3, tol=1e-12, return_singular_vectors=False),
                               atol=EIG_TOL)
    assert U.shape == (m, 3) and Vh.shape == (3, n)


def window_operands(seed=9):
    A = banded(n=96, seed=seed)
    r, c = np.nonzero(A)
    return A, j_bsr(r, c, A[r, c], A.shape, (4, 4)), t_bsr(r, c, A[r, c], A.shape, (4, 4),
                                                           device="cpu")


@pytest.mark.parametrize("mode", ["allgather", "sym_halo"])
def test_eigsh_window_mesh(mode):
    A, jb, tb = window_operands()
    ev = np.linalg.eigvalsh(A)
    win = (float(ev[0] - 0.5), float((ev[3] + ev[4]) / 2))
    kw = dict(block_size=8, degree=30, tol=1e-10, max_iterations=80, matvec_mode=mode)
    jr = japi.__dict__.get("eigsh_window") or __import__(
        "eigenex_tpu.solvers.chebyshev", fromlist=["eigsh_window"]).eigsh_window
    jres = jr(jb, win, mesh=jmesh(2), **kw)
    tres = ext.eigsh_window(tb, win, mesh=tmesh(2), **kw)
    assert jres.converged and tres.converged
    np.testing.assert_allclose(tres.eigenvalues, np.asarray(jres.eigenvalues), atol=1e-9)
    np.testing.assert_allclose(tres.eigenvalues, ev[:4], atol=1e-9)


def test_eigsh_range_and_moments_mesh():
    from eigenex_tpu.solvers.kpm import eigsh_range as j_range

    A, jb, tb = window_operands(seed=10)
    ev = np.linalg.eigvalsh(A)
    iv = (float(ev[0] - 0.5), float((ev[4] + ev[5]) / 2))
    kw = dict(block_size=10, slack=3, degree=30, tol=1e-10, n_moments=60, max_iterations=80)
    jres = j_range(jb, iv, mesh=jmesh(2), **kw)
    tres = ext.eigsh_range(tb, iv, mesh=tmesh(2), **kw)
    np.testing.assert_allclose(tres.eigenvalues, np.asarray(jres.eigenvalues), atol=1e-9)
    np.testing.assert_allclose(tres.eigenvalues, ev[:5], atol=1e-9)
    # the moments over the mesh equal the single-device ones (same probes)
    mu_mesh, b_mesh = ext.chebyshev_moments(tb, 40, mesh=tmesh(2), spectral_bounds=(-10, 10))
    mu_one, b_one = ext.chebyshev_moments(tb, 40, spectral_bounds=(-10, 10))
    assert b_mesh == b_one
    np.testing.assert_allclose(mu_mesh, mu_one, atol=1e-12)


def test_load_state_mesh_and_shard_state(tmp_path):
    from eigenex_tpu.utils.checkpoint import load_state as j_load
    from eigenex_tpu.utils.checkpoint import save_state as j_save
    from eigenex_tpu.solvers.lanczos import init_lanczos_state as j_init
    from eigenex_tpu.solvers.lanczos import lanczos_steps as j_steps

    A = banded(n=64, seed=11)
    jop = j_coo_from_dense(A).as_linear_operator()
    js = j_steps(jop, j_init(jop, 12, v0=jnp.asarray(np.ones(64))), 8)
    p = str(tmp_path / "state.npz")
    j_save(p, js)
    jm = jmesh(8)
    ref = j_load(p, mesh=jm)
    got = ext.load_state(p, mesh=tmesh(8))
    assert isinstance(got.V, Sharded) and len(got.V.pieces) == 8
    shard_shapes = [s.data.shape for s in ref.V.addressable_shards]
    assert [tuple(p.shape) for p in got.V.pieces] == [tuple(s) for s in shard_shapes]
    np.testing.assert_array_equal(got.V.gather().numpy(), np.asarray(ref.V))
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))
    assert int(got.k) == int(ref.k)
    # the placed state resumes on the mesh and equals a single-device resume
    from eigenex_tpu_torch.parallel.distributed import distributed_lanczos_steps
    from eigenex_tpu_torch.solvers.lanczos import lanczos_steps

    bsr = ext.bsr_from_dense(A, (4, 4), device="cpu")
    resumed = distributed_lanczos_steps(bsr, got, 4, tmesh(8), matvec_mode="halo")
    single = lanczos_steps(bsr.as_linear_operator(), ext.load_state(p, device="cpu"), 4)
    np.testing.assert_allclose(resumed.alpha.numpy(), single.alpha.numpy(), atol=1e-12)
    # a sharded state saves back to the reference's format
    p2 = str(tmp_path / "again.npz")
    ext.save_state(p2, resumed)
    np.testing.assert_allclose(np.asarray(j_load(p2).V), single.V.numpy(), atol=1e-12)
    with pytest.raises(EigenexError, match="not divisible"):
        ext.shard_state(ext.load_state(p, device="cpu"), tmesh(3))
