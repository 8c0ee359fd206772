"""The general path as a whole: ``eigs`` (and the ``eigsh`` routes this slice
adds: ``sigma=``, ``which="SM"``, ``refine=``, complex Hermitian
``accelerate=``) of the port against the JAX package, f64 on the CPU, on
the same numpy-seeded operands with the same explicit start vector (mirrors
the ``eigs`` cases of ``tests/test_api.py`` and config 2 of
``tests/test_baseline_configs.py``; the accelerated routes are in
``tests/test_torch_accelerate.py``).

Tolerances: eigenvalues 1e-10 against the reference (conjugation-insensitive
where a conjugate pair ties under ``which``); 1e-6 against
``numpy.linalg.eig`` as the reference's own tests; refined pairs 1e-11;
config 2 by backward error <= 1e-10 (its forward eigenvalues are ill-posed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg)
import torch

from eigenex_tpu.solvers.api import eigs as j_eigs
from eigenex_tpu.solvers.api import eigsh as j_eigsh
from eigenex_tpu.sparse.coo import coo_from_dense as j_coo
import eigenex_tpu_torch as ext
from eigenex_tpu_torch.solvers.api import _check_true_residuals
from eigenex_tpu_torch.solvers.krylov_schur import _which_key
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)


def canon(v):
    v = np.asarray(v)
    return np.sort_complex(np.where(v.imag < 0, np.conj(v), v))


def gaussian(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if complex_:
        A = A + 1j * rng.standard_normal((n, n))
    return A, rng.standard_normal(n)


def convection_diffusion(nx, conv=0.4):
    """The upwind convection-diffusion stencil of BASELINE config 2
    (``benchmarks/bench_arnoldi.py``), as scipy CSR."""
    n = nx * nx
    i = np.arange(nx)
    jj, ii = np.meshgrid(i, i)
    u = (ii * nx + jj).ravel()
    rows, cols, vals = [u], [u], [np.full(n, 4.0)]
    for mask, off, val in ((ii > 0, -nx, -1.0 - conv), (ii < nx - 1, nx, -1.0 + conv),
                           (jj > 0, -1, -1.0 - conv), (jj < nx - 1, 1, -1.0 + conv)):
        uu = u[mask.ravel()]
        rows.append(uu)
        cols.append(uu + off)
        vals.append(np.full(len(uu), val))
    r, c, v = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    return sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()


@pytest.mark.parametrize("which", ["LM", "SM", "LR", "SR", "LI", "SI"])
def test_eigs_which_modes_match_reference(which):
    n = 60
    A, v0 = gaussian(n, 0, complex_=True)
    m = n if which == "SM" else 40  # SM without shift-invert: the full subspace
    kw = dict(k=3, which=which, tol=1e-10, max_subspace=m, max_restarts=400)
    rj = j_eigs(jnp.asarray(A), v0=jnp.asarray(v0.astype(complex)), **kw)
    rt = ext.eigs(torch.as_tensor(A), v0=v0.astype(complex), device="cpu", **kw)
    assert rt.converged
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    lam_all = np.linalg.eigvals(A)
    want = lam_all[np.argsort(_which_key(lam_all, which), kind="stable")][:3]
    np.testing.assert_allclose(np.sort_complex(rt.eigenvalues), np.sort_complex(want), atol=1e-6)
    keys = _which_key(rt.eigenvalues, which)
    assert keys[0] <= keys[-1] + 1e-9  # the most-wanted pair first


def test_eigs_real_operator_and_residuals():
    A, v0 = gaussian(70, 1)
    rj = j_eigs(jnp.asarray(A), k=2, tol=1e-9, max_subspace=40, v0=jnp.asarray(v0))
    rt = ext.eigs(ext.coo_from_dense(A, device="cpu"), k=2, tol=1e-9, max_subspace=40, v0=v0)
    np.testing.assert_allclose(canon(rt.eigenvalues), canon(rj.eigenvalues), atol=1e-10)
    assert np.all(rt.residual_norms(torch.as_tensor(A)) < 1e-6)


@pytest.mark.parametrize("case", ["real_sigma", "complex_sigma_cgls"])
def test_eigs_sigma_matches_reference(case):
    if case == "real_sigma":
        A, v0 = gaussian(60, 2)
        sigma, kw = 0.5, dict(k=2, tol=1e-10, max_subspace=30)
    else:  # GMRES(48) stagnates here; the CGLS fallback must deliver
        rng = np.random.default_rng(0)
        A = rng.standard_normal((60, 60)) + 1j * rng.standard_normal((60, 60))
        v0 = rng.standard_normal(60).astype(complex)
        sigma, kw = 0.5 + 0.2j, dict(k=2, tol=1e-10, max_subspace=30)
    rj = j_eigs(jnp.asarray(A), sigma=sigma, v0=jnp.asarray(v0), **kw)
    rt = ext.eigs(torch.as_tensor(A), sigma=sigma, v0=v0, device="cpu", **kw)
    assert rt.converged and rt.termination != "inner_solve_failure"
    np.testing.assert_allclose(canon(rt.eigenvalues), canon(rj.eigenvalues), atol=1e-10)
    d = np.sort(np.abs(rt.eigenvalues - sigma))
    np.testing.assert_allclose(d, np.sort(np.abs(np.linalg.eigvals(A) - sigma))[:2], atol=1e-7)
    st = rt.inner_stats
    assert st["applications"] >= rt.iterations and st["matvecs"] > st["applications"]
    assert st["fallbacks"] > 0 or case == "real_sigma"


def test_eigs_refine_hits_1e11():
    rng = np.random.default_rng(2)
    A = np.diag(np.arange(1.0, 51.0)) + 0.1 * rng.standard_normal((50, 50))
    v0 = rng.standard_normal(50)
    rj = j_eigs(j_coo(A), k=2, tol=1e-8, refine=True, v0=jnp.asarray(v0))
    rt = ext.eigs(ext.coo_from_dense(A, device="cpu"), k=2, tol=1e-8, refine=True, v0=v0)
    true = np.linalg.eigvals(A)
    true = true[np.argsort(-np.abs(true))][:2]
    np.testing.assert_allclose(np.sort_complex(rt.eigenvalues), np.sort_complex(true), atol=1e-11)
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)


def test_config2_convection_diffusion_backward_error():
    """BASELINE config 2 at nx = 20: the port's own solve + refine, certified
    by the backward error (the reference's criterion), and each value near
    the dominant edge of the closed-form spectrum."""
    nx = 20
    A = convection_diffusion(nx).tocoo()
    coo = ext.COOMatrix(torch.as_tensor(A.row.astype(np.int32)),
                        torch.as_tensor(A.col.astype(np.int32)), torch.as_tensor(A.data), A.shape)
    v0 = np.random.default_rng(9).standard_normal(nx * nx)
    res = ext.eigs(coo, k=3, tol=1e-9, max_subspace=80, max_restarts=200, refine=True, v0=v0)
    got = np.asarray(res.eigenvalues)[:3]
    lam_check, resid = ext.general_rayleigh_refine(coo, res.eigenvectors)
    scale = float(np.max(np.abs(got)))
    assert float(np.max(resid)) / scale <= 1e-10
    np.testing.assert_allclose(lam_check, got, atol=1e-10 * scale)
    cgrid = np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    top = np.sort((4 + 2 * np.sqrt(1 - 0.4**2) * (cgrid[:, None] + cgrid[None, :])).ravel())[::-1][:10]
    assert all(np.min(np.abs(top - lam.real)) < 5e-2 for lam in got)


def eigenvalue_backward_error(A, lam, iters=8):
    """sigma_min(A - lam I) from above: 1 / ||(A - lam I)^-1|| by power
    iteration on the inverse's normal operator through a sparse LU."""
    M = (A - lam * sp.eye(A.shape[0])).tocsc().astype(np.complex128)
    lu = sp.linalg.splu(M)
    v = np.ones(A.shape[0], np.complex128) / np.sqrt(A.shape[0])
    norm = 0.0
    for _ in range(iters):
        w = lu.solve(v)
        v = lu.solve(w / np.linalg.norm(w), trans="H")
        norm = np.linalg.norm(v)
        v /= norm
    return 1.0 / norm


@pytest.mark.parametrize("package", ["port", "reference"])
def test_f32_eigs_meets_what_tol_certifies(package):
    """The operand and call of the card-only test
    ``test_torch_cuda.py::test_eigs_on_a_packed_general_operand_launches_once_a_matvec``
    (config 2 at nx = 40 on its f32 (32, 128) pack, ``eigs(k=2, tol=1e-5,
    seed=1)``), in both packages on the CPU.  The reference's ``tol`` bounds
    the residuals of the leading Schur vectors, |beta Q[k-1, i]| <= tol
    max|theta|, so their values are eigenvalues of A + E with ||E|| <=
    sqrt(k) tol max|theta|; its leading block holds the p wanted values in no
    set order, and on this operand its first k are other Ritz values than the
    k returned: the returned eigenvalues' backward error is held to that
    bound all the same, and their eigenvectors' residuals, tens of times
    larger, to none.  The port's stop test reads the Ritz estimates of the
    pairs it returns (``krylov_schur.py``), so there each returned
    eigenvector's residual is held to 2 tol |lambda| too (the estimate's
    bound tol max|theta|, and float32 rounding of the Arnoldi relation).  Each
    returned eigenvector is the Ritz vector of its eigenvalue, whose residual
    is orthogonal to the Krylov space and so to span(X) up to rounding; the
    Schur vectors in their place, or columns swapped, leave 22 times the limit
    or more there over seeds 0-39 (``tests/cpu_studies.py ks-ritz``)."""
    nx, k, tol = 40, 2, 1e-5
    A = convection_diffusion(nx)
    t = A.tocoo()
    trip = (t.row, t.col, t.data.astype(np.float32), t.shape)
    if package == "port":
        res = ext.eigs(trip, k=k, tol=tol, seed=1, accelerate=True, device="cpu")
    else:
        res = j_eigs(trip, k=k, tol=tol, seed=1, accelerate=True)
    assert res.converged
    lam = np.asarray(res.eigenvalues, np.complex128)
    X = np.asarray(res.eigenvectors)
    assert X.shape == (nx * nx, k) and np.isfinite(X).all()
    limit = np.sqrt(k) * tol * np.abs(lam).max()
    backward = max(eigenvalue_backward_error(A, lam_i) for lam_i in lam)
    vectors = np.max(np.linalg.norm(A @ X - X * lam[None, :], axis=0) / np.abs(lam))
    R = A @ X - X * lam[None, :]
    inside = np.linalg.norm(np.linalg.qr(X)[0].conj().T @ R, axis=0) / np.linalg.norm(X, axis=0)
    print(f"{package}: backward error {backward / np.abs(lam).max():.3e} of max|lambda| "
          f"(limit {limit / np.abs(lam).max():.3e}); eigenvector residual {vectors:.3e}, "
          f"in span(X) {inside.max() / limit:.3e} of the limit")
    assert backward <= limit
    assert inside.max() <= limit
    if package == "port":
        assert vectors <= 2 * tol


@pytest.mark.parametrize("route", ["sigma", "SM", "refine", "sigma_refine"])
def test_eigsh_routes_match_reference(route):
    rng = np.random.default_rng(11)
    n = 80
    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2
    A[np.abs(A) < 0.7] = 0
    v0 = rng.standard_normal(n)
    ref_ev = np.linalg.eigvalsh(A)
    kw = dict(k=3, tol=1e-10, max_subspace=40)
    if route == "sigma":
        kw["sigma"] = float(ref_ev[40] + 0.1 * (ref_ev[41] - ref_ev[40]))
    elif route == "SM":
        kw["which"] = "SM"
    elif route == "refine":
        kw.update(refine=True, tol=1e-6)
    else:
        kw.update(sigma=0.3, refine=3)
    rj = j_eigsh(j_coo(A), v0=jnp.asarray(v0), **kw)
    rt = ext.eigsh(ext.coo_from_dense(A, device="cpu"), v0=v0, **kw)
    np.testing.assert_allclose(rt.eigenvalues, np.asarray(rj.eigenvalues), rtol=0, atol=1e-10)
    target = kw.get("sigma", 0.0)
    if route == "refine":
        want = ref_ev[:3]
    else:
        want = np.sort(ref_ev[np.argsort(np.abs(ref_ev - target))[:3]])
    np.testing.assert_allclose(rt.eigenvalues, want, atol=1e-10)


def test_inner_tol_controls_outer_accuracy():
    n = 300
    A = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    target = 2 - 2 * np.cos(np.pi / (n + 1))
    kw = dict(k=1, sigma=-1e-3, tol=1e-12, max_subspace=30, device="cpu")
    loose = ext.eigsh(A, inner_tol=1e-2, **kw)
    tight = ext.eigsh(A, inner_tol=1e-13, **kw)
    err_loose = abs(loose.eigenvalues[0] - target)
    err_tight = abs(tight.eigenvalues[0] - target)
    assert err_tight <= 1e-10 and err_loose > 10 * err_tight


def test_true_residual_check_flags_garbage():
    A, _ = gaussian(40, 4)
    A = (A + A.T) / 2
    res = ext.eigsh(A, k=2, which="SA", tol=1e-12, device="cpu")
    assert res.converged
    res.eigenvectors = torch.as_tensor(np.random.default_rng(1).standard_normal((40, 2)))
    res = _check_true_residuals(res, ext.aslinearoperator(torch.as_tensor(A)), "unit test")
    assert not res.converged and res.termination == "inner_solve_failure"
    assert res.trace.has_error()


def test_eigs_rejections():
    A, _ = gaussian(8, 5)
    with pytest.raises(EigenexError, match="which"):
        ext.eigs(A, k=1, which="XY", device="cpu")
    with pytest.raises(EigenexError, match="square"):
        ext.eigs(np.ones((4, 5)), k=1, device="cpu")
    mesh = ext.make_mesh(devices=["cpu"] * 2)  # mesh= is ported for sparse operands
    with pytest.raises(EigenexError, match="mesh= requires a sparse operand"):
        ext.eigs(A, k=1, mesh=mesh, device="cpu")
    m = (sp.random(40, 40, density=0.1, random_state=4) + sp.eye(40)).tocoo()
    acc = ext.accelerate((m.row, m.col, m.data + 1j * m.data, m.shape), device="cpu")
    with pytest.raises(EigenexError, match="REAL sigma"):
        ext.eigs(acc, k=2, sigma=1.0 + 1.0j)
    with pytest.raises(EigenexError, match="COOMatrix"):
        ext.eigs(A, k=1, refine=True, device="cpu")
    with pytest.raises(EigenexError, match="mesh= requires a sparse operand"):
        ext.svds(A, k=1, mesh=mesh, device="cpu")
