"""Orthogonalisation parity: the port's CGS2 primitives against the JAX
package on the same numpy-seeded inputs, in f64 (and complex128).

Tolerance: 1e-13 relative -- the same products in another summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.ops import orthogonalize as jo
from eigenex_tpu_torch.ops import orthogonalize as to

torch.set_num_threads(1)

TOL = 1e-13


def inputs(k, n, complex_, seed):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((k, n))
    v = rng.standard_normal(n)
    if complex_:
        V = V + 1j * rng.standard_normal((k, n))
        v = v + 1j * rng.standard_normal(n)
    Q = np.linalg.qr(V.T)[0].T  # orthonormal rows, like a Krylov basis
    return Q, v


def close(a, b, tol=TOL):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b), 1.0)


@pytest.mark.parametrize("complex_", [False, True])
def test_norm_matches_reference(complex_):
    _, v = inputs(2, 40, complex_, 0)
    got = to.norm_psum(torch.as_tensor(v))
    assert got.ndim == 0 and not got.is_complex()
    assert abs(float(got) - float(jo.norm_psum(jnp.asarray(v)))) <= TOL * np.linalg.norm(v)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_projections_match_reference(complex_, masked):
    Q, v = inputs(6, 50, complex_, 1)
    mask = np.arange(6) <= 3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    tQ, tv = torch.as_tensor(Q), torch.as_tensor(v)
    close(to.project_coefficients(tQ, tv, tm), jo.project_coefficients(jnp.asarray(Q), jnp.asarray(v), mask=jm))
    close(to.project_out(tQ, tv, tm), jo.project_out(jnp.asarray(Q), jnp.asarray(v), mask=jm))
    w, c = to.cgs2(tQ, tv, tm)
    w_ref, c_ref = jo.cgs2(jnp.asarray(Q), jnp.asarray(v), mask=jm)
    close(w, w_ref)
    close(c, c_ref)
    rows = Q if mask is None else Q[mask]
    assert np.abs(rows.conj() @ w.numpy()).max() <= 1e-14 * np.linalg.norm(v)
    if masked:  # masked-out rows get exactly zero coefficients
        assert np.all(c.numpy()[~mask] == 0)


def test_mask_selects_and_keeps_nan_rows_out_of_the_coefficients():
    Q, v = inputs(4, 20, False, 2)
    Q[3] = np.nan  # a stale row beyond the mask
    c = to.project_coefficients(torch.as_tensor(Q), torch.as_tensor(v),
                                torch.as_tensor(np.arange(4) <= 2))
    assert torch.isfinite(c).all() and float(c[3]) == 0.0


@pytest.mark.parametrize("complex_", [False, True])
def test_gram_schmidt_matches_reference(complex_):
    rng = np.random.default_rng(3)
    V = rng.standard_normal((5, 30))
    if complex_:
        V = V + 1j * rng.standard_normal((5, 30))
    got = to.gram_schmidt(torch.as_tensor(V))
    close(got, jo.gram_schmidt(jnp.asarray(V)), 1e-12)
    G = got.numpy() @ got.numpy().conj().T
    assert np.abs(G - np.eye(5)).max() <= 1e-13


@pytest.mark.parametrize("complex_", [False, True])
def test_orthogonal_complement_matches_reference(complex_):
    """The complement is unique only as a space: its projector equals the
    reference's to 1e-13, and every diagnostic of the debug twin stays at
    rounding level in both packages."""
    V, _ = inputs(3, 9, complex_, 4)
    V = V * np.arange(1, 4)[:, None]  # not orthonormal rows
    R = to.orthogonal_complement(torch.as_tensor(V)).numpy()
    Rj = np.asarray(jo.orthogonal_complement(jnp.asarray(V)))
    assert R.shape == Rj.shape == (6, 9)
    P, Pj = R.conj().T @ R, Rj.conj().T @ Rj
    assert np.linalg.norm(P - Pj) <= TOL * np.linalg.norm(Pj)
    R2, diag = to.orthogonal_complement_debug(torch.as_tensor(V))
    _, jdiag = jo.orthogonal_complement_debug(jnp.asarray(V))
    np.testing.assert_array_equal(R2.numpy(), R)
    assert diag.keys() == jdiag.keys()
    for k in diag:
        assert float(diag[k]) <= 1e-13 and float(jdiag[k]) <= 1e-13
    Q = to.orthonormal_columns(torch.as_tensor(V.T)).numpy()
    Qj = np.asarray(jo.orthonormal_columns(jnp.asarray(V.T)))
    assert np.linalg.norm(Q @ Q.conj().T - Qj @ Qj.conj().T) <= TOL * 3


def test_complement_of_host_data_runs_on_the_card():
    """Entry points run on the card unless told otherwise: numpy input with
    no device is factored on CUDA, or raises where there is none -- never
    quietly on the CPU.  ``device="cpu"`` keeps it on the host."""
    V, _ = inputs(2, 5, False, 5)
    for call in (lambda **kw: to.orthogonal_complement(V, **kw),
                 lambda **kw: to.orthonormal_columns(V.T, **kw),
                 lambda **kw: to.orthogonal_complement_debug(V, **kw)[0]):
        assert call(device="cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
