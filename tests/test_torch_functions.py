"""f(A)v and exp(xA)v of the port against the JAX package's
``eigenex_tpu/solvers/functions.py``, f64 on the CPU, on the same
numpy-seeded Hermitian matrix and vector (the cases of
``tests/test_functions.py``, with the reference's output as the oracle
beside the dense eigendecomposition).

Tolerances: 1e-10 relative against the reference (the Lanczos routes run
the same recurrence from the same start vector; the Taylor routes sum the
same terms); against the dense oracle the reference's own tolerances.
The Taylor loop reads its stop test on the host every ``CHECK_EVERY``
terms and masks the terms past it: the number of terms summed must equal
the reference's, counted there with a callback in the operator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.solvers.functions as jfn
from eigenex_tpu.core.operators import LinearOperator as JLinearOperator
from eigenex_tpu.sparse import COOBuilder as JCOOBuilder
from eigenex_tpu_torch import (
    COOBuilder,
    LanczosExponentialSolver,
    LanczosFunctionSolver,
    LinearOperator,
    dense_expmv,
    expm_multiply,
    lanczos_expmv,
    lanczos_function_apply,
    taylor_expmv,
    taylor_expmv_auto,
)
from eigenex_tpu_torch.solvers.cg import CHECK_EVERY
from eigenex_tpu_torch.solvers.functions import _taylor
from eigenex_tpu_torch.utils.exceptions import LanczosError

torch.set_num_threads(1)
N = 30


def close(x, ref, rel=1e-10):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ref = np.asarray(ref)
    assert x.shape == ref.shape
    assert np.linalg.norm(x - ref) <= rel * np.linalg.norm(ref), np.linalg.norm(x - ref)


def expm_oracle(A, v, x):
    w, U = np.linalg.eigh(A)
    return U @ (np.exp(x * w) * (U.conj().T @ v))


@pytest.fixture
def problem():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((N, N))
    return (a + a.T) / 2, rng.standard_normal(N)


def t(a):
    return torch.as_tensor(a)


def ref_terms(A, v, x, tol, max_terms=256):
    """Terms the reference's Taylor loop sums: its body applies the operator
    once a term (twice for a complex x on a real operator)."""
    calls = []

    def mv(m, z):
        jax.debug.callback(lambda: calls.append(1))
        return m @ z

    op = JLinearOperator(mv, jnp.asarray(A), A.shape, jnp.float64)
    out = jfn.taylor_expmv(op, jnp.asarray(v), x, tol=tol, max_terms=max_terms)
    jax.block_until_ready(out)
    return np.asarray(out), len(calls) // (2 if np.iscomplexobj(x) else 1)


class TestFunctionApply:
    def test_identity_function(self, problem):
        A, v = problem
        out = lanczos_function_apply(t(A), t(v), lambda th: th, num_steps=30)
        close(out, jfn.lanczos_function_apply(jnp.asarray(A), jnp.asarray(v), lambda th: th,
                                              num_steps=30))
        np.testing.assert_allclose(out.numpy(), A @ v, atol=1e-9)

    def test_inverse_function(self, problem):
        A, v = problem
        A = A + 10.0 * np.eye(N)
        out = lanczos_function_apply(t(A), t(v), lambda th: 1.0 / th, num_steps=30)
        close(out, jfn.lanczos_function_apply(jnp.asarray(A), jnp.asarray(v),
                                              lambda th: 1.0 / th, num_steps=30))
        np.testing.assert_allclose(out.numpy(), np.linalg.solve(A, v), atol=1e-8)

    def test_complex_function(self, problem):
        A, v = problem
        f = lambda th: np.exp(1j * th)  # noqa: E731
        out = lanczos_function_apply(t(A), t(v), f, num_steps=30)
        assert out.dtype == torch.complex128
        close(out, jfn.lanczos_function_apply(jnp.asarray(A), jnp.asarray(v), f, num_steps=30))
        np.testing.assert_allclose(out.numpy(), expm_oracle(A, v, 1j), atol=1e-8)

    def test_class_api(self, problem):
        A, v = problem
        out = LanczosFunctionSolver(t(A), num_steps=30).solve(lambda th: th**2, t(v))
        np.testing.assert_allclose(out.numpy(), A @ (A @ v), atol=1e-8)


class TestExpmv:
    @pytest.mark.parametrize("x", [1.0, -0.5])
    def test_lanczos_expmv(self, problem, x):
        A, v = problem
        out = lanczos_expmv(t(A), t(v), x, num_steps=30)
        close(out, jfn.lanczos_expmv(jnp.asarray(A), jnp.asarray(v), x, num_steps=30))
        np.testing.assert_allclose(out.numpy(), expm_oracle(A, v, x), atol=1e-8)

    def test_dense_expmv(self, problem):
        A, v = problem
        out = dense_expmv(t(A), t(v), 0.7)
        close(out, jfn.dense_expmv(jnp.asarray(A), jnp.asarray(v), 0.7))
        np.testing.assert_allclose(out.numpy(), expm_oracle(A, v, 0.7), atol=1e-9)

    @pytest.mark.parametrize("x,tol", [(0.3, 1e-14), (0.3, 1e-6), (-1.1, 1e-12), (0.5j, 1e-14)],
                             ids=["0.3", "0.3_loose", "-1.1", "0.5j"])
    def test_taylor_terms_and_sum_match_reference(self, problem, x, tol):
        A, v = problem
        ref, terms = ref_terms(A, v, x, tol)
        out, k = _taylor(t(A), t(v), x, tol, 256)
        assert int(k) == terms
        close(out, ref)
        np.testing.assert_allclose(taylor_expmv(t(A), t(v), x, tol=tol).numpy(), out.numpy(),
                                   atol=0)

    def test_masked_terms_do_not_enter_the_sum(self, problem):
        """The stop falls between two host reads: the terms computed past it
        are discarded, so the sum is the reference's although the operator
        was applied up to CHECK_EVERY - 1 more times."""
        A, v = problem
        applied = []

        def mv(m, z):
            applied.append(1)
            return m @ z

        op = LinearOperator(mv, t(A), A.shape, torch.float64, "cpu")
        ref, terms = ref_terms(A, v, 0.3, 1e-14)
        assert terms % CHECK_EVERY  # the stop is not on a read
        out, k = _taylor(op, t(v), 0.3, 1e-14, 256)
        assert int(k) == terms and terms < len(applied) < terms + CHECK_EVERY
        close(out, ref)

    def test_max_terms_caps_the_sum(self, problem):
        A, v = problem
        ref, terms = ref_terms(A, v, 0.3, 0.0, max_terms=5)
        out, k = _taylor(t(A), t(v), 0.3, 0.0, 5)
        assert int(k) == terms == 5
        close(out, ref)

    def test_taylor_auto_division(self, problem):
        A, v = problem
        out = taylor_expmv_auto(t(A), t(v), -2.0, tol=1e-14)
        close(out, jfn.taylor_expmv_auto(jnp.asarray(A), jnp.asarray(v), -2.0, tol=1e-14))
        np.testing.assert_allclose(out.numpy(), expm_oracle(A, v, -2.0), atol=1e-7)

    def test_imaginary_time_evolution(self, problem):
        """exp(i x A) v (complex x over real A): norm conserved."""
        A, v = problem
        out = taylor_expmv(t(A), t(v), 0.5j, tol=1e-14)
        assert out.dtype == torch.complex128
        np.testing.assert_allclose(out.numpy(), expm_oracle(A, v, 0.5j), atol=1e-9)
        np.testing.assert_allclose(np.linalg.norm(out.numpy()), np.linalg.norm(v), atol=1e-10)

    def test_dispatcher_and_class_api(self, problem):
        A, v = problem
        ref = expm_oracle(A, v, 0.25)
        At, vt = t(A), t(v)
        for method, kw in (("lanczos", dict(num_steps=30)), ("taylor", dict(tol=1e-14)),
                           ("taylor_auto", dict(tol=1e-14)), ("dense", {})):
            out = expm_multiply(At, vt, 0.25, method=method, **kw)
            close(out, jfn.expm_multiply(jnp.asarray(A), jnp.asarray(v), 0.25, method=method, **kw))
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-8)
        op = LinearOperator(lambda m, z: m @ z, At, A.shape, torch.float64, "cpu")
        np.testing.assert_allclose(expm_multiply(op, vt, 0.25, method="dense").numpy(), ref,
                                   atol=1e-9)
        sol = LanczosExponentialSolver(At, num_steps=30)
        np.testing.assert_allclose(sol.solve_with_eigens(vt, 0.25).numpy(), ref, atol=1e-9)
        np.testing.assert_allclose(sol.solve_with_lanczos(vt, 0.25).numpy(), ref, atol=1e-8)
        np.testing.assert_allclose(sol.solve_with_taylor_no_division(vt, 0.25, tol=1e-14).numpy(),
                                   ref, atol=1e-8)
        np.testing.assert_allclose(
            sol.solve_with_taylor_auto_division(vt, 0.25, tol=1e-14).numpy(), ref, atol=1e-8)
        with pytest.raises(LanczosError):
            expm_multiply(At, vt, 0.25, method="pade")

    def test_sparse_operator_gershgorin_bound_path(self):
        """taylor_expmv_auto takes its division from the COO container's
        Gershgorin range, found as the operator's params as in the reference:
        same sub-steps, same result."""
        n = 40
        jb, b = JCOOBuilder(n, n, np.float64), COOBuilder(n, n, np.float64)
        for i in range(n):
            for bb in (jb, b):
                bb.append(i, i, 2.0)
                if i + 1 < n:
                    bb.append(i, i + 1, -1.0)
                    bb.append(i + 1, i, -1.0)
        coo = b.build(device="cpu")
        lo, hi = coo.estimate_eigenvalue_range()
        assert (float(lo), float(hi)) == (0.0, 4.0)
        v = np.zeros(n)
        v[0] = 1.0
        out = taylor_expmv_auto(coo.as_linear_operator(), t(v), -3.0, tol=1e-14)
        ref = jfn.taylor_expmv_auto(jb.build().as_linear_operator(), jnp.asarray(v), -3.0,
                                    tol=1e-14)
        close(out, ref)
        np.testing.assert_allclose(out.numpy(), expm_oracle(coo.to_dense(), v, -3.0),
                                   atol=1e-8)
