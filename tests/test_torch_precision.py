"""Every solver of the port runs its f32 products at "highest" matmul
precision, whatever the caller set, and gives the caller's setting back.

The JAX package pins ``precision="highest"`` on its dense f32 products.  In
PyTorch those products follow ``torch.set_float32_matmul_precision``: under a
caller's "medium" (bf16-grade products on the CPU, TF32 or bf16 on the card)
an unpinned f32 ``eigsh`` returned eigenvalues off by ~2e-4 relative and
still reported convergence.  Here an operator records the precision it sees
inside its matvec while the caller has set "medium": it must read "highest"
inside ``eigsh``, ``eigs``, ``svds``, block Lanczos and ``expm_multiply``,
and "medium" must be back after each call, also after one that raised.

Accuracy: an exact f64 operator behind an f32 ``LinearOperator``; the error
of each f32 solve under the caller's "medium" must stay within 10x its error
under "highest" (unpinned, "medium" gave 2e-4 against 5e-8 for ``eigsh``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.linalg import eigvalsh_tridiagonal

import eigenex_tpu_torch as ext
from eigenex_tpu_torch import BlockLanczosEigenSolver, BlockLanczosOptions, LinearOperator
from eigenex_tpu_torch.utils.precision import highest_f32_matmul

torch.set_num_threads(1)


@pytest.fixture
def caller_precision():
    """Set the caller's precision for a test and put the process default back."""
    before = torch.get_float32_matmul_precision()

    def set_(p):
        torch.set_float32_matmul_precision(p)

    yield set_
    torch.set_float32_matmul_precision(before)


def recording(A, seen: list, dtype=torch.float32, fail=False):
    """An f64 matrix (dense or scipy sparse) applied exactly on the host,
    behind an operator of ``dtype``, that records the f32 matmul precision it
    runs under."""

    def mm(_, X):
        seen.append(torch.get_float32_matmul_precision())
        if fail:
            raise RuntimeError("operator failure")
        return torch.as_tensor(A @ X.to(torch.float64).numpy()).to(dtype)

    return LinearOperator(mm, None, A.shape, dtype, "cpu", rmatvec_fn=mm, matmat_fn=mm)


def banded(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    return sp.diags([e, d, e], [-1, 0, 1]).tocsr()


ENTRY_POINTS = {
    "eigsh": lambda op: ext.eigsh(op, k=2, which="LA", tol=1e-4, device="cpu"),
    "eigs": lambda op: ext.eigs(op, k=2, tol=1e-4, device="cpu"),
    "svds": lambda op: ext.svds(op, k=2, tol=1e-4, device="cpu"),
    "block_lanczos": lambda op: BlockLanczosEigenSolver(
        op, BlockLanczosOptions(block_size=2, max_subspace=40, max_eigenvalues=2)).compute(),
    "expm_multiply": lambda op: ext.expm_multiply(
        op, torch.ones(op.shape[1]), -0.1, method="taylor"),
    "expm_multiply_lanczos": lambda op: ext.expm_multiply(op, torch.ones(op.shape[1]), -0.1,
                                                         num_steps=10),
    "eigsh_window": lambda op: ext.eigsh_window(op, (1.0, 2.0), block_size=2, degree=8,
                                                max_iterations=1),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_solvers_run_at_highest_and_restore_the_callers_setting(caller_precision, entry):
    caller_precision("medium")
    A = banded(200)
    seen: list = []
    ENTRY_POINTS[entry](recording(A, seen))
    assert seen and set(seen) == {"highest"}
    assert torch.get_float32_matmul_precision() == "medium"


@pytest.mark.parametrize("entry", ["eigsh", "eigs", "svds", "block_lanczos", "expm_multiply"])
def test_the_callers_setting_comes_back_after_an_error(caller_precision, entry):
    caller_precision("high")
    seen: list = []
    with pytest.raises(RuntimeError, match="operator failure"):
        ENTRY_POINTS[entry](recording(banded(60), seen, fail=True))
    assert seen == ["highest"]
    assert torch.get_float32_matmul_precision() == "high"


def test_the_pin_nests():
    with highest_f32_matmul():
        with highest_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "highest"


def relative_error(got, want):
    return float(np.max(np.abs(np.sort(got) - np.sort(want))) / np.max(np.abs(want)))


def solve_errors(solve, want, caller_precision):
    errors = {}
    for p in ("highest", "medium"):
        caller_precision(p)
        errors[p] = relative_error(solve(), want)
    return errors


def test_eigsh_accuracy_under_medium(caller_precision):
    A = banded()
    want = eigvalsh_tridiagonal(A.diagonal(), A.diagonal(1))[-4:]
    op = recording(A, [])
    e = solve_errors(lambda: ext.eigsh(op, k=4, which="LA", tol=1e-6, device="cpu").eigenvalues,
                     want, caller_precision)
    assert e["highest"] <= 1e-6 and e["medium"] <= 10 * e["highest"], e


def test_eigs_accuracy_under_medium(caller_precision):
    A = np.random.default_rng(1).standard_normal((400, 400))
    w = np.linalg.eigvals(A)
    want = np.sort(np.abs(w))[-4:]
    op = recording(A, [])
    e = solve_errors(lambda: np.abs(ext.eigs(op, k=4, which="LM", tol=1e-6,
                                             device="cpu").eigenvalues), want, caller_precision)
    assert e["highest"] <= 1e-5 and e["medium"] <= 10 * e["highest"], e


def test_block_lanczos_accuracy_under_medium(caller_precision):
    A = banded()
    want = eigvalsh_tridiagonal(A.diagonal(), A.diagonal(1))[-4:]
    op = recording(A, [])
    options = BlockLanczosOptions(block_size=4, max_subspace=400, max_eigenvalues=4,
                                  eigenvalue_indices=(-4, -3, -2, -1), tolerance=1e-6)
    e = solve_errors(lambda: BlockLanczosEigenSolver(op, options).compute().eigenvalues, want,
                     caller_precision)
    assert e["highest"] <= 1e-4 and e["medium"] <= 10 * e["highest"], e
