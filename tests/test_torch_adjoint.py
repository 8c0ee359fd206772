"""The derived adjoint of the port against the JAX package's, f64 on the CPU,
same numpy-seeded inputs (mirrors ``tests/test_operators.py``'s vjp cases).

An operator built without ``rmatvec_fn`` gets A^H x from its matvec: the
reference by ``jax.vjp``, the port by ``torch.autograd.grad``.  On the card the
kernels' products are autograd Functions whose backward launches
the same kernel; here the launch is replaced by the plain version, so the
backward's wiring (the cached adjoint pack, or the same symmetric pack) is
tested without a card.  Tolerance: 1e-14 against the reference and against
the explicit adjoint.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.core.operators import LinearOperator as JLinearOperator
from eigenex_tpu.sparse.bsr import bsr_from_dense as j_bsr_from_dense
from eigenex_tpu.sparse.coo import coo_from_dense as j_coo_from_dense
from eigenex_tpu.sparse.csr import csr_from_dense as j_csr_from_dense
from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr as j_sym_bsr_from_bsr
from eigenex_tpu_torch import LinearOperator, aslinearoperator
from eigenex_tpu_torch.core.operators import pullback
from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.sparse.bsr import bsr_from_dense
from eigenex_tpu_torch.sparse.coo import coo_from_dense
from eigenex_tpu_torch.sparse.csr import csr_from_dense
from eigenex_tpu_torch.sparse.sym_bsr import sym_bsr_from_bsr
from eigenex_tpu_torch.utils.exceptions import OperatorError

torch.set_num_threads(1)


def close(x, ref, tol=1e-14):
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape
    assert np.abs(x - ref).max() <= tol * max(np.abs(ref).max(), 1.0), np.abs(x - ref).max()


def matvec(p, v):
    return p @ v


def container_matvec(p, v):
    return p.matvec(v)


def test_rmatvec_derived_real():
    """test_operators.py::test_rmatvec_vjp_fallback_real, both packages."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((5, 7))
    op = LinearOperator(matvec, torch.as_tensor(A), (5, 7), torch.float64, "cpu")
    ref = JLinearOperator(matvec, jnp.asarray(A), (5, 7), jnp.float64)
    x = rng.standard_normal(5)
    assert not op.has_adjoint and not ref.has_adjoint
    got = op.rmatvec(torch.as_tensor(x))
    close(got, ref.rmatvec(jnp.asarray(x)))
    close(got, A.T @ x)
    # .H built from the derived adjoint round-trips
    close(op.H.matvec(torch.as_tensor(x)), ref.H.matvec(jnp.asarray(x)))
    z = rng.standard_normal(7)
    close(op.H.rmatvec(torch.as_tensor(z)), ref.H.rmatvec(jnp.asarray(z)))
    assert op.H.shape == (7, 5) and op.H.has_adjoint and op.H.H.shape == (5, 7)
    close(op.H.H.matvec(torch.as_tensor(z)), A @ z)


def test_rmatvec_derived_complex_is_the_conjugate_transpose():
    """test_operators.py::test_rmatvec_vjp_fallback_complex.  PyTorch's
    backward already gives A^H g: the reference's conjugates around
    ``jax.vjp`` (which gives A^T), copied here, would return A^T x, which
    lies far from A^H x for this A."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
    op = LinearOperator(matvec, torch.as_tensor(A), (6, 6), torch.complex128, "cpu")
    ref = JLinearOperator(matvec, jnp.asarray(A), (6, 6), jnp.complex128)
    x = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    got = op.rmatvec(torch.as_tensor(x)).numpy()
    close(got, np.asarray(ref.rmatvec(jnp.asarray(x))))
    close(got, A.conj().T @ x)
    assert np.abs(got - A.T @ x).max() > 1.0
    close(op.H.matvec(torch.as_tensor(x)), ref.H.matvec(jnp.asarray(x)))


def test_derived_adjoint_leaves_no_state_and_works_under_no_grad():
    rng = np.random.default_rng(2)
    A = torch.as_tensor(rng.standard_normal((8, 8)))
    op = LinearOperator(matvec, A, (8, 8), torch.float64, "cpu")
    x = torch.as_tensor(rng.standard_normal(8))
    with torch.no_grad():
        y = op.rmatvec(x)
    assert not x.requires_grad and x.grad is None and x.grad_fn is None
    assert not y.requires_grad and y.grad_fn is None
    assert torch.equal(y, op.rmatvec(x))  # the same numbers outside no_grad
    close(y, A.T.numpy() @ x.numpy())
    assert not A.requires_grad and A.grad is None


def test_pullback_of_a_matmat_and_the_backward_on_the_calling_thread():
    """``pullback`` gives A^H G for a panel through the closure's matmat, and
    leaves the thread's multithreaded-backward setting as it found it."""
    rng = np.random.default_rng(10)
    A = rng.standard_normal((9, 6)) + 1j * rng.standard_normal((9, 6))
    G = torch.as_tensor(rng.standard_normal((9, 4)) + 1j * rng.standard_normal((9, 4)))
    before = torch._C._is_multithreading_enabled()
    got = pullback(lambda X: torch.as_tensor(A) @ X, G, (6, 4), torch.complex128)
    assert torch._C._is_multithreading_enabled() == before
    close(got, A.conj().T @ G.numpy())


def test_derived_adjoint_refuses_a_product_autograd_cannot_see():
    """A matvec through numpy is outside autograd's graph: the adjoint cannot
    be derived, and the operator says so instead of returning zeros."""
    A = np.arange(9.0).reshape(3, 3)
    op = LinearOperator(lambda p, v: torch.as_tensor(p @ v.detach().numpy()), A, (3, 3),
                        torch.float64, "cpu")
    with pytest.raises(OperatorError, match="rmatvec_fn"):
        op.rmatvec(torch.ones(3, dtype=torch.float64))


def _containers(complex_):
    """The same matrix in each container of both packages, and a closure
    over each with no adjoint."""
    rng = np.random.default_rng(3)
    n = 16
    A = rng.standard_normal((n, n))
    if complex_:
        A = A + 1j * rng.standard_normal((n, n))
    A[np.abs(A) < 0.7] = 0
    H = (A + A.conj().T) / 2
    yield "coo", A, coo_from_dense(A, device="cpu"), j_coo_from_dense(A)
    yield "csr", A, csr_from_dense(A, device="cpu"), j_csr_from_dense(A)
    yield "bsr", A, bsr_from_dense(A, (4, 4), device="cpu"), j_bsr_from_dense(A, (4, 4))
    yield ("sym_bsr", H, sym_bsr_from_bsr(bsr_from_dense(H, (4, 4), device="cpu")),
           j_sym_bsr_from_bsr(j_bsr_from_dense(H, (4, 4))))


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("kind", ["coo", "csr", "bsr", "sym_bsr"])
def test_closure_over_each_container(kind, complex_):
    name, A, got, ref = next(c for c in _containers(complex_) if c[0] == kind)
    dt = torch.complex128 if complex_ else torch.float64
    op = LinearOperator(container_matvec, got, A.shape, dt, "cpu")
    jop = JLinearOperator(container_matvec, ref, A.shape, jnp.complex128 if complex_ else jnp.float64)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(A.shape[0]) + (1j * rng.standard_normal(A.shape[0]) if complex_ else 0)
    derived = op.rmatvec(torch.as_tensor(x))
    close(derived, np.asarray(jop.rmatvec(jnp.asarray(x))))
    close(derived, got.as_linear_operator().rmatvec(torch.as_tensor(x)))  # the explicit adjoint
    close(derived, A.conj().T @ x)


# ---------------------------------------------------------------------------
# the kernels' autograd Functions, the launch replaced by the plain version
# ---------------------------------------------------------------------------
PLAIN = {
    "bsr_spmv": cuda_spmv.bsr_spmv_plain,
    "sym_bsr_spmv": cuda_spmv.sym_bsr_spmv_plain,
    "bsr_spmm": cuda_spmv.bsr_spmm_plain,
    "sym_bsr_spmm": cuda_spmv.sym_bsr_spmm_plain,
}


@pytest.fixture
def plain_launches(monkeypatch):
    """Each kernel's launch replaced by its plain version, taken outside
    autograd as a ctypes launch is; records (kernel, container) per launch."""
    calls = []

    def launcher(name):
        def launch(op, x):
            calls.append((name, op))
            with torch.no_grad():
                return PLAIN[name](op, x)
        return launch

    for name in PLAIN:
        monkeypatch.setitem(cuda_spmv._LAUNCH, name, launcher(name))
    return calls


def general_pack(storage=torch.float32):
    """A non-symmetric (8, 128)-block pack with an adjoint of the same shape."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((256, 256)).astype(np.float32)
    A[rng.random((256, 256)) < 0.9] = 0
    return A, bsr_from_dense(A, (8, 128), device="cpu").astype(storage)


def symmetric_pack(storage=torch.float32):
    rng = np.random.default_rng(6)
    B = rng.standard_normal((384, 384)).astype(np.float32)
    B[rng.random((384, 384)) < 0.9] = 0
    H = (B + B.T) / 2
    return H, sym_bsr_from_bsr(bsr_from_dense(H, (128, 128), device="cpu")).astype(storage)


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["bsr_spmv", "sym_bsr_spmv", "bsr_spmm", "sym_bsr_spmm"])
def test_kernel_function_backward_launches_on_the_adjoint(plain_launches, name, storage):
    """Forward: one launch on the pack.  Backward: one launch of the same
    kernel on ``kernel_adjoint()`` (general) or on the same pack (symmetric),
    returning f32 for bf16 packs too, equal to the explicit adjoint."""
    A, op = general_pack(storage) if name.startswith("bsr") else symmetric_pack(storage)
    spmm = name.endswith("spmm")
    gen = torch.Generator().manual_seed(7)
    shape_in = (A.shape[1], 12) if spmm else (A.shape[1],)
    shape_out = (A.shape[0], 12) if spmm else (A.shape[0],)
    x = torch.randn(shape_in, generator=gen).requires_grad_()
    g = torch.randn(shape_out, generator=gen)
    y = cuda_spmv._product(name, op, x)
    assert y.requires_grad and y.dtype == torch.float32
    assert plain_launches == [(name, op)]
    assert torch.equal(y.detach(), PLAIN[name](op, x.detach()))
    (grad,) = torch.autograd.grad(y, x, g)
    adj = op if name.startswith("sym") else op.kernel_adjoint()
    assert plain_launches == [(name, op), (name, adj)]
    if not name.startswith("sym"):
        assert adj is op.kernel_adjoint() and adj.dtype == storage  # cached, same storage
    assert grad.dtype == torch.float32 and not grad.requires_grad
    assert torch.equal(grad, PLAIN[name](adj, g))
    lifted = A.astype(np.float64) if storage == torch.float32 else None
    if lifted is not None:
        close(grad.double(), lifted.T @ g.double().numpy(), 1e-5)


def test_a_derived_adjoint_keeps_no_graph_alive(plain_launches):
    """The kernel's backward node lives while its output does, and no
    derived adjoint leaves one behind."""
    A, op = general_pack()
    closure = LinearOperator(lambda p, v: cuda_spmv._product("bsr_spmv", p, v), op, A.shape,
                             torch.float32, "cpu")

    def live_nodes():
        return sum(type(o).__name__ == "_KernelProductBackward" for o in gc.get_objects())

    y = cuda_spmv._product("bsr_spmv", op, torch.zeros(A.shape[1], requires_grad=True))
    assert live_nodes() == 1
    del y
    x = torch.ones(A.shape[0])
    for _ in range(5):
        closure.rmatvec(x)
    assert live_nodes() == 0


def test_kernel_product_launches_directly_when_autograd_does_not_record(plain_launches):
    A, op = general_pack()
    x = torch.ones(A.shape[1])
    y = cuda_spmv._product("bsr_spmv", op, x)
    with torch.no_grad():
        cuda_spmv._product("bsr_spmv", op, x.clone().requires_grad_())
    assert y.grad_fn is None and plain_launches == [("bsr_spmv", op)] * 2


@pytest.mark.parametrize("name", ["bsr_spmv", "sym_bsr_spmv"])
def test_closure_adjoint_through_the_kernel_functions(plain_launches, monkeypatch, name):
    """A closure ``A x - sigma x`` over a kernel product: through the
    Functions its derived adjoint is (A^T - sigma) x, a forward and a backward
    launch; with the launch outside autograd and no Function around it (the
    wrapper before the Functions), autograd sees only ``- sigma x`` and the
    'adjoint' is silently -sigma x."""
    A, op = general_pack() if name == "bsr_spmv" else symmetric_pack()
    sigma = 0.75
    closure = LinearOperator(
        lambda p, v: cuda_spmv._product(name, p, v) - sigma * v, op, A.shape, torch.float32, "cpu")
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(A.shape[0]).astype(np.float32))
    explicit = cuda_spmv._LAUNCH[name](op if name.startswith("sym") else op.kernel_adjoint(), x)
    plain_launches.clear()
    got = closure.rmatvec(x)
    assert torch.equal(got, explicit - sigma * x)
    assert [c[0] for c in plain_launches] == [name, name]
    monkeypatch.setattr(cuda_spmv, "_product", lambda n, p, v: cuda_spmv._LAUNCH[n](p, v))
    assert torch.equal(closure.rmatvec(x), -sigma * x)


def test_algebra_without_adjoints_derives_the_whole_adjoint():
    """Sums, products and shifts of operators without an explicit adjoint
    carry none (as in the reference); their adjoint is derived as a whole."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((7, 7)) + 1j * rng.standard_normal((7, 7))
    B = rng.standard_normal((7, 7))
    a = LinearOperator(matvec, torch.as_tensor(A), (7, 7), torch.complex128, "cpu")
    b = aslinearoperator(torch.as_tensor(B + 0j))
    s = 0.3 - 0.2j
    op = (a @ b + 2.0 * a).shifted(s)
    assert not op.has_adjoint
    x = rng.standard_normal(7) + 1j * rng.standard_normal(7)
    M = A @ B + 2.0 * A + s * np.eye(7)
    close(op.rmatvec(torch.as_tensor(x)), M.conj().T @ x)
