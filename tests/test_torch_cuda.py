"""Card-only checks of the CUDA kernels through pytest (marker ``cuda``):
skipped with a reason where there is no NVIDIA GPU.  ``chip_smoke.py`` is the
full check on the card; this file holds the same comparisons at small sizes
for a machine that has both a card and the test dependencies.

Tolerance: relative error <= 1e-5 against the plain version on the same
stored operator lifted to f32; the SpMM kernels also <= 1e-6 per column
against the plain-PyTorch model of their split products.
"""

import numpy as np
import pytest
import torch

from eigenex_tpu_torch import eigsh
from eigenex_tpu_torch.convert import bsr_from_numpy
from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.sparse.sym_bsr import sym_bsr_from_bsr

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    # decided here, inside the fixture, never while the module is imported
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def banded(nbr, b, seed, device):
    rng = np.random.default_rng(seed)
    data = np.zeros((nbr, 3, b, b), np.float32)
    cols = np.zeros((nbr, 3), np.int32)
    diag = rng.standard_normal((nbr, b, b)).astype(np.float32)
    off = rng.standard_normal((nbr - 1, b, b)).astype(np.float32)
    for r in range(nbr):
        data[r, 0], cols[r, 0] = (diag[r] + diag[r].T) / 2, r
        slot = 1
        if r > 0:
            data[r, slot], cols[r, slot] = off[r - 1].T, r - 1
            slot += 1
        if r + 1 < nbr:
            data[r, slot], cols[r, slot] = off[r], r + 1
    return bsr_from_numpy(data, cols, (nbr * b, nbr * b), device=device)


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [128, 256])
def test_kernels_match_plain_versions(card, storage, b):
    bsr = banded(24, b, 0, card).astype(storage)
    sym = sym_bsr_from_bsr(bsr)
    x = torch.randn(bsr.shape[1], device=card, generator=torch.Generator(card).manual_seed(1))
    for wrapper, plain, op in (
        (cuda_spmv.bsr_spmv, cuda_spmv.bsr_spmv_plain, bsr),
        (cuda_spmv.sym_bsr_spmv, cuda_spmv.sym_bsr_spmv_plain, sym),
    ):
        y = wrapper(op, x)
        ref = plain(op.astype(torch.float32), x)
        rel = float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref))
        assert rel <= 1e-5
    assert torch.equal(cuda_spmv.sym_bsr_spmv(sym, x), cuda_spmv.sym_bsr_spmv(sym, x))


def sym_case(nbr, b, ku, kind, seed, device):
    """SymBSR on the card: "banded" puts slot k at distance k + 1 (the last rows
    end in padding slots: column 0, zero block); "hub" puts slot 0 of every row
    in the last block column, which then receives partials from every row, and
    the other slots at random columns above the diagonal."""
    gen = torch.Generator(device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    cols = np.zeros((nbr, ku), np.int64)
    for r in range(nbr - 1):
        if kind == "banded":
            pick = [r + d for d in range(1, ku + 1) if r + d < nbr]
        else:
            rest = np.arange(r + 1, nbr - 1)
            take = min(ku - 1, len(rest))
            pick = [nbr - 1] + sorted(rng.choice(rest, size=take, replace=False).tolist())
        cols[r, :len(pick)] = pick
    real = torch.as_tensor(cols > np.arange(nbr)[:, None], device=device)
    diag = torch.randn((nbr, b, b), generator=gen, device=device)
    upper = torch.randn((nbr, ku, b, b), generator=gen, device=device) * real[:, :, None, None]
    cols_t = torch.as_tensor(np.where(cols > np.arange(nbr)[:, None], cols, 0).astype(np.int32))
    from eigenex_tpu_torch.sparse.sym_bsr import SymBSRMatrix

    return SymBSRMatrix((diag + diag.transpose(1, 2)) / 2, upper.contiguous(), cols_t.to(device),
                        (nbr * b, nbr * b), -1)


SYM_SPMV_CASES = {
    # nbr, b, ku, kind: one block row; fewer rows than the grid has warps; rows
    # that are no multiple of the grid's warps; 256- and 384-wide blocks; padding
    # in the last rows; one block column that hears from every row
    "nbr1": (1, 128, 1, "banded"),
    "nbr3_b256": (3, 256, 2, "banded"),
    "nbr1061": (1061, 128, 1, "banded"),
    "nbr7_b384": (7, 384, 2, "hub"),
    "padding_last_rows": (40, 128, 3, "banded"),
    "hub_column": (300, 128, 3, "hub"),
}


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SYM_SPMV_CASES))
def test_sym_spmv_schedule(card, storage, case):
    """Three back-to-back calls on different x, each against the plain version
    and bit-equal on repeat: the scratch and the ticket counter that the
    container keeps between launches start every launch afresh."""
    sym = sym_case(*SYM_SPMV_CASES[case], seed=5, device=card).astype(storage)
    gen = torch.Generator(card).manual_seed(6)
    xs = [torch.randn(sym.shape[1], generator=gen, device=card) for _ in range(3)]
    ys = [cuda_spmv.sym_bsr_spmv(sym, x) for x in xs]
    lifted = sym.astype(torch.float32)
    for x, y in zip(xs, ys):
        ref = cuda_spmv.sym_bsr_spmv_plain(lifted, x)
        assert float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref)) <= 1e-5
    for x, y in zip(xs, ys):
        assert torch.equal(cuda_spmv.sym_bsr_spmv(sym, x), y)
    _, _, (_, ticket) = sym.kernel_workspace(
        ("sym_bsr_spmv", torch.cuda.current_stream(card).cuda_stream), None)
    assert int(ticket) == 0  # reset by the last unit of every launch


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 5, 12, 40])
def test_spmm_kernels_match_plain_versions(card, storage, p):
    bsr = banded(24, 128, 0, card).astype(storage)
    sym = sym_bsr_from_bsr(bsr)
    X = torch.randn((bsr.shape[1], p), device=card, generator=torch.Generator(card).manual_seed(1))
    for wrapper, plain, op in (
        (cuda_spmv.bsr_spmm, cuda_spmv.bsr_spmm_plain, bsr),
        (cuda_spmv.sym_bsr_spmm, cuda_spmv.sym_bsr_spmm_plain, sym),
    ):
        before = cuda_spmv.launch_counts()
        Y = op.matmat(X)  # the container routes a CUDA panel to the kernel
        after = cuda_spmv.launch_counts()
        assert sum(after.values()) == sum(before.values()) + 1
        ref = plain(op.astype(torch.float32), X)
        assert float(torch.linalg.norm(Y - ref) / torch.linalg.norm(ref)) <= 1e-5
        assert torch.equal(wrapper(op, X.T.contiguous().T), Y)  # a transposed view is copied
    assert torch.equal(cuda_spmv.sym_bsr_spmm(sym, X), cuda_spmv.sym_bsr_spmm(sym, X))


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 8, 12])
def test_spmm_kernels_compute_the_model_of_their_split_products(card, storage, p):
    """The kernels against ``spmm_split_model``, the plain-PyTorch model the
    CPU tests hold to the f64 product: the same split products, exact and
    summed in f64, so every column agrees to 1e-6 of its norm (a dropped
    third bf16 part would be 8e-6 off, a one-pass product 2e-4 or more), also
    with column norms spread over twelve decades."""
    bsr = banded(24, 128, 3, card).astype(storage)
    sym = sym_bsr_from_bsr(bsr)
    X = torch.randn((bsr.shape[1], p), device=card, generator=torch.Generator(card).manual_seed(2))
    X = X * 10.0 ** torch.linspace(-6, 6, p, device=card)[None, :]
    for wrapper, op in ((cuda_spmv.bsr_spmm, bsr), (cuda_spmv.sym_bsr_spmm, sym)):
        Y = wrapper(op, X).double()
        model = cuda_spmv.spmm_split_model(op, X).double()
        err = torch.linalg.vector_norm(Y - model, dim=0) / torch.linalg.vector_norm(model, dim=0)
        assert float(err.max()) <= 1e-6


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    bsr = banded(4, 128, 0, card)
    from eigenex_tpu_torch.utils.exceptions import EigenexError

    with pytest.raises(EigenexError):
        cuda_spmv.bsr_spmv(bsr, torch.ones(bsr.shape[1], device=card, dtype=torch.float64))
    with pytest.raises(EigenexError):
        cuda_spmv.bsr_spmv(bsr.astype(torch.float64), torch.ones(bsr.shape[1], device=card))
    with pytest.raises(EigenexError):
        cuda_spmv.sym_bsr_spmv(sym_bsr_from_bsr(bsr), torch.ones(bsr.shape[1]))  # x on the CPU


def test_every_solver_matvec_is_a_kernel_launch(card):
    sym = sym_bsr_from_bsr(banded(16, 128, 2, card))
    cuda_spmv.reset_launch_counts()
    res = eigsh(sym, k=2, which="LA", tol=1e-5, seed=0)
    assert res.converged
    assert cuda_spmv.launch_counts() == {"bsr_spmv": 0, "sym_bsr_spmv": res.iterations,
                                         "bsr_spmm": 0, "sym_bsr_spmm": 0}


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_bsr_spmv_at_the_general_pack_shape(card, storage):
    """32x128 blocks, the shape ``accelerate()`` gives a non-symmetric
    operator: against the plain version, and bit-equal on a second run."""
    from eigenex_tpu_torch.sparse.bsr import BSRMatrix

    gen = torch.Generator(card).manual_seed(3)
    nbr, kmax, nbc = 96, 5, 24
    data = torch.randn((nbr, kmax, 32, 128), generator=gen, device=card).to(storage)
    cols = torch.randint(0, nbc, (nbr, kmax), generator=gen, device=card, dtype=torch.int32)
    bsr = BSRMatrix(data, cols, (nbr * 32, nbc * 128))
    x = torch.randn(bsr.shape[1], generator=gen, device=card)
    y = cuda_spmv.bsr_spmv(bsr, x)
    ref = cuda_spmv.bsr_spmv_plain(bsr.astype(torch.float32), x)
    assert float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref)) <= 1e-5
    assert torch.equal(y, cuda_spmv.bsr_spmv(bsr, x))


def test_eigs_on_a_packed_general_operand_launches_once_a_matvec(card):
    """``eigs`` on an accelerated non-symmetric operand (the upwind stencil of
    BASELINE config 2 at nx = 40): every Krylov-Schur matvec is one launch of
    the general SpMV kernel, and the pairs are right on the host in f64."""
    import scipy.sparse as sp

    from eigenex_tpu_torch import accelerate, eigs

    nx, conv = 40, 0.4
    n = nx * nx
    lap = sp.diags([-1.0 - conv, 4.0, -1.0 + conv], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(sp.eye(nx), lap) + sp.kron(sp.diags([-1.0 - conv, -1.0 + conv], [-1, 1],
                                                     shape=(nx, nx)), sp.eye(nx))).tocoo()
    acc = accelerate((A.row, A.col, A.data, A.shape), device=card)
    assert acc.matrix.block_shape == (32, 128) and acc.matrix.dtype == torch.float32
    cuda_spmv.reset_launch_counts()
    res = eigs(acc, k=2, tol=1e-5, seed=1)
    assert res.converged
    assert cuda_spmv.launch_counts() == {"bsr_spmv": res.iterations, "sym_bsr_spmv": 0,
                                         "bsr_spmm": 0, "sym_bsr_spmm": 0}
    X, lam = res.eigenvectors, res.eigenvalues
    rel = np.linalg.norm(A.tocsr() @ X - X * lam[None, :], axis=0) / np.abs(lam)
    assert rel.max() <= 1e-4 and X.shape == (n, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gtsv2_solve_matches_the_host_lapack_solve(card, dtype):
    """The tridiagonal shift-invert operator on the card (cuSPARSE gtsv2)
    against LAPACK gtsv on the host, one call a matvec and a matmat, the
    workspace made once for each width."""
    from eigenex_tpu_torch import tridiagonal_shift_invert_operator
    from eigenex_tpu_torch.solvers import direct

    n = 3000
    rng = np.random.default_rng(5)
    dl, d, du = rng.standard_normal(n - 1), 4.0 + rng.standard_normal(n), rng.standard_normal(n - 1)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    si = tridiagonal_shift_invert_operator(dl, d, du, 0.25, dtype=npdt)
    host = tridiagonal_shift_invert_operator(dl, d, du, 0.25, dtype=npdt, device="cpu")
    X = torch.as_tensor(rng.standard_normal((n, 4)), dtype=dtype)
    direct.reset_gtsv2_calls()
    Y = si.matmat(X.to(card))
    y = si.matvec(X[:, 1].to(card))
    si.matvec(X[:, 2].to(card))
    assert direct.gtsv2_calls() == 3 and sorted(si._params.workspace) == [1, 4]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    ref = host.matmat(X)
    err = torch.linalg.vector_norm(Y.cpu() - ref, dim=0) / torch.linalg.vector_norm(ref, dim=0)
    assert float(err.max()) <= tol
    assert float(torch.linalg.vector_norm(y.cpu() - ref[:, 1]) / torch.linalg.vector_norm(ref[:, 1])) <= tol
    assert torch.equal(X, X.clone())  # the right-hand side is not overwritten


def test_svds_on_a_rectangular_pack_launches_two_spmv_a_gram_matvec(card):
    """Both Gram matvecs of ``svds`` on a rectangular pack are general SpMV
    launches (A, and A^H packed at 32x128); the recovery of U one SpMM."""
    import scipy.sparse as sp

    from eigenex_tpu_torch import accelerate, svds

    rng = np.random.default_rng(1)
    m, n = 3000, 1800
    r = np.repeat(np.arange(m), 4)
    c = np.clip((r * n) // m + rng.integers(-40, 40, size=len(r)), 0, n - 1)
    v = rng.standard_normal(len(r))
    acc = accelerate((r, c, v, (m, n)), device=card)
    assert acc.adjoint_matrix().block_shape == (32, 128)
    cuda_spmv.reset_launch_counts()
    U, s, Vh = svds(acc, k=3, tol=1e-5)
    counts = cuda_spmv.launch_counts()
    assert counts["bsr_spmv"] % 2 == 0 and counts["bsr_spmv"] > 0
    assert counts["bsr_spmm"] == 1 and counts["sym_bsr_spmv"] == counts["sym_bsr_spmm"] == 0
    A = sp.csr_matrix((v, (r, c)), shape=(m, n))
    ref = np.sort(np.linalg.svd(A.toarray(), compute_uv=False))[::-1][:3]
    np.testing.assert_allclose(s, ref, rtol=1e-4)


def test_expm_multiply_on_a_symmetric_pack_launches_once_an_application(card):
    from eigenex_tpu_torch import expm_multiply

    sym = sym_bsr_from_bsr(banded(8, 128, 4, card))
    x = torch.randn(sym.shape[1], device=card, generator=torch.Generator(card).manual_seed(2))
    cuda_spmv.reset_launch_counts()
    y = expm_multiply(sym, x, -0.05, method="lanczos", num_steps=24)
    assert cuda_spmv.launch_counts()["sym_bsr_spmv"] == 24
    z = expm_multiply(sym, x, -0.05, method="taylor", tol=1e-7)
    assert float(torch.linalg.vector_norm(y - z) / torch.linalg.vector_norm(z)) <= 1e-4


def test_block_operator_on_bsr_sectors_launches_once_a_sector(card):
    """Config 3's kernel route at L = 10: every stored sector of the f32
    BSR Hamiltonian (32x128 packs on the card) is one ``bsr_spmv`` launch
    a matvec, and the product agrees with the plain route (the same
    sectors on the CPU) to 1e-5."""
    from eigenex_tpu_torch import heisenberg_block_hamiltonian
    from eigenex_tpu_torch.block.operator import block_operator

    bt = heisenberg_block_hamiltonian(10, dtype=np.float32, storage="bsr", device=card)
    assert all(b.block_shape == (32, 128) for b in bt.blocks.values())
    op = block_operator(bt)
    plain = block_operator(heisenberg_block_hamiltonian(
        10, dtype=np.float32, storage="bsr", block_shape=(32, 128), device="cpu"))
    x = torch.randn(op.shape[1], device=card, generator=torch.Generator(card).manual_seed(5))
    cuda_spmv.reset_launch_counts()
    y = op.matvec(x)
    y2 = op.matvec(x)
    torch.cuda.synchronize()
    assert cuda_spmv.launch_counts()["bsr_spmv"] == 2 * bt.num_stored_blocks == 22
    assert torch.equal(y, y2)  # bsr_spmv is bit-reproducible
    ref = plain.matvec(x.cpu())
    assert float(torch.linalg.vector_norm(y.cpu() - ref) / torch.linalg.vector_norm(ref)) <= 1e-5
