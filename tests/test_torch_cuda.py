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

import _embed_reference as embed_reference
from _stencil import stencil
from eigenex_tpu_torch import eigsh
from eigenex_tpu_torch.convert import bsr_from_numpy
from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.sparse.sym_bsr import sym_bsr_from_bsr
from eigenex_tpu_torch.utils.exceptions import EigenexError

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
                                         "bsr_spmm": 0, "sym_bsr_spmm": 0, "csr_spmv": 0}


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


#: (nbr, kmax, bm, bn) of the general SpMV checks: one block row, fewer block rows
#: than the card has SMs, and the config-2 pack's count; one slot and fifteen; the
#: general pack's 32-row blocks and 128-row ones; then ragged row groups (1, 8 and
#: 320 rows) and several 128-column chunks a block
BSR_SPMV_SHAPES = [(nbr, kmax, bm, 128) for nbr in (1, 60, 3124) for kmax in (1, 15)
                   for bm in (32, 128)] + [(7, 3, 1, 128), (33, 4, 8, 256), (5, 2, 320, 384)]


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BSR_SPMV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bsr_spmv_every_work_split_matches_the_plain_version(card, storage, shape):
    """The general SpMV kernel at shapes that take each of its work splits
    (whole units a warp, and a unit's steps over 2-8 warps when the block rows
    are few), with ELL padding slots (column 0, zero block) in every other
    row: one launch a product, against the plain version on the same stored
    blocks lifted to f32, and bit-equal on a second run."""
    from eigenex_tpu_torch.sparse.bsr import BSRMatrix

    nbr, kmax, bm, bn = shape
    gen = torch.Generator(card).manual_seed(nbr * 1000 + kmax * 10 + bm)
    nbc = max(kmax, 24)
    data = torch.randn((nbr, kmax, bm, bn), generator=gen, device=card)
    cols = torch.randint(0, nbc, (nbr, kmax), generator=gen, device=card, dtype=torch.int32)
    if kmax > 1:
        data[::2, -1] = 0
        cols[::2, -1] = 0
    bsr = BSRMatrix(data.to(storage), cols, (nbr * bm, nbc * bn))
    del data
    x = torch.randn(bsr.shape[1], generator=gen, device=card)
    cuda_spmv.reset_launch_counts()
    y = cuda_spmv.bsr_spmv(bsr, x)
    torch.cuda.synchronize()
    assert cuda_spmv.launch_counts()["bsr_spmv"] == 1
    ref = cuda_spmv.bsr_spmv_plain(bsr.astype(torch.float32), x)
    assert y.shape == (nbr * bm,) and bool(torch.isfinite(y).all())
    assert float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref)) <= 1e-5
    assert torch.equal(y, cuda_spmv.bsr_spmv(bsr, x))


def test_eigs_on_a_packed_general_operand_launches_once_a_matvec(card):
    """``eigs`` on an accelerated non-symmetric operand (the upwind stencil of
    BASELINE config 2 at nx = 40, which ``accelerate()`` stores row-compressed
    on the card): every Krylov-Schur matvec is one launch of ``csr_spmv``.
    On the host in f64, each eigenvalue's backward error
    sigma_min(A - lambda I) is at most sqrt(k) tol max|lambda|, and each
    returned eigenvector is the Ritz vector of its eigenvalue: its residual is
    orthogonal to the Krylov space, so to span(X), up to rounding.  Wrong
    columns, or the Schur vectors in their place, leave a component there of
    |lambda_i - lambda_j| or |T_12|, 22 times the limit or more over seeds
    0-39 (``tests/cpu_studies.py ks-ritz``).  The port's stop test reads the
    Ritz estimates of the pairs it returns, so each returned eigenvector's
    own residual is held to 2 tol |lambda| as well
    (``test_torch_eigs.py::test_f32_eigs_meets_what_tol_certifies`` holds
    both packages to the same checks on the CPU)."""
    from eigenex_tpu_torch import eigs

    n, A = 40 * 40, stencil(40)
    acc = general_stencil_on(card, 40)
    assert acc.matrix.dtype == torch.float32
    cuda_spmv.reset_launch_counts()
    res = eigs(acc, k=2, tol=1e-5, seed=1)
    assert res.converged
    assert cuda_spmv.launch_counts() == {"bsr_spmv": 0, "sym_bsr_spmv": 0, "bsr_spmm": 0,
                                         "sym_bsr_spmm": 0, "csr_spmv": res.iterations}
    X, lam = res.eigenvectors, np.asarray(res.eigenvalues, np.complex128)
    assert X.shape == (n, 2) and np.isfinite(X).all()
    limit = np.sqrt(2) * 1e-5 * np.abs(lam).max()
    assert max(backward_error(A, z) for z in lam) <= limit
    X = np.asarray(X, np.complex128)
    R = A.tocsr() @ X - X * lam[None, :]
    inside = np.linalg.norm(np.linalg.qr(X)[0].conj().T @ R, axis=0) / np.linalg.norm(X, axis=0)
    assert inside.max() <= limit
    assert np.max(np.linalg.norm(R, axis=0) / (np.abs(lam) * np.linalg.norm(X, axis=0))) <= 2e-5


def backward_error(A, z, iters=8):
    """sigma_min(A - z I) of a scipy operator A from above, on the host in f64:
    power iteration on the inverse's normal operator."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    n = A.shape[0]
    lu = spl.splu((A - z * sp.eye(n)).tocsc().astype(np.complex128))
    v = np.ones(n, np.complex128) / np.sqrt(n)
    for _ in range(iters):
        w = lu.solve(v)
        v = lu.solve(w / np.linalg.norm(w), trans="H")
        norm = np.linalg.norm(v)
        v /= norm
    return 1.0 / norm


def test_solves_on_a_thread_share_one_side_stream_and_its_workspace(card):
    """The chunk graphs of every solve on a thread run on one side stream,
    kept from solve to solve (``solvers/chunk_graph.py``): PyTorch keeps a
    cuBLAS workspace for each stream that ran a cuBLAS call, so a new stream
    a solve left 32 MiB more allocated after each solve, up to about 1 GiB.
    After the first solve, the memory allocated after a solve stays put."""
    import scipy.sparse as sp

    from eigenex_tpu_torch import accelerate, eigs
    from eigenex_tpu_torch.solvers import chunk_graph

    nx, conv = 40, 0.4
    lap = sp.diags([-1.0 - conv, 4.0, -1.0 + conv], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(sp.eye(nx), lap) + sp.kron(sp.diags([-1.0 - conv, -1.0 + conv], [-1, 1],
                                                     shape=(nx, nx)), sp.eye(nx))).tocoo()
    acc = accelerate((A.row, A.col, A.data, A.shape), device=card)
    streams, allocated = [], []
    side_stream = chunk_graph.ChunkGraphs._side_stream

    def recorded(self, device):
        streams.append(side_stream(self, device))
        return streams[-1]

    chunk_graph.ChunkGraphs._side_stream = recorded
    try:
        for seed in range(4):
            assert eigs(acc, k=2, tol=1e-5, seed=seed).converged
            torch.cuda.synchronize()
            allocated.append(torch.cuda.memory_allocated(card))
    finally:
        chunk_graph.ChunkGraphs._side_stream = side_stream
    assert streams and len({s.stream_id for s in streams}) == 1
    assert allocated[1:] == allocated[1:2] * 3


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


def test_a_pack_in_host_memory_solves_on_a_mesh_of_the_card(card):
    """``eigsh(acc, mesh=)`` with the accelerated pack left in host memory:
    the mesh places only the shards' panels on the card, and the solve is
    bit-equal to the same pack's on the card (the route for a pack past one
    card's memory)."""
    from eigenex_tpu_torch import accelerate, make_mesh

    n = 4096
    rng = np.random.default_rng(3)
    r = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    c = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    v = np.concatenate([rng.uniform(-1, 1, n), -np.ones(2 * (n - 1))])
    host = accelerate((r, c, v, (n, n)), device="cpu")
    on_card = accelerate((r, c, v, (n, n)), device=card)
    mesh = make_mesh(devices=[card] * 2)
    cuda_spmv.reset_launch_counts()
    a = eigsh(host, k=2, which="SA", tol=1e-6, mesh=mesh)
    assert cuda_spmv.launch_counts()["sym_bsr_spmv"] == 2 * a.iterations
    b = eigsh(on_card, k=2, which="SA", tol=1e-6, mesh=mesh)
    assert host.device.type == "cpu"
    np.testing.assert_array_equal(a.eigenvalues, b.eigenvalues)
    np.testing.assert_array_equal(a.eigenvectors, b.eigenvectors)


def general_pack_on(card, storage, seed=3):
    """A square general pack of 32x128 blocks, as ``accelerate()`` gives."""
    from eigenex_tpu_torch.sparse.bsr import BSRMatrix

    gen = torch.Generator(card).manual_seed(seed)
    nbr, kmax, nbc = 96, 5, 24
    data = torch.randn((nbr, kmax, 32, 128), generator=gen, device=card).to(storage)
    cols = torch.randint(0, nbc, (nbr, kmax), generator=gen, device=card, dtype=torch.int32)
    return BSRMatrix(data, cols, (nbr * 32, nbc * 128))


def general_stencil_on(card, nx, conv=0.4, dtype="auto"):
    """``accelerate()`` of the stencil on the card: row-compressed storage."""
    from eigenex_tpu_torch import accelerate
    from eigenex_tpu_torch.sparse.sym_csr import SymCSRMatrix

    A = stencil(nx, conv)
    acc = accelerate((A.row, A.col, A.data, A.shape), dtype=dtype, device=card)
    assert isinstance(acc.matrix, SymCSRMatrix) and not acc.matrix.hermitian
    return acc


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["bsr_spmv", "sym_bsr_spmv", "bsr_spmm", "sym_bsr_spmm",
                                  "csr_spmv"])
def test_derived_adjoint_through_each_kernel_is_the_explicit_one(card, storage, name):
    """A closure over each kernel with no adjoint: its derived A^H x (or A^H X,
    by ``pullback`` of the closure's matmat) is one forward and one backward launch,
    bit-equal to the explicit adjoint (the same kernel on ``kernel_adjoint()``,
    or on the same symmetric pack), f32 for bf16 packs too.  ``csr_spmv`` runs
    on a general stencil stored row-compressed, its backward on the transpose."""
    from eigenex_tpu_torch import LinearOperator
    from eigenex_tpu_torch.core.operators import pullback

    if name == "csr_spmv":
        op = general_stencil_on(card, 24, dtype=storage).matrix
    elif name.startswith("bsr"):
        op = general_pack_on(card, storage)
    else:
        op = sym_bsr_from_bsr(banded(24, 128, 0, card)).astype(storage)
    gen = torch.Generator(card).manual_seed(4)
    if name.endswith("spmv"):
        closure = LinearOperator(lambda p, v: p.matvec(v), op, op.shape, torch.float32, card)
        x = torch.randn(op.shape[0], generator=gen, device=card)
        explicit = op.matvec(x) if name == "sym_bsr_spmv" else op.kernel_adjoint().matvec(x)
        cuda_spmv.reset_launch_counts()
        with torch.no_grad():
            derived = closure.rmatvec(x)
    else:
        X = torch.randn((op.shape[0], 12), generator=gen, device=card)
        explicit = op.kernel_adjoint().matmat(X) if name == "bsr_spmm" else op.matmat(X)
        closure = LinearOperator(lambda p, v: p.matvec(v), op, op.shape, torch.float32, card,
                                 matmat_fn=lambda p, Y: p.matmat(Y))
        cuda_spmv.reset_launch_counts()
        derived = pullback(closure.matmat, X, (op.shape[1], 12), torch.float32)
    assert cuda_spmv.launch_counts()[name] == 2 and sum(cuda_spmv.launch_counts().values()) == 2
    assert derived.dtype == torch.float32 and not derived.requires_grad
    assert torch.equal(derived, explicit)


@pytest.mark.parametrize("storage,kernel", [("row_compressed", "csr_spmv"),
                                            ("block", "bsr_spmv")])
def test_cgls_fallback_on_a_closure_over_the_general_kernel(card, storage, kernel):
    """``shift_invert_operator_general`` on a closure over config 2's storage
    (nx = 40) with no adjoint, at an interior shift where GMRES(8) stagnates:
    the CGLS fallback derives each adjoint through the kernels, and the result
    is bit-equal to the same operator with the explicit adjoint.  Both general
    storages: the row-compressed one ``accelerate()`` makes on the card and its
    block pack (``block_matrix()``)."""
    from eigenex_tpu_torch import LinearOperator, shift_invert_operator_general

    acc = general_stencil_on(card, 40)
    pack = acc.matrix if storage == "row_compressed" else acc.block_matrix()
    routes = {}
    for route, rmv in (("derived", None), ("explicit", lambda p, v: p.rmatvec(v))):
        op = LinearOperator(lambda p, v: p.matvec(v), pack, pack.shape, torch.float32, card,
                            rmatvec_fn=rmv)
        si = shift_invert_operator_general(op, 7.5, restart=8, cycles=4)
        x = torch.randn(pack.shape[0], generator=torch.Generator(card).manual_seed(0), device=card)
        cuda_spmv.reset_launch_counts()
        routes[route] = (si.matvec(x), dict(si.stats), cuda_spmv.launch_counts())
    (yd, sd, cd), (ye, se, ce) = routes["derived"], routes["explicit"]
    assert sd["fallbacks"] == 1 and sd["iterations"] > 0 and sd["adjoint_forwards"] > 0
    assert torch.equal(yd, ye)
    assert {k: sd[k] for k in ("matvecs", "iterations")} == {k: se[k] for k in ("matvecs", "iterations")}
    assert cd[kernel] == sd["matvecs"] + sd["adjoint_forwards"] and ce[kernel] == se["matvecs"]
    assert sum(cd.values()) == cd[kernel] and sum(ce.values()) == ce[kernel]


# ---------------------------------------------------------------------------
# the chunk graphs of a solve (eigenex_tpu_torch.solvers.chunk_graph)
# ---------------------------------------------------------------------------
def test_the_containers_on_the_card_say_they_may_be_captured(card):
    from eigenex_tpu_torch.solvers.cg import _Counted, _new_stats

    bsr = banded(4, 128, 3, card)
    for container in (bsr, bsr.astype(torch.bfloat16), sym_bsr_from_bsr(bsr)):
        op = container.as_linear_operator()
        assert op.capturable
        assert _Counted(op, 0.5, _new_stats()).operator().capturable
    assert not bsr.astype(torch.float64).as_linear_operator().capturable  # plain version


def test_a_chunk_graph_replays_bit_equal_and_counts_its_launches(card, monkeypatch):
    """One key run four times on the same input: a warm-up, a capture then
    its replay, two replays.  Every run bit-equal to the warm-up; launches =
    matvecs, the capture counted as none; the capture adds no kernel
    workspace to the container (the warm-up made the set stream's)."""
    from eigenex_tpu_torch.solvers import chunk_graph
    from eigenex_tpu_torch.solvers.arnoldi import _arnoldi_chunk, init_arnoldi_state

    sym = sym_bsr_from_bsr(banded(16, 128, 4, card))
    op = sym.as_linear_operator()
    workspaces = []
    capture = chunk_graph.ChunkGraphs._capture

    def counted_capture(self, *args):
        before = len(sym.__dict__.get("_kernel_workspaces", {}))
        out = capture(self, *args)
        workspaces.append((before, len(sym.__dict__.get("_kernel_workspaces", {}))))
        return out

    monkeypatch.setattr(chunk_graph.ChunkGraphs, "_capture", counted_capture)
    chunk_graph.reset_graph_counts()
    cuda_spmv.reset_launch_counts()
    steps, outs = 20, []
    with chunk_graph.solve_graphs():
        state = init_arnoldi_state(op, steps, seed=5, breakdown_threshold=1e-6)
        start = [t.clone() for t in chunk_graph.state_tensors(state)]
        for _ in range(4):
            for buffer, value in zip(chunk_graph.state_tensors(state), start):
                buffer.copy_(value)
            out = _arnoldi_chunk(op, state, 0.0, 1e-6, None, k_start=0, num_steps=steps)
            assert out is state
            outs.append([t.clone() for t in chunk_graph.state_tensors(state)])
    torch.cuda.synchronize()
    for run in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, outs[0]))
    assert int(outs[0][2]) == steps
    counts = chunk_graph.graph_counts()
    assert (counts["keys"], counts["warmups"], counts["captures"], counts["replays"]) == (1, 1, 1, 3)
    assert cuda_spmv.launch_counts()["sym_bsr_spmv"] == 4 * steps
    assert workspaces == [(1, 1)]


def test_a_chunk_from_a_restarted_state_replays_bit_equal_to_eager(card):
    """A chunk from k = 5, its basis rows above the live ones NaN (stale rows
    after a restart): CGS2 reads only ``V[:kh + 1]``, so the warm-up, the
    capture's replay and two replays are bit-equal to one another and to the
    body run eagerly outside any graph set, and finite."""
    from eigenex_tpu_torch.solvers import chunk_graph
    from eigenex_tpu_torch.solvers.arnoldi import (_arnoldi_chunk, _arnoldi_chunk_body,
                                                   arnoldi_steps, init_arnoldi_state)

    op = sym_bsr_from_bsr(banded(16, 128, 4, card)).as_linear_operator()
    first, steps = 5, 15
    state = arnoldi_steps(op, init_arnoldi_state(op, first + steps, seed=5,
                                                 breakdown_threshold=1e-6),
                          first, breakdown_threshold=1e-6)
    state.V[first + 1:] = float("nan")
    start = [t.clone() for t in chunk_graph.state_tensors(state)]

    def from_start():
        for buffer, value in zip(chunk_graph.state_tensors(state), start):
            buffer.copy_(value)

    chunk_graph.reset_graph_counts()
    outs = []
    with chunk_graph.solve_graphs():
        for _ in range(4):
            from_start()
            out = _arnoldi_chunk(op, state, 0.0, 1e-6, None, k_start=first, num_steps=steps)
            outs.append([t.clone() for t in chunk_graph.state_tensors(out)])
    from_start()  # the body returns its scalars as new tensors
    out = _arnoldi_chunk_body(op, state, 0.0, 1e-6, None, k_start=first, num_steps=steps)
    outs.append([t.clone() for t in chunk_graph.state_tensors(out)])
    torch.cuda.synchronize()
    assert int(outs[0][2]) == first + steps
    assert torch.isfinite(outs[0][0]).all() and torch.isfinite(outs[0][1]).all()
    for run in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, outs[0]))
    counts = chunk_graph.graph_counts()
    assert (counts["warmups"], counts["captures"], counts["replays"]) == (1, 1, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["step", "breakdown", "failed", "inactive"])
def test_arnoldi_step_kernel_is_its_plain_version(card, dtype, case):
    """The tail of one Arnoldi step, fused and plain, on the same inputs:
    a normal step, one whose residue breaks down, one with a NaN
    coefficient, and one after a breakdown (inactive).  The basis, the
    Hessenberg and the new flags bit-equal."""
    from eigenex_tpu_torch.ops import arnoldi_step

    gen = torch.Generator(card).manual_seed(11)
    m, n, kh, thr = 12, 1000, 6, 1e-6
    w = torch.randn(n, device=card, dtype=dtype, generator=gen)
    c = torch.randn(kh + 1, device=card, dtype=dtype, generator=gen)
    if case == "breakdown":
        w *= 1e-9
    if case == "failed":
        c[3] = float("nan")
    start = (torch.randn(m + 1, n, device=card, dtype=dtype, generator=gen),
             torch.randn(m + 1, m, device=card, dtype=dtype, generator=gen),
             torch.tensor(kh, device=card), torch.tensor(case == "inactive", device=card),
             torch.tensor(0.5, device=card, dtype=dtype), torch.tensor(False, device=card))
    assert arnoldi_step.fused(start[0])
    outs = []
    for tail in (arnoldi_step.step_tail, arnoldi_step.step_tail_plain):
        V, H, k, breakdown, residue_prev, failed = (t.clone() for t in start)
        residue = torch.linalg.vector_norm(w)
        flags = tail(V, H, c, w, residue, thr, kh, k, breakdown, residue_prev, failed)
        outs.append((V, H, *flags))
    torch.cuda.synchronize()
    for fused, plain in zip(*outs):
        assert torch.equal(fused, plain)
    V, H, k, breakdown, _, failed = outs[0]
    # a breakdown step counts (its row of V is zero), a failed one does not
    want = {"step": (kh + 1, False, False), "breakdown": (kh + 1, True, False),
            "failed": (kh, False, True), "inactive": (kh, True, False)}[case]
    assert (int(k), bool(breakdown), bool(failed)) == want
    assert torch.equal(V[kh + 1], start[0][kh + 1]) == (case == "inactive")


def graph_and_eager(solve):
    """The solve eagerly, then with graphs (counts from 0): both results,
    the graph run's launches and its graph counts."""
    from eigenex_tpu_torch.solvers import chunk_graph

    with chunk_graph.eager_chunks():
        eager = solve()
    chunk_graph.reset_graph_counts()
    cuda_spmv.reset_launch_counts()
    graphed = solve()
    return eager, graphed, cuda_spmv.launch_counts(), chunk_graph.graph_counts()


def test_a_thick_restart_with_graphs_is_the_eager_solve(card):
    sym = sym_bsr_from_bsr(banded(24, 128, 6, card))
    v0 = torch.randn(sym.shape[0], device=card, generator=torch.Generator(card).manual_seed(7))
    eager, graphed, launches, counts = graph_and_eager(
        lambda: eigsh(sym, k=2, which="LA", v0=v0, tol=1e-9, max_subspace=24, max_restarts=6))
    assert np.array_equal(eager.eigenvalues, graphed.eigenvalues)
    assert torch.equal(eager.eigenvectors, graphed.eigenvectors)
    assert eager.iterations == graphed.iterations
    # keys (0, 24) and (p, 24 - p): the second warmed up at restart 1, captured at 2
    assert (counts["keys"], counts["captures"], counts["replays"]) == (2, 1, 5)
    assert launches["sym_bsr_spmv"] == graphed.iterations


def test_krylov_schur_and_gmres_with_graphs_are_the_eager_solves(card):
    from eigenex_tpu_torch import eigs

    bsr = banded(24, 128, 8, card)
    v0 = torch.randn(bsr.shape[0], device=card, generator=torch.Generator(card).manual_seed(9))
    eager, graphed, launches, counts = graph_and_eager(
        lambda: eigs(bsr, k=2, v0=v0, tol=1e-9, max_subspace=24, max_restarts=5))
    assert np.array_equal(eager.eigenvalues, graphed.eigenvalues)
    assert torch.equal(eager.eigenvectors, graphed.eigenvectors)
    assert counts["captures"] >= 1 and counts["replays"] >= 1
    assert launches["bsr_spmv"] == graphed.iterations
    # shift-invert: every inner GMRES cycle one key, captured at the second solve
    eager, graphed, launches, counts = graph_and_eager(
        lambda: eigs(bsr, k=1, sigma=0.5, v0=v0, tol=1e-5, inner_tol=1e-5, max_subspace=12))
    assert np.array_equal(eager.eigenvalues, graphed.eigenvalues)
    assert torch.equal(eager.eigenvectors, graphed.eigenvectors)
    assert eager.inner_stats == graphed.inner_stats
    assert counts["captures"] >= 1 and counts["replays"] >= 1
    assert launches["bsr_spmv"] == graphed.inner_stats["matvecs"]


# ---------------------------------------------------------------------------
# row-compressed storage (eigenex_tpu_torch.sparse.sym_csr) and csr_spmv
# ---------------------------------------------------------------------------
def row_compressed_case(per_row, storage, device):
    """A SymCSRMatrix on the card, ending in padding rows: the L = 14
    Heisenberg sector (``per_row`` None), a chain (1) or a random operator of
    about 2 ``per_row`` entries a row."""
    from eigenex_tpu_torch.block.hamiltonians import heisenberg_sector_coo
    from eigenex_tpu_torch.sparse.sym_csr import sym_csr_from_triplets

    rng = np.random.default_rng(4)
    if per_row is None:
        coo = heisenberg_sector_coo(14, 7, 1.0, 1.0, False, device="cpu")
        r, c, v, n = coo.row.numpy(), coo.col.numpy(), coo.val.numpy(), coo.shape[0]
    else:
        n = 5000 if per_row == 1 else 3000
        r = np.repeat(np.arange(n), per_row)
        c = (r + 1) if per_row == 1 else rng.integers(0, n, len(r))
        keep = (r < c) & (c < n)
        key = np.unique(r[keep] * n + c[keep])
        r, c = key // n, key % n
        v = np.round(rng.standard_normal(len(r)) * 32) / 32
        r, c, v = (np.concatenate([r, c, np.arange(n)]), np.concatenate([c, r, np.arange(n)]),
                   np.concatenate([v, v, np.full(n, 2.0)]))
    return sym_csr_from_triplets(r, c, v, n + 512, storage, device, hermitian=True)


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_row,group", [(1, 1), (None, 2), (10, 4), (35, 8), (50, 16),
                                           (80, 32)])
def test_csr_spmv_matches_its_plain_version_and_replays_bit_equal(card, storage, per_row, group):
    csr = row_compressed_case(per_row, storage, card)
    assert cuda_spmv.csr_group(csr.nnz, csr.shape[0]) == group
    x = torch.randn(csr.shape[1], device=card, generator=torch.Generator(card).manual_seed(3))
    cuda_spmv.reset_launch_counts()
    y = cuda_spmv.csr_spmv(csr, x)
    assert cuda_spmv.launch_counts()["csr_spmv"] == 1
    ref = cuda_spmv.csr_spmv_plain(csr.astype(torch.float32), x)
    assert float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref)) <= 1e-5
    assert torch.equal(y, cuda_spmv.csr_spmv(csr, x))  # no atomics: bit-equal re-runs
    op = csr.as_linear_operator()
    assert op.capturable
    xs = x.clone()
    graph = torch.cuda.CUDAGraph()
    with cuda_spmv.launch_tally() as tally, torch.cuda.graph(graph):
        ys = op.matvec(xs)
    graph.replay()
    torch.cuda.synchronize()
    assert tally["csr_spmv"] == 1 and torch.equal(ys, y)
    with pytest.raises(EigenexError):
        cuda_spmv.csr_spmv(csr, x.double())
    with pytest.raises(EigenexError):
        cuda_spmv.csr_spmv(csr, x.cpu())


def test_a_low_fill_sector_is_stored_row_compressed_on_the_card(card):
    """accelerate() on the card stores the L = 14 sector row-compressed: every
    solver matvec is one csr_spmv launch, a thick restart with graphs is the
    eager solve, and the block pack made on first need gives the same
    products through sym_bsr_spmv."""
    from eigenex_tpu_torch import accelerate
    from eigenex_tpu_torch.block.hamiltonians import heisenberg_sector_coo
    from eigenex_tpu_torch.sparse.sym_csr import SymCSRMatrix

    coo = heisenberg_sector_coo(14, 7, 1.0, 1.0, False, device="cpu")
    acc = accelerate(coo, symmetric=True, device=card)
    assert isinstance(acc.matrix, SymCSRMatrix) and acc.stats["storage"] == "row_compressed"
    assert acc.matrix.dtype == torch.bfloat16
    assert acc.stats["bytes"] < acc.stats["storage_bytes"]["block"]
    v0 = np.random.default_rng(5).standard_normal(acc.orig_shape[0])
    eager, graphed, launches, counts = graph_and_eager(
        lambda: eigsh(acc, k=2, which="SA", v0=v0, tol=1e-7, max_subspace=20))
    assert np.array_equal(eager.eigenvalues, graphed.eigenvalues)
    assert counts["replays"] >= 1
    assert launches == {"bsr_spmv": 0, "sym_bsr_spmv": 0, "bsr_spmm": 0, "sym_bsr_spmm": 0,
                        "csr_spmv": graphed.iterations}
    block = acc.block_matrix()
    x = acc.embed(np.random.default_rng(6).standard_normal(acc.orig_shape[0]))
    y, yb = acc.matrix.matvec(x), block.matvec(x)
    assert float(torch.linalg.vector_norm(y - yb) / torch.linalg.vector_norm(yb)) <= 1e-6


def test_a_general_stencil_is_stored_row_compressed_on_the_card(card, tmp_path):
    """accelerate() on the card stores the nx = 64 stencil of config 2
    row-compressed (it fills about 1 % of its 32x128 pack): ``csr_spmv``
    bit-equal across re-runs and within 1e-5 of its plain version and of the
    block pack's ``bsr_spmv``; ``rmatvec`` and ``adjoint_matrix()`` the dense
    transpose; ``eigs(which="LM")`` with graphs bit-equal to the eager solve on
    both storages, every eigenvalue of each within the backward error its tol
    certifies (the top of this spectrum is ill-conditioned in f32: two such
    solves part by about 1e-3, so the storages are held to the operator, not
    to each other); ``block_matrix()`` feeds the mesh route; ``save``/``load``
    round-trips the storage."""
    import dataclasses

    from eigenex_tpu_torch import AcceleratedOperator, eigs, make_mesh

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    acc = general_stencil_on(card, 64)
    mat, sizes = acc.matrix, acc.stats["storage_bytes"]
    assert acc.stats["bytes"] == sizes["row_compressed"] < sizes["block"] / 20
    x = torch.randn(mat.shape[1], device=card, generator=torch.Generator(card).manual_seed(1))
    cuda_spmv.reset_launch_counts()
    y = mat.matvec(x)
    assert cuda_spmv.launch_counts()["csr_spmv"] == 1 and torch.equal(y, mat.matvec(x))
    assert rel(y, cuda_spmv.csr_spmv_plain(mat, x)) <= 1e-5
    block = acc.block_matrix()
    assert block.block_shape == (32, 128) and rel(y, block.matvec(x)) <= 1e-5
    dense = mat.to_dense().double()
    assert rel(mat.rmatvec(x).double(), dense.T @ x.double()) <= 1e-5
    adj = acc.adjoint_matrix()
    assert adj is mat.kernel_adjoint() and torch.equal(adj.to_dense().double(), dense.T)
    A = stencil(64).tocsr()
    v0 = np.random.default_rng(2).standard_normal(acc.orig_shape[0])
    blocked = dataclasses.replace(acc, matrix=block)
    for operand, kernel in ((acc, "csr_spmv"), (blocked, "bsr_spmv")):
        eager, graphed, launches, counts = graph_and_eager(
            lambda: eigs(operand, k=2, which="LM", tol=1e-5, v0=v0))
        assert eager.converged and np.array_equal(eager.eigenvalues, graphed.eigenvalues)
        assert np.array_equal(eager.eigenvectors, graphed.eigenvectors)
        assert counts["captures"] >= 1 and counts["replays"] >= 1
        assert launches[kernel] == sum(launches.values()) == graphed.iterations
        lam = np.asarray(graphed.eigenvalues, np.complex128)
        assert max(backward_error(A, z) for z in lam) <= np.sqrt(2) * 1e-5 * np.abs(lam).max()
    cuda_spmv.reset_launch_counts()
    on_mesh = eigs(acc, k=2, which="LM", tol=1e-5, v0=v0, mesh=make_mesh(devices=[card] * 2))
    assert on_mesh.converged and cuda_spmv.launch_counts()["csr_spmv"] == 0
    assert cuda_spmv.launch_counts()["bsr_spmv"] > 0
    lam = np.asarray(on_mesh.eigenvalues, np.complex128)
    assert max(backward_error(A, z) for z in lam) <= np.sqrt(2) * 1e-5 * np.abs(lam).max()
    acc.save(tmp_path / "stencil.npz")
    back = AcceleratedOperator.load(tmp_path / "stencil.npz", device=card)
    assert not back.matrix.hermitian and back.stats == acc.stats
    assert torch.equal(back.matrix.matvec(x), y)
    assert torch.equal(back.matrix.rmatvec(x), adj.matvec(x))


def test_shift_invert_on_a_general_stencil_gives_the_block_route_pairs(card):
    """``eigs(sigma=8.5)`` on the nx = 32 stencil (convection 0.2, where the
    pairs are well-conditioned) stored row-compressed and as its block pack:
    the same eigenvalues to 1e-5 (the storages sum each product in another
    order; they agree to 2e-7 on the CPU's plain products), every inner matvec
    -- the A^H products of the CGLS fallbacks, on the transposed storage,
    included -- and every column of the closing residual check one launch."""
    import dataclasses

    from eigenex_tpu_torch import eigs

    acc = general_stencil_on(card, 32, conv=0.2)
    v0 = np.random.default_rng(3).standard_normal(acc.orig_shape[0])
    kw = dict(k=2, sigma=8.5, tol=1e-6, inner_tol=1e-6, v0=v0)
    cuda_spmv.reset_launch_counts()
    got = eigs(acc, **kw)
    check = 2 * (2 if np.iscomplexobj(got.eigenvectors) else 1)
    assert cuda_spmv.launch_counts()["csr_spmv"] == got.inner_stats["matvecs"] + check
    want = eigs(dataclasses.replace(acc, matrix=acc.block_matrix()), **kw)
    assert got.converged and want.converged

    def key(z):
        z = np.asarray(z, np.complex128)
        return np.sort_complex(z.real + 1j * np.abs(z.imag))

    np.testing.assert_allclose(key(got.eigenvalues), key(want.eigenvalues), rtol=1e-5)


@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("kind", ["square", "rectangular", "complexified"])
def test_boundary_methods_on_card_tensors_equal_the_numpy_reference(card, kind, ndim):
    """The boundary methods of a pack on the card, given tensors on the card,
    against the host NumPy gather and scatter: bytes, dtypes, shapes, the
    error messages, and restores that return arrays of their own though they
    share one pinned staging buffer."""
    acc = embed_reference.operator(kind, torch.float32, card)
    embed_reference.check_against_reference(acc, str(card), ndim)


def test_an_accelerated_solve_copies_only_its_answer_to_the_host(card, monkeypatch):
    """On the card an embed of a card ``v0`` copies nothing to the host and a
    restore copies its k answers once; a solve and its restore leave no
    permutation on the card; and ``eigsh`` gives the bytes and iterations of
    the host route, to which the same start vector goes through NumPy."""
    from eigenex_tpu_torch import accelerate
    from eigenex_tpu_torch.block.hamiltonians import heisenberg_sector_coo
    from eigenex_tpu_torch.sparse.accelerate import AcceleratedOperator
    from eigenex_tpu_torch.utils import profiling

    acc = accelerate(heisenberg_sector_coo(14, 7, 1.0, 1.0, False, device="cpu"),
                     symmetric=True, device=card)
    n = acc.orig_shape[0]
    v0 = torch.randn(n, generator=torch.Generator(card).manual_seed(3), device=card)
    solve = dict(k=4, which="SA", tol=1e-8, max_subspace=20, v0=v0)
    eigsh(acc, **solve)  # the first solve makes the cached host index and the workspaces
    torch.cuda.synchronize(card)
    profiling.reset_counters("accelerate.")
    acc.embed(v0)
    assert profiling.counters("accelerate.").get("accelerate.d2h_bytes", 0) == 0
    acc.restore(torch.zeros((acc.shape[0], 4), device=card))
    assert profiling.counters("accelerate.")["accelerate.d2h_bytes"] == 4 * n * 4
    before = torch.cuda.memory_allocated(card)
    got = eigsh(acc, **solve)
    torch.cuda.synchronize(card)
    assert torch.cuda.memory_allocated(card) == before
    monkeypatch.setattr(AcceleratedOperator, "embed",
                        lambda self, v: embed_reference.embed(self, v).to(self.device))
    monkeypatch.setattr(AcceleratedOperator, "restore", embed_reference.restore)
    want = eigsh(acc, **solve)
    assert got.iterations == want.iterations and got.converged
    assert got.eigenvalues.tobytes() == want.eigenvalues.tobytes()
    assert got.eigenvectors.dtype == want.eigenvectors.dtype
    assert got.eigenvectors.tobytes() == want.eigenvectors.tobytes()

