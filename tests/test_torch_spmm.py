"""SpMM parity: the port's plain versions against the JAX package's Pallas
SpMM kernels run in interpret mode on the CPU.

The same numpy-seeded operator and (n, p) panel go through both packages.
The plain versions (``bsr_spmm_plain``, ``sym_bsr_spmm_plain``) are what the
port runs on the CPU and what the CUDA kernels are held against on the card,
so this pins them to every kernel of the reference: the general kernel, and
the symmetric resident, streaming and ring kernels, f32 and bf16 storage, at
panel widths p in {1, 5, 8, 12}.

Tolerances: f32 storage, relative error <= 1e-5 in the Frobenius norm (both
sides accumulate in f32, in different orders).  bf16 storage against the
reference's own limit for its SpMM kernels, ``2e-2 * max|Y|`` elementwise
(the TPU kernels split X into bf16 parts; the port widens the blocks to f32
exactly, and is far inside that limit).  The streaming and ring entry points
take X as ``(nbc, p, bn)`` slabs with p a multiple of 8, so narrower panels
are zero-padded to 8 columns for them, as the reference's dispatcher does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.ops.pallas_spmv import (
    _pick_ring_params_mm,
    _sdot,
    _sym_ring_matmat_call,
    _sym_stream_matmat_call,
    bsr_matmat_pallas,
    sym_bsr_matmat_pallas,
)
from eigenex_tpu.sparse.bsr import BSRMatrix as JBSR
from eigenex_tpu.sparse.sym_bsr import SymBSRMatrix as JSym
from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr as j_sym_bsr_from_bsr
from eigenex_tpu_torch.convert import sym_bsr_from_numpy
from eigenex_tpu_torch.ops.cuda_spmv import (
    bsr_spmm,
    bsr_spmm_plain,
    bsr_spmv_plain,
    launch_counts,
    reset_launch_counts,
    split_bf16x3,
    split_tf32,
    spmm_split_model,
    spmm_split_terms,
    sym_bsr_spmm,
    sym_bsr_spmm_plain,
    sym_bsr_spmv_plain,
)
from test_torch_spmv import (
    DTYPES,
    REL_TOL,
    banded_bsr,
    far_reach_sym,
    port_bsr,
    port_sym,
    sym_banded_bsr,
)

torch.set_num_threads(1)

WIDTHS = [1, 5, 8, 12]
STORAGE_WIDTHS = [("f32", p) for p in WIDTHS] + [("bf16", p) for p in WIDTHS]


def panel(n, p, seed):
    return np.random.default_rng(seed).standard_normal((n, p)).astype(np.float32)


def slabs(X, bn):
    """(n, p) -> the reference's (nbc, p8, bn) slab layout, p padded to 8."""
    n, p = X.shape
    p8 = max(8, -(-p // 8) * 8)
    Xp = np.zeros((n, p8), np.float32)
    Xp[:, :p] = X
    return jnp.asarray(Xp.reshape(-1, bn, p8).transpose(0, 2, 1))


def from_slabs(y3, p):
    y3 = np.asarray(y3)
    return y3.transpose(0, 2, 1).reshape(-1, y3.shape[1])[:, :p]


def assert_close(Y_port, Y_ref, storage):
    Y_port = Y_port.numpy()
    Y_ref = np.asarray(Y_ref)
    assert Y_port.dtype == np.float32 and Y_ref.dtype == np.float32
    assert Y_port.shape == Y_ref.shape
    if storage == "f32":
        rel = np.linalg.norm(Y_port - Y_ref) / np.linalg.norm(Y_ref)
        assert rel <= REL_TOL, rel
    else:
        np.testing.assert_allclose(Y_port, Y_ref, rtol=0, atol=2e-2 * np.abs(Y_ref).max())


# -- general kernel ------------------------------------------------------------
@pytest.mark.parametrize("storage,p", STORAGE_WIDTHS)
def test_bsr_spmm_plain_matches_pallas_interpret(storage, p):
    jdt, tdt = DTYPES[storage]
    jbsr = banded_bsr(8, 128).astype(jdt)
    X = panel(jbsr.shape[1], p, 2 + p)
    Y_ref = bsr_matmat_pallas(jbsr, jnp.asarray(X), interpret=True)
    assert_close(bsr_spmm_plain(port_bsr(jbsr, tdt), torch.as_tensor(X)), Y_ref, storage)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_bsr_spmm_plain_matches_pallas_interpret_8x128_blocks(storage):
    jdt, tdt = DTYPES[storage]
    rng = np.random.default_rng(5)
    nbr, kmax, bm, bn, nbc = 16, 3, 8, 128, 4
    data = rng.standard_normal((nbr, kmax, bm, bn)).astype(np.float32)
    cols = rng.integers(0, nbc, size=(nbr, kmax)).astype(np.int32)
    data[3, 2] = 0  # an ELL padding slot: column 0, zero block
    cols[3, 2] = 0
    jbsr = JBSR(jnp.asarray(data), jnp.asarray(cols), (nbr * bm, nbc * bn)).astype(jdt)
    X = panel(nbc * bn, 5, 6)
    Y_ref = bsr_matmat_pallas(jbsr, jnp.asarray(X), interpret=True)
    assert_close(bsr_spmm_plain(port_bsr(jbsr, tdt), torch.as_tensor(X)), Y_ref, storage)


# -- symmetric kernels: the three kernels of the reference -----------------------
@pytest.mark.parametrize("storage,p", STORAGE_WIDTHS)
def test_sym_spmm_plain_matches_resident_kernel(storage, p):
    jdt, tdt = DTYPES[storage]
    jsym = j_sym_bsr_from_bsr(sym_banded_bsr(16, 128)).astype(jdt)
    X = panel(jsym.shape[1], p, 10 + p)
    Y_ref = sym_bsr_matmat_pallas(jsym, jnp.asarray(X), interpret=True)
    assert_close(sym_bsr_spmm_plain(port_sym(jsym, tdt), torch.as_tensor(X)), Y_ref, storage)


@pytest.mark.parametrize("storage,p", STORAGE_WIDTHS)
def test_sym_spmm_plain_matches_stream_kernel(storage, p):
    jdt, tdt = DTYPES[storage]
    jsym = j_sym_bsr_from_bsr(sym_banded_bsr(32, 128, seed=2)).astype(jdt)
    assert jsym.band_reach == 1
    X = panel(jsym.shape[1], p, 30 + p)
    y3 = _sym_stream_matmat_call(jsym, slabs(X, 128), 8, interpret=True)  # 4 strips: carry
    assert_close(sym_bsr_spmm_plain(port_sym(jsym, tdt), torch.as_tensor(X)),
                 from_slabs(y3, p), storage)


@pytest.mark.parametrize("storage,p", STORAGE_WIDTHS)
def test_sym_spmm_plain_matches_ring_kernel(storage, p):
    jdt, tdt = DTYPES[storage]
    nbr, bm, reach = 32, 8, 7
    jsym = far_reach_sym(nbr, bm, reach, seed=3).astype(jdt)
    assert jsym.band_reach == reach
    s, W = _pick_ring_params_mm(nbr, jsym.upper_cols.shape[1], bm, bm, 8,
                                jsym.upper_data.dtype.itemsize, reach)
    assert s > 0
    X = panel(jsym.shape[1], p, 2)
    y3 = _sym_ring_matmat_call(jsym, slabs(X, bm), s, W, True)
    assert_close(sym_bsr_spmm_plain(port_sym(jsym, tdt), torch.as_tensor(X)),
                 from_slabs(y3, p), storage)


def test_sym_spmm_plain_unknown_reach_matches_resident_kernel():
    j0 = j_sym_bsr_from_bsr(sym_banded_bsr(16, 128, seed=4))
    jsym = JSym(j0.diag_data, j0.upper_data, j0.upper_cols, j0.shape)
    assert jsym.band_reach == -1
    X = panel(jsym.shape[1], 8, 25)
    Y_ref = sym_bsr_matmat_pallas(jsym, jnp.asarray(X), interpret=True, rows_per=4)
    assert_close(sym_bsr_spmm_plain(port_sym(jsym, torch.float32), torch.as_tensor(X)),
                 Y_ref, "f32")


def test_sym_spmm_plain_f64_matches_reference_plain():
    """f64 storage takes the plain route in both packages; 1e-13 relative."""
    jsym = j_sym_bsr_from_bsr(sym_banded_bsr(8, 8, dtype=np.float64, seed=9))
    X = np.random.default_rng(2).standard_normal((jsym.shape[1], 5))
    Y_ref = np.asarray(jsym._xla_matmat(jnp.asarray(X)))
    psym = sym_bsr_from_numpy(np.asarray(jsym.diag_data), np.asarray(jsym.upper_data),
                              np.asarray(jsym.upper_cols), jsym.shape, jsym.band_reach,
                              device="cpu")
    reset_launch_counts()
    Y = psym.matmat(torch.as_tensor(X)).numpy()
    assert Y.dtype == np.float64
    assert np.linalg.norm(Y - Y_ref) <= 1e-13 * np.linalg.norm(Y_ref)
    assert launch_counts()["sym_bsr_spmm"] == 0


# -- one column is the matvec ----------------------------------------------------
@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_one_column_equals_the_matvec_plain_versions(storage):
    _, tdt = DTYPES[storage]
    psym = port_sym(j_sym_bsr_from_bsr(sym_banded_bsr(8, 128, seed=6)), tdt)
    pbsr = port_bsr(sym_banded_bsr(8, 128, seed=6), tdt)
    x = torch.as_tensor(panel(psym.shape[1], 1, 7))
    for spmm, spmv, op in ((sym_bsr_spmm_plain, sym_bsr_spmv_plain, psym),
                           (bsr_spmm_plain, bsr_spmv_plain, pbsr)):
        Y, y = spmm(op, x), spmv(op, x[:, 0])
        assert Y.shape == (op.shape[0], 1)
        rel = float(torch.linalg.vector_norm(Y[:, 0] - y) / torch.linalg.vector_norm(y))
        assert rel <= REL_TOL


# -- routing and counters --------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    psym = port_sym(j_sym_bsr_from_bsr(sym_banded_bsr(4, 128)), torch.float32)
    pbsr = port_bsr(sym_banded_bsr(4, 128), torch.float32)
    X = torch.as_tensor(panel(psym.shape[1], 5, 0))
    reset_launch_counts()
    assert torch.equal(sym_bsr_spmm(psym, X), sym_bsr_spmm_plain(psym, X))
    assert torch.equal(bsr_spmm(pbsr, X), bsr_spmm_plain(pbsr, X))
    assert torch.equal(psym.matmat(X), sym_bsr_spmm_plain(psym, X))
    assert torch.equal(pbsr.matmat(X), bsr_spmm_plain(pbsr, X))
    assert torch.equal(psym.as_linear_operator().matmat(X), sym_bsr_spmm_plain(psym, X))
    # a transposed view of basis rows, as block Lanczos hands it over
    Xt = X.T.contiguous().T
    assert not Xt.is_contiguous()
    assert torch.equal(psym.matmat(Xt), sym_bsr_spmm_plain(psym, X))
    assert launch_counts() == {"bsr_spmv": 0, "sym_bsr_spmv": 0, "bsr_spmm": 0,
                               "sym_bsr_spmm": 0, "csr_spmv": 0}


def test_sym_spmm_plain_against_to_dense_any_reach():
    """Scattered columns, padding slots, unknown reach: the plain version is
    the dense product (f64 oracle, 1e-5 of max|Y| for f32 sums)."""
    rng = np.random.default_rng(11)
    nbr, ku, b = 24, 3, 8
    cols = np.zeros((nbr, ku), np.int32)
    upper = rng.standard_normal((nbr, ku, b, b)).astype(np.float32)
    for r in range(nbr):
        take = min(ku, nbr - 1 - r, int(rng.integers(0, ku + 1)))
        pick = np.sort(rng.choice(nbr - 1 - r, size=take, replace=False)) if take else []
        cols[r, :take] = r + 1 + np.asarray(pick, np.int32)
        upper[r, take:] = 0  # padding slots: column 0, zero block
    d = rng.standard_normal((nbr, b, b)).astype(np.float32)
    sym = sym_bsr_from_numpy((d + d.transpose(0, 2, 1)) / 2, upper, cols,
                             (nbr * b, nbr * b), -1, device="cpu")
    X = torch.as_tensor(panel(nbr * b, 12, 3))
    want = sym.to_dense().double() @ X.double()
    got = sym_bsr_spmm_plain(sym, X).double()
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


# -- the arithmetic of the CUDA SpMM kernels, modelled in plain torch -------------
# The kernels multiply on the tensor cores and compensate to f32 grade: X in
# three bf16 parts under bf16 blocks, both sides in a TF32 big and small part
# under f32 blocks.  The helpers beside the kernels repeat the splits and the
# products; here they are held to the f64 product, per column, at the limit
# the kernels are held to on the card (1e-5).
SPLIT_TOL = 1e-5
KINDS = ["sym", "bsr"]


def small_operator(kind, storage, dyadic=False, seed=12):
    """8 block rows of 128x128, banded; dyadic blocks are bf16-exact."""
    _, tdt = DTYPES[storage]
    jbsr = sym_banded_bsr(8, 128, seed=seed)
    if dyadic:
        jbsr = JBSR(jnp.round(jbsr.data * 8) / 8, jbsr.block_cols, jbsr.shape)
    if kind == "sym":
        return port_sym(j_sym_bsr_from_bsr(jbsr), tdt)
    return port_bsr(jbsr, tdt)


def plain_of(op):
    return sym_bsr_spmm_plain if hasattr(op, "upper_data") else bsr_spmm_plain


def worst_column_error(Y, op, X):
    """Largest relative error of a column of Y against the f64 product."""
    want = plain_of(op)(op.astype(torch.float64), X.double())
    err = torch.linalg.vector_norm(Y.double() - want, dim=0)
    return float((err / torch.linalg.vector_norm(want, dim=0)).max())


def test_split_bf16x3_parts_sum_back_bit_exactly():
    rng = np.random.default_rng(40)
    x = rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096)
    x = torch.as_tensor(x.astype(np.float32))
    hi, mid, lo = split_bf16x3(x)
    for part in (hi, mid, lo):
        assert part.dtype == torch.float32
        assert torch.equal(part.to(torch.bfloat16).to(torch.float32), part)
    assert torch.equal(hi + mid + lo, x)
    # hi alone is x to 8 bits: the single pass that must never be taken
    assert float(((x - hi).abs() / x.abs()).max()) > 1e-3


@pytest.mark.parametrize("decades", [0, 6, 30])
def test_split_bf16x3_is_the_split_of_the_reference_sdot(decades, monkeypatch):
    """The same numpy-seeded x through ``_sdot`` of the JAX package (mode
    "split") and through the port's split: the operands ``_sdot`` hands to its
    three bf16 passes are the port's hi, mid and lo, bit for bit.  ``_sdot``
    leaves its third operand in f32 and lets the bf16 pass round it; it is
    bf16-exact already, so nothing is lost there and the parts agree as f32."""
    rng = np.random.default_rng(42 + decades)
    x = (rng.standard_normal((8, 128)) * 10.0 ** rng.uniform(-decades, decades, (8, 128)))
    x = x.astype(np.float32)
    handed = []
    dot_general = jax.lax.dot_general

    def recording(lhs, rhs, *args, **kwargs):
        handed.append(np.array(lhs))
        return dot_general(lhs, rhs, *args, **kwargs)

    monkeypatch.setattr(jax.lax, "dot_general", recording)
    _sdot(jnp.asarray(x), jnp.eye(128, dtype=jnp.float32), ((1,), (0,)), "split")
    monkeypatch.undo()
    assert len(handed) == 3
    for ours, theirs in zip(split_bf16x3(torch.as_tensor(x)), handed):
        assert theirs.dtype == np.float32
        assert np.array_equal(ours.numpy().view(np.int32), theirs.view(np.int32))
    lo = torch.as_tensor(handed[2])
    assert torch.equal(lo.to(torch.bfloat16).to(torch.float32), lo)


def test_split_tf32_stays_finite_up_to_the_largest_f32():
    """Rounding to 10 mantissa bits must not carry the largest finite values
    to infinity (inf - inf in the small part would poison the product)."""
    top = float(np.finfo(np.float32).max)
    x = torch.tensor([top, -top, top * (1 - 2.0 ** -12), 1.0], dtype=torch.float32)
    big, small = split_tf32(x)
    assert bool(torch.isfinite(big).all()) and bool(torch.isfinite(small).all())
    assert float(((x - big - small).abs() / x.abs()).max()) <= 2.0 ** -20


def test_split_tf32_big_and_small_parts():
    rng = np.random.default_rng(41)
    x = rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096)
    x = torch.as_tensor(x.astype(np.float32))
    big, small = split_tf32(x)
    for part in (big, small):  # 13 mantissa bits masked: TF32 operands
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = lambda d: float((d.abs() / x.abs()).max())
    assert 1e-5 < rel(x - big) <= 2.0 ** -11        # round to nearest at 10 bits
    assert rel(x - big - small) <= 2.0 ** -20       # the remainder, cut at 10 more bits
    # a tie rounds away from zero, for either sign
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(split_tf32(tie)[0], torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))


@pytest.mark.parametrize("p", [1, 8, 12])
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_split_model_matches_f64_product_per_column(kind, storage, p):
    op = small_operator(kind, storage)
    X = torch.as_tensor(panel(op.shape[1], p, 50 + p))
    Y = spmm_split_model(op, X)
    assert Y.dtype == torch.float64 and Y.shape == (op.shape[0], p)
    assert worst_column_error(Y, op, X) <= SPLIT_TOL


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_split_model_badly_scaled_columns_dyadic_blocks(kind, storage):
    """Columns of X spanning 1e-6..1e6 on bf16-exact blocks: every column is
    right to 1e-5 of ITS norm, which a norm over the panel would not show."""
    op = small_operator(kind, storage, dyadic=True)
    scale = np.float32(10.0) ** np.linspace(-6, 6, 12, dtype=np.float32)
    X = torch.as_tensor(panel(op.shape[1], 12, 60) * scale[None, :])
    assert worst_column_error(spmm_split_model(op, X), op, X) <= SPLIT_TOL


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_single_pass_model_misses_the_limit(kind, storage):
    """The one-pass product (hi only, big x big only) is what the kernels must
    not take; the per-column check sees it: over ten times the limit (TF32
    keeps 11 bits of X, bf16 8)."""
    op = small_operator(kind, storage, dyadic=True)
    X = torch.as_tensor(panel(op.shape[1], 8, 61))
    blocks, part = spmm_split_terms(op, X)[-1]  # the leading product alone
    one_pass = plain_of(op)(blocks.astype(torch.float64), part.double())
    assert worst_column_error(one_pass, op, X) > 10 * SPLIT_TOL
