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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.ops.pallas_spmv import (
    _pick_ring_params_mm,
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
                               "sym_bsr_spmm": 0}


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
