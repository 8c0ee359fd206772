"""SpMV parity: the port's plain versions against the JAX package's Pallas
kernels run in interpret mode on the CPU.

The same numpy-seeded operator and vector go through both packages.  The
plain versions (``bsr_spmv_plain``, ``sym_bsr_spmv_plain``) are what the
port runs on the CPU and what the CUDA kernels are held against on the card,
so this pins them to every regime of the reference: the general kernel, and
the symmetric streaming, resident and ring kernels, f32 and bf16 storage.

Tolerance: relative error <= 1e-5 in the 2-norm.  Both sides accumulate in
f32 (the reference at HIGHEST precision for f32 blocks, with x split into
three bf16 parts for bf16 blocks), in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.ops.pallas_spmv import (
    _pick_ring_params,
    _sym_ring_call,
    _sym_stream_call,
    bsr_matvec_pallas,
    sym_bsr_matvec_pallas,
)
from eigenex_tpu.sparse.bsr import BSRMatrix as JBSR
from eigenex_tpu.sparse.bsr import bsr_from_coo_arrays as j_bsr_from_coo_arrays
from eigenex_tpu.sparse.sym_bsr import SymBSRMatrix as JSym
from eigenex_tpu.sparse.sym_bsr import sym_bsr_from_bsr as j_sym_bsr_from_bsr
from eigenex_tpu_torch.convert import bsr_from_numpy, sym_bsr_from_numpy
from eigenex_tpu_torch.ops.cuda_spmv import (
    SPMV_TILE_ROWS,
    bsr_spmv,
    bsr_spmv_plain,
    launch_counts,
    reset_launch_counts,
    sym_bsr_spmv,
    sym_bsr_spmv_plain,
    sym_spmv_scratch_shape,
)
from eigenex_tpu_torch.utils.exceptions import EigenexError

torch.set_num_threads(1)

REL_TOL = 1e-5
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


# -- generators: the recipes of tests/test_pallas.py, copied -----------------
def banded_bsr(nbr, bm, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(nbr):
        for c in (r - 1, r, r + 1):
            if 0 <= c < nbr:
                blk = rng.standard_normal((bm, bm)).astype(dtype)
                rr, cc = np.meshgrid(np.arange(bm), np.arange(bm), indexing="ij")
                rows.append(r * bm + rr.ravel())
                cols.append(c * bm + cc.ravel())
                vals.append(blk.ravel())
    n = nbr * bm
    return j_bsr_from_coo_arrays(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n), (bm, bm)
    )


def sym_banded_bsr(nbr, bm, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    kmax = 3
    data = np.zeros((nbr, kmax, bm, bm), dtype)
    cols = np.zeros((nbr, kmax), np.int32)
    diag = rng.standard_normal((nbr, bm, bm)).astype(dtype)
    off = rng.standard_normal((nbr - 1, bm, bm)).astype(dtype)
    for r in range(nbr):
        data[r, 0] = (diag[r] + diag[r].T) / 2
        cols[r, 0] = r
        slot = 1
        if r > 0:
            data[r, slot] = off[r - 1].T
            cols[r, slot] = r - 1
            slot += 1
        if r + 1 < nbr:
            data[r, slot] = off[r]
            cols[r, slot] = r + 1
    n = nbr * bm
    return JBSR(jnp.asarray(data), jnp.asarray(cols), (n, n))


def far_reach_sym(nbr, bm, reach, seed=0):
    """Symmetric matrix whose upper blocks sit at distance ``reach`` (plus a
    near band) -- the shape of TestSymRingKernel."""
    rng = np.random.default_rng(seed)
    n = nbr * bm
    rows, cols, vals = [], [], []
    for br in range(nbr):
        r0 = br * bm
        d = rng.standard_normal((bm, bm))
        d = (d + d.T) / 2
        rr, cc = np.nonzero(np.abs(d) > 1.2)
        rows.append(r0 + rr); cols.append(r0 + cc); vals.append(d[rr, cc])
        for dist in (1, reach):
            if br + dist < nbr:
                o = rng.standard_normal((bm, bm))
                rr, cc = np.nonzero(np.abs(o) > 1.4)
                rows.append(r0 + rr); cols.append(r0 + dist * bm + cc)
                vals.append(o[rr, cc])
                rows.append(r0 + dist * bm + cc); cols.append(r0 + rr)
                vals.append(o[rr, cc])
    r = np.concatenate(rows); c = np.concatenate(cols); v = np.concatenate(vals)
    key = r.astype(np.int64) * n + c
    order = np.argsort(key)
    key, v = key[order], v[order]
    uniq, start = np.unique(key, return_index=True)
    v = np.add.reduceat(v, start)
    r, c = (uniq // n).astype(np.int64), (uniq % n).astype(np.int64)
    bsr = j_bsr_from_coo_arrays(r, c, v.astype(np.float32), (n, n), (bm, bm))
    return j_sym_bsr_from_bsr(bsr)


# -- carrying an operator across ---------------------------------------------
def port_bsr(jbsr, tdtype):
    return bsr_from_numpy(
        np.asarray(jbsr.data.astype(jnp.float32)), np.asarray(jbsr.block_cols),
        jbsr.shape, dtype=tdtype, device="cpu",
    )


def port_sym(jsym, tdtype):
    return sym_bsr_from_numpy(
        np.asarray(jsym.diag_data.astype(jnp.float32)),
        np.asarray(jsym.upper_data.astype(jnp.float32)),
        np.asarray(jsym.upper_cols), jsym.shape, jsym.band_reach,
        dtype=tdtype, device="cpu",
    )


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def assert_close(y_port, y_ref):
    y_port = y_port.numpy()
    y_ref = np.asarray(y_ref)
    assert y_port.dtype == np.float32 and y_ref.dtype == np.float32
    rel = np.linalg.norm(y_port - y_ref) / np.linalg.norm(y_ref)
    assert rel <= REL_TOL, rel


# -- general kernel ------------------------------------------------------------
@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_bsr_plain_matches_pallas_interpret(storage):
    jdt, tdt = DTYPES[storage]
    jbsr = banded_bsr(16, 128).astype(jdt)
    x = vec(jbsr.shape[1], 1)
    y_ref = bsr_matvec_pallas(jbsr, jnp.asarray(x), interpret=True)
    assert_close(bsr_spmv_plain(port_bsr(jbsr, tdt), torch.as_tensor(x)), y_ref)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_bsr_plain_matches_pallas_interpret_8x128_blocks(storage):
    jdt, tdt = DTYPES[storage]
    rng = np.random.default_rng(5)
    nbr, kmax, bm, bn, nbc = 16, 3, 8, 128, 4
    data = rng.standard_normal((nbr, kmax, bm, bn)).astype(np.float32)
    cols = rng.integers(0, nbc, size=(nbr, kmax)).astype(np.int32)
    data[3, 2] = 0  # an ELL padding slot: column 0, zero block
    cols[3, 2] = 0
    jbsr = JBSR(jnp.asarray(data), jnp.asarray(cols), (nbr * bm, nbc * bn)).astype(jdt)
    x = vec(nbc * bn, 6)
    y_ref = bsr_matvec_pallas(jbsr, jnp.asarray(x), interpret=True)
    assert_close(bsr_spmv_plain(port_bsr(jbsr, tdt), torch.as_tensor(x)), y_ref)


# -- symmetric kernels: the three regimes of the reference ---------------------
@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_sym_plain_matches_pallas_dispatcher(storage):
    jdt, tdt = DTYPES[storage]
    jsym = j_sym_bsr_from_bsr(sym_banded_bsr(16, 128)).astype(jdt)
    x = vec(jsym.shape[1], 3)
    y_ref = sym_bsr_matvec_pallas(jsym, jnp.asarray(x), interpret=True)
    assert_close(sym_bsr_spmv_plain(port_sym(jsym, tdt), torch.as_tensor(x)), y_ref)


@pytest.mark.parametrize("storage,strip", [("f32", 8), ("f32", 16), ("bf16", 8)])
def test_sym_plain_matches_stream_kernel(storage, strip):
    jdt, tdt = DTYPES[storage]
    jsym = j_sym_bsr_from_bsr(sym_banded_bsr(32, 128, seed=2)).astype(jdt)
    assert jsym.band_reach == 1
    x = vec(jsym.shape[1], 21)
    y_ref = _sym_stream_call(jsym, jnp.asarray(x), strip, interpret=True)  # carry exercised
    assert_close(sym_bsr_spmv_plain(port_sym(jsym, tdt), torch.as_tensor(x)), y_ref)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_sym_plain_matches_resident_kernel(storage):
    jdt, tdt = DTYPES[storage]
    j0 = j_sym_bsr_from_bsr(sym_banded_bsr(16, 128, seed=4)).astype(jdt)
    # unknown reach, rows_per forced: the resident kernel with its cross-row scatter
    jsym = JSym(j0.diag_data, j0.upper_data, j0.upper_cols, j0.shape)
    assert jsym.band_reach == -1
    x = vec(jsym.shape[1], 25)
    y_ref = sym_bsr_matvec_pallas(jsym, jnp.asarray(x), interpret=True, rows_per=4)
    psym = port_sym(jsym, tdt)
    assert psym.band_reach == -1
    assert_close(sym_bsr_spmv_plain(psym, torch.as_tensor(x)), y_ref)


@pytest.mark.parametrize("storage,reach", [("f32", 3), ("f32", 7), ("bf16", 7)])
def test_sym_plain_matches_ring_kernel(storage, reach):
    jdt, tdt = DTYPES[storage]
    nbr, bm = 32, 8
    jsym = far_reach_sym(nbr, bm, reach).astype(jdt)
    assert jsym.band_reach == reach
    s, W = _pick_ring_params(nbr, jsym.upper_cols.shape[1], bm, bm,
                             jsym.upper_data.dtype.itemsize, reach)
    assert s > 0
    x = vec(jsym.shape[1], 1)
    y_ref = _sym_ring_call(jsym, jnp.asarray(x), s, W, True)
    assert_close(sym_bsr_spmv_plain(port_sym(jsym, tdt), torch.as_tensor(x)), y_ref)


def test_sym_plain_f64_matches_reference_plain():
    """f64 storage takes the plain route in both packages; 1e-13 relative."""
    jsym = j_sym_bsr_from_bsr(sym_banded_bsr(8, 8, dtype=np.float64, seed=9))
    x = np.random.default_rng(2).standard_normal(jsym.shape[1])
    y_ref = np.asarray(jsym._xla_matvec(jnp.asarray(x)))
    psym = sym_bsr_from_numpy(np.asarray(jsym.diag_data), np.asarray(jsym.upper_data),
                              np.asarray(jsym.upper_cols), jsym.shape, jsym.band_reach,
                              device="cpu")
    y = psym.matvec(torch.as_tensor(x)).numpy()
    assert y.dtype == np.float64
    assert np.linalg.norm(y - y_ref) <= 1e-13 * np.linalg.norm(y_ref)


# -- routing and counters --------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    jsym = j_sym_bsr_from_bsr(sym_banded_bsr(4, 128))
    psym = port_sym(jsym, torch.float32)
    pbsr = port_bsr(sym_banded_bsr(4, 128), torch.float32)
    x = torch.as_tensor(vec(psym.shape[1], 0))
    reset_launch_counts()
    assert torch.equal(sym_bsr_spmv(psym, x), sym_bsr_spmv_plain(psym, x))
    assert torch.equal(bsr_spmv(pbsr, x), bsr_spmv_plain(pbsr, x))
    assert torch.equal(psym.matvec(x), sym_bsr_spmv_plain(psym, x))
    assert launch_counts() == {"bsr_spmv": 0, "sym_bsr_spmv": 0, "bsr_spmm": 0, "sym_bsr_spmm": 0,
                               "csr_spmv": 0}


# -- the column index of the kernel's second pass ---------------------------------
def two_pass(sym, x):
    """The kernel's schedule in plain torch: pass 1 writes the direct part and
    the transposed partials of the REAL slots, pass 2 adds the partials per
    block column in the order of the column index."""
    b = sym.block_shape[0]
    nbr, ku = sym.upper_cols.shape
    xb = x.reshape(nbr, b).double()
    diag, upper = sym.diag_data.double(), sym.upper_data.double()
    cols = sym.upper_cols.long()
    real = cols > torch.arange(nbr)[:, None]
    y = torch.einsum("rij,rj->ri", diag, xb)
    y += torch.einsum("rkij,rkj->ri", upper * real[:, :, None, None], xb[cols])
    t = torch.einsum("rkij,ri->rkj", upper, xb).reshape(nbr * ku, b)
    col_ptr, slot_ids = sym.column_index()
    for c in range(nbr):
        for s in slot_ids[col_ptr[c]:col_ptr[c + 1]].tolist():
            y[c] += t[s]
    return y.reshape(-1)


@pytest.mark.parametrize("kind", ["far_reach", "scattered"])
def test_column_index_against_to_dense(kind):
    if kind == "far_reach":
        sym = port_sym(far_reach_sym(32, 8, 7, seed=1), torch.float32)
    else:
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
    nbr, ku = sym.upper_cols.shape
    b = sym.block_shape[0]
    col_ptr, slot_ids = sym.column_index()
    assert col_ptr.dtype == torch.int32 and slot_ids.dtype == torch.int32
    assert col_ptr.shape == (nbr + 1,) and int(col_ptr[0]) == 0
    assert int(col_ptr[-1]) == slot_ids.numel()
    assert sym.column_index()[1] is slot_ids  # built once, cached

    dense = sym.to_dense().numpy()
    blocks = dense.reshape(nbr, b, nbr, b).transpose(0, 2, 1, 3)
    nonzero_upper = {(r, c) for r in range(nbr) for c in range(r + 1, nbr)
                     if np.any(blocks[r, c])}
    listed = set()
    for c in range(nbr):
        slots = slot_ids[col_ptr[c]:col_ptr[c + 1]].tolist()
        assert slots == sorted(slots)  # fixed (r, k) order: deterministic sums
        for s in slots:
            r, k = divmod(s, ku)
            assert int(sym.upper_cols[r, k]) == c and c > r
            listed.add((r, c))
    assert listed == nonzero_upper
    # no padding slot is listed: block column 0 has no strictly-upper block
    assert int(col_ptr[1]) == 0

    x = torch.as_tensor(np.random.default_rng(3).standard_normal(nbr * b))
    want = torch.as_tensor(dense).double() @ x
    assert torch.allclose(two_pass(sym, x), want, rtol=0, atol=1e-12 * float(want.abs().max()))
    got = sym_bsr_spmv_plain(sym, x.float()).double()
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("where", ["below_diagonal", "on_diagonal", "column_0"])
def test_column_index_rejects_block_not_above_diagonal(where):
    """The kernel skips every slot whose column is not above the diagonal,
    the plain version applies it: such a container must raise, not differ."""
    nbr, ku, b = 8, 2, 8
    rng = np.random.default_rng(5)
    d = rng.standard_normal((nbr, b, b)).astype(np.float32)
    upper = np.zeros((nbr, ku, b, b), np.float32)
    cols = np.zeros((nbr, ku), np.int32)
    for r in range(nbr - 1):
        cols[r, 0] = r + 1
        upper[r, 0] = rng.standard_normal((b, b))
    sym_bsr_from_numpy(d, upper, cols, (nbr * b,) * 2, 1, device="cpu").column_index()  # canonical
    cols[5, 1] = {"below_diagonal": 3, "on_diagonal": 5, "column_0": 0}[where]
    upper[5, 1] = rng.standard_normal((b, b))
    sym = sym_bsr_from_numpy(d, upper, cols, (nbr * b,) * 2, 1, device="cpu")
    with pytest.raises(EigenexError, match="at or below the diagonal"):
        sym.column_index()


# -- the host side of the SpMV kernel's schedule: units and scratch ---------------
def scattered_sym(nbr, ku, b, seed):
    """Random columns above the diagonal, fewer in some rows (padding: column
    0, zero block), and one column that every row above it reaches."""
    rng = np.random.default_rng(seed)
    cols = np.zeros((nbr, ku), np.int32)
    upper = rng.standard_normal((nbr, ku, b, b)).astype(np.float32)
    for r in range(nbr - 1):
        avail = nbr - 2 - r  # columns r + 1 .. nbr - 2, beside the hub column nbr - 1
        take = min(ku - 1, avail, int(rng.integers(0, ku)))
        pick = sorted((r + 1 + rng.choice(avail, size=take, replace=False)).tolist()) if take else []
        pick.append(nbr - 1)
        cols[r, :len(pick)] = pick
        upper[r, len(pick):] = 0
    upper[nbr - 1] = 0  # the last block row has no block above the diagonal
    d = rng.standard_normal((nbr, b, b)).astype(np.float32)
    return sym_bsr_from_numpy((d + d.transpose(0, 2, 1)) / 2, upper, cols, (nbr * b,) * 2, -1,
                              device="cpu")


def scheduled(sym, x, order):
    """The SpMV kernel's schedule in plain torch (f64): units of
    SPMV_TILE_ROWS rows of a block row, taken in ``order``, each writing its
    direct rows of y and one transposed partial per real slot into the
    scratch of ``sym_spmv_scratch_shape``; then pass 2 adds each column's
    partials in the order of the column index, row tiles in order."""
    nbr, ku, b, _ = sym.upper_data.shape
    tiles = b // SPMV_TILE_ROWS
    tbuf = torch.full(sym_spmv_scratch_shape(nbr, ku, b), float("nan"), dtype=torch.float64)
    y = torch.full((nbr, b), float("nan"), dtype=torch.float64)
    xb = x.reshape(nbr, b).double()
    diag, upper = sym.diag_data.double(), sym.upper_data.double()
    for u in order:
        r, t = divmod(int(u), tiles)
        rows = slice(t * SPMV_TILE_ROWS, (t + 1) * SPMV_TILE_ROWS)
        acc = diag[r, rows] @ xb[r]
        for k in range(ku):
            c = int(sym.upper_cols[r, k])
            if c > r:  # padding slots are never read
                acc += upper[r, k, rows] @ xb[c]
                tbuf[r, k, t] = upper[r, k, rows].T @ xb[r, rows]
        y[r, rows] = acc
    col_ptr, slot_ids = sym.column_index()
    flat = tbuf.reshape(nbr * ku, tiles, b)
    for c in range(nbr):
        for s in slot_ids[col_ptr[c]:col_ptr[c + 1]].tolist():
            for t in range(tiles):
                y[c] += flat[s, t]  # NaN if pass 1 left a listed partial unwritten
    return y.reshape(-1)


@pytest.mark.parametrize("b", [128, 256])
@pytest.mark.parametrize("kind", ["far_reach", "scattered"])
def test_spmv_units_and_scratch_against_to_dense(kind, b):
    """Every partial that pass 2 reads was written by pass 1 (the scratch is
    NaN-filled), the result is the dense product, and it does not depend on
    the order in which the units ran."""
    if kind == "far_reach":
        sym = port_sym(far_reach_sym(10, b, 7, seed=2), torch.float32)
    else:
        sym = scattered_sym(10, 3, b, seed=4)
        col_ptr, _ = sym.column_index()
        assert int(col_ptr[-1] - col_ptr[-2]) == 9  # the hub column hears from every row
    nbr, ku = sym.upper_cols.shape
    assert sym_spmv_scratch_shape(nbr, ku, b) == (nbr, ku, b // SPMV_TILE_ROWS, b)
    x = torch.as_tensor(vec(nbr * b, 9))
    want = sym.to_dense().double() @ x.double()
    units = nbr * (b // SPMV_TILE_ROWS)
    results = [scheduled(sym, x, np.random.default_rng(seed).permutation(units)) for seed in range(3)]
    assert torch.allclose(results[0], want, rtol=0, atol=1e-12 * float(want.abs().max()))
    assert torch.equal(results[0], results[1]) and torch.equal(results[0], results[2])
