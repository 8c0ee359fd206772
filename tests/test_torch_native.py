"""The port's native host builders (``eigenex_tpu_torch/native``) against
the JAX package's (``eigenex_tpu/native``): the same C++ source apart from
its header, the same results bit for bit from every wrapper on the same
numpy-seeded inputs, the same Matrix Market error codes, and -- as the
reference's own ``tests/test_native.py`` does -- the same results as the
port's numpy routes.  Also: a build that several processes run at once
into one directory leaves one loadable library, the call counter, and the
switch that turns the library off.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import eigenex_tpu.native as jn
import eigenex_tpu_torch.native as tn
from eigenex_tpu_torch.block.hamiltonians import _heisenberg_triplets
from eigenex_tpu_torch.sparse.bsr import _pack_bsr_host
from eigenex_tpu_torch.sparse.coo import _shrink

ROOT = Path(__file__).resolve().parent.parent



@pytest.fixture(autouse=True)
def _both_libraries():
    if not (jn.native_available() and tn.native_available()):
        pytest.skip("native builders not built on this host (no g++)")


def u16(a) -> np.ndarray:
    """bf16 blocks of either package as their uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def symmetric_triplets(n, reach, seed):
    """A shuffled symmetric pattern, dyadic values (bf16-exact), unsorted."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 3)
    c = r + rng.integers(1, reach, size=len(r))
    keep = c < n
    r, c = r[keep], c[keep]
    _, first = np.unique(r * n + c, return_index=True)
    r, c = r[first], c[first]
    v = np.round(rng.standard_normal(len(r)) * 8) / 8 + 0.125
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 4.0)])
    order = rng.permutation(len(rows))
    return rows[order], cols[order], vals[order]


def test_source_is_the_reference_copy():
    ours = (ROOT / "eigenex_tpu_torch/native/src/builders.cpp").read_text().splitlines()
    ref = (ROOT / "eigenex_tpu/native/src/builders.cpp").read_text().splitlines()
    header = 0
    while ours[header] != ref[0]:
        assert ours[header].startswith("//"), ours[header]
        header += 1
    assert 0 < header <= 6 and ours[header:] == ref


def test_library_lives_in_the_port_build_directory():
    path = tn.library_path()
    assert path.parent == ROOT / "eigenex_tpu_torch" / "build"
    assert Path(tn.NATIVE._name) == path and path.exists()


def test_coo_shrink(rng):
    n = 500
    r, c = rng.integers(0, 30, n), rng.integers(0, 40, n)  # many duplicates
    v = rng.standard_normal(n)
    got = tn.coo_shrink(r, c, v, 40, 0.0)
    want = jn.coo_shrink(r, c, v, 40, 0.0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    pr, pc, pv = _shrink(r.astype(np.int32), c.astype(np.int32), v.copy(), 30, 40, 0.0)
    np.testing.assert_array_equal(got[0], pr)
    np.testing.assert_array_equal(got[1], pc)
    np.testing.assert_allclose(got[2], pv, atol=1e-14)  # another summation order
    r2, c2, v2 = tn.coo_shrink([0, 1], [0, 1], [1e-15, 1.0], 2, 1e-12)
    assert len(v2) == 1 and v2[0] == 1.0


def test_bsr_pack(rng):
    n = 48
    m = rng.standard_normal((n, n))
    m[rng.random((n, n)) > 0.2] = 0
    r, c = np.nonzero(m)
    r, c = r[::-1].copy(), c[::-1].copy()  # not in row-major order: slot order shows
    v = m[r, c]
    data, bcols, shape = tn.bsr_pack(r, c, v, (n, n), (4, 8))
    jdata, jbcols, jshape = jn.bsr_pack(r, c, v, (n, n), (4, 8))
    assert shape == jshape == (48, 48)
    assert np.array_equal(data, jdata) and np.array_equal(bcols, jbcols)
    ndata, nbcols, _ = _pack_bsr_host(r, c, v, (n, n), (4, 8))

    def dense(d, cols):
        out = np.zeros((n, n))
        for br in range(d.shape[0]):
            for k in range(d.shape[1]):
                out[4 * br:4 * br + 4, 8 * cols[br, k]:8 * cols[br, k] + 8] += d[br, k]
        return out

    assert np.array_equal(dense(data, bcols), m) and np.array_equal(dense(ndata, nbcols), m)


@pytest.mark.parametrize("L,n_up,Jz,pbc", [(6, 3, 0.7, False), (8, 4, 0.7, True),
                                           (5, 2, 0.7, False), (12, 6, 1.0, False)])
def test_heisenberg_sector(L, n_up, Jz, pbc):
    got = tn.heisenberg_sector(L, n_up, 1.0, Jz, pbc)
    want = jn.heisenberg_sector(L, n_up, 1.0, Jz, pbc)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # lexsorted, the native triplets are the numpy builder's, bit for bit
    r, c, v, dim = got
    order = np.lexsort((c, r))
    nr, nc, nv, ndim = _heisenberg_triplets(L, n_up, 1.0, Jz, pbc, np.float64)
    assert dim == ndim
    assert np.array_equal(r[order], nr) and np.array_equal(c[order], nc)
    assert np.array_equal(v[order], nv)


def test_csr_and_rcm():
    r, c, _ = symmetric_triplets(700, 40, 1)
    relabel = np.random.default_rng(5).permutation(700)  # scatter the band
    r, c = relabel[r], relabel[c]
    rowptr, colidx = tn.build_csr(r, c, 700)
    jrowptr, jcolidx = jn.build_csr(r, c, 700)
    assert np.array_equal(rowptr, jrowptr) and np.array_equal(colidx, jcolidx)
    perm = tn.rcm_permutation(rowptr, colidx)
    assert np.array_equal(perm, jn.rcm_permutation(jrowptr, jcolidx))
    assert np.array_equal(np.sort(perm), np.arange(700))
    ip = np.empty(700, np.int64)
    ip[perm] = np.arange(700)
    assert np.abs(ip[r] - ip[c]).max() < np.abs(r - c).max()  # banded


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_block_packers(storage):
    n, b = 900, 32
    r, c, v = symmetric_triplets(n, 70, 2)
    nbr = -(-n // b)
    order, kmax, ku, reach = tn.blk_widths(r, c, b, b, nbr)
    jorder, jkmax, jku, jreach = jn.blk_widths(r, c, b, b, nbr)
    assert np.array_equal(order, jorder) and (kmax, ku, reach) == (jkmax, jku, jreach)
    if storage == "f32":
        got = tn.sym_bsr_pack_f32(r, c, v, order, nbr, b, ku)
        want = jn.sym_bsr_pack_f32(r, c, v, order, nbr, b, ku)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    else:
        got = tn.sym_bsr_pack_bf16(r, c, v, order, nbr, b, ku)
        want = jn.sym_bsr_pack_bf16(r, c, v, order, nbr, b, ku)
        assert got[0].dtype == got[1].dtype == torch.bfloat16
        assert np.array_equal(u16(got[0]), u16(want[0])) and np.array_equal(u16(got[1]), u16(want[1]))
        assert np.array_equal(got[2], want[2])
    assert got[3] == want[3] == int(np.count_nonzero(c // b < r // b))
    # the general packer over a (16, 32) block sort
    bm, bn = 16, 32
    nbr_g, nbc = -(-n // bm), -(-n // bn)
    order, kmax, _, _ = tn.blk_widths(r, c, bm, bn, nbc)
    jorder, jkmax, _, _ = jn.blk_widths(r, c, bm, bn, nbc)
    assert np.array_equal(order, jorder) and kmax == jkmax
    if storage == "f32":
        data, bcols = tn.bsr_pack_f32(r, c, v, order, nbr_g, nbc, bm, bn, kmax)
        jdata, jbcols = jn.bsr_pack_f32(r, c, v, order, nbr_g, nbc, bm, bn, kmax)
        assert np.array_equal(data, jdata)
    else:
        data, bcols = tn.bsr_pack_bf16(r, c, v, order, nbr_g, nbc, bm, bn, kmax)
        jdata, jbcols = jn.bsr_pack_bf16(r, c, v, order, nbr_g, nbc, bm, bn, kmax)
        assert data.dtype == torch.bfloat16 and np.array_equal(u16(data), u16(jdata))
    assert np.array_equal(bcols, jbcols)


def test_bf16_pack_rounds_to_nearest_even():
    """Values that are not bf16-exact round as torch rounds f32 to bf16."""
    rng = np.random.default_rng(3)
    n = 64
    r = np.arange(n)
    v = rng.standard_normal(n)
    order, _, ku, _ = tn.blk_widths(r, r, 32, 32, 2)
    diag = tn.sym_bsr_pack_bf16(r, r, v, order, 2, 32, ku)[0]
    want = torch.as_tensor(v.astype(np.float32)).to(torch.bfloat16)
    got = torch.stack([torch.diagonal(diag[0]), torch.diagonal(diag[1])]).reshape(-1)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


MM_FILES = {
    "real_general": "%%MatrixMarket matrix coordinate real general\n% c\n3 4 4\n"
                    "1 1 2.5\n2 3 -1.0\n3 4 7\n1 2 1e-3\n",
    "real_symmetric": "%%MatrixMarket matrix coordinate real symmetric\n3 3 4\n"
                      "1 1 1.0\n2 1 5.0\n3 2 -2.0\n3 3 4.0\n",
    "complex_hermitian": "%%MatrixMarket matrix coordinate complex hermitian\n2 2 2\n"
                         "1 1 3.0 0.0\n2 1 1.0 -2.0\n",
    "pattern_general": "%%MatrixMarket matrix coordinate pattern general\n2 2 2\n1 2\n2 1\n",
    "integer_skew": "%%MatrixMarket matrix coordinate integer skew-symmetric\n2 2 1\n2 1 3\n",
}


@pytest.mark.parametrize("name", sorted(MM_FILES))
def test_mm_info_and_read(tmp_path, name):
    p = tmp_path / f"{name}.mtx"
    p.write_text(MM_FILES[name])
    assert tn.mm_info(p) == jn.mm_info(str(p))
    got, want = tn.mm_read(p), jn.mm_read(str(p))
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3:] == want[3:]


MM_ERRORS = {
    -2: "%%MatrixMarket matrix array real general\n2 2\n1.0\n3.0\n2.0\n4.0\n",
    -3: "%%MatrixMarket matrix coordinate quaternion general\n1 1 1\n1 1 1.0\n",
    -4: "%%MatrixMarket matrix coordinate real lopsided\n1 1 1\n1 1 1.0\n",
    -5: "%%MatrixMarket matrix coordinate real general\n3 x\n",
    -6: "%%MatrixMarket matrix coordinate real general\n3 3 5\n1 1 1.0\n",
    -8: "%%MatrixMarket matrix coordinate real general\n2 2 1\n5 1 1.0\n",
}


@pytest.mark.parametrize("code", [-1, *MM_ERRORS, -7])
def test_mm_error_codes(tmp_path, code):
    """Each error code of the parser, read through both packages' libraries;
    the wrappers' messages name it as the reference's do."""
    p = tmp_path / "e.mtx"
    if code == -7:  # capacity below the declared count: only a direct call can ask for it
        p.write_text(MM_FILES["real_general"])
        bufs = lambda: (np.zeros(2, np.int64), np.zeros(2, np.int64), np.zeros(2), np.zeros(2))
        assert tn.NATIVE.mm_read(str(p).encode(), *bufs(), 2) == jn.NATIVE.mm_read(
            str(p).encode(), *bufs(), 2) == -7
        return
    if code != -1:
        p.write_text(MM_ERRORS[code])
    reader = tn.mm_read if code in (-6, -8) else tn.mm_info
    jreader = jn.mm_read if code in (-6, -8) else jn.mm_info
    with pytest.raises(RuntimeError) as got:
        reader(str(p))
    with pytest.raises(RuntimeError) as want:
        jreader(str(p))
    assert str(got.value) == str(want.value)
    assert tn._MM_ERRORS[code] in str(got.value)
    assert tn._MM_ERRORS == jn._MM_ERRORS
    assert (tn.MM_FIELDS, tn.MM_SYMMETRIES) == (jn.MM_FIELDS, jn.MM_SYMMETRIES)


def test_all_names_and_call_counter():
    assert tn.__all__ == jn.__all__
    tn.reset_native_calls()
    assert tn.native_calls() == {}
    tn.heisenberg_sector(6, 3, 1.0, 1.0, False)
    tn.coo_shrink([0], [0], [1.0], 1, 0.0)
    tn.coo_shrink([0], [0], [1.0], 1, 0.0)
    assert tn.native_calls() == {"heisenberg_sector": 1, "coo_shrink": 2}
    tn.reset_native_calls()
    assert tn.native_calls() == {}


BUILD = (
    "import sys, ctypes, numpy as np\n"
    "from eigenex_tpu_torch import native\n"
    "path = native.build_library(sys.argv[1])\n"
    "lib = ctypes.CDLL(str(path))\n"
    "r = np.zeros(24, np.int64); v = np.zeros(24)\n"
    "lib.heisenberg_sector.restype = ctypes.c_int64\n"
    "nnz = lib.heisenberg_sector(ctypes.c_int64(4), ctypes.c_int64(2), ctypes.c_double(1.0),"
    " ctypes.c_double(1.0), ctypes.c_int64(0), r.ctypes.data_as(ctypes.c_void_p),"
    " np.zeros(24, np.int64).ctypes.data_as(ctypes.c_void_p), v.ctypes.data_as(ctypes.c_void_p))\n"
    "print(path, nnz)\n"
)


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    """Two processes build into one empty directory at the same time: both
    load the library they get back, and no temporary file is left over."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = {o[0].strip() for o in outs}
    assert len(lines) == 1  # the same library, and it computed the 4-site sector (nnz 18)
    path, nnz = lines.pop().split()
    assert int(nnz) == 18 and Path(path).parent == tmp_path
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([Path(path).name, "native.lock"])


def test_switch_turns_the_library_off():
    code = ("from eigenex_tpu_torch import native\n"
            "assert not native.native_available() and native.NATIVE is None\n"
            "from eigenex_tpu_torch.block.hamiltonians import heisenberg_sector_coo\n"
            "h = heisenberg_sector_coo(8, 4, device='cpu')\n"
            "assert h.nnz == 350 and native.native_calls() == {}\n"
            "print('off')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**__import__("os").environ, "EIGENEX_TPU_NO_NATIVE": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "off"
