"""ctypes loader for the native host-side builders.

Counterpart of ``eigenex_tpu/native/__init__.py``, over the port's own copy
of its C++ source (``src/builders.cpp``).  The library is compiled with
``g++`` at its first use, not when this module is imported, into
``eigenex_tpu_torch/build/`` (no pip, no pybind11), and the wrappers below
give it typed numpy arguments.  Every entry point has a numpy fallback at
its call site: ``native_available()`` false routes there, so the package
works on a machine without a toolchain, and ``EIGENEX_TPU_NO_NATIVE`` set
to a non-empty value switches the library off in both packages.

The build may run in several processes at once (test workers): each takes
an exclusive lock on ``native.lock`` in the build directory, compiles into
a temporary name and renames the result into place.  ``-march=native``
makes a library specific to the CPU it was built on, so its file name
carries a digest of the source, the flags and the CPU's identity.

``native_calls()`` counts the calls of each wrapper since the last
``reset_native_calls()``: it shows which route a host stage took.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "NATIVE", "native_available", "coo_shrink", "bsr_pack",
    "heisenberg_sector", "mm_info", "mm_read",
    "rcm_permutation", "blk_widths", "bsr_pack_f32", "sym_bsr_pack_f32",
    "sym_bsr_pack_bf16", "bsr_pack_bf16", "build_csr",
]

_SRC = Path(__file__).resolve().parent / "src" / "builders.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
GXX_FLAGS = (
    "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
    "-pthread",  # std::thread in the packers: explicit link, not implicit
)
_UNLOADED = object()
_calls: dict[str, int] = {}


def native_calls() -> dict[str, int]:
    """Calls of each native wrapper since the last reset (wrappers never
    called are absent)."""
    return dict(_calls)


def reset_native_calls() -> None:
    _calls.clear()


def _cpu_signature() -> str:
    """The CPU's model name and feature flags (what ``-march=native``
    compiles for), or the platform's names where /proc/cpuinfo is absent."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        lines = []
    keep = [next((ln for ln in lines if ln.startswith(key)), "") for key in ("model name", "flags")]
    return "\n".join(keep) if any(keep) else f"{platform.machine()} {platform.processor()}"


def library_path(build_dir=BUILD_DIR) -> Path:
    """Where :func:`build_library` puts the library for this source, these
    flags and this CPU."""
    digest = hashlib.sha256()
    digest.update(_SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(_cpu_signature().encode())
    return Path(build_dir) / f"libeigenex_native-{digest.hexdigest()[:16]}.so"


def build_library(build_dir=BUILD_DIR) -> Path:
    """Compile ``src/builders.cpp`` into ``build_dir`` unless it is there,
    and return the library's path.  Concurrent callers serialise on a file
    lock; the compiler writes a temporary file that is renamed into place,
    so no process loads a half-written library.  Raises ``RuntimeError``
    when the compiler fails and ``OSError`` when there is none."""
    target = library_path(build_dir)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if target.exists():  # built by another process while this one waited
                return target
            fd, tmp = tempfile.mkstemp(prefix=target.name + ".", suffix=".tmp", dir=target.parent)
            os.close(fd)
            try:
                res = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp],
                                     capture_output=True, timeout=120)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed:\n{res.stderr.decode()[:2000]}")
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def _load():
    try:
        path = build_library()
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:  # no toolchain, read-only tree, ...
        sys.stderr.write(f"eigenex_tpu_torch.native build unavailable: {e}\n")
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.coo_shrink.restype = i64
    lib.coo_shrink.argtypes = [p_i64, p_i64, p_f64, i64, i64, ctypes.c_double]
    lib.bsr_kmax.restype = i64
    lib.bsr_kmax.argtypes = [p_i64, p_i64, i64, i64, i64, i64, i64]
    lib.bsr_pack.restype = i64
    lib.bsr_pack.argtypes = [p_i64, p_i64, p_f64, i64, i64, i64, i64, i64, i64, p_f64, p_i32]
    lib.heisenberg_sector.restype = i64
    lib.heisenberg_sector.argtypes = [i64, i64, ctypes.c_double, ctypes.c_double, i64, p_i64, p_i64, p_f64]
    lib.mm_info.restype = i64
    lib.mm_info.argtypes = [ctypes.c_char_p, p_i64]
    lib.mm_read.restype = i64
    lib.mm_read.argtypes = [ctypes.c_char_p, p_i64, p_i64, p_f64, p_f64, i64]
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.rcm_permutation.restype = i64
    lib.rcm_permutation.argtypes = [p_i64, p_i64, i64, p_i64]
    lib.blk_widths.restype = i64
    lib.blk_widths.argtypes = [p_i64, p_i64, i64, i64, i64, i64, p_i64, p_i64]
    lib.bsr_pack_sorted_f32.restype = i64
    lib.bsr_pack_sorted_f32.argtypes = [
        p_i64, p_i64, p_f64, i64, p_i64, i64, i64, i64, i64, p_f32, p_i32,
    ]
    lib.sym_bsr_pack_sorted_f32.restype = i64
    lib.sym_bsr_pack_sorted_f32.argtypes = [
        p_i64, p_i64, p_f64, i64, p_i64, i64, i64, p_f32, p_f32, p_i32,
    ]
    p_u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.sym_bsr_pack_sorted_bf16.restype = i64
    lib.sym_bsr_pack_sorted_bf16.argtypes = [
        p_i64, p_i64, p_f64, i64, p_i64, i64, i64, p_u16, p_u16, p_i32,
    ]
    lib.bsr_pack_sorted_bf16.restype = i64
    lib.bsr_pack_sorted_bf16.argtypes = [
        p_i64, p_i64, p_f64, i64, p_i64, i64, i64, i64, i64, p_u16, p_i32,
    ]
    lib.sym_bsr_pack_sorted_f32_mt.restype = i64
    lib.sym_bsr_pack_sorted_f32_mt.argtypes = [
        p_i64, p_i64, p_f64, i64, p_i64, i64, i64, p_f32, p_f32, p_i32,
    ]
    lib.build_csr.restype = i64
    lib.build_csr.argtypes = [p_i64, p_i64, i64, i64, p_i64, p_i64]
    return lib


def _lib():
    """The loaded library (built at the first call), or None."""
    lib = globals().get("NATIVE", _UNLOADED)
    if lib is _UNLOADED:
        lib = None if os.environ.get("EIGENEX_TPU_NO_NATIVE") else _load()
        globals()["NATIVE"] = lib
    return lib


def __getattr__(name):
    # ``NATIVE`` is resolved at its first use, so that importing the package
    # compiles nothing
    if name == "NATIVE":
        return _lib()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def native_available() -> bool:
    return _lib() is not None


def _call(name: str, *args):
    _calls[name] = _calls.get(name, 0) + 1
    return getattr(_lib(), name)(*args)


def _bf16(a: np.ndarray) -> torch.Tensor:
    """bf16 bit patterns held as uint16 -> a ``torch.bfloat16`` tensor over
    the same buffer, bits unchanged."""
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def coo_shrink(rows, cols, vals, n_cols: int, threshold: float):
    """Sort row-major, merge duplicates, drop small entries (native).
    Returns (rows, cols, vals) trimmed copies."""
    # the C function sorts/merges IN PLACE -- always hand it private copies
    rows = np.array(rows, np.int64, copy=True, order="C")
    cols = np.array(cols, np.int64, copy=True, order="C")
    vals = np.array(vals, np.float64, copy=True, order="C")
    kept = _call("coo_shrink", rows, cols, vals, len(vals), int(n_cols), float(threshold))
    return rows[:kept].copy(), cols[:kept].copy(), vals[:kept].copy()


def bsr_pack(rows, cols, vals, shape, block_shape):
    """Pack float64 triplets into BSR-ELL (native).  Returns (data, block_cols,
    padded shape); a block row's slots in the order its blocks first occur."""
    bm, bn = block_shape
    m = -(-shape[0] // bm) * bm
    n = -(-shape[1] // bn) * bn
    nbr, nbc = m // bm, n // bn
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    kmax = _call("bsr_kmax", rows, cols, len(vals), bm, bn, nbr, nbc)
    data = np.zeros((nbr, kmax, bm, bn), np.float64)
    bcols = np.zeros((nbr, kmax), np.int32)
    rc = _call("bsr_pack", rows, cols, vals, len(vals), bm, bn, nbr, nbc, kmax, data, bcols)
    if rc != 0:
        raise RuntimeError(f"bsr_pack failed with code {rc}")
    return data, bcols, (m, n)


def heisenberg_sector(L: int, n_up: int, J: float, Jz: float, pbc: bool):
    """Sector Hamiltonian triplets (native), column-major by construction.
    Returns (rows, cols, vals, dim)."""
    from math import comb

    dim = comb(L, n_up)
    n_bonds = (L - 1) + (1 if pbc and L > 2 else 0)
    cap = dim * (1 + n_bonds)
    rows = np.zeros(cap, np.int64)
    cols = np.zeros(cap, np.int64)
    vals = np.zeros(cap, np.float64)
    nnz = _call("heisenberg_sector", L, n_up, float(J), float(Jz), int(bool(pbc)), rows, cols, vals)
    if nnz < 0:
        raise RuntimeError(f"heisenberg_sector failed with code {nnz}")
    return rows[:nnz], cols[:nnz], vals[:nnz], dim


def build_csr(rows, cols, n: int):
    """(rowptr, colidx) adjacency of UNSORTED triplets -- one threaded
    histogram + scatter, no argsort/gather (feeds rcm_permutation)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    rowptr = np.zeros(n + 1, np.int64)
    colidx = np.zeros(len(cols), np.int64)
    rc = _call("build_csr", rows, cols, len(rows), n, rowptr, colidx)
    if rc != 0:
        raise RuntimeError(f"build_csr failed with code {rc} (row index out of range?)")
    return rowptr, colidx


def rcm_permutation(rowptr, colidx):
    """Reverse Cuthill-McKee ordering of a symmetric-pattern CSR graph.

    Returns perm (int64) with scipy's convention: ``A[perm][:, perm]``
    is banded (perm[i] = original index at new position i)."""
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    colidx = np.ascontiguousarray(colidx, np.int64)
    n = len(rowptr) - 1
    perm = np.zeros(n, np.int64)
    rc = _call("rcm_permutation", rowptr, colidx, n, perm)
    if rc != 0:
        raise RuntimeError(f"rcm_permutation failed with code {rc}")
    return perm


def blk_widths(rows, cols, bm: int, bn: int, nbc: int):
    """One shared sort for the block packers.

    Returns (order, kmax, ku, reach): ``order`` argsorts the triplets by
    (block_row, block_col) and feeds :func:`bsr_pack_f32` /
    :func:`sym_bsr_pack_f32`; kmax/ku are the general/strictly-upper ELL
    widths, reach the block band reach (ku/reach only for bm == bn)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    order = np.zeros(len(rows), np.int64)
    out = np.zeros(3, np.int64)
    rc = _call("blk_widths", rows, cols, len(rows), bm, bn, nbc, order, out)
    if rc != 0:
        raise RuntimeError(f"blk_widths failed with code {rc}")
    return order, int(out[0]), int(out[1]), int(out[2])


def bsr_pack_f32(rows, cols, vals, order, nbr, nbc, bm, bn, kmax):
    """General BSR-ELL pack (f32 data) over a blk_widths order."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    data = np.zeros((nbr, kmax, bm, bn), np.float32)
    bcols = np.zeros((nbr, kmax), np.int32)
    rc = _call("bsr_pack_sorted_f32", rows, cols, vals, len(vals), order, bm, bn, nbc, kmax,
               data, bcols)
    if rc != 0:
        raise RuntimeError(f"bsr_pack_sorted_f32 failed with code {rc}")
    return data, bcols


def sym_bsr_pack_f32(rows, cols, vals, order, nbr, b, ku):
    """Symmetric diag + strictly-upper pack (f32, threaded) over a
    blk_widths order.

    Lower-triangle triplets are skipped (their count is returned for the
    caller's symmetry sanity check as ``skipped``)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    diag = np.zeros((nbr, b, b), np.float32)
    upper = np.zeros((nbr, ku, b, b), np.float32)
    ucols = np.zeros((nbr, ku), np.int32)
    skipped = _call("sym_bsr_pack_sorted_f32_mt", rows, cols, vals, len(vals), order, b, ku,
                    diag, upper, ucols)
    if skipped < 0:
        raise RuntimeError(f"sym_bsr_pack_sorted_f32 failed with code {skipped}")
    return diag, upper, ucols, int(skipped)


def sym_bsr_pack_bf16(rows, cols, vals, order, nbr, b, ku):
    """Symmetric pack emitting bfloat16 DIRECTLY (threaded; each value
    rounded to nearest even, through f32) -- no f32 staging buffer and no
    cast pass.  Returns (diag, upper, ucols, skipped) with diag/upper as
    ``torch.bfloat16`` host tensors over the packed bits."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    diag = np.zeros((nbr, b, b), np.uint16)
    upper = np.zeros((nbr, ku, b, b), np.uint16)
    ucols = np.zeros((nbr, ku), np.int32)
    skipped = _call("sym_bsr_pack_sorted_bf16", rows, cols, vals, len(vals), order, b, ku,
                    diag, upper, ucols)
    if skipped < 0:
        raise RuntimeError(f"sym_bsr_pack_sorted_bf16 failed with code {skipped}")
    return _bf16(diag), _bf16(upper), ucols, int(skipped)


def bsr_pack_bf16(rows, cols, vals, order, nbr, nbc, bm, bn, kmax):
    """General BSR-ELL pack emitting bfloat16 directly (threaded); the data
    as a ``torch.bfloat16`` host tensor over the packed bits."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    data = np.zeros((nbr, kmax, bm, bn), np.uint16)
    bcols = np.zeros((nbr, kmax), np.int32)
    rc = _call("bsr_pack_sorted_bf16", rows, cols, vals, len(vals), order, bm, bn, nbc, kmax,
               data, bcols)
    if rc != 0:
        raise RuntimeError(f"bsr_pack_sorted_bf16 failed with code {rc}")
    return _bf16(data), bcols


_MM_ERRORS = {
    -1: "cannot open/read file",
    -2: "not a coordinate MatrixMarket file",
    -3: "unknown field (expect real/integer/complex/pattern)",
    -4: "unknown symmetry (expect general/symmetric/skew-symmetric/hermitian)",
    -5: "malformed size line",
    -6: "malformed or truncated triplet data",
    -7: "capacity smaller than declared nnz",
    -8: "1-based index out of declared range",
}

MM_FIELDS = ("real", "integer", "complex", "pattern")
MM_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


def mm_info(path: str):
    """(rows, cols, nnz, field, symmetry) of a coordinate .mtx file (native)."""
    out = np.zeros(5, np.int64)
    rc = _call("mm_info", str(path).encode(), out)
    if rc != 0:
        raise RuntimeError(f"mm_info({path!r}): {_MM_ERRORS.get(rc, rc)}")
    return (
        int(out[0]), int(out[1]), int(out[2]),
        MM_FIELDS[int(out[3])], MM_SYMMETRIES[int(out[4])],
    )


def mm_read(path: str):
    """Raw triplets of a coordinate .mtx file (native, 0-based).

    Returns (rows, cols, vals, shape, symmetry) -- vals complex128 only for
    complex files; symmetry is NOT expanded here (sparse.io does that)."""
    nr, nc, nnz, field, symmetry = mm_info(path)
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    vre = np.zeros(nnz, np.float64)
    vim = np.zeros(nnz, np.float64)
    rc = _call("mm_read", str(path).encode(), rows, cols, vre, vim, nnz)
    if rc < 0:
        raise RuntimeError(f"mm_read({path!r}): {_MM_ERRORS.get(rc, rc)}")
    vals = vre + 1j * vim if field == "complex" else vre
    return rows, cols, vals, (nr, nc), symmetry
