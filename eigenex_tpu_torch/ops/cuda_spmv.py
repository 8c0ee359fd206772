"""Hand-written CUDA kernels for block-sparse SpMV and SpMM, their plain
PyTorch versions, the code that builds and loads them, and their launch
counts.

This module replaces ``eigenex_tpu/ops/pallas_spmv.py``:

====================  ==========================================  =====================
wrapper               replaces (Pallas kernel / entry point)      source
====================  ==========================================  =====================
:func:`bsr_spmv`      ``_spmv_kernel`` / ``bsr_matvec_pallas``    ``csrc/bsr_spmv.cu``
:func:`sym_bsr_spmv`  ``_sym_spmv_stream_kernel``,                ``csrc/sym_bsr_spmv.cu``
                      ``_sym_spmv_kernel``,
                      ``_sym_spmv_ring_kernel`` /
                      ``sym_bsr_matvec_pallas``
:func:`bsr_spmm`      ``_spmm_kernel`` / ``bsr_matmat_pallas``    ``csrc/bsr_spmm.cu``
:func:`sym_bsr_spmm`  ``_sym_spmm_kernel``,                       ``csrc/sym_bsr_spmm.cu``
                      ``_sym_spmm_stream_kernel``,
                      ``_sym_spmm_ring_kernel`` /
                      ``sym_bsr_matmat_pallas``
:func:`csr_spmv`      none (row-compressed symmetric operators)   ``csrc/csr_spmv.cu``
====================  ==========================================  =====================

and the precision rule ``_dot_mode``/``_sdot`` that all of them share:
f32 or bf16 block storage, f32 x, f32 accumulation, f32 output.
:func:`csr_spmv` has no TPU counterpart: it multiplies a symmetric operator
stored row-compressed (:class:`~eigenex_tpu_torch.sparse.sym_csr.SymCSRMatrix`),
which ``accelerate()`` picks on the card where the block pack would move more
bytes; it keeps the same precision rule.  The SpMV
kernels multiply with f32 FMAs on CUDA cores (``csrc/spmv_common.cuh``).
The SpMM kernels take the ``(n, p)`` row-major panels the block solvers
hold, for any p >= 1, and multiply on the tensor cores with ``mma.sync``,
compensated to f32 grade (``csrc/spmm_common.cuh``): with bf16 blocks X is
split into three bf16 parts (what ``_sdot`` does), with f32 blocks both
sides are split into a TF32 big and small part (3xTF32).  No product of X is
ever taken in one TF32 or bf16 pass.  ``spmm_split_model`` repeats that
arithmetic in plain PyTorch for the tests and the card-only checks; no entry
point calls it.

How the kernels reach Python: each ``.cu`` file is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, at first
use, from the sources in ``eigenex_tpu_torch/csrc`` and nothing else,
into ``eigenex_tpu_torch/build``; the library is loaded with ``ctypes``,
pointers come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream()``.  Importing this module builds nothing.

Gradients: each wrapper is differentiable in x (or X), never in the
pack.  When autograd records (grad enabled and x requiring grad) a CUDA
launch goes through a ``torch.autograd.Function`` whose backward is a
launch of the same kernel: on the cached adjoint pack
(``BSRMatrix.kernel_adjoint()``) for the general kernels, on the same pack
for the symmetric ones (a real symmetric A equals A^T).  A backward counts
as one launch of its kernel.  Otherwise the wrapper launches directly, at
no extra cost.  Complex operands never reach the kernels: they arrive
through the real embedding of ``sparse/realify.py``, whose torch ops
autograd differentiates around the real products, and a complex x is
refused as any non-f32 x is.

Routing rule: a wrapper given CUDA tensors launches its kernel or
raises.  It never catches a failure and carries on with the plain
version.  The plain versions (``*_plain``) run when the tensors lie on
the CPU, and for storage the kernels do not take (f64, complex), as in
the reference; that route is visible because the launch count does not
move.  A launch recorded into a CUDA graph (a Krylov chunk's capture,
:mod:`eigenex_tpu_torch.solvers.chunk_graph`) is counted at each replay of
the graph instead (:func:`launch_tally`, :func:`count_replayed_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from ..utils import profiling
from ..utils.exceptions import EigenexError

__all__ = [
    "bsr_spmv",
    "bsr_spmv_plain",
    "sym_bsr_spmv",
    "sym_bsr_spmv_plain",
    "bsr_spmm",
    "bsr_spmm_plain",
    "sym_bsr_spmm",
    "sym_bsr_spmm_plain",
    "csr_spmv",
    "csr_spmv_plain",
    "build_kernels",
    "LIBRARY_SOURCES",
    "kernel_storage",
    "launch_counts",
    "reset_launch_counts",
    "launch_tally",
    "count_replayed_launches",
    "KERNEL_SOURCES",
]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"

#: kernel name -> source file under ``csrc/``
KERNEL_SOURCES = {
    "bsr_spmv": "bsr_spmv.cu",
    "sym_bsr_spmv": "sym_bsr_spmv.cu",
    "bsr_spmm": "bsr_spmm.cu",
    "sym_bsr_spmm": "sym_bsr_spmm.cu",
    "csr_spmv": "csr_spmv.cu",
}
#: kernels whose operand is its own adjoint (symmetric storage): the backward
#: of :class:`_KernelProduct` launches them on the same operand
_SELF_ADJOINT = frozenset({"sym_bsr_spmv", "sym_bsr_spmm", "csr_spmv"})
#: kernel name -> its launch counter
_LAUNCH_COUNTERS = {name: f"launch.{name}" for name in KERNEL_SOURCES}
_HEADERS = ("spmv_common.cuh", "spmm_common.cuh")
#: sources outside the SpMV family, whose launches are not counted here ->
#: their file under ``csrc/``: a CUDA library's binding or a solver's kernel;
#: built by :func:`build_kernels` like the kernels
LIBRARY_SOURCES = {
    "tridiag_solve": "tridiag_solve.cu",  # cuSPARSE gtsv2 (solvers/direct.py)
    "arnoldi_step": "arnoldi_step.cu",  # an Arnoldi step's tail (ops/arnoldi_step.py)
}
#: extra ``nvcc`` arguments of one source: the libraries it links
_LINK_FLAGS = {"tridiag_solve": ("-lcusparse",)}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: block storage the kernels take -> the ``storage`` code of the C entries
_STORAGE = {torch.float32: 0, torch.bfloat16: 1}
#: columns covered by one warp-wide load (``kChunk`` in spmv_common.cuh)
_CHUNK = 128
#: rows of one unit of work of the symmetric SpMV kernel (``kRows`` in
#: sym_bsr_spmv.cu); its scratch and arrival counts are sized by it
SPMV_TILE_ROWS = 128
#: columns of X one SpMM launch covers (``kMaxCols`` in spmm_common.cuh);
#: the scratch of :func:`sym_bsr_spmm` is sized for one such chunk
_MAX_COLS = 32

_libs: dict[str, ctypes.CDLL] = {}


def kernel_storage(dtype) -> bool:
    """Whether blocks stored as ``dtype`` go through the CUDA kernels."""
    return dtype in _STORAGE


def launch_counts() -> dict[str, int]:
    """Launches of each kernel's wrapper since the last reset, from every
    thread: the ``launch.<kernel>`` counters of
    :mod:`~eigenex_tpu_torch.utils.profiling`."""
    launched = profiling.counters("launch.")
    return {name: launched.get(key, 0) for name, key in _LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    profiling.reset_counters("launch.")


def _count_launch(name: str) -> None:
    tally = getattr(_capturing, "tally", None)
    if tally is not None:  # captured into a CUDA graph: counted at each replay instead
        tally[name] += 1
        return
    profiling.count(_LAUNCH_COUNTERS[name])


_capturing = threading.local()


@contextlib.contextmanager
def launch_tally():
    """While open, this thread's launches go into the yielded dict instead
    of the counts: a CUDA graph capture, where a launch is recorded, not
    run (:mod:`eigenex_tpu_torch.solvers.chunk_graph`)."""
    tally = dict.fromkeys(KERNEL_SOURCES, 0)
    previous = getattr(_capturing, "tally", None)
    _capturing.tally = tally
    try:
        yield tally
    finally:
        _capturing.tally = previous


def count_replayed_launches(tally: dict) -> None:
    """Add the launches a CUDA graph replay made: the tally of its capture."""
    for name, launched in tally.items():
        if launched:
            profiling.count(_LAUNCH_COUNTERS[name], launched)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------
def _find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise EigenexError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _source(name: str) -> str:
    return KERNEL_SOURCES.get(name) or LIBRARY_SOURCES[name]


def _link_flags(name: str, nvcc: str | None = None) -> list[str]:
    """The libraries a source links, with the toolkit's library directory as
    its run path (``nvcc`` passes the directory to the linker, not to the
    loader)."""
    flags = list(_LINK_FLAGS.get(name, ()))
    if flags and nvcc is not None:
        lib = Path(nvcc).resolve().parent.parent / "lib64"
        flags += ["-Xlinker", "-rpath", "-Xlinker", str(lib)]
    return flags


def _library_path(name: str) -> Path:
    """Build product of one source, keyed by the content it is built from."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(_link_flags(name))).encode())
    for fname in (_source(name),) + _HEADERS:
        h.update((_CSRC / fname).read_bytes())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names=None) -> dict[str, Path]:
    """Compile the sources that are not built yet -- every kernel of
    :data:`KERNEL_SOURCES` and every library binding of
    :data:`LIBRARY_SOURCES` unless ``names`` picks some -- one ``nvcc`` per
    source, all started together.  Returns name -> shared library.  The
    compiler's resource report (``-Xptxas -v``) of each fresh build is
    kept beside the library as ``<library>.log``."""
    names = [*KERNEL_SOURCES, *LIBRARY_SOURCES] if names is None else list(names)
    paths = {name: _library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    nvcc = _find_nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / _source(name)), *_link_flags(name, nvcc)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{_source(name)}: nvcc exited {proc.returncode}\n{out}")
            continue
        paths[name].with_suffix(".so.log").write_text(out)
        os.replace(tmp, paths[name])
    if failures:
        raise EigenexError("kernel build failed\n" + "\n".join(failures))
    return paths


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # data, cols, x, y, nbr, kmax, bm, bn, storage, stream
    "bsr_spmv": ("eigenex_bsr_spmv", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # diag, upper, cols, col_ptr, slot_ids, ticket, x, y, tbuf, nbr, ku, b, storage, stream
    "sym_bsr_spmv": ("eigenex_sym_bsr_spmv",
                     [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # data, cols, X, Y, nbr, kmax, bm, bn, p, storage, stream
    "bsr_spmm": ("eigenex_bsr_spmm", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # diag, upper, cols, col_ptr, slot_ids, X, Y, tbuf, nbr, ku, b, p, storage, stream
    "sym_bsr_spmm": ("eigenex_sym_bsr_spmm",
                     [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # rowptr, col, val, x, y, n_rows, group, storage, stream
    "csr_spmv": ("eigenex_csr_spmv", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
}


_load_lock = threading.Lock()


def _entry(name: str):
    """The C entry point of a kernel, building and loading on first use
    (once, whichever shard thread asks first)."""
    lib = _libs.get(name)
    if lib is None:
        with _load_lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build_kernels([name])[name]))
                symbol, argtypes = _ARGTYPES[name]
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _libs[name] = lib
    return getattr(lib, _ARGTYPES[name][0])


@contextlib.contextmanager
def _on_device(device):
    """The raw handle of ``device``'s current stream, with ``device`` made
    current for the launch; the switch (and its cost on the host) only when
    it is not current already, as in the shard threads of a mesh."""
    if device.index == torch.cuda.current_device():
        yield torch._C._cuda_getCurrentRawStream(device.index)
    else:
        with torch.cuda.device(device):
            yield torch._C._cuda_getCurrentRawStream(device.index)


def _check_launch(name: str, code: int) -> None:
    if code != 0:
        raise EigenexError(f"{name}: kernel launch failed (cudaError {code})")


def _kernel_vector(x: torch.Tensor, n: int, device, what: str) -> torch.Tensor:
    """x as the kernels take it: f32, on the blocks' device, length n,
    contiguous and 16-byte aligned (the lanes load float4)."""
    if x.device != device:
        raise EigenexError(f"{what}: x is on {x.device}, the operator on {device}")
    if x.dtype != torch.float32:
        raise EigenexError(f"{what}: x must be float32, got {x.dtype}")
    if x.ndim != 1 or x.shape[0] != n:
        raise EigenexError(f"{what}: x must have shape ({n},), got {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def _kernel_panel(X: torch.Tensor, n: int, device, what: str) -> torch.Tensor:
    """X as the SpMM kernels take it: f32, on the blocks' device, shape
    (n, p) with p >= 1, row-major.  A panel that is already row-major (the
    ``(n, 3b)`` trial block of LOBPCG, a Chebyshev block) is passed as it
    is; a transposed view of basis rows (block Lanczos hands over
    ``Qj.T``) is copied once into row-major order -- n p 4 bytes, a few
    percent of the blocks the product streams."""
    if X.device != device:
        raise EigenexError(f"{what}: X is on {X.device}, the operator on {device}")
    if X.dtype != torch.float32:
        raise EigenexError(f"{what}: X must be float32, got {X.dtype}")
    if X.ndim != 2 or X.shape[0] != n or X.shape[1] < 1:
        raise EigenexError(f"{what}: X must have shape ({n}, p >= 1), got {tuple(X.shape)}")
    return X.contiguous()


def _check_blocks(t: torch.Tensor, what: str) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise EigenexError(f"{what}: block data must be contiguous and 16-byte aligned")


def _check_bsr(bsr, what: str) -> tuple[int, int, int, int]:
    """(nbr, kmax, bm, bn) of a container the general kernels take, or raise."""
    nbr, kmax, bm, bn = bsr.data.shape
    if bsr.dtype not in _STORAGE:
        raise EigenexError(f"{what}: block storage {bsr.dtype} is not float32/bfloat16")
    if bn % _CHUNK:
        raise EigenexError(f"{what}: block width {bn} is not a multiple of {_CHUNK}")
    cols = bsr.block_cols
    if cols.dtype != torch.int32 or not cols.is_contiguous() or cols.device != bsr.device:
        raise EigenexError(f"{what}: block_cols must be contiguous int32 on the blocks' device")
    _check_blocks(bsr.data, what)
    return nbr, kmax, bm, bn


def _check_sym(sym, what: str) -> tuple[int, int, int]:
    """(nbr, ku, b) of a container the symmetric kernels take, or raise."""
    nbr, ku, bm, bn = sym.upper_data.shape
    if sym.dtype not in _STORAGE or sym.diag_data.dtype != sym.dtype:
        raise EigenexError(f"{what}: block storage {sym.dtype} is not float32/bfloat16")
    if bm != bn or bn % _CHUNK:
        raise EigenexError(
            f"{what}: blocks must be square with a side that is a multiple of "
            f"{_CHUNK}, got {bm}x{bn}"
        )
    if tuple(sym.diag_data.shape) != (nbr, bm, bn) or sym.diag_data.device != sym.device:
        raise EigenexError(f"{what}: diag_data does not match upper_data")
    cols = sym.upper_cols
    if cols.dtype != torch.int32 or not cols.is_contiguous() or cols.device != sym.device:
        raise EigenexError(f"{what}: upper_cols must be contiguous int32 on the blocks' device")
    _check_blocks(sym.diag_data, what)
    _check_blocks(sym.upper_data, what)
    return nbr, ku, bn


# ---------------------------------------------------------------------------
# the arithmetic of the SpMM kernels, in plain PyTorch.  Not part of the
# port's surface (left out of __all__) and called by no entry point: the CPU
# tests hold this model to the f64 product and to the reference's split, and
# the card-only checks hold the kernels to the model.
# ---------------------------------------------------------------------------
def split_bf16x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``x`` as hi + mid + lo, each exactly representable in bf16
    (returned as f32), as the bf16 route of the SpMM kernels splits a panel
    of X and as ``_sdot`` of the reference does: 3 x 8 mantissa bits, so
    the parts sum back to ``x`` bit-exactly."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    rest = x - hi
    mid = rest.to(torch.bfloat16).to(torch.float32)
    lo = (rest - mid).to(torch.bfloat16).to(torch.float32)
    return hi, mid, lo


#: the largest f32 that does not round up to infinity at 10 mantissa bits
_TF32_TOP = float(torch.tensor(0x7F7FEFFF, dtype=torch.int32).view(torch.float32))


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` as the two TF32 operands of the f32 route (3xTF32), made as
    ``tf32_big`` and ``tf32_small`` of ``csrc/spmm_common.cuh`` make them:
    big = ``x`` rounded to 10 mantissa bits (nearest, ties away from zero:
    add half a unit, mask 13 bits; ``|x|`` held below the value that would
    round to infinity), small = the exact remainder ``x - big`` with its 13
    low mantissa bits masked."""
    mask = -0x2000  # 0xffffe000
    held = x.clamp(-_TF32_TOP, _TF32_TOP).contiguous()
    big = ((held.view(torch.int32) + 0x1000) & mask).view(torch.float32)
    small = ((x - big).view(torch.int32) & mask).view(torch.float32)
    return big, small


def spmm_split_terms(op, X: torch.Tensor) -> list:
    """The (blocks, part of X) pairs whose products the SpMM kernels add, in
    the kernels' order, for a ``BSRMatrix`` or ``SymBSRMatrix`` with f32 or
    bf16 blocks.  bf16 blocks: A lo, A mid, A hi over the three parts of X.
    f32 blocks: small x big, big x small, big x big.  The last pair alone is
    the one-pass product the kernels must never take."""
    def with_blocks(fn):
        if hasattr(op, "upper_data"):
            return type(op)(fn(op.diag_data), fn(op.upper_data), op.upper_cols, op.shape,
                            op.band_reach)
        return type(op)(fn(op.data), op.block_cols, op.shape)

    if op.dtype == torch.bfloat16:
        lifted = op.astype(torch.float32)  # exact
        hi, mid, lo = split_bf16x3(X)
        return [(lifted, lo), (lifted, mid), (lifted, hi)]
    if op.dtype == torch.float32:
        big = with_blocks(lambda t: split_tf32(t)[0])
        small = with_blocks(lambda t: split_tf32(t)[1])
        x_big, x_small = split_tf32(X)
        return [(small, x_big), (big, x_small), (big, x_big)]
    raise EigenexError(f"spmm_split_terms: block storage {op.dtype} is not float32/bfloat16")


def spmm_split_model(op, X: torch.Tensor) -> torch.Tensor:
    """What the SpMM kernels compute, but for the rounding of their f32 sums:
    the products of :func:`spmm_split_terms`, each exact (the plain version on
    f64 copies), added in f64.  Returns f64.  Against the f64 product of the
    unsplit operands it shows what the split leaves out; a kernel differs from
    it by its own f32 accumulation only."""
    plain = sym_bsr_spmm_plain if hasattr(op, "upper_data") else bsr_spmm_plain
    Y = None
    for blocks, part in spmm_split_terms(op, X):
        term = plain(blocks.astype(torch.float64), part.double())
        Y = term if Y is None else Y + term
    return Y


# ---------------------------------------------------------------------------
# kernel A: general BSR-ELL SpMV
# ---------------------------------------------------------------------------
def bsr_spmv_plain(bsr, x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bsr_spmv`: gather + batched block matmul,
    accumulating in f32 for bf16/f16 storage.  Any dtype, any device."""
    bm, bn = bsr.block_shape
    acc = bsr._acc_dtype
    xb = x.reshape(bsr.n_block_cols, bn).to(acc)
    gathered = xb[bsr.block_cols.long()]  # (nbr, kmax, bn)
    y = torch.einsum("rkij,rkj->ri", bsr.data.to(acc), gathered)
    return y.reshape(bsr.shape[0])


def bsr_spmv(bsr, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` for a :class:`~eigenex_tpu_torch.sparse.bsr.BSRMatrix`.

    CUDA tensors launch the kernel of ``csrc/bsr_spmv.cu`` (f32 or bf16
    blocks, bn a multiple of 128, f32 x) or raise; CPU tensors take
    :func:`bsr_spmv_plain`."""
    if not bsr.data.is_cuda:
        return bsr_spmv_plain(bsr, x)
    return _product("bsr_spmv", bsr, x)


def _launch_bsr_spmv(bsr, x: torch.Tensor) -> torch.Tensor:
    nbr, kmax, bm, bn = _check_bsr(bsr, "bsr_spmv")
    cols = bsr.block_cols
    x = _kernel_vector(x, bsr.shape[1], bsr.device, "bsr_spmv")
    y = torch.empty(bsr.shape[0], dtype=torch.float32, device=bsr.device)
    entry = _entry("bsr_spmv")
    with _on_device(bsr.device) as stream:
        code = entry(
            bsr.data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
            nbr, kmax, bm, bn, _STORAGE[bsr.dtype], stream,
        )
    _check_launch("bsr_spmv", code)
    _count_launch("bsr_spmv")
    return y


# ---------------------------------------------------------------------------
# kernel B: symmetric BSR SpMV on half storage
# ---------------------------------------------------------------------------
def sym_bsr_spmv_plain(sym, x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sym_bsr_spmv`: gather + batched einsum +
    ``index_add_``, accumulating in f32 for bf16/f16 storage.  Any
    dtype (complex: Hermitian), any device."""
    bm, bn = sym.block_shape
    acc = sym._acc_dtype
    xb = x.reshape(-1, bn).to(acc)
    diag = sym.diag_data.to(acc)
    upper = sym.upper_data.to(acc)
    cols = sym.upper_cols.long()
    # diagonal blocks act on the aligned x blocks
    y = torch.einsum("rij,rj->ri", diag, xb)
    # upper blocks: y[r] += B x[c]
    y = y + torch.einsum("rkij,rkj->ri", upper, xb[cols])
    # transpose (conjugate for complex) contributions: y[c] += B^H x[r];
    # padding slots hold zero blocks and add zeros to block row 0
    up = upper.conj() if upper.is_complex() else upper
    contrib = torch.einsum("rkij,ri->rkj", up, xb)  # (nbr, ku, bn)
    y.index_add_(0, cols.reshape(-1), contrib.reshape(-1, bn))
    return y.reshape(sym.shape[0])


def sym_spmv_scratch_shape(nbr: int, ku: int, b: int) -> tuple[int, int, int, int]:
    """Shape of the f32 scratch of :func:`sym_bsr_spmv`: one transposed
    partial ``U[r,k]^T x_r`` per slot and row tile of ``SPMV_TILE_ROWS``
    rows, ``(nbr, ku, b / SPMV_TILE_ROWS, b)``."""
    return (nbr, ku, b // SPMV_TILE_ROWS, b)


def _sym_spmv_workspace(sym) -> tuple:
    """What :func:`sym_bsr_spmv` keeps on a container between calls: the
    checks it passed, the scratch, the ticket counter of the kernel's units
    (zero between launches), and the launch arguments that do not change
    from call to call."""
    nbr, ku, b = _check_sym(sym, "sym_bsr_spmv")
    col_ptr, slot_ids = sym.column_index()
    tbuf = torch.empty(sym_spmv_scratch_shape(nbr, ku, b), dtype=torch.float32, device=sym.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=sym.device)
    head = (sym.diag_data.data_ptr(), sym.upper_data.data_ptr(), sym.upper_cols.data_ptr(),
            col_ptr.data_ptr(), slot_ids.data_ptr(), ticket.data_ptr())
    tail = (tbuf.data_ptr(), nbr, ku, b, _STORAGE[sym.dtype])
    return head, tail, (tbuf, ticket)


def sym_bsr_spmv(sym, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` for a :class:`~eigenex_tpu_torch.sparse.sym_bsr.SymBSRMatrix`.

    CUDA tensors launch the kernel of ``csrc/sym_bsr_spmv.cu`` (f32 or bf16
    square blocks, b a multiple of 128, f32 x, any band reach) or raise; CPU
    tensors take :func:`sym_bsr_spmv_plain`.  Two calls on the same input
    give bit-equal results.

    The container is checked, and its scratch and ticket counter are
    allocated, on the first call from each CUDA stream and kept on it
    (:meth:`SymBSRMatrix.kernel_workspace`); calls on one stream are ordered,
    so they share them, and calls on two streams use two sets."""
    if not sym.upper_data.is_cuda:
        return sym_bsr_spmv_plain(sym, x)
    return _product("sym_bsr_spmv", sym, x)


def _launch_sym_bsr_spmv(sym, x: torch.Tensor) -> torch.Tensor:
    device = sym.device
    with _on_device(device) as stream:
        head, tail, _ = sym.kernel_workspace(("sym_bsr_spmv", stream),
                                             lambda: _sym_spmv_workspace(sym))
        x = _kernel_vector(x, sym.shape[1], device, "sym_bsr_spmv")
        y = torch.empty(sym.shape[0], dtype=torch.float32, device=device)
        code = _entry("sym_bsr_spmv")(*head, x.data_ptr(), y.data_ptr(), *tail, stream)
    _check_launch("sym_bsr_spmv", code)
    _count_launch("sym_bsr_spmv")
    return y


# ---------------------------------------------------------------------------
# kernel C: general BSR-ELL SpMM
# ---------------------------------------------------------------------------
def bsr_spmm_plain(bsr, X: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bsr_spmm`: gather + batched block matmul
    over the (n, p) panel, accumulating in f32 for bf16/f16 storage.  Any
    dtype, any device."""
    bm, bn = bsr.block_shape
    acc = bsr._acc_dtype
    p = X.shape[1]
    xb = X.reshape(bsr.n_block_cols, bn, p).to(acc)
    gathered = xb[bsr.block_cols.long()]  # (nbr, kmax, bn, p)
    y = torch.einsum("rkij,rkjp->rip", bsr.data.to(acc), gathered)
    return y.reshape(bsr.shape[0], p)


def bsr_spmm(bsr, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` for a :class:`~eigenex_tpu_torch.sparse.bsr.BSRMatrix`
    and an (n, p) panel, any p >= 1.

    CUDA tensors launch the kernel of ``csrc/bsr_spmm.cu`` (f32 or bf16
    blocks, bn a multiple of 128, f32 X) or raise; CPU tensors take
    :func:`bsr_spmm_plain`."""
    if not bsr.data.is_cuda:
        return bsr_spmm_plain(bsr, X)
    return _product("bsr_spmm", bsr, X)


def _launch_bsr_spmm(bsr, X: torch.Tensor) -> torch.Tensor:
    nbr, kmax, bm, bn = _check_bsr(bsr, "bsr_spmm")
    X = _kernel_panel(X, bsr.shape[1], bsr.device, "bsr_spmm")
    p = X.shape[1]
    Y = torch.empty((bsr.shape[0], p), dtype=torch.float32, device=bsr.device)
    entry = _entry("bsr_spmm")
    with _on_device(bsr.device) as stream:
        code = entry(
            bsr.data.data_ptr(), bsr.block_cols.data_ptr(), X.data_ptr(), Y.data_ptr(),
            nbr, kmax, bm, bn, p, _STORAGE[bsr.dtype], stream,
        )
    _check_launch("bsr_spmm", code)
    _count_launch("bsr_spmm")
    return Y


# ---------------------------------------------------------------------------
# kernel D: symmetric BSR SpMM on half storage
# ---------------------------------------------------------------------------
def sym_bsr_spmm_plain(sym, X: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sym_bsr_spmm`: gather + batched einsum +
    ``index_add_`` over the (n, p) panel, accumulating in f32 for
    bf16/f16 storage.  Any dtype (complex: Hermitian), any device."""
    bm, bn = sym.block_shape
    acc = sym._acc_dtype
    p = X.shape[1]
    xb = X.reshape(-1, bn, p).to(acc)
    diag = sym.diag_data.to(acc)
    upper = sym.upper_data.to(acc)
    cols = sym.upper_cols.long()
    y = torch.einsum("rij,rjp->rip", diag, xb)
    y = y + torch.einsum("rkij,rkjp->rip", upper, xb[cols])
    up = upper.conj() if upper.is_complex() else upper
    contrib = torch.einsum("rkij,rip->rkjp", up, xb)  # (nbr, ku, bn, p)
    y.index_add_(0, cols.reshape(-1), contrib.reshape(-1, bn, p))
    return y.reshape(sym.shape[0], p)


def sym_bsr_spmm(sym, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` for a :class:`~eigenex_tpu_torch.sparse.sym_bsr.SymBSRMatrix`
    and an (n, p) panel, any p >= 1.

    CUDA tensors launch the two-pass kernel of ``csrc/sym_bsr_spmm.cu``
    (f32 or bf16 square blocks, b a multiple of 128, f32 X, any band
    reach) or raise; CPU tensors take :func:`sym_bsr_spmm_plain`.  Two
    calls on the same input give bit-equal results."""
    if not sym.upper_data.is_cuda:
        return sym_bsr_spmm_plain(sym, X)
    return _product("sym_bsr_spmm", sym, X)


def _launch_sym_bsr_spmm(sym, X: torch.Tensor) -> torch.Tensor:
    nbr, ku, b = _check_sym(sym, "sym_bsr_spmm")
    X = _kernel_panel(X, sym.shape[1], sym.device, "sym_bsr_spmm")
    p = X.shape[1]
    col_ptr, slot_ids = sym.column_index()
    Y = torch.empty((sym.shape[0], p), dtype=torch.float32, device=sym.device)
    tbuf = torch.empty((nbr * ku, b, min(p, _MAX_COLS)), dtype=torch.float32, device=sym.device)
    entry = _entry("sym_bsr_spmm")
    with _on_device(sym.device) as stream:
        code = entry(
            sym.diag_data.data_ptr(), sym.upper_data.data_ptr(), sym.upper_cols.data_ptr(),
            col_ptr.data_ptr(), slot_ids.data_ptr(), X.data_ptr(), Y.data_ptr(),
            tbuf.data_ptr(), nbr, ku, b, p, _STORAGE[sym.dtype], stream,
        )
    _check_launch("sym_bsr_spmm", code)
    _count_launch("sym_bsr_spmm")
    return Y


# ---------------------------------------------------------------------------
# kernel E: row-compressed SpMV of a symmetric operator, both triangles stored
# ---------------------------------------------------------------------------
#: lanes of the widest row group of :func:`csr_spmv` (a warp)
_MAX_GROUP = 32
#: entries a lane of :func:`csr_spmv` loads in one pass (``kEntries`` in csr_spmv.cu)
_CSR_ENTRIES = 4


def csr_group(nnz: int, n_rows: int) -> int:
    """Lanes a row of :func:`csr_spmv`: the smallest power of two whose passes
    of 4 entries a lane cover the operator's mean row length, between 1 and
    32 (4 at a mean of 13)."""
    mean = nnz / max(n_rows, 1)
    group = 1
    while group < _MAX_GROUP and _CSR_ENTRIES * group < mean:
        group *= 2
    return group


def csr_spmv_plain(csr, x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`csr_spmv`: gather + multiply + ``index_add_``
    over the stored entries, accumulating in f32 for bf16/f16 storage.  Any
    dtype, any device."""
    acc = csr._acc_dtype
    prod = csr.val.to(acc) * x.to(acc)[csr.col.long()]
    y = torch.zeros(csr.shape[0], dtype=prod.dtype, device=prod.device)
    return y.index_add_(0, csr.row_ids(), prod)


def csr_spmv(csr, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` for a :class:`~eigenex_tpu_torch.sparse.sym_csr.SymCSRMatrix`.

    CUDA tensors launch the kernel of ``csrc/csr_spmv.cu`` (f32 or bf16
    values, int32 ``rowptr`` and ``col``, f32 x) or raise; CPU tensors take
    :func:`csr_spmv_plain`.  No scratch and no atomics: two calls on the same
    input give bit-equal results."""
    if not csr.val.is_cuda:
        return csr_spmv_plain(csr, x)
    return _product("csr_spmv", csr, x)


def _check_csr(csr, what: str) -> int:
    """The lanes a row of a container the row-compressed kernel takes, or
    raise.  The indices are checked once on the device (one synchronisation
    at the container's first launch), so that the kernel reads no entry
    outside its arrays."""
    n = csr.shape[0]
    if csr.dtype not in _STORAGE:
        raise EigenexError(f"{what}: value storage {csr.dtype} is not float32/bfloat16")
    for name, t, size in (("rowptr", csr.rowptr, n + 1), ("col", csr.col, csr.val.shape[0])):
        if t.dtype != torch.int32 or t.ndim != 1 or t.shape[0] != size:
            raise EigenexError(f"{what}: {name} must be int32 of shape ({size},)")
        if not t.is_contiguous() or t.device != csr.device:
            raise EigenexError(f"{what}: {name} must be contiguous on the values' device")
    if csr.val.ndim != 1 or not csr.val.is_contiguous():
        raise EigenexError(f"{what}: val must be a contiguous vector")
    nnz = csr.val.shape[0]
    if nnz >= 2 ** 31 or n >= 2 ** 31:
        raise EigenexError(f"{what}: {nnz} entries of {n} rows do not fit int32 indices")
    rowptr = csr.rowptr
    ok = (rowptr[0] == 0) & (rowptr[-1] == nnz) & (rowptr[1:] >= rowptr[:-1]).all()
    if nnz:
        ok &= (csr.col.min() >= 0) & (csr.col.max() < csr.shape[1])
    if not bool(ok):
        raise EigenexError(f"{what}: rowptr is not a row pointer of {nnz} entries, or a column "
                           f"lies outside 0..{csr.shape[1] - 1}")
    return csr_group(csr.val.shape[0], n)


def _launch_csr_spmv(csr, x: torch.Tensor) -> torch.Tensor:
    device = csr.device
    group = csr.kernel_workspace("csr_spmv", lambda: _check_csr(csr, "csr_spmv"))
    x = _kernel_vector(x, csr.shape[1], device, "csr_spmv")
    y = torch.empty(csr.shape[0], dtype=torch.float32, device=device)
    with _on_device(device) as stream:
        code = _entry("csr_spmv")(
            csr.rowptr.data_ptr(), csr.col.data_ptr(), csr.val.data_ptr(), x.data_ptr(),
            y.data_ptr(), csr.shape[0], group, _STORAGE[csr.dtype], stream,
        )
    _check_launch("csr_spmv", code)
    _count_launch("csr_spmv")
    return y


# ---------------------------------------------------------------------------
# autograd: the five products differentiable in x (or X), not in the operand
# ---------------------------------------------------------------------------
#: kernel name -> the function that launches it on (container, x);
#: :class:`_KernelProduct` looks its launches up here when it runs
_LAUNCH = {
    "bsr_spmv": _launch_bsr_spmv,
    "sym_bsr_spmv": _launch_sym_bsr_spmv,
    "bsr_spmm": _launch_bsr_spmm,
    "sym_bsr_spmm": _launch_sym_bsr_spmm,
    "csr_spmv": _launch_csr_spmv,
}


class _KernelProduct(torch.autograd.Function):
    """y = A x by kernel ``name``; backward A^H g by the same kernel, on
    ``kernel_adjoint()``'s pack for the general kernels and on the same
    operand for the symmetric ones (A = A^T)."""

    @staticmethod
    def forward(ctx, x, op, name):
        ctx.op, ctx.name = op, name
        return _LAUNCH[name](op, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        adj = ctx.op if ctx.name in _SELF_ADJOINT else ctx.op.kernel_adjoint()
        return _LAUNCH[ctx.name](adj, g), None, None


def _product(name: str, op, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``name`` on (op, x): through :class:`_KernelProduct`
    when autograd records this call, directly otherwise."""
    if x.requires_grad and torch.is_grad_enabled():
        return _KernelProduct.apply(x, op, name)
    return _LAUNCH[name](op, x)
