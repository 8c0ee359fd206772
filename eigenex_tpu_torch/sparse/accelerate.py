"""Scalar-sparse acceleration: band-reducing reorder + dense-block packing.

Counterpart of the square routes of ``eigenex_tpu/sparse/accelerate.py``.
A scalar COO matvec is a gather/scatter that moves a few bytes per
request; the card's bandwidth only flows through dense tiles.  This
module is the bridge from "born scalar" to the block kernels of
:mod:`eigenex_tpu_torch.ops.cuda_spmv`:

1. **Reorder** -- a reverse Cuthill-McKee permutation over the
   (symmetrised) pattern concentrates entries near the diagonal.
2. **Pack** -- the permuted triplets densify into 128x128 blocks in
   diagonal + strictly-upper (SymBSR) storage, or, for a non-symmetric
   operator, into 32x128 general BSR-ELL blocks.  bf16 storage is
   auto-selected only when *lossless* (every value round-trips bf16
   exactly -- dyadic couplings do), and the kernels widen bf16 blocks to
   f32 in registers, so bf16 storage never degrades Krylov convergence.
3. **Solve in permuted space** -- the permutation is applied once to the
   operator on the host; solvers run entirely in permuted coordinates
   (no per-matvec gather), and eigenvectors are unpermuted at the end
   (:meth:`AcceleratedOperator.restore`).

On the card, a square operator whose nonzeros fill few of its blocks is
stored row-compressed instead (:class:`~eigenex_tpu_torch.sparse.sym_csr.SymCSRMatrix`,
both triangles of a symmetric one, for the ``csr_spmv`` kernel): the slots the
block pack would hold are counted from the triplets, and the storage whose
product reads fewer bytes is taken (:func:`choose_storage`).  The reference's
128x128 and 32x128 packs exist for the TPU's matrix unit; the card gathers x
from L2 instead.  The
CPU keeps the reference's block pack, and
:meth:`AcceleratedOperator.block_matrix` packs it on first need for the
routes that take only blocks.

Padding rows/cols (to the block multiple) are structurally zero: with a
zero-padded start vector the Krylov space never leaves the embedded
subspace, so no spurious eigenvalues enter the computed spectrum
(:meth:`AcceleratedOperator.embed` and :func:`_padding_safe_v0` build
such vectors).

Complex operators ride the same pipeline through the real embedding
[[A,-B],[B,A]] (:mod:`eigenex_tpu_torch.sparse.realify`): a complex
Hermitian operator becomes real symmetric and reaches the half-storage
kernel; a complex general one becomes a real general operator.

Rectangular operators take a two-sided route: RCM on the bipartite graph
[[0, A], [A^T, 0]] gives a row and a column permutation
(:func:`bipartite_band_permutation`), both sides pad to lcm(bm, bn), and
the pack is general 32x128 BSR-ELL.  That is the ``svds`` Gram pipeline:
:meth:`AcceleratedOperator.embed_left` / :meth:`~AcceleratedOperator.restore_right`
carry vectors of the other side, and :meth:`~AcceleratedOperator.adjoint_matrix`
packs A^H at the same block shape, so both Gram matvecs reach the general
SpMV kernel.

The host stages run where the JAX package runs them: in the native C++
builders (:mod:`eigenex_tpu_torch.native`, the port's copy of the JAX
package's) whenever the library is available -- the RCM ordering, the CSR
adjacency of a trusted-symmetric pattern, the one shared block sort, and the
threaded symmetric and general packers, which emit f32 or bf16 directly (bf16
rounded to nearest even in C++, through f32; the bits go to the card as they
are) -- and in numpy and scipy otherwise.  The two routes agree on the pack
given the same permutation; their RCM orderings differ in tie-breaks.
:meth:`AcceleratedOperator.save` / :meth:`~AcceleratedOperator.load` read
and write the JAX package's ``.npz`` format, so a pack made by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Any

import numpy as np
import torch

from .. import native
from ..core.operators import LinearOperator
from ..utils.device import resolve_device
from ..utils.exceptions import EigenexError
from ..utils.profiling import add_span, annotate, count
from ..utils.prng import make_generator, random_vector
from ..utils.tolerance import as_torch_dtype
from .bsr import BSRMatrix, _pack_bsr_host
from .coo import COOMatrix
from .realify import realify_coo
from .sym_bsr import SymBSRMatrix, sym_bsr_from_bsr
from .sym_csr import SymCSRMatrix, sym_csr_from_triplets

__all__ = [
    "AcceleratedOperator",
    "accelerate",
    "band_permutation",
    "bipartite_band_permutation",
    "choose_storage",
    "dedup_embedded_pairs",
]


def _as_host_triplets(A) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple[int, int]]:
    """(rows, cols, vals, shape) host arrays from any accepted operand."""
    if isinstance(A, COOMatrix):
        return (
            A.row.cpu().numpy().astype(np.int64),
            A.col.cpu().numpy().astype(np.int64),
            A.val.cpu().numpy(),
            A.shape,
        )
    if hasattr(A, "tocoo"):  # scipy sparse
        coo = A.tocoo()
        return (
            coo.row.astype(np.int64),
            coo.col.astype(np.int64),
            coo.data,
            coo.shape,
        )
    if isinstance(A, tuple) and len(A) == 4:
        r, c, v, shape = A
        return (
            np.asarray(r, np.int64),
            np.asarray(c, np.int64),
            np.asarray(v),
            (int(shape[0]), int(shape[1])),
        )
    raise EigenexError(
        "accelerate() expects a COOMatrix, a scipy sparse matrix, or a "
        "(rows, cols, vals, shape) tuple"
    )


def _merged(r, c, v, shape):
    """Row-major sorted, duplicate-merged triplets (full canonical form)."""
    key = r * np.int64(shape[1]) + c
    order = np.argsort(key, kind="stable")
    key, v = key[order], v[order]
    uniq, start = np.unique(key, return_index=True)
    if len(uniq) != len(key):
        sums = np.add.reduceat(v, start)
        key, v = uniq, sums
    return key // shape[1], key % shape[1], v


def _canonicalize(r, c, v, shape):
    """Duplicate-free triplets, NOT necessarily sorted: duplicates are
    detected with a payload-free sort of the flat keys and the full merge
    is paid for only when they exist."""
    key = np.sort(r * np.int64(shape[1]) + c)
    if len(key) > 1 and bool(np.any(key[1:] == key[:-1])):
        return _merged(r, c, v, shape)
    return r, c, v


def _is_hermitian(r, c, v, shape) -> bool:
    """Exact A == A^H on duplicate-free triplets (any order)."""
    if shape[0] != shape[1]:
        return False
    key = r * np.int64(shape[1]) + c
    tkey = c * np.int64(shape[1]) + r
    korder = np.argsort(key, kind="stable")
    torder = np.argsort(tkey, kind="stable")
    if not np.array_equal(key[korder], tkey[torder]):
        return False
    return np.array_equal(v[korder], np.conj(v[torder]))


def _sampled_hermitian_check(r, c, v, shape, *, sample: int = 2048, seed: int = 0):
    """Cheap sanity check behind ``symmetric=True``: O(nnz) vectorised
    pattern counts + a sampled mirror-value probe, instead of the full
    O(nnz log nnz) transpose comparison the flag exists to skip.  Works
    on UNSORTED duplicate-free triplets.

    Raises :class:`EigenexError` on any detected asymmetry.  This cannot
    PROVE Hermiticity (only the full check can), but it catches the
    realistic misuses -- a general operator passed by mistake, a
    triangle-only store, sign errors -- rather than silently symmetrising
    them into a wrong answer."""
    n_lo = int(np.count_nonzero(c < r))
    n_up = int(np.count_nonzero(c > r))
    if n_lo != n_up:
        raise EigenexError(
            f"symmetric=True, but the pattern has {n_lo} strictly-lower vs "
            f"{n_up} strictly-upper entries -- the operator is not Hermitian "
            "(a triangle-only store must be expanded first)"
        )
    off = np.nonzero(r != c)[0]
    if off.size == 0:
        return
    rng = np.random.default_rng(seed)
    pick = off if off.size <= sample else rng.choice(off, size=sample, replace=False)
    # entries on the sampled MIRROR rows only -- small subset, own sort
    is_mrow = np.zeros(shape[0], bool)
    is_mrow[c[pick]] = True
    sel = np.nonzero(is_mrow[r])[0]
    skey = r[sel] * np.int64(shape[1]) + c[sel]
    so = np.argsort(skey, kind="stable")
    skey, sval = skey[so], v[sel][so]
    tkey = c[pick] * np.int64(shape[1]) + r[pick]
    pos = np.searchsorted(skey, tkey)
    pos = np.minimum(pos, max(len(skey) - 1, 0))
    found = skey[pos] == tkey if len(skey) else np.zeros(len(tkey), bool)
    if not np.all(found):
        i = int(pick[np.nonzero(~found)[0][0]])
        raise EigenexError(
            f"symmetric=True, but entry ({int(r[i])}, {int(c[i])}) has no "
            "mirror entry -- the operator is not Hermitian"
        )
    if not np.array_equal(sval[pos], np.conj(v[pick])):
        bad = int(pick[np.nonzero(sval[pos] != np.conj(v[pick]))[0][0]])
        raise EigenexError(
            f"symmetric=True, but entry ({int(r[bad])}, {int(c[bad])}) does "
            "not equal the conjugate of its mirror -- the operator is not "
            "Hermitian"
        )


def band_permutation(rows, cols, n: int, *, assume_symmetric: bool = False) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the SYMMETRISED pattern of the
    triplets -- perm[i] = original index at new position i, so
    ``A[perm][:, perm]`` is banded (scipy's convention).

    The native BFS (``rcm_permutation`` of the native builders) when the
    library is available, scipy's ``reverse_cuthill_mckee`` otherwise; the
    two orderings differ only in tie-breaks.  ``assume_symmetric``: the
    pattern is already symmetric, so the native CSR adjacency is built from
    the triplets directly (any order), without scipy's transpose-and-add."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    if assume_symmetric and len(rows) and native.native_available():
        rowptr, colidx = native.build_csr(rows, cols, n)
        return native.rcm_permutation(rowptr, colidx)
    import scipy.sparse as sp

    pattern = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    return _rcm(pattern + pattern.T)  # symmetrise for the general case


def _rcm(pattern) -> np.ndarray:
    """RCM ordering of a symmetric scipy CSR pattern, native or scipy."""
    if native.native_available():
        return native.rcm_permutation(pattern.indptr.astype(np.int64),
                                      pattern.indices.astype(np.int64))
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return reverse_cuthill_mckee(pattern, symmetric_mode=True).astype(np.int64)


def bipartite_band_permutation(rows, cols, m: int, n: int):
    """(row_perm, col_perm) banding a RECTANGULAR pattern: RCM on the
    bipartite graph [[0, A], [A^T, 0]] (row node i, column node m + j for
    each entry (i, j)), its ordering split back into the row and the column
    subsequence, so ``A[row_perm][:, col_perm]`` is banded."""
    import scipy.sparse as sp

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    br = np.concatenate([rows, cols + m])
    bc = np.concatenate([cols + m, rows])
    perm_all = _rcm(sp.csr_matrix((np.ones(len(br), np.int8), (br, bc)), shape=(m + n, m + n)))
    return perm_all[perm_all < m], perm_all[perm_all >= m] - m


def _bf16_lossless(values: np.ndarray) -> bool:
    """True iff every value round-trips bfloat16 exactly (then bf16
    storage halves SpMV traffic at ZERO accuracy cost -- e.g. the dyadic
    +-J/2, +-Jz/4 couplings of spin Hamiltonians).  The round trip runs
    through ``torch.bfloat16``."""
    v32 = torch.as_tensor(np.ascontiguousarray(values, dtype=np.float32))
    return bool(torch.equal(v32.to(torch.bfloat16).to(torch.float32), v32))


def _host_cast(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Cast packed block data ON THE HOST before the move to the device:
    uploading f32 and casting there would transiently hold both copies in
    device memory."""
    return torch.as_tensor(a).to(dtype).to(device)


def _no_stage(name, t_start):
    return time.perf_counter()


def choose_storage(nnz: int, n_pad: int, block_slots: int,
                   value_bytes: int) -> tuple[str, dict]:
    """(storage, bytes a product reads in each) of a square operator on the
    card: ``"row_compressed"`` (every stored entry, ``nnz`` -- both triangles
    of a symmetric operator -- as a value and an int32 column, and
    ``n_pad + 1`` int32 row pointers) when that is fewer bytes than
    ``"block"`` (the ``block_slots`` values the block pack reads: the real
    blocks of the half-storage pack, or every slot of the general BSR-ELL
    pack), else ``"block"``."""
    sizes = {"row_compressed": nnz * (value_bytes + 4) + (n_pad + 1) * 4,
             "block": block_slots * value_bytes}
    return ("row_compressed" if sizes["row_compressed"] < sizes["block"] else "block"), sizes


def _storage_rule_applies(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether :func:`choose_storage` chooses the storage of a square pack:
    on the card, for the value types the row-compressed kernel takes.  The
    CPU keeps the reference's block pack."""
    from ..ops.cuda_spmv import kernel_storage

    return device.type == "cuda" and kernel_storage(dtype)


def _block_census(r, c, block: int, nbr: int) -> tuple[int, int, int]:
    """(blocks, ku, reach) of the half-storage pack these triplets would
    make: the blocks a product reads (the ``nbr`` diagonal blocks and every
    distinct strictly-upper block that holds an entry), the most upper blocks
    of a block row (at least 1, as the packers make it) and the band reach.
    The upper blocks are marked in a bitmap over the band reach where that is
    at most a few bytes an entry (RCM-ordered operators), else counted by
    ``np.unique``."""
    key = r // block
    dist = c // block - key
    reach = int(dist.max()) if len(dist) else 0
    np.multiply(key, reach, out=key)
    key += dist  # block (br, br + dist) -> br * reach + dist, distinct for 0 < dist <= reach
    key = key[dist > 0]
    if nbr * reach > 4 * len(r) + 2 ** 20:
        key = np.unique(key)
    else:
        seen = np.zeros(nbr * reach + 1, bool)
        seen[key] = True
        key = np.flatnonzero(seen)
    per_row = np.bincount((key - 1) // max(reach, 1), minlength=1)
    return nbr + len(key), max(int(per_row.max()), 1), reach


def _general_kmax(r, c, bm: int, bn: int, n_pad: int) -> int:
    """k_max of the general (bm, bn) BSR-ELL pack these triplets would make:
    the most distinct blocks a block row holds (at least 1, as the packers
    make it), counted without packing."""
    nbc = n_pad // bn
    key = np.unique((r // bm) * nbc + c // bn)
    return max(int(np.bincount(key // nbc, minlength=1).max()), 1)


def _pack_row_compressed(r, c, v, n_pad, dtype: torch.dtype, device, use_native,
                         hermitian: bool, stage=_no_stage) -> SymCSRMatrix:
    """Permuted triplets (both triangles where ``hermitian``) ->
    SymCSRMatrix.  Native: the row-major (row, column) argsort as two stable
    threaded counting passes of the CSR builder; numpy: ``lexsort``.  Values
    are cast on the host and the arrays reach the device in one copy each."""
    ts = time.perf_counter()
    order = None
    if use_native:  # two stable threaded passes: by column, then by row
        _, by_col = native.build_csr(c, np.arange(len(c), dtype=np.int64), n_pad)
        _, order = native.build_csr(r[by_col], by_col, n_pad)
        del by_col
    ts = stage("row_sort", ts)
    mat = sym_csr_from_triplets(r, c, v, n_pad, dtype, device, order, hermitian=hermitian)
    stage("device_put", ts)
    return mat


def _pack_symmetric(r, c, v, n_pad, block, dtype: torch.dtype, device, use_native,
                    stage=_no_stage):
    """Permuted triplets -> (SymBSRMatrix, skipped).  Native: one block sort,
    then the threaded diagonal + strictly-upper packer, straight to bf16
    when that is the storage; ``skipped`` counts the strictly-lower-block
    triplets it dropped (their mirrors are the upper blocks).  numpy: pack
    both triangles into BSR-ELL in f32, keep the diagonal and the strictly
    upper blocks; ``skipped`` is None."""
    nbr = n_pad // block
    ts = time.perf_counter()
    if use_native:
        order, _kmax, ku, reach = native.blk_widths(r, c, block, block, nbr)
        ts = stage("blk_sort", ts)
        v64 = v.astype(np.float64)
        if dtype == torch.bfloat16:
            diag, upper, ucols, skipped = native.sym_bsr_pack_bf16(r, c, v64, order, nbr, block, ku)
        else:
            diag, upper, ucols, skipped = native.sym_bsr_pack_f32(r, c, v64, order, nbr, block, ku)
        del order, v64
        ts = stage("pack_scatter", ts)
        mat = SymBSRMatrix(_host_cast(diag, dtype, device), _host_cast(upper, dtype, device),
                           torch.from_numpy(ucols).to(device), (n_pad, n_pad), int(reach))
        stage("device_put", ts)
        return mat, skipped
    data, block_cols, _ = _pack_bsr_host(
        r, c, v.astype(np.float32), (n_pad, n_pad), (block, block)
    )
    full = BSRMatrix(torch.as_tensor(data), torch.as_tensor(block_cols), (n_pad, n_pad))
    sym = sym_bsr_from_bsr(full, device="cpu")
    ts = stage("pack_scatter", ts)
    mat = SymBSRMatrix(
        _host_cast(sym.diag_data, dtype, device),
        _host_cast(sym.upper_data, dtype, device),
        sym.upper_cols.to(device),
        sym.shape,
        sym.band_reach,
    )
    stage("device_put", ts)
    return mat, None


def _pack_general(r, c, v, m_pad, n_pad, bm, bn, dtype: torch.dtype, device, use_native,
                  stage=_no_stage) -> BSRMatrix:
    """Permuted triplets -> general BSR-ELL with (bm, bn) blocks: the native
    block sort and threaded packer (f32, or bf16 directly), or the numpy
    packer in f32; cast on the host to the storage dtype."""
    nbr, nbc = m_pad // bm, n_pad // bn
    ts = time.perf_counter()
    if use_native:
        order, kmax, _ku, _reach = native.blk_widths(r, c, bm, bn, nbc)
        ts = stage("blk_sort", ts)
        pack = native.bsr_pack_bf16 if dtype == torch.bfloat16 else native.bsr_pack_f32
        data, block_cols = pack(r, c, v.astype(np.float64), order, nbr, nbc, bm, bn, kmax)
        del order
    else:
        data, block_cols, _ = _pack_bsr_host(r, c, v.astype(np.float32), (m_pad, n_pad), (bm, bn))
    ts = stage("pack_scatter", ts)
    mat = BSRMatrix(_host_cast(data, dtype, device), torch.as_tensor(block_cols).to(device),
                    (m_pad, n_pad))
    stage("device_put", ts)
    return mat


def _padding_safe_v0(orig_n: int, padded_n: int, dtype, seed: int, device) -> torch.Tensor:
    """Random start vector supported on the ORIGINAL coordinates only.

    Structurally-zero padding rows add a spurious eigenvalue 0 of
    multiplicity (padded_n - orig_n); a start vector with no component in
    that exactly-invariant subspace keeps Krylov iterates out of it, so
    the padded operator's Ritz values are those of the original."""
    v = random_vector(make_generator(seed), orig_n, dtype, normalize=False, device=device)
    out = torch.zeros((padded_n,), dtype=as_torch_dtype(dtype), device=device)
    out[:orig_n] = v
    return out


#: one D2H copy through a staging buffer at a time (the buffer is reused)
_STAGING_LOCK = threading.Lock()


def _as_tensor(a) -> torch.Tensor:
    """A tensor, detached, or a host array as a tensor over its memory (a
    copy only where torch cannot map it: read-only or negatively strided)."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.asarray(a)
    if not a.flags.writeable or min(a.strides, default=0) < 0:
        a = a.copy()
    return torch.from_numpy(a)


def _moved(v: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``v`` on ``device``: as it is when it is there, else moved once (the
    bytes of a move from a device to the host are counted)."""
    if v.device == device:
        return v
    if device.type == "cpu":
        count("accelerate.d2h_bytes", v.numel() * v.element_size())
    return v.to(device)


def _host_counted(method):
    """Count the host ms spent inside ``method`` as ``accelerate.host_ms``,
    with no profiler running too."""

    @functools.wraps(method)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return method(*args, **kwargs)
        finally:
            count("accelerate.host_ms", (time.perf_counter() - t0) * 1e3)

    return timed


@dataclasses.dataclass(frozen=True)
class AcceleratedOperator:
    """A scalar-sparse operator repacked for the block kernels.

    Lives in PERMUTED + PADDED coordinates: ``matrix`` is ``P A P^T``
    (zero-padded to the block multiple), where P is the band-reducing
    permutation; a rectangular operator has a row permutation of its own,
    ``matrix`` = ``P_r A P^T``.  Solvers run here; :meth:`embed` carries
    original-space vectors in and :meth:`restore` carries results back
    (one index operation each, on the vectors' device -- never a
    per-matvec gather)."""

    matrix: Any  # SymBSRMatrix | SymCSRMatrix | BSRMatrix, permuted + padded
    perm: np.ndarray  # (n_work,) original COLUMN index at permuted position i
    orig_shape: tuple[int, int]  # user-facing shape (before the embedding)
    symmetric: bool
    complexified: bool  # True: ``matrix`` is the real embedding (dim 2n)
    stats: dict
    #: rectangular operators carry a separate ROW permutation (bipartite
    #: RCM); None for square operators, where ``perm`` applies to both sides
    row_perm: np.ndarray | None = None
    #: PERMUTED host triplets, kept for general block packs only:
    #: :meth:`adjoint_matrix` packs A^H from them.  Not written by
    #: :meth:`save`.
    host_triplets: Any = None

    @property
    def shape(self) -> tuple[int, int]:
        """Padded working shape (what the solvers see)."""
        return self.matrix.shape

    @property
    def n_work(self) -> int:
        """Unpadded working COLUMN dimension (2n for complexified)."""
        return len(self.perm)

    @property
    def m_work(self) -> int:
        """Unpadded working ROW dimension (= :attr:`n_work` when square)."""
        return len(self._row_perm)

    @property
    def _row_perm(self) -> np.ndarray:
        return self.row_perm if self.row_perm is not None else self.perm

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    def as_linear_operator(self) -> LinearOperator:
        return self.matrix.as_linear_operator()

    @property
    def _embed_dtype(self) -> torch.dtype:
        """Dtype of embedded vectors: the container's ACCUMULATION dtype
        (f64 containers must not truncate inputs to f32)."""
        return torch.float64 if self.matrix.dtype == torch.float64 else torch.float32

    # -- the boundary between original and permuted coordinates -----------
    # Vectors cross it by one gather (:meth:`_gather`) and one scatter
    # (:meth:`_scatter`), as index operations on the device the vectors
    # live on: the host sees only the answer, once.

    @annotate("eigenex.embed")
    @_host_counted
    def embed(self, v) -> torch.Tensor:
        """Original-space (n,) or (n, k) vector(s) -> permuted,
        zero-padded tensor on the operator's device.  Complex inputs
        realify to [Re v; Im v] first when the operator was complexified.
        A tensor already on that device stays there; anything else is
        moved there once."""
        v = _as_tensor(v)
        if v.shape[0] != self.orig_shape[1]:
            raise EigenexError(
                f"embed expects length {self.orig_shape[1]}, got {v.shape[0]}"
            )
        if v.is_complex() and not self.complexified:
            raise EigenexError("complex vector for a real operator")
        v = _moved(v, self.device)
        if self.complexified:
            v = torch.cat([v.real, v.imag] if v.is_complex() else [v, torch.zeros_like(v)])
        return self._gather(v, rows=False)

    @annotate("eigenex.restore")
    @_host_counted
    def restore(self, V) -> np.ndarray:
        """Permuted-padded ROW-space (m_pad,) or (m_pad, k) result(s) ->
        original row coordinates, as a new host array (complex when the
        operator was complexified).  For a square operator rows and columns
        share one permutation, so this inverts :meth:`embed`."""
        V = _as_tensor(V)
        if V.shape[0] != self.shape[0]:
            raise EigenexError(
                f"restore expects length {self.shape[0]}, got {V.shape[0]}"
            )
        out = self._scatter(V, rows=True)
        if self.complexified:
            n = self.orig_shape[0]
            out = out[:n] + 1j * out[n:]
        return out

    # -- the svds pipeline (rectangular operands) -------------------------
    @_host_counted
    def embed_left(self, v) -> torch.Tensor:
        """Original ROW-space vector(s) -> permuted, zero-padded tensor over
        the operator's OUTPUT side: the input side of A^H in the ``svds``
        Gram pipeline (the rectangular analog of :meth:`embed`)."""
        v = _as_tensor(v)
        if v.shape[0] != self.orig_shape[0]:
            raise EigenexError(
                f"embed_left expects length {self.orig_shape[0]}, got {v.shape[0]}"
            )
        if v.is_complex():
            raise EigenexError("complex vector for a real operator")
        return self._gather(_moved(v, self.device), rows=True)

    @_host_counted
    def restore_right(self, V) -> np.ndarray:
        """Permuted-padded COLUMN-space result(s) -> original column space:
        the right singular vectors of the ``svds`` pipeline (the rectangular
        analog of :meth:`restore`)."""
        V = _as_tensor(V)
        if V.shape[0] != self.shape[1]:
            raise EigenexError(
                f"restore_right expects length {self.shape[1]}, got {V.shape[0]}"
            )
        return self._scatter(V, rows=False)

    def _gather(self, v: torch.Tensor, rows: bool) -> torch.Tensor:
        """Original-order ``v`` -> permuted order (``rows``: the row side's
        permutation), zero-padded to that side's padded length, in the embed
        dtype, on ``v``'s device."""
        index = self._index(rows, inverse=False, device=v.device)
        out = torch.zeros((self.shape[0 if rows else 1],) + tuple(v.shape[1:]),
                          dtype=self._embed_dtype, device=v.device)
        out[: len(index)] = v.index_select(0, index)
        return out

    def _scatter(self, V: torch.Tensor, rows: bool) -> np.ndarray:
        """Permuted-padded ``V`` -> original order, as a new host array: a
        gather by the inverse permutation on ``V``'s device, which writes each
        row once (no atomics, so re-runs are bit-equal), then one copy to the
        host."""
        out = V.index_select(0, self._index(rows, inverse=True, device=V.device))
        if out.device.type == "cpu":
            return out.numpy()  # index_select made it: nothing else holds it
        count("accelerate.d2h_bytes", out.numel() * out.element_size())
        return self._copy_to_host(out)

    def _copy_to_host(self, out: torch.Tensor) -> np.ndarray:
        """A device tensor -> a new NumPy array the caller owns, through a
        pinned staging buffer kept on the operator and reused (grown when a
        result is larger): one DMA copy, then one host copy out of it, so
        no result ever pins memory of its own.  The host copy is torch's,
        on the intra-op threads: writing a fresh array faults in its pages,
        and that work splits across cores."""
        nbytes = out.numel() * out.element_size()
        with _STAGING_LOCK:
            staging = self.__dict__.get("_staging")
            if staging is None or staging.numel() < nbytes:
                staging = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                object.__setattr__(self, "_staging", staging)
            host = staging[:nbytes].view(out.dtype).view(out.shape)
            host.copy_(out)
            res = np.empty(tuple(out.shape), host.numpy().dtype)
            torch.from_numpy(res).copy_(host)
            return res

    def _index(self, rows: bool, inverse: bool, device: torch.device) -> torch.Tensor:
        """The permutation (``rows``: the row side's) or its inverse as an
        index on ``device``, uploaded for one call and freed with it.  Its host
        copy is made on first use and kept: int32 (int64 past 2**31 rows),
        pinned where it goes to the card, so the upload does not block the
        host.  Nothing is kept on the card: a resident index would add to
        every solve's peak device memory."""
        rows = rows and self.row_perm is not None  # square: one permutation
        cache = self.__dict__.get("_index_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_index_cache", cache)
        host = cache.get((rows, inverse))
        if host is None:
            perm = np.asarray(self.row_perm if rows else self.perm)
            if inverse:
                inv = np.empty_like(perm)
                inv[perm] = np.arange(len(perm))
                perm = inv
            host = torch.from_numpy(perm.astype(np.int32 if len(perm) < 2**31 else np.int64))
        if device.type == "cuda" and not host.is_pinned():
            host = host.pin_memory()
        cache[(rows, inverse)] = host
        return host.to(device, non_blocking=True)

    def block_matrix(self):
        """The operator as a block container, for the routes that take only
        blocks (the mesh, the block filters and KPM): ``matrix`` itself when
        it is one; for a row-compressed operator the pack that ``accelerate``
        makes of the same triplets on the CPU (half storage where it is
        symmetric, general BSR-ELL otherwise), packed on first need on the
        operator's device and cached (it then sits beside the row-compressed
        storage)."""
        if not isinstance(self.matrix, SymCSRMatrix):
            return self.matrix
        cached = self.__dict__.get("_block_cache")
        if cached is None:
            r, c, v = self.matrix.triplets()
            use_native = native.native_available() and np.isrealobj(v)
            n_pad, dtype = self.shape[0], self.matrix.dtype
            if self.matrix.hermitian:
                cached, _ = _pack_symmetric(r, c, v, n_pad, self.stats.get("block", 128),
                                            dtype, self.device, use_native)
            else:
                bm, bn = self.stats.get("general_block", (32, 128))
                cached = _pack_general(r, c, v, n_pad, n_pad, bm, bn, dtype, self.device,
                                       use_native)
            object.__setattr__(self, "_block_cache", cached)
        return cached

    def adjoint_matrix(self):
        """A^H of the packed container at the SAME (bm, bn) block shape, so
        the ``svds`` Gram pipeline's second matvec reaches the general SpMV
        kernel too (the block transpose of ``BSRMatrix.adjoint()`` gives
        (bn, bm) blocks, which the kernel does not take).  Packed once from
        the kept host triplets or, for a loaded pack that has none, from the
        stored blocks (:meth:`BSRMatrix.kernel_adjoint`); cached.  A
        symmetric container is its own adjoint; a row-compressed one gives
        its :meth:`~SymCSRMatrix.kernel_adjoint`."""
        cached = self.__dict__.get("_adjoint_cache")
        if cached is not None:
            return cached
        if isinstance(self.matrix, SymBSRMatrix):
            return self.matrix
        if isinstance(self.matrix, SymCSRMatrix):
            return self.matrix.kernel_adjoint()
        if self.host_triplets is None:
            adj = self.matrix.kernel_adjoint()
        else:
            r, c, v = self.host_triplets
            bm, bn = self.matrix.block_shape
            m_pad, n_pad = self.matrix.shape
            # swapped triplets: rows of A^H are columns of A; the pad sizes
            # swap with them, the block shape stays
            use_native = native.native_available() and np.isrealobj(v)
            adj = _pack_general(c, r, np.conj(v) if np.iscomplexobj(v) else v,
                                n_pad, m_pad, bm, bn, self.matrix.dtype, self.device,
                                use_native)
        object.__setattr__(self, "_adjoint_cache", adj)
        return adj

    # -- persistence ------------------------------------------------------
    def save(self, path) -> None:
        """Write the packed operator (blocks, permutations, metadata) as a
        ``.npz`` in the JAX package's format: bf16 blocks as a uint16 view
        (npz has no bf16), the metadata as JSON bytes.  The pack is the
        largest set-up cost and is deterministic: pack once, reload.  A
        row-compressed operator is written as ``rowptr``/``col``/``val`` with
        ``kind`` "csr", which only this package reads (``symmetric`` says
        whether it is Hermitian)."""
        import json

        def host(a: torch.Tensor) -> np.ndarray:
            a = a.detach().cpu()
            if a.dtype == torch.bfloat16:
                return a.view(torch.int16).numpy().view(np.uint16)
            return a.numpy()

        sym = isinstance(self.matrix, SymBSRMatrix)
        csr = isinstance(self.matrix, SymCSRMatrix)
        meta = dict(
            orig_shape=list(self.orig_shape),
            symmetric=self.symmetric,
            complexified=self.complexified,
            stats=self.stats,
            kind="csr" if csr else "sym" if sym else "gen",
            dtype=str(self.matrix.dtype).replace("torch.", ""),
            shape=list(self.matrix.shape),
            band_reach=getattr(self.matrix, "band_reach", -1),
        )
        arrays = dict(perm=np.asarray(self.perm),
                      meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
        if self.row_perm is not None:
            arrays["row_perm"] = np.asarray(self.row_perm)
        if csr:
            arrays.update(rowptr=host(self.matrix.rowptr), col=host(self.matrix.col),
                          val=host(self.matrix.val))
        elif sym:
            arrays.update(diag=host(self.matrix.diag_data), upper=host(self.matrix.upper_data),
                          ucols=host(self.matrix.upper_cols))
        else:
            arrays.update(data=host(self.matrix.data), bcols=host(self.matrix.block_cols))
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path, device=None) -> "AcceleratedOperator":
        """Read a :meth:`save`'d operator (either package's file), blocks at
        the stored dtype on ``device`` (the card unless told otherwise)."""
        import json

        from ..convert import accelerated_from_numpy

        with np.load(path) as z:
            arrays = {name: z[name] for name in z.files if name != "meta"}
            meta = json.loads(bytes(z["meta"]).decode())
        for name in ("data", "diag", "upper", "val"):  # bf16 values are stored as uint16
            a = arrays.get(name)
            if a is not None and a.dtype == np.uint16:
                arrays[name] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return accelerated_from_numpy(meta, device=device, **arrays)


def dedup_embedded_pairs(lam, vecs, keep_max: int | None = None):
    """Indices to KEEP from a RESTORED doubled-spectrum result.

    Eigenvalues of a complexified (real-embedded) Hermitian operator
    appear up to twice; a clean Krylov space may hold only ONE vector
    per 2-D embedded eigenspace, so dedup goes by value-closeness AND
    vector overlap, never by blind pairing.  ``vecs`` are the restored
    complex eigenvectors (columns, any normalization); eigenvalues are
    assumed sorted the way the caller wants them kept."""
    lam = np.asarray(lam)
    spread = float(np.abs(lam).max()) if lam.size else 1.0
    close = max(spread, 1.0) * 1e-3
    unit = None
    if vecs is not None:
        norms = np.linalg.norm(vecs, axis=0)
        unit = vecs / np.maximum(norms, 1e-300)
    keep: list[int] = []
    for i in range(len(lam)):
        dup = False
        for j in keep:
            if abs(lam[i] - lam[j]) > close:
                continue
            if unit is None or abs(np.vdot(unit[:, j], unit[:, i])) > 0.9:
                dup = True
                break
        if not dup:
            keep.append(i)
        if keep_max is not None and len(keep) >= keep_max:
            break
    return keep


def _accelerate_rectangular(r, c, v, shape, *, dtype, general_block, reorder,
                            merge_duplicates, device, t0, stage, stages) -> AcceleratedOperator:
    """Rectangular pack: bipartite RCM (a row and a column permutation) and
    general BSR-ELL with both sides padded to lcm(bm, bn), so that the
    adjoint pack (rows and columns swapped, same block shape) tiles the same
    padded shape and the Gram pipeline chains A and A^H without re-padding."""
    m, n = shape
    ts = time.perf_counter()
    if merge_duplicates:
        r, c, v = _canonicalize(r, c, v, shape)
    ts = stage("merge", ts)
    if reorder and len(r):
        row_perm, col_perm = bipartite_band_permutation(r, c, m, n)
        ts = stage("rcm", ts)
        ipr = np.empty(m, np.int64)
        ipr[row_perm] = np.arange(m)
        ipc = np.empty(n, np.int64)
        ipc[col_perm] = np.arange(n)
        r, c = ipr[r], ipc[c]
        ts = stage("permute", ts)
    else:
        row_perm = np.arange(m, dtype=np.int64)
        col_perm = np.arange(n, dtype=np.int64)
    if isinstance(dtype, str) and dtype == "auto":
        target = torch.bfloat16 if _bf16_lossless(v) else torch.float32
    else:
        target = as_torch_dtype(dtype)
    bm, bn = general_block
    mult = int(np.lcm(bm, bn))
    m_pad = -(-m // mult) * mult
    n_pad = -(-n // mult) * mult
    mat = _pack_general(r, c, v, m_pad, n_pad, bm, bn, target, device,
                        native.native_available(), stage)
    slots = mat.data.numel()
    # normalised cross bandwidth: how far an entry sits from the matched
    # band diagonal after the two-sided permutation (row positions scaled
    # onto the column axis)
    bw = int(np.abs(r * (n / max(m, 1)) - c).max()) if len(r) else 0
    stats = dict(
        nnz=len(v),
        slots=int(slots),
        fill=float(len(v) / max(slots, 1)),
        storage="block",
        bytes=int(slots * (torch.finfo(target).bits // 8)),
        dtype=str(target).replace("torch.", ""),
        bandwidth_before=-1,
        bandwidth_after=bw,
        symmetric=False,
        complexified=False,
        pack_seconds=time.perf_counter() - t0,
        pack_stages={k: round(s, 4) for k, s in stages.items()},
        kmax=mat.k_max,
    )
    return AcceleratedOperator(
        matrix=mat, perm=col_perm, orig_shape=(m, n), symmetric=False, complexified=False,
        stats=stats, row_perm=row_perm, host_triplets=(r, c, v),
    )


@annotate("eigenex.accelerate")
def accelerate(
    A,
    *,
    symmetric: bool | None = None,
    symmetric_check: bool = True,
    dtype: Any = "auto",
    block: int = 128,
    general_block: tuple[int, int] = (32, 128),
    reorder: bool = True,
    merge_duplicates: bool | None = None,
    device=None,
) -> AcceleratedOperator:
    """Repack a scalar sparse operator for the dense-block kernels.

    Parameters
    ----------
    A : COOMatrix | scipy sparse | (rows, cols, vals, shape)
        The operator, in any scalar-sparse form.  Complex operators are
        embedded as [[A,-B],[B,A]] automatically (Hermitian -> real
        symmetric -> the half-storage kernel).  RECTANGULAR (real)
        operators take the two-sided route: bipartite RCM and general
        BSR-ELL with both sides padded to lcm(bm, bn) (the ``svds`` Gram
        path); their vectors go in and out through ``embed`` /
        ``embed_left`` and ``restore`` / ``restore_right``.
    symmetric : bool | None
        None (default) detects A == A^H exactly on the triplets.  Passing
        True skips the full check; a cheap sampled probe (pattern counts
        + mirror-value sample, see ``symmetric_check``) still guards the
        claim, because the pack drops lower-triangle blocks and
        reconstructs them as mirrors -- on a non-symmetric operator that
        silently computes the wrong spectrum.
    symmetric_check : bool
        Set False to skip even the sampled probe behind
        ``symmetric=True`` (trusted production re-packs only).
    dtype : "auto" | dtype
        "auto" stores bf16 when every value round-trips bf16 exactly
        (lossless; halves traffic), else f32.  An explicit dtype forces.
    block : int
        Symmetric block size (the CUDA kernel takes multiples of 128; other
        sizes run through the plain version).
    general_block : (bm, bn)
        Block shape for non-symmetric operators; the SpMV kernel takes any
        bm and a bn that is a multiple of 128.  A square operator is padded
        to a multiple of lcm(bm, bn), so it stays square.
    reorder : bool
        Apply the RCM band-reducing permutation (disable only for
        operators already ordered, e.g. tridiagonal).
    merge_duplicates : bool | None
        None (default) canonicalises every operand: a cheap payload-free
        sort detects duplicates and the full merge runs only when they
        exist.  False skips even the detection (trusted canonical
        triplets only -- the symmetry checks assume duplicate-free input).
    device : where the packed blocks live (the card unless told otherwise).

    Returns an :class:`AcceleratedOperator`; ``.stats`` records fill,
    slot counts, bytes, bandwidth before/after, and pack time
    (``pack_seconds``, and ``pack_stages``: seconds by stage, each stage
    also a span ``eigenex.accelerate.<stage>`` inside ``eigenex.accelerate``,
    :mod:`~eigenex_tpu_torch.utils.profiling`).
    """
    t0 = time.perf_counter()
    stages: dict[str, float] = {}

    def _stage(name, t_start):
        now = time.perf_counter()
        stages[name] = stages.get(name, 0.0) + (now - t_start)
        add_span(f"eigenex.accelerate.{name}", t_start, now)
        return now

    device = resolve_device(device)
    r, c, v, shape = _as_host_triplets(A)
    if shape[0] != shape[1]:
        if symmetric:
            raise EigenexError("a rectangular operator cannot be symmetric")
        if np.iscomplexobj(v):
            raise EigenexError(
                "complex rectangular acceleration is not supported -- "
                "realify by hand or use the COO Gram path"
            )
        return _accelerate_rectangular(
            r, c, v, shape, dtype=dtype, general_block=general_block, reorder=reorder,
            merge_duplicates=merge_duplicates is None or merge_duplicates, device=device,
            t0=t0, stage=_stage, stages=stages,
        )
    if merge_duplicates is None:
        merge_duplicates = True
    ts = time.perf_counter()
    if merge_duplicates:
        r, c, v = _canonicalize(r, c, v, shape)
    ts = _stage("merge", ts)

    if symmetric is None:
        symmetric = _is_hermitian(r, c, v, shape)
    elif symmetric and symmetric_check:
        _sampled_hermitian_check(r, c, v, shape)
    ts = _stage("symmetry_check", ts)
    complexified = bool(np.iscomplexobj(v))
    if complexified:
        emb = realify_coo(COOMatrix(torch.as_tensor(r.astype(np.int32)),
                                    torch.as_tensor(c.astype(np.int32)), torch.as_tensor(v), shape))
        r = emb.row.numpy().astype(np.int64)
        c = emb.col.numpy().astype(np.int64)
        v = emb.val.numpy()
        ts = _stage("realify", ts)
    n_work = 2 * shape[0] if complexified else shape[0]

    bw_before = int(np.abs(r - c).max()) if len(r) else 0
    if reorder and len(r):
        perm = band_permutation(r, c, n_work, assume_symmetric=bool(symmetric))
        ts = _stage("rcm", ts)
        ip = np.empty(n_work, np.int64)
        ip[perm] = np.arange(n_work)
        r, c = ip[r], ip[c]
        ts = _stage("permute", ts)
    else:
        perm = np.arange(n_work, dtype=np.int64)
    bw_after = int(np.abs(r - c).max()) if len(r) else 0

    use_native = native.native_available() and np.isrealobj(v)
    nnz = len(v)
    if isinstance(dtype, str) and dtype == "auto":
        target = torch.bfloat16 if _bf16_lossless(v) else torch.float32
    else:
        target = as_torch_dtype(dtype)

    storage, compared = "block", {}
    bm, bn = general_block
    if symmetric:
        # pad to 32 BLOCK rows, as the JAX package does, so that packed
        # operators have the same shape in both packages
        n_pad = -(-n_work // (32 * block)) * (32 * block)
        nbr = n_pad // block
    else:
        # square stays square (eigs needs it): pad both sides to lcm(bm, bn)
        mult = int(np.lcm(bm, bn))
        n_pad = -(-n_work // mult) * mult
    if _storage_rule_applies(device, target):
        # the storage whose product reads fewer bytes, from the slots the
        # block pack would hold: the real blocks of the half-storage pack,
        # every slot of the general one
        if symmetric:
            blocks, ku, reach = _block_census(r, c, block, nbr)
            block_slots = blocks * block * block
            compared = dict(blocks=blocks)
        else:
            kmax = _general_kmax(r, c, bm, bn, n_pad)
            block_slots = n_pad * kmax * bn
        storage, sizes = choose_storage(nnz, n_pad, block_slots, torch.finfo(target).bits // 8)
        compared["storage_bytes"] = sizes
        ts = _stage("blk_count", ts)
    if storage == "row_compressed":
        mat = _pack_row_compressed(r, c, v, n_pad, target, device, use_native, bool(symmetric),
                                   _stage)
        # fill and widths of the block pack the rule compared, as the CPU reports them
        if symmetric:
            slots, applied = nnz, (nbr + 2 * nbr * ku) * block * block
            widths = dict(ku=ku, band_reach=reach, block=block)
        else:
            slots, applied = nnz, block_slots
            widths = dict(kmax=kmax, general_block=[bm, bn])
    elif symmetric:
        mat, skipped = _pack_symmetric(r, c, v, n_pad, block, target, device, use_native, _stage)
        if skipped is not None:
            # the count of strictly-lower-block triplets the native pack
            # dropped is fixed by the pattern: a mismatch is a packer defect
            expect = int(np.count_nonzero(c // block < r // block))
            if skipped != expect:
                raise EigenexError(
                    f"sym pack dropped {skipped} lower-block triplets but the "
                    f"pattern holds {expect} -- packer inconsistency"
                )
        slots = mat.diag_data.numel() + mat.upper_data.numel()
        applied = mat.diag_data.numel() + 2 * mat.upper_data.numel()
        widths = dict(ku=int(mat.upper_cols.shape[1]), band_reach=int(mat.band_reach))
    else:
        mat = _pack_general(r, c, v, n_pad, n_pad, bm, bn, target, device, use_native, _stage)
        slots = applied = mat.data.numel()
        widths = dict(kmax=mat.k_max)

    stats = dict(
        nnz=nnz,
        slots=int(slots),
        fill=float(nnz / max(applied, 1)),
        storage=storage,
        bytes=int(compared["storage_bytes"][storage] if storage == "row_compressed"
                  else slots * (torch.finfo(target).bits // 8)),
        dtype=str(target).replace("torch.", ""),
        bandwidth_before=bw_before,
        bandwidth_after=bw_after,
        symmetric=bool(symmetric),
        complexified=complexified,
        pack_seconds=time.perf_counter() - t0,
        pack_stages={k: round(s, 4) for k, s in stages.items()},
        **widths,
        **compared,
    )
    return AcceleratedOperator(
        matrix=mat,
        perm=perm,
        orig_shape=shape,
        symmetric=bool(symmetric),
        complexified=complexified,
        stats=stats,
        # general block packs keep the permuted triplets, as the JAX package
        # does for its adjoint pack; the other containers keep memory flat
        host_triplets=(r, c, v) if isinstance(mat, BSRMatrix) else None,
    )
