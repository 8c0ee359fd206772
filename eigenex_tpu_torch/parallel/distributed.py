"""Row-partitioned distributed SpMV, the distributed Krylov drivers, and
the mesh operators.

Counterpart of ``eigenex_tpu/parallel/distributed.py``.  The operator's
block rows are split over a mesh axis, vectors and the Krylov basis split
over the same axis, Gram-Schmidt inner products complete with
``comm.psum``, and each matvec brings the x segments it needs with the
collectives of :mod:`~eigenex_tpu_torch.parallel.shard_map`.

Four matvec modes, as in the JAX package:

- **allgather**: gather all x shards, then the shard's block rows
  (a rectangular n_local x n pack);
- **colsplit**: each shard holds the block-COLUMN panel of its own x shard
  (an n x n_local pack), makes a full-length partial y, and
  ``psum_scatter`` sums the partials and leaves each shard its y shard;
- **halo** (:func:`halo_matvec`): the operator's blocks reach only the
  neighbouring shards; two ring shifts bring the neighbours' x shards to
  the diagonal, left and right parts;
- **sym_halo** (:func:`sym_halo_matvec`): half storage
  (:class:`~eigenex_tpu_torch.sparse.sym_bsr.SymBSRMatrix`) on the ring --
  the in-panel symmetric part, the boundary blocks that reach the right
  neighbour applied forward (``y[r] += B x_next[c]``) and in reverse
  (``y_next[c] += B^H x[r]``, shipped one step right).

plus the **2-D panel grid** (:func:`mesh_operator_2d`): an R x C mesh
holds an R x C grid of panels, x split over (cols, rows) and y over
(rows, cols).

Every shard-local product goes through the port's containers, so f32 and
bf16 blocks with a width that is a multiple of 128 launch the hand-written
kernels on the card (``bsr_spmv``, ``sym_bsr_spmv``, ``bsr_spmm``,
``sym_bsr_spmm``), and f64/complex blocks take the plain versions, as on
one device.  Where the JAX package multiplies the halo parts with an XLA
einsum, the port uses ``bsr_spmv`` for all three; where it scatters the
sym_halo reverse product with ``.at[rc].add``, the port builds the
boundary blocks' adjoint once at placement as a ``BSRMatrix``, so the
reverse product is one ``bsr_spmv`` launch with no float atomics, and two
runs of a product are bit-equal.  ``use_pallas`` is accepted for
signature parity only: there is no XLA path to switch from.

The host splits (:func:`split_bsr_halo`, :func:`split_sym_bsr_halo`,
:func:`split_bsr_colpanels`, :func:`split_bsr_grid`) return the JAX
package's stacked layout bit for bit, computed with vectorised torch ops
where the container lives; placement (:func:`place_on_mesh`) then cuts
them into per-shard containers, contiguous and 16-byte aligned on each
shard's device.  A placement belongs to the object that uses it -- a
driver, the operator :func:`mesh_operator` returns, or the caller of
:func:`place_on_mesh` -- and is freed with it; nothing is kept on the
caller's container.

The distributed Lanczos and Arnoldi chunks are the single-device chunks
(:func:`~eigenex_tpu_torch.solvers.lanczos._lanczos_chunk`,
:func:`~eigenex_tpu_torch.solvers.arnoldi._arnoldi_chunk`) with ``comm=``
set -- one code path.  Between chunks the drivers keep the basis ``V`` as
per-shard column panels (:class:`~eigenex_tpu_torch.parallel.shard_map.Sharded`)
and gather only the Ritz vectors at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.operators import LinearOperator
from ..solvers.arnoldi import ArnoldiState, _arnoldi_chunk
from ..solvers.cg import _cg_loop, _minres_loop
from ..solvers.krylov_schur import KrylovSchurArnoldiSolver
from ..solvers.lanczos import LanczosEigenSolver, LanczosOptions, LanczosState, _lanczos_chunk
from ..solvers.lobpcg import LOBPCGSolver
from ..solvers.restart import ThickRestartLanczosEigenSolver, ThickRestartOptions
from ..sparse.accelerate import _padding_safe_v0
from ..sparse.bsr import BSRMatrix
from ..sparse.sym_bsr import SymBSRMatrix, sym_bsr_from_bsr
from ..utils.exceptions import EigenexError
from ..utils.tolerance import accumulation_dtype, default_breakdown_threshold
from .mesh import ROWS, Mesh, make_mesh
from .shard_map import P, Sharded, _Layout, _place, shard_map

__all__ = [
    "pad_bsr_for_mesh",
    "pad_bsr_rect",
    "distributed_lanczos_steps",
    "distributed_arnoldi_steps",
    "DistributedLanczosEigenSolver",
    "DistributedShiftInvertLanczosEigenSolver",
    "DistributedThickRestartLanczosEigenSolver",
    "DistributedKrylovSchurArnoldiSolver",
    "DistributedLOBPCGSolver",
    "halo_matvec",
    "halo_matmat",
    "sym_halo_matvec",
    "sym_halo_matmat",
    "mesh_operator",
    "mesh_operator_2d",
    "place_on_mesh",
    "prepare_packed_mesh",
    "split_bsr_grid",
    "split_bsr_halo",
    "split_sym_bsr_halo",
    "split_bsr_colpanels",
    "sym_inpanel_reach",
]

_MODES = ("allgather", "colsplit", "halo", "sym_halo")


def prepare_packed_mesh(mat, mesh, matvec_mode: str):
    """(mesh, matvec_mode) normalisation shared by every front end that
    row-partitions a PACKED (accelerate()) container:

    - multi-axis meshes flatten to one row axis (the halo/sym_halo rings
      are 1-axis row partitions);
    - SymBSR half storage has exactly one mesh mode (sym_halo);
    - the packed band must fit ONE mesh panel -- the ring exchanges with
      the immediate neighbour only, so a wider band is rejected up front
      with the shard-count remedy."""
    if len(mesh.axis_names) >= 2:
        mesh = mesh.flattened(ROWS)
    if isinstance(mat, SymBSRMatrix):
        if matvec_mode == "allgather":
            matvec_mode = "sym_halo"
        elif matvec_mode != "sym_halo":
            raise EigenexError(
                "an accelerated (SymBSR) operand supports matvec_mode='sym_halo' only"
            )
        nd = mesh.shape[mesh.axis_names[0]]
        nbr_pad = -(-mat.n_block_rows // nd) * nd
        if mat.band_reach > nbr_pad // nd:
            raise EigenexError(
                f"the packed band reach ({mat.band_reach} block rows) exceeds "
                f"one mesh panel ({nbr_pad // nd} block rows at {nd} shards) — "
                "the sym_halo ring exchanges with the immediate neighbor only; "
                "use fewer shards so each panel covers the band, or repack "
                "with a stronger reordering"
            )
    return mesh, matvec_mode


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------
def _zeros_like_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)


def pad_bsr_for_mesh(bsr, n_shards: int):
    """Zero-pad block rows/cols so the row count divides evenly over the
    mesh.  Accepts a :class:`BSRMatrix` or a :class:`SymBSRMatrix`.

    The padding rows are structurally zero, which adds eigenvalue 0 with
    multiplicity = padding size to the padded operator; the distributed
    solvers start from a vector with no padding support
    (:func:`_padding_safe_v0`), so it never enters the Krylov space."""
    nbr = bsr.n_block_rows
    if nbr % n_shards == 0:
        return bsr
    pad = n_shards - nbr % n_shards
    bm, bn = bsr.block_shape
    if isinstance(bsr, SymBSRMatrix):
        diag = torch.cat([bsr.diag_data, _zeros_like_rows(bsr.diag_data, pad)])
        ud = torch.cat([bsr.upper_data, _zeros_like_rows(bsr.upper_data, pad)])
        uc = torch.cat([bsr.upper_cols, _zeros_like_rows(bsr.upper_cols, pad)])
        m = bsr.shape[0] + pad * bm
        return SymBSRMatrix(diag, ud, uc, (m, m), bsr.band_reach)
    data = torch.cat([bsr.data, _zeros_like_rows(bsr.data, pad)])
    cols = torch.cat([bsr.block_cols, _zeros_like_rows(bsr.block_cols, pad)])
    m = bsr.shape[0] + pad * bm
    n = max(bsr.shape[1], m) if bsr.shape[0] == bsr.shape[1] else bsr.shape[1]
    return BSRMatrix(data, cols, (m, n))


def pad_bsr_rect(bsr: BSRMatrix, n_shards: int) -> BSRMatrix:
    """Rectangular twin of :func:`pad_bsr_for_mesh`: zero-pad block ROWS
    and block COLS independently to multiples of ``n_shards`` -- the svds
    Gram pipeline needs both A and A^H row-partitionable.  Column padding
    is a pure shape extension (the padded block columns hold no data)."""
    nbr = bsr.n_block_rows
    nbc = bsr.n_block_cols
    bm, bn = bsr.block_shape
    padr = (-nbr) % n_shards
    padc = (-nbc) % n_shards
    data, cols = bsr.data, bsr.block_cols
    if padr:
        data = torch.cat([data, _zeros_like_rows(data, padr)])
        cols = torch.cat([cols, _zeros_like_rows(cols, padr)])
    if not padr and not padc:
        return bsr
    return BSRMatrix(data, cols, ((nbr + padr) * bm, (nbc + padc) * bn))


# ---------------------------------------------------------------------------
# the host splits (the JAX package's stacked layouts, bit for bit)
# ---------------------------------------------------------------------------
_ROW_CHUNK = 4096  # block rows a pass over the block data touches at once
_ENTRY_CHUNK = 1 << 15  # blocks a scatter copies at once


def _nonzero_blocks(data: torch.Tensor) -> torch.Tensor:
    """(nbr, k) bool: which stored blocks hold a non-zero entry (the
    reference's ``np.any(blk)``), in row chunks to bound the scratch."""
    nbr, k = data.shape[:2]
    out = torch.empty((nbr, k), dtype=torch.bool, device=data.device)
    for r0 in range(0, nbr, _ROW_CHUNK):
        blk = data[r0:r0 + _ROW_CHUNK]
        out[r0:r0 + _ROW_CHUNK] = blk.reshape(blk.shape[0], k, -1).ne(0).any(dim=2)
    return out


def _slots(nz: torch.Tensor, cls: torch.Tensor, n_cls: int):
    """(slot, max count per class): each stored non-zero block's rank
    among the non-zero blocks of its row and class, in slot order -- the
    order the reference's per-row buckets append in."""
    slot = torch.zeros(cls.shape, dtype=torch.int64, device=cls.device)
    counts = []
    for c in range(n_cls):
        m = nz & (cls == c)
        rank = torch.cumsum(m.to(torch.int64), dim=1) - 1
        slot = torch.where(m, rank, slot)
        counts.append(int(m.sum(dim=1).max()) if m.numel() else 0)
    return slot, counts


def _scatter(out_d, out_c, src, sel, rows_out, slot, local):
    """out[rows_out, slot] = src[r, k] (and the local column) for every
    selected (r, k), in bounded chunks."""
    r, k = sel.nonzero(as_tuple=True)
    for i in range(0, r.numel(), _ENTRY_CHUNK):
        rr, kk = r[i:i + _ENTRY_CHUNK], k[i:i + _ENTRY_CHUNK]
        ro, so = rows_out[rr, kk], slot[rr, kk]
        out_d[ro, so] = src[rr, kk]
        out_c[ro, so] = local[rr, kk].to(torch.int32)


def _first_true(mask: torch.Tensor) -> tuple[int, int]:
    """(row, slot) of the first True of a 2-D mask in row-major order."""
    flat = int(mask.reshape(-1).nonzero()[0])
    return flat // mask.shape[1], flat % mask.shape[1]


def split_bsr_halo(bsr: BSRMatrix, n_shards: int):
    """Split of a row-partitioned BSR matrix into (diagonal, left-halo,
    right-halo) BSR-ELL parts with *shard-local* block-column ids, each a
    ``(data (nbr, k, bm, bn), cols (nbr, k))`` pair.  Raises if any block
    reaches beyond the adjacent shards (use the all-gather path then)."""
    nbr = bsr.n_block_rows
    if nbr % n_shards:
        raise EigenexError("pad_bsr_for_mesh before split_bsr_halo")
    rows_per = nbr // n_shards
    data = bsr.data
    cols = bsr.block_cols.long()
    bm, bn = bsr.block_shape
    dev = data.device
    nz = _nonzero_blocks(data)
    shard = (torch.arange(nbr, device=dev) // rows_per)[:, None].expand_as(cols)
    src = cols // rows_per
    d = (src - shard) % n_shards
    cls = torch.where(src == shard, 0, torch.where(
        d == n_shards - 1, 1, torch.where(d == 1, 2, 3)))
    bad = nz & (cls == 3)
    if bool(bad.any()):
        r, k = _first_true(bad)
        raise EigenexError(
            f"block row {r} reaches shard {int(src[r, k])} (own {int(shard[r, k])}) — "
            "not neighbor-banded; use the all-gather matvec"
        )
    slot, counts = _slots(nz, cls, 3)
    local = cols % rows_per
    rows_out = torch.arange(nbr, device=dev)[:, None].expand_as(cols)
    out = []
    for c in range(3):
        kk = max(counts[c], 1)
        od = torch.zeros((nbr, kk, bm, bn), dtype=data.dtype, device=dev)
        oc = torch.zeros((nbr, kk), dtype=torch.int32, device=dev)
        _scatter(od, oc, data, nz & (cls == c), rows_out, slot, local)
        out.append((od, oc))
    return out[0], out[1], out[2]


def sym_inpanel_reach(in_data, in_cols, rows_per: int) -> int:
    """Max in-panel block band reach (local col - local row) over the
    stored non-zero in-panel upper blocks (0 when there are none)."""
    lr = torch.arange(in_cols.shape[0], dtype=torch.int64, device=in_cols.device) % rows_per
    return _inpanel_reach(_nonzero_blocks(in_data), in_cols.long(), lr[:, None])


def _inpanel_reach(nz, local_cols, local_rows) -> int:
    """Max (local col - local row) over the blocks ``nz`` (0 when none)."""
    if nz.numel() == 0:
        return 0
    return max(int(torch.where(nz, local_cols - local_rows, 0).max()), 0)


def split_sym_bsr_halo(sym: SymBSRMatrix, n_shards: int):
    """Split of a :class:`SymBSRMatrix` for the sym_halo mode:
    ``(diag_data, (in_data, in_cols), (right_data, right_cols))`` with
    shard-local block-column ids.  Upper blocks must lie in the own or the
    immediately-right panel (c > r always holds for upper storage),
    otherwise raises -- use all-gather then."""
    return _split_sym(sym, n_shards)[:3]


def _split_sym(sym: SymBSRMatrix, n_shards: int, rows: range | None = None):
    """:func:`split_sym_bsr_halo` of the block rows ``rows`` only (whole
    panels; default all), and the in-panel reach of the whole operator.
    The slot widths are the whole operator's, so a process that splits only
    its own shards' rows gets their rows of the whole split bit for bit."""
    nbr = sym.n_block_rows
    if nbr % n_shards:
        raise EigenexError("pad the operator before split_sym_bsr_halo")
    rows_per = nbr // n_shards
    rows = range(nbr) if rows is None else rows
    ud = sym.upper_data
    uc = sym.upper_cols.long()
    bm, bn = sym.block_shape
    dev = ud.device
    nz = _nonzero_blocks(ud)
    shard = (torch.arange(nbr, device=dev) // rows_per)[:, None].expand_as(uc)
    src = uc // rows_per
    cls = torch.where(src == shard, 0, torch.where(src == shard + 1, 1, 2))
    bad = nz & (cls == 2)
    if bool(bad.any()):
        r, k = _first_true(bad)
        raise EigenexError(
            f"upper block ({r}, {int(uc[r, k])}) reaches shard {int(src[r, k])} (own "
            f"{int(shard[r, k])}) — not neighbor-banded; use the all-gather matvec"
        )
    slot, counts = _slots(nz, cls, 2)
    local = uc % rows_per
    row_ids = torch.arange(nbr, device=dev)[:, None]
    reach = _inpanel_reach(nz & (cls == 0), local, row_ids % rows_per)
    rows_out = (row_ids - rows.start).expand_as(uc)
    mine = torch.zeros((nbr, 1), dtype=torch.bool, device=dev)
    mine[rows.start:rows.stop] = True
    out = []
    for c in range(2):
        kk = max(counts[c], 1)
        od = torch.zeros((len(rows), kk, bm, bn), dtype=ud.dtype, device=dev)
        oc = torch.zeros((len(rows), kk), dtype=torch.int32, device=dev)
        _scatter(od, oc, ud, nz & (cls == c) & mine, rows_out, slot, local)
        out.append((od, oc))
    return sym.diag_data[rows.start:rows.stop], out[0], out[1], reach


def split_bsr_colpanels(bsr: BSRMatrix, n_shards: int):
    """Split of a BSR matrix into block-COLUMN panels with *panel-local*
    block-column ids, stacked so the row split hands each shard its own
    panel (the colsplit layout).  Returns (data (nd*nbr, kmax_p, bm, bn),
    cols (nd*nbr, kmax_p)); panel d occupies rows [d*nbr, (d+1)*nbr)."""
    nbr = bsr.n_block_rows
    nbc = bsr.n_block_cols
    if nbc % n_shards:
        raise EigenexError("pad_bsr_for_mesh before split_bsr_colpanels")
    cols_per = nbc // n_shards
    data = bsr.data
    cols = bsr.block_cols.long()
    bm, bn = bsr.block_shape
    dev = data.device
    nz = _nonzero_blocks(data)
    cls = cols // cols_per
    slot, counts = _slots(nz, cls, n_shards)
    kmax_p = max(max(counts, default=0), 1)
    out_d = torch.zeros((n_shards * nbr, kmax_p, bm, bn), dtype=data.dtype, device=dev)
    out_c = torch.zeros((n_shards * nbr, kmax_p), dtype=torch.int32, device=dev)
    rows_out = cls * nbr + torch.arange(nbr, device=dev)[:, None]
    _scatter(out_d, out_c, data, nz, rows_out, slot, cols % cols_per)
    return out_d, out_c


def split_bsr_grid(bsr: BSRMatrix, n_row_shards: int, n_col_shards: int):
    """Split of a BSR matrix into an R x C grid of panels with
    *panel-local* block-column ids, stacked rows-major (panel (r, c) at
    index r*C + c) -- the 2-D SpMV layout.  Returns
    (data (R*C*nbr_l, kmax_p, bm, bn), cols (R*C*nbr_l, kmax_p)) where
    nbr_l = nbr / R."""
    nbr, nbc = bsr.n_block_rows, bsr.n_block_cols
    if nbr % n_row_shards or nbc % n_col_shards:
        raise EigenexError(
            f"grid split needs {n_row_shards} | {nbr} block rows and "
            f"{n_col_shards} | {nbc} block cols — pad_bsr_for_mesh first"
        )
    R, C = n_row_shards, n_col_shards
    rows_per = nbr // R
    cols_per = nbc // C
    data = bsr.data
    cols = bsr.block_cols.long()
    bm, bn = bsr.block_shape
    dev = data.device
    nz = _nonzero_blocks(data)
    cg = cols // cols_per
    slot, counts = _slots(nz, cg, C)
    kmax_p = max(max(counts, default=0), 1)
    r = torch.arange(nbr, device=dev)[:, None]
    rows_out = ((r // rows_per) * C + cg) * rows_per + r % rows_per
    out_d = torch.zeros((R * C * rows_per, kmax_p, bm, bn), dtype=data.dtype, device=dev)
    out_c = torch.zeros((R * C * rows_per, kmax_p), dtype=torch.int32, device=dev)
    _scatter(out_d, out_c, data, nz, rows_out, slot, cols % cols_per)
    return out_d, out_c


def _block_adjoint(data: torch.Tensor, cols: torch.Tensor, n_block_cols: int,
                   shape: tuple[int, int]) -> BSRMatrix:
    """B^H of an ELL pack as a new ELL pack (block (r, c) -> block^H at
    (c, r); a block row's slots in ascending old row), built with torch ops
    where the blocks live."""
    nbr, kk, bm, bn = data.shape
    nz = _nonzero_blocks(data)
    rr, ks = nz.nonzero(as_tuple=True)
    cc = cols.long()[rr, ks]
    cc, order = torch.sort(cc, stable=True)
    rr, ks = rr[order], ks[order]
    counts = torch.bincount(cc, minlength=n_block_cols)
    width = max(int(counts.max()) if counts.numel() else 0, 1)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(cc.numel(), device=cc.device) - start[cc]
    out_d = torch.zeros((n_block_cols, width, bn, bm), dtype=data.dtype, device=data.device)
    out_c = torch.zeros((n_block_cols, width), dtype=torch.int32, device=data.device)
    for i in range(0, cc.numel(), _ENTRY_CHUNK):
        sl = slice(i, i + _ENTRY_CHUNK)
        blk = data[rr[sl], ks[sl]].transpose(-1, -2)
        out_d[cc[sl], slot[sl]] = blk.conj() if blk.is_complex() else blk
        out_c[cc[sl], slot[sl]] = rr[sl].to(torch.int32)
    return BSRMatrix(out_d, out_c, shape)


# ---------------------------------------------------------------------------
# placement: per-shard containers, once per operator, mode and mesh
# ---------------------------------------------------------------------------
class _ShardParts:
    """The containers one shard multiplies with, for one mode.

    ``main``: allgather -- the shard's block rows (n_local x n); colsplit --
    its column panel (n x n_local); halo -- the diagonal part; sym_halo --
    the in-panel :class:`SymBSRMatrix`; grid -- its panel (n/R x n/C).
    halo: ``left``, ``right``.  sym_halo: ``right`` holds the boundary
    blocks from block row ``lo`` on (the rows above hold none),
    ``right_adj`` their adjoint over the neighbour's first ``hi`` block
    rows."""

    def __init__(self, mode, main, left=None, right=None, right_adj=None, lo=0, hi=0,
                 n_local=0):
        self.mode = mode
        self.main = main
        self.left = left
        self.right = right
        self.right_adj = right_adj
        self.lo = lo
        self.hi = hi
        self.n_local = n_local

    def roles(self) -> dict:
        """The shard's containers by role: main, left, right, right_adj."""
        found = dict(main=self.main, left=self.left, right=self.right, right_adj=self.right_adj)
        return {role: c for role, c in found.items() if c is not None}


def _bsr_piece(data, cols, shape, device) -> BSRMatrix:
    return BSRMatrix(_place(data, device), _place(cols, device), shape)


def _sym_parts(split, rows_per: int, s: int, b: int, sym_reach: int, device) -> _ShardParts:
    diag, (ind, inc), (rd, rc) = split
    rows = slice(s * rows_per, (s + 1) * rows_per)
    n_local = rows_per * b
    main = SymBSRMatrix(_place(diag[rows], device), _place(ind[rows], device),
                        _place(inc[rows], device), (n_local, n_local), sym_reach)
    rd_s, rc_s = rd[rows], rc[rows]
    nz = _nonzero_blocks(rd_s)
    hit = nz.any(dim=1).nonzero()
    lo = min(int(hit[0]) if hit.numel() else rows_per - 1, rows_per - 1)
    used = rc_s.long()[nz]
    hi = max(int(used.max()) + 1 if used.numel() else 1, 1)
    # copies, so that the full-height boundary arrays of the split are freed
    right = BSRMatrix(_place(rd_s[lo:], device).clone(), _place(rc_s[lo:], device).clone(),
                      ((rows_per - lo) * b, n_local))
    adj = _block_adjoint(right.data, right.block_cols, hi, (hi * b, (rows_per - lo) * b))
    adj = BSRMatrix(_place(adj.data, device), _place(adj.block_cols, device), adj.shape)
    return _ShardParts("sym_halo", main, right=right, right_adj=adj, lo=lo, hi=hi,
                       n_local=n_local)


class _MeshPack:
    """One operator placed on a mesh for one mode: a :class:`Sharded` of
    :class:`_ShardParts` (shard order) and what the bodies need to know."""

    def __init__(self, mode, parts: Sharded, shape, dtype, sym_reach=-1):
        self.mode = mode
        self.parts = parts
        self.shape = shape
        self.dtype = dtype
        self.sym_reach = sym_reach


def _per_axis(mesh: Mesh, axes, make) -> Sharded:
    """A :class:`Sharded` whose piece for shard s is ``make(i, device)``
    with i the shard's index along ``axes`` (built once per index and
    device, for this process's shards only)."""
    lay = _Layout(mesh)
    built: dict = {}
    pieces = []
    for s, dev in enumerate(mesh.flat_devices):
        if not mesh.is_local(s):
            pieces.append(None)
            continue
        i = lay.index(s, axes)
        if (i, dev) not in built:
            built[(i, dev)] = make(i, dev)
        pieces.append(built[(i, dev)])
    return Sharded(pieces, P(axes), mesh)


def _mesh_pack(A, mesh: Mesh, axis_name: str, mode: str, split=None) -> _MeshPack:
    """``A`` split for ``mode`` and placed on ``mesh`` (``split``: the
    stacked split of the mode, when the caller has one)."""
    nd = mesh.shape[axis_name]
    nbr = A.n_block_rows
    if nbr % nd:
        raise EigenexError(
            f"{nbr} block rows not divisible by {nd} shards — use pad_bsr_for_mesh first"
        )
    rows_per = nbr // nd
    bm, bn = A.block_shape
    n_local = rows_per * bm
    sym_reach = -1
    if mode == "sym_halo":
        first = 0
        if split is None:
            # this process's shards only: the span of its panels along the axis
            sym = A if isinstance(A, SymBSRMatrix) else sym_bsr_from_bsr(A)
            lay = _Layout(mesh)
            idx = [lay.index(s, (axis_name,)) for s in mesh.local_shards]
            first = min(idx)
            *split, sym_reach = _split_sym(sym, nd, range(first * rows_per,
                                                         (max(idx) + 1) * rows_per))
        else:
            sym_reach = sym_inpanel_reach(split[1][0], split[1][1], rows_per)
        parts = _per_axis(mesh, (axis_name,),
                          lambda i, dev: _sym_parts(split, rows_per, i - first, bn, sym_reach,
                                                    dev))
    elif mode == "halo":
        if split is None:
            split = split_bsr_halo(A, nd)
        (dd, dc), (ld, lc), (rd, rc) = split

        def make(i, dev):
            rows = slice(i * rows_per, (i + 1) * rows_per)
            shp = (n_local, rows_per * bn)
            return _ShardParts("halo", _bsr_piece(dd[rows], dc[rows], shp, dev),
                               left=_bsr_piece(ld[rows], lc[rows], shp, dev),
                               right=_bsr_piece(rd[rows], rc[rows], shp, dev), n_local=n_local)

        parts = _per_axis(mesh, (axis_name,), make)
    elif mode == "colsplit":
        if split is None:
            split = split_bsr_colpanels(A, nd)
        pd, pc = split
        ncol = A.shape[1] // nd

        def make(i, dev):
            rows = slice(i * nbr, (i + 1) * nbr)
            return _ShardParts("colsplit", _bsr_piece(pd[rows], pc[rows], (A.shape[0], ncol), dev),
                               n_local=n_local)

        parts = _per_axis(mesh, (axis_name,), make)
    elif mode == "allgather":
        def make(i, dev):
            rows = slice(i * rows_per, (i + 1) * rows_per)
            return _ShardParts("allgather", _bsr_piece(A.data[rows], A.block_cols[rows],
                                                       (n_local, A.shape[1]), dev),
                               n_local=n_local)

        parts = _per_axis(mesh, (axis_name,), make)
    else:
        raise EigenexError(f"unknown matvec_mode {mode!r}")
    return _MeshPack(mode, parts, A.shape, accumulation_dtype(A.dtype), sym_reach)


# ---------------------------------------------------------------------------
# the shard-local products (run inside shard_map)
# ---------------------------------------------------------------------------
def _apply(c, x, matmat: bool):
    return c.matmat(x) if matmat else c.matvec(x)


def _local_apply(parts: _ShardParts, x, ax, matmat: bool = False):
    """This shard's piece of A @ x (x: this shard's piece) for its mode."""
    mode = parts.mode
    if mode == "allgather":
        return _apply(parts.main, ax.all_gather(x), matmat)
    if mode == "colsplit":
        return ax.psum_scatter(_apply(parts.main, x, matmat))
    if mode == "halo":
        # x from the left neighbour arrives by shifting right, and vice versa
        x_from_left = ax.shift(x, 1)
        x_from_right = ax.shift(x, -1)
        y = _apply(parts.main, x, matmat)
        y = y + _apply(parts.left, x_from_left, matmat)
        return y + _apply(parts.right, x_from_right, matmat)
    # sym_halo: the right neighbour's x arrives by shifting every shard left
    x_from_right = ax.shift(x, -1)
    y = _apply(parts.main, x, matmat)
    b = parts.main.block_shape[0]
    lo, hi = parts.lo * b, parts.hi * b
    # boundary: y[r] += B x_next[c], over the rows that hold boundary blocks
    y[lo:] += _apply(parts.right, x_from_right, matmat)
    # reverse contribution y_next[c] += B^H x[r], shipped one step right
    yc = torch.zeros_like(y)
    yc[:hi] = _apply(parts.right_adj, x[lo:], matmat)
    return y + ax.shift(yc, 1)


def _grid_apply(parts: _ShardParts, x, comm, row_axis, col_axis, matmat: bool):
    """2-D grid body: gather the column panel of x along the row axis, the
    panel product, reduce-scatter along the column axis."""
    x_panel = comm.all_gather(x, row_axis)
    y_partial = _apply(parts.main, x_panel, matmat)
    return comm.psum_scatter(y_partial, col_axis)


class _ShardOperator:
    """The shard-local operator a chunk body multiplies with: this shard's
    rows of A @ x from this shard's x (collectives inside)."""

    def __init__(self, parts: _ShardParts, ax, dtype, device):
        self.parts = parts
        self.ax = ax
        self.dtype = dtype
        self.device = device
        self.shape = (parts.n_local, parts.n_local * ax.size)

    def matvec(self, x):
        return _local_apply(self.parts, x, self.ax)

    def matmat(self, X):
        return _local_apply(self.parts, X, self.ax, matmat=True)

    rmatvec = matvec  # only the Hermitian uses (shift-invert rescue) take it


class _ShiftedOperator:
    """(A - sigma I) on a shard; Hermitian A and real sigma make it
    self-adjoint."""

    def __init__(self, base, sigma):
        self.base = base
        self.sigma = sigma
        self.dtype = base.dtype
        self.device = base.device
        self.shape = base.shape

    def matvec(self, v):
        return self.base.matvec(v) - self.sigma * v

    rmatvec = matvec


class _ShiftInvertOperator:
    """Each application a mesh-parallel CG solve of (A - sigma I) y = x,
    checked by its true residual and rescued by mesh-parallel MINRES when
    CG did not meet the target (an interior sigma makes A - sigma I
    indefinite).  Every predicate is psum-completed, so every shard takes
    the same branch."""

    def __init__(self, base, sigma, tol, max_iters, ax):
        self.shifted = _ShiftedOperator(base, sigma)
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.ax = ax
        self.dtype = base.dtype
        self.device = base.device
        self.shape = base.shape

    def matvec(self, x):
        ax = self.ax
        shifted = self.shifted
        y, _, _ = _cg_loop(shifted, x, torch.zeros_like(x), self.tol,
                           max_iters=self.max_iters, comm=ax)
        r = x - shifted.matvec(y)
        rr = ax.psum(torch.vdot(r, r))
        xx = ax.psum(torch.vdot(x, x))
        rel2 = (rr.real if rr.is_complex() else rr) / torch.clamp(
            xx.real if xx.is_complex() else xx, min=1e-300)
        tol2 = torch.as_tensor(self.tol * self.tol, dtype=rel2.dtype, device=rel2.device)
        n_bad = ax.psum((~torch.all(torch.isfinite(y))).to(torch.float32))
        if bool(torch.isfinite(rel2) & (rel2 <= tol2)):
            return y
        y_safe = torch.where(n_bad == 0, y, torch.zeros_like(y))
        return _minres_loop(shifted, x, y_safe, self.tol, max_iters=self.max_iters,
                            comm=ax)[0]


def _chunk_pack(bsr, mesh, axis_name, matvec_mode, halo_parts) -> _MeshPack:
    """The placed operator of a chunk or mesh operator: ``halo_parts`` as
    given (placed, or the mode's split), else placed from ``bsr`` (a BSR
    operand of the sym_halo mode packed to half storage once)."""
    if matvec_mode not in _MODES:
        raise EigenexError(f"unknown matvec_mode {matvec_mode!r}")
    if isinstance(halo_parts, _MeshPack):
        return halo_parts
    if halo_parts is not None:
        if matvec_mode == "halo":
            split = tuple(halo_parts)
        elif matvec_mode == "sym_halo":
            diag, inp, right = halo_parts
            split = (diag, tuple(inp), tuple(right))
        elif matvec_mode == "colsplit":
            split = tuple(halo_parts)
        else:
            split = None
        return _mesh_pack(bsr, mesh, axis_name, matvec_mode, split)
    if matvec_mode == "sym_halo" and not isinstance(bsr, SymBSRMatrix):
        bsr = sym_bsr_from_bsr(bsr)
    return _mesh_pack(bsr, mesh, axis_name, matvec_mode)


def place_on_mesh(A, mesh: Mesh, *, axis_name: str = ROWS, matvec_mode: str = "allgather"):
    """``A`` split for ``matvec_mode`` and placed on ``mesh``: per-shard
    containers, contiguous and aligned on each shard's device.  Pass it as
    ``halo_parts=`` to :func:`distributed_lanczos_steps` or
    :func:`distributed_arnoldi_steps` to run many calls on one placement.
    Nothing else keeps it: it is freed with the caller's last reference, as
    the drivers' and :func:`mesh_operator`'s placements are freed with
    them."""
    if A.n_block_rows % mesh.shape[axis_name]:
        raise EigenexError(
            f"{A.n_block_rows} block rows not divisible by {mesh.shape[axis_name]} shards — "
            "use pad_bsr_for_mesh first"
        )
    return _chunk_pack(A, mesh, axis_name, matvec_mode, None)


def _as_sharded_rows(V, mesh, axis_name) -> Sharded:
    """A basis as per-shard column panels (contiguous copies)."""
    if isinstance(V, Sharded):
        return V
    from .shard_map import split_tensor

    return split_tensor(V, P(None, axis_name), mesh, place=True)


def distributed_lanczos_steps(
    bsr,
    state: LanczosState,
    num_steps: int,
    mesh: Mesh,
    *,
    axis_name: str = ROWS,
    shift=0.0,
    breakdown_threshold: float | None = None,
    reorthogonalize_interval: int = 1,
    deflate=None,
    matvec_mode: str = "allgather",
    halo_parts=None,
    shift_invert_sigma=None,
    cg_tol: float = 1e-8,
    cg_max_iters: int = 500,
    use_pallas: bool | str = False,
) -> LanczosState:
    """Run Lanczos steps with the operator row-partitioned over ``mesh``.

    Same semantics as :func:`eigenex_tpu_torch.solvers.lanczos.lanczos_steps`;
    the returned basis is held in per-shard column panels
    (:class:`~eigenex_tpu_torch.parallel.shard_map.Sharded`, the JAX
    package's ``P(None, rows)``), alpha/beta/k replicated.

    ``shift_invert_sigma``: each Lanczos matvec becomes a mesh-parallel CG
    solve of (A - sigma I) y = x with a MINRES rescue -- distributed
    shift-invert Lanczos, the BASELINE config-5 pipeline; the Ritz values
    theta then estimate 1/(lambda - sigma).  ``matvec_mode``: "allgather",
    "colsplit", "halo" or "sym_halo" (a ``SymBSRMatrix``, or a BSR packed
    to half storage here).  ``halo_parts``: the mode's split, when the
    caller has it, or a :func:`place_on_mesh` placement (else ``bsr`` is
    placed for this call).  ``use_pallas`` is accepted for signature
    parity."""
    nd = mesh.shape[axis_name]
    if bsr.n_block_rows % nd:
        raise EigenexError(
            f"{bsr.n_block_rows} block rows not divisible by {nd} shards — "
            "use pad_bsr_for_mesh first"
        )
    if bsr.shape[0] != bsr.shape[1]:
        raise EigenexError("Lanczos requires a square operator")
    if matvec_mode not in _MODES:
        raise EigenexError(f"unknown matvec_mode {matvec_mode!r}")
    pack = _chunk_pack(bsr, mesh, axis_name, matvec_mode, halo_parts)
    dtype = state.V.dtype
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(dtype)
    m = state.alpha.shape[0]
    k_start = int(state.k)
    num_steps = max(min(int(num_steps), m - k_start), 0)
    V = _as_sharded_rows(state.V, mesh, axis_name)
    has_deflate = deflate is not None
    if has_deflate:
        deflate = torch.as_tensor(deflate).to(device=V.device, dtype=dtype)
    else:
        deflate = torch.zeros((0, bsr.shape[1]), dtype=dtype, device=V.device)
    reorth = int(reorthogonalize_interval)
    bd = float(breakdown_threshold)

    def body(comm, parts, V, alpha, beta, k, brk, failed, defl):
        ax = comm.along(axis_name)
        op = _ShardOperator(parts, ax, dtype, V.device)
        if shift_invert_sigma is not None:
            op = _ShiftInvertOperator(op, float(shift_invert_sigma), cg_tol, cg_max_iters, ax)
        out = _lanczos_chunk(
            op, LanczosState(V=V, alpha=alpha, beta=beta, k=k, breakdown=brk, failed=failed),
            shift, bd, defl if has_deflate else None, k_start=k_start, num_steps=num_steps,
            reorthogonalize_interval=reorth, comm=ax,
        )
        return out.V, out.alpha, out.beta, out.k, out.breakdown, out.failed

    run = shard_map(
        body, mesh,
        in_specs=(P(axis_name), P(None, axis_name), P(), P(), P(), P(), P(), P(None, axis_name)),
        out_specs=(P(None, axis_name), P(), P(), P(), P(), P()),
        gather=False,
    )
    V, alpha, beta, k, brk, failed = run(
        pack.parts, V, state.alpha, state.beta, state.k, state.breakdown, state.failed, deflate)
    return LanczosState(V=V, alpha=alpha, beta=beta, k=k, breakdown=brk, failed=failed)


def distributed_arnoldi_steps(
    bsr,
    state: ArnoldiState,
    num_steps: int,
    mesh: Mesh,
    *,
    axis_name: str = ROWS,
    shift=0.0,
    breakdown_threshold: float | None = None,
    matvec_mode: str = "allgather",
    halo_parts=None,
    use_pallas: bool | str = False,
) -> ArnoldiState:
    """Arnoldi basis/Hessenberg build with the operator row-partitioned
    over ``mesh`` -- the engine of the distributed thick-restart and
    Krylov-Schur solvers.  The basis comes back in per-shard column
    panels, H and the flags replicated."""
    nd = mesh.shape[axis_name]
    if bsr.n_block_rows % nd:
        raise EigenexError("pad_bsr_for_mesh before distributed_arnoldi_steps")
    pack = _chunk_pack(bsr, mesh, axis_name, matvec_mode, halo_parts)
    dtype = state.V.dtype
    if breakdown_threshold is None:
        breakdown_threshold = default_breakdown_threshold(dtype)
    m = state.H.shape[1]
    k_start = int(state.k)
    num_steps = max(min(int(num_steps), m - k_start), 0)
    V = _as_sharded_rows(state.V, mesh, axis_name)
    bd = float(breakdown_threshold)

    def body(comm, parts, V, H, k, brk, residue, failed):
        ax = comm.along(axis_name)
        op = _ShardOperator(parts, ax, dtype, V.device)
        out = _arnoldi_chunk(
            op, ArnoldiState(V=V, H=H, k=k, breakdown=brk, residue=residue, failed=failed),
            shift, bd, None, k_start=k_start, num_steps=num_steps, comm=ax,
        )
        return out.V, out.H, out.k, out.breakdown, out.residue, out.failed

    run = shard_map(
        body, mesh,
        in_specs=(P(axis_name), P(None, axis_name), P(), P(), P(), P(), P()),
        out_specs=(P(None, axis_name), P(), P(), P(), P(), P()),
        gather=False,
    )
    V, H, k, brk, res, failed = run(pack.parts, V, state.H, state.k, state.breakdown,
                                    state.residue, state.failed)
    return ArnoldiState(V=V, H=H, k=k, breakdown=brk, residue=res, failed=failed)


# ---------------------------------------------------------------------------
# the distributed drivers
# ---------------------------------------------------------------------------
class _DistributedBSRSolverMixin:
    """Shared plumbing of the distributed drivers: mesh defaulting, row
    padding (with a null-space-safe start vector), the placement of the
    split operator, and the distributed Arnoldi chunk of the restarted
    solvers.  Subclasses call ``_init_distributed`` after their base
    ``__init__``."""

    def _init_distributed(self, bsr, mesh, axis_name, matvec_mode, orig_n, use_pallas=False):
        self.bsr = bsr
        self.mesh = mesh
        self.axis_name = axis_name
        self.matvec_mode = matvec_mode
        self.use_pallas = use_pallas
        self._dist_orig_n = orig_n
        if isinstance(bsr, SymBSRMatrix) and matvec_mode != "sym_halo":
            raise EigenexError(
                "a SymBSRMatrix operand requires matvec_mode='sym_halo' — "
                "the other modes need full-storage block rows"
            )
        self._halo_parts = _chunk_pack(bsr, mesh, axis_name, matvec_mode, None)
        # the host loop's operator: the placed shards' product, on the mesh's
        # first device (``bsr`` itself may stay in host memory)
        self.operator = _pack_operator(self._halo_parts, mesh, axis_name, bsr)
        if bsr.shape[0] != orig_n:
            self._initial_vector = _padding_safe_v0(
                orig_n, bsr.shape[0], accumulation_dtype(bsr.dtype), self.options.seed,
                mesh.first_device,
            )

    def compute(self, *args, **kwargs):
        """Run the base solver, then slice Ritz vectors back to the
        caller's ORIGINAL length (padding coordinates of every Krylov
        iterate are exactly zero, so truncation loses nothing)."""
        res = super().compute(*args, **kwargs)
        n = getattr(self, "_dist_orig_n", None)
        ev = getattr(res, "eigenvectors", None)
        if n is not None and ev is not None and ev.shape[0] != n:
            res.eigenvectors = ev[:n]
        return res

    def _run_arnoldi_chunk(self, op, state, num_steps, breakdown_threshold):
        if num_steps <= 0:
            return state
        # fixed chunk length (= m): steps past the subspace are not run
        return distributed_arnoldi_steps(
            self.bsr, state, state.H.shape[1], self.mesh, axis_name=self.axis_name,
            shift=self.options.eigenvalue_shift, breakdown_threshold=breakdown_threshold,
            matvec_mode=self.matvec_mode, halo_parts=self._halo_parts,
        )


def _default_mesh(mesh, axis_name):
    return mesh if mesh is not None else make_mesh(axis_name=axis_name)


class DistributedLanczosEigenSolver(_DistributedBSRSolverMixin, LanczosEigenSolver):
    """Mesh-parallel Lanczos driver: the host control loop, convergence
    machinery and result of :class:`LanczosEigenSolver`, with the chunk
    running under ``shard_map`` on a row-partitioned block operator."""

    def __init__(self, bsr, mesh: Mesh | None = None, options: LanczosOptions | None = None,
                 axis_name: str = ROWS, matvec_mode: str = "allgather",
                 use_pallas: bool | str = False):
        mesh = _default_mesh(mesh, axis_name)
        orig_n = bsr.shape[0]
        bsr = pad_bsr_for_mesh(bsr, mesh.shape[axis_name])
        super().__init__(bsr.as_linear_operator(), options)
        self._init_distributed(bsr, mesh, axis_name, matvec_mode, orig_n, use_pallas)

    def _run_chunk(self, op, state, num_steps, breakdown_threshold):
        o = self.options
        return distributed_lanczos_steps(
            self.bsr, state, num_steps, self.mesh, axis_name=self.axis_name,
            shift=o.eigenvalue_shift, breakdown_threshold=breakdown_threshold,
            reorthogonalize_interval=o.reorthogonalize_interval, deflate=self._deflate,
            matvec_mode=self.matvec_mode, halo_parts=self._halo_parts,
        )


class DistributedShiftInvertLanczosEigenSolver(DistributedLanczosEigenSolver):
    """Mesh-parallel SHIFT-INVERT Lanczos: each outer Lanczos matvec is a
    mesh-parallel CG solve of (A - sigma I) y = x (MINRES rescue) -- the
    BASELINE config-5 pipeline as a driver, reachable from
    ``eigsh(A, k, sigma=s, mesh=mesh)``.  :meth:`compute` back-transforms
    the Ritz values theta of (A - sigma I)^-1 to lambda = sigma + 1/theta.
    ``cg_tol`` is the inner relative-residual target."""

    def __init__(self, bsr, mesh: Mesh | None = None, options: LanczosOptions | None = None,
                 axis_name: str = ROWS, matvec_mode: str = "allgather",
                 use_pallas: bool | str = False, *, sigma: float, cg_tol: float = 1e-10,
                 cg_max_iters: int = 5000):
        super().__init__(bsr, mesh, options, axis_name, matvec_mode, use_pallas)
        self.sigma = float(sigma)
        self.cg_tol = float(cg_tol)
        self.cg_max_iters = int(cg_max_iters)

    def _run_chunk(self, op, state, num_steps, breakdown_threshold):
        o = self.options
        return distributed_lanczos_steps(
            self.bsr, state, num_steps, self.mesh, axis_name=self.axis_name,
            shift=o.eigenvalue_shift, breakdown_threshold=breakdown_threshold,
            reorthogonalize_interval=o.reorthogonalize_interval, deflate=self._deflate,
            matvec_mode=self.matvec_mode, halo_parts=self._halo_parts,
            shift_invert_sigma=self.sigma, cg_tol=self.cg_tol, cg_max_iters=self.cg_max_iters,
        )

    def compute(self, *args, **kwargs):
        res = super().compute(*args, **kwargs)
        theta = np.asarray(res.eigenvalues)
        nonzero = np.abs(theta) > 0
        res.eigenvalues = np.where(
            nonzero, self.sigma + 1.0 / np.where(nonzero, theta, 1.0), np.inf
        )
        return res


class DistributedThickRestartLanczosEigenSolver(
    _DistributedBSRSolverMixin, ThickRestartLanczosEigenSolver
):
    """Thick-restart Lanczos with the chunk row-partitioned over a mesh --
    the memory-bounded solver for operators whose Krylov basis cannot be
    held at full subspace size.  The restart compression runs on each
    shard's panel of the basis."""

    def __init__(self, bsr, mesh: Mesh | None = None,
                 options: ThickRestartOptions | None = None, axis_name: str = ROWS,
                 matvec_mode: str = "allgather", use_pallas: bool | str = False):
        mesh = _default_mesh(mesh, axis_name)
        orig_n = bsr.shape[0]
        bsr = pad_bsr_for_mesh(bsr, mesh.shape[axis_name])
        super().__init__(bsr.as_linear_operator(), options)
        self._init_distributed(bsr, mesh, axis_name, matvec_mode, orig_n, use_pallas)


class DistributedKrylovSchurArnoldiSolver(_DistributedBSRSolverMixin, KrylovSchurArnoldiSolver):
    """Krylov-Schur restarted Arnoldi with the chunk row-partitioned over a
    mesh -- the general-operator counterpart of
    :class:`DistributedThickRestartLanczosEigenSolver`."""

    def __init__(self, bsr, mesh: Mesh | None = None, options=None, axis_name: str = ROWS,
                 matvec_mode: str = "allgather", use_pallas: bool | str = False):
        mesh = _default_mesh(mesh, axis_name)
        orig_n = bsr.shape[0]
        bsr = pad_bsr_for_mesh(bsr, mesh.shape[axis_name])
        super().__init__(bsr.as_linear_operator(), options)
        self._init_distributed(bsr, mesh, axis_name, matvec_mode, orig_n, use_pallas)


# ---------------------------------------------------------------------------
# mesh operators: global-array LinearOperators whose products run sharded
# ---------------------------------------------------------------------------
def _local_bsr(data, cols, n_cols: int) -> BSRMatrix:
    return BSRMatrix(data, cols, (data.shape[0] * data.shape[2], n_cols))


def halo_matvec(diag_data, diag_cols, left_data, left_cols, right_data, right_cols, x_local,
                *, comm):
    """Halo-exchange SpMV inside a shard body, for operators whose
    off-shard column blocks lie only in the adjacent shards: two ring
    shifts bring the neighbours' x shards, and the diagonal, left and right
    parts of this shard (from :func:`split_bsr_halo`, shard-local block
    columns) multiply the own, left and right x shards.  ``comm``: the row
    axis's :class:`~eigenex_tpu_torch.parallel.shard_map.AxisComm`."""
    n = x_local.shape[0]
    parts = _ShardParts("halo", _local_bsr(diag_data, diag_cols, n),
                        left=_local_bsr(left_data, left_cols, n),
                        right=_local_bsr(right_data, right_cols, n))
    return _local_apply(parts, x_local, comm, matmat=x_local.ndim == 2)


def halo_matmat(diag_data, diag_cols, left_data, left_cols, right_data, right_cols, X_local,
                *, comm):
    """Multi-RHS twin of :func:`halo_matvec` (X_local: this shard's rows of
    an (n, p) panel)."""
    return halo_matvec(diag_data, diag_cols, left_data, left_cols, right_data, right_cols,
                       X_local, comm=comm)


def sym_halo_matvec(diag, ud, uc, rd, rc, x_local, *, comm, sym_reach: int = -1):
    """Symmetric halo-exchange SpMV inside a shard body (the layout of
    :func:`split_sym_bsr_halo`): the in-panel half-stored part (``diag``,
    ``ud``, ``uc``), and the boundary blocks reaching the right neighbour
    (``rd``, ``rc``) applied forward with the neighbour's x and, through
    their adjoint, to the local x, shipped one step right.  Each boundary
    block is stored once on the mesh."""
    n = x_local.shape[0]
    b = diag.shape[1]
    sym_local = SymBSRMatrix(diag, ud, uc, (n, n), sym_reach)
    right = _local_bsr(rd, rc, n)
    nb = n // b
    adj = _block_adjoint(right.data, right.block_cols, nb, (n, n))
    parts = _ShardParts("sym_halo", sym_local, right=right, right_adj=adj, lo=0, hi=nb,
                        n_local=n)
    return _local_apply(parts, x_local, comm, matmat=x_local.ndim == 2)


def sym_halo_matmat(diag, ud, uc, rd, rc, X_local, *, comm, sym_reach: int = -1):
    """Multi-RHS twin of :func:`sym_halo_matvec`."""
    return sym_halo_matvec(diag, ud, uc, rd, rc, X_local, comm=comm, sym_reach=sym_reach)


def _mesh_apply(pack: _MeshPack, mesh, axis_name, x, matmat: bool):
    spec = P(axis_name, None) if matmat else P(axis_name)

    def body(comm, parts, xl):
        return _local_apply(parts, xl, comm.along(axis_name), matmat)

    return shard_map(body, mesh, in_specs=(P(axis_name), spec), out_specs=spec)(pack.parts, x)


def mesh_operator(A, mesh: Mesh | None = None, *, axis_name: str = ROWS,
                  matvec_mode: str = "allgather", use_pallas: bool | str = False
                  ) -> LinearOperator:
    """A global-array :class:`LinearOperator` whose ``matvec`` AND
    ``matmat`` run shard-mapped over ``mesh`` (row-partitioned operator,
    row-split vectors and panels) -- the operand that makes every
    matvec/matmat-driven solver mesh-parallel without code changes:
    Chebyshev window filtering, KPM moments, LOBPCG, user code.

    ``A``: a :class:`BSRMatrix` (any mode) or :class:`SymBSRMatrix`
    (``matvec_mode='sym_halo'``) whose block rows divide the mesh -- use
    :func:`pad_bsr_for_mesh` first.  Vectors live on the mesh's first
    device.  The operator holds the placement of ``A`` and frees it with
    itself."""
    mesh = _default_mesh(mesh, axis_name)
    nd = mesh.shape[axis_name]
    if matvec_mode not in _MODES:
        raise EigenexError(f"unknown matvec_mode {matvec_mode!r}")
    if isinstance(A, SymBSRMatrix) and matvec_mode != "sym_halo":
        raise EigenexError("a SymBSRMatrix operand requires matvec_mode='sym_halo'")
    if A.n_block_rows % nd:
        raise EigenexError(
            f"{A.n_block_rows} block rows not divisible by {nd} shards — "
            "use pad_bsr_for_mesh first"
        )
    return _pack_operator(_chunk_pack(A, mesh, axis_name, matvec_mode, None), mesh, axis_name, A)


def _pack_operator(pack: _MeshPack, mesh: Mesh, axis_name: str, A) -> LinearOperator:
    """The :class:`LinearOperator` of ``A`` placed on ``mesh`` as ``pack``."""

    def mv(p, x):
        return _mesh_apply(p, mesh, axis_name, x, False)

    def mm(p, X):
        return _mesh_apply(p, mesh, axis_name, X, True)

    return LinearOperator(
        mv, pack, A.shape, accumulation_dtype(A.dtype), mesh.first_device,
        rmatvec_fn=mv if isinstance(A, SymBSRMatrix) else None, matmat_fn=mm,
    )


def mesh_operator_2d(A: BSRMatrix, mesh: Mesh, *, row_axis: str | None = None,
                     col_axis: str | None = None, use_pallas: bool | str = False
                     ) -> LinearOperator:
    """Global-array operator over a 2-D mesh: the operator splits into an
    R x C panel grid, x splits over (cols, rows), y over (rows, cols), and a
    product moves n/C + n/R entries a shard where the 1-D all-gather moves n.
    Chained applications need no re-layout: the global vector is the same
    either way."""
    if len(mesh.axis_names) < 2:
        raise EigenexError("mesh_operator_2d needs a 2-axis mesh")
    row_axis = row_axis or mesh.axis_names[0]
    col_axis = col_axis or mesh.axis_names[1]
    R, C = mesh.shape[row_axis], mesh.shape[col_axis]
    if A.shape[0] != A.shape[1]:
        raise EigenexError("mesh_operator_2d requires a square operator")
    data, cols = split_bsr_grid(A, R, C)
    rows_per = A.n_block_rows // R
    shape = (A.shape[0] // R, A.shape[1] // C)

    def make(i, dev):
        rows = slice(i * rows_per, (i + 1) * rows_per)
        return _ShardParts("grid", _bsr_piece(data[rows], cols[rows], shape, dev))

    parts = _per_axis(mesh, (row_axis, col_axis), make)

    def apply(p, x, matmat):
        tail = (None,) if matmat else ()
        x_spec, y_spec = P((col_axis, row_axis), *tail), P((row_axis, col_axis), *tail)

        def body(comm, part, xl):
            return _grid_apply(part, xl, comm, row_axis, col_axis, matmat)

        return shard_map(body, mesh, in_specs=(P((row_axis, col_axis)), x_spec),
                         out_specs=y_spec)(p, x)

    return LinearOperator(
        lambda p, x: apply(p, x, False), parts, A.shape, accumulation_dtype(A.dtype),
        mesh.first_device, matmat_fn=lambda p, X: apply(p, X, True),
    )


# ---------------------------------------------------------------------------
# Distributed LOBPCG (row-partitioned block iteration)
# ---------------------------------------------------------------------------
class DistributedLOBPCGSolver(LOBPCGSolver):
    """LOBPCG with the operator row-partitioned over a mesh via
    :func:`mesh_operator`: the A S / B S products (any matvec_mode,
    including ``sym_halo``) run mesh-parallel; only the 3b x 3b projected
    pencil visits the host, as in the single-device driver.  ``b_operator``
    and a block-sparse ``preconditioner`` are meshified the same way; a
    LinearOperator or callable preconditioner acts on the global (padded)
    residual block."""

    def __init__(self, bsr, mesh: Mesh | None = None, options=None, *, block_size: int = 4,
                 axis_name: str = ROWS, preconditioner=None, b_operator=None,
                 matvec_mode: str = "allgather", use_pallas: bool | str = False):
        from ..utils.prng import make_generator, random_matrix

        mesh = _default_mesh(mesh, axis_name)
        nd = mesh.shape[axis_name]
        orig_n = bsr.shape[0]
        if isinstance(bsr, SymBSRMatrix):
            matvec_mode = "sym_halo"
        bsr = pad_bsr_for_mesh(bsr, nd)
        opA = mesh_operator(bsr, mesh, axis_name=axis_name, matvec_mode=matvec_mode)

        def meshify(Cn, what):
            if not isinstance(Cn, (BSRMatrix, SymBSRMatrix)):
                return Cn  # LinearOperator / callable: applied globally
            if Cn.shape[0] != orig_n:
                raise EigenexError(f"{what} shape {Cn.shape} does not match A ({orig_n})")
            mode = "sym_halo" if isinstance(Cn, SymBSRMatrix) else "allgather"
            return mesh_operator(pad_bsr_for_mesh(Cn, nd), mesh, axis_name=axis_name,
                                 matvec_mode=mode)

        opB = meshify(b_operator, "b_operator") if b_operator is not None else None
        precond = meshify(preconditioner, "preconditioner") if preconditioner is not None else None
        super().__init__(opA, options, block_size=block_size, b_operator=opB,
                         preconditioner=precond)
        self.bsr = bsr
        self.mesh = mesh
        self.axis_name = axis_name
        self._dist_orig_n = orig_n
        if bsr.shape[0] != orig_n:
            # padding-safe start block: zero rows beyond the true n keep
            # every iterate exactly zero in the padding coordinates
            seed = options.seed if options is not None else 0
            X0 = random_matrix(make_generator(seed), block_size, orig_n, opA.dtype,
                               device=opA.device).T
            start = torch.zeros((bsr.shape[0], block_size), dtype=opA.dtype, device=opA.device)
            start[:orig_n] = X0
            self._initial_block = start

    def compute(self, operator=None):
        res = super().compute(operator)
        n = self._dist_orig_n
        if res.eigenvectors is not None and res.eigenvectors.shape[0] != n:
            res.eigenvectors = res.eigenvectors[:n]
        return res
