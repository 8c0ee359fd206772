"""Spin-chain Hamiltonian builders over symmetry sectors.

Counterpart of ``eigenex_tpu/block/hamiltonians.py``.  The reference's
BlockTensor exists to exploit quantum-number conservation; BASELINE
config 3 instantiates it: "block-sparse Heisenberg spin-chain Hamiltonian
matvec + Lanczos ground state (symmetry-sector blocks)".

The XXZ/Heisenberg chain conserves total S_z, so the Hamiltonian is
block-diagonal over magnetization sectors:

- :func:`sz_sector_basis` / :func:`heisenberg_sector_coo` -- the basis
  and sparse matrix of one sector;
- :func:`heisenberg_block_hamiltonian` -- the full operator as a rank-2
  :class:`BlockTensor` over the sector structure, each sector stored
  sparse (COO), packed (BSR) or dense;
- :func:`heisenberg_ground_state` -- sector-by-sector Lanczos sweep;
- the transverse-field Ising chain over its Z2 parity sectors, with the
  free-fermion closed form of its ground energy.

The f64 sector matrices come from the native enumerator
(:mod:`eigenex_tpu_torch.native`) where the library is available, as in the
JAX package.  Otherwise they are built on the host, vectorised: the basis
states are sorted ascending, so ``np.searchsorted(states, s ^ mask)`` gives
the row of each spin flip, and each row's entries (its diagonal and one
flip per movable bond) are sorted in place of a global sort.  Either way
the triplets, their values and their (row, col) order are those of the JAX
package's builders.
"""

from __future__ import annotations

from math import comb

import numpy as np
import torch

from .. import native
from ..core.indices import AddIndices
from ..solvers.lanczos import LanczosEigenSolver, LanczosOptions
from ..sparse.bsr import bsr_from_coo_arrays
from ..sparse.coo import COOMatrix, _coo_on
from ..utils.device import resolve_device
from ..utils.exceptions import EigenexError
from ..utils.profiling import annotate
from .block_tensor import BlockTensor

__all__ = [
    "sz_sector_basis",
    "parity_sector_basis",
    "tfi_parity_sector_coo",
    "tfi_ground_energy_exact",
    "heisenberg_sector_coo",
    "heisenberg_block_hamiltonian",
    "heisenberg_ground_state",
    "sector_structure",
]

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def _popcount(states: np.ndarray, L: int) -> np.ndarray:
    pop = np.zeros(states.shape, np.int64)
    for shift in range(0, L, 8):
        pop += _POPCOUNT8[(states >> shift) & 0xFF]
    return pop


def sz_sector_basis(L: int, n_up: int) -> np.ndarray:
    """All length-L bit states with ``n_up`` up-spins, ascending --
    the basis of one total-S_z sector."""
    states = np.arange(1 << L, dtype=np.int64)
    return states[_popcount(states, L) == n_up]


def _bonds(L: int, pbc: bool) -> list[tuple[int, int]]:
    return [(i, i + 1) for i in range(L - 1)] + ([(L - 1, 0)] if pbc and L > 2 else [])


def _row_sorted_triplets(states, flips, diag, off_value, dtype):
    """Row-major triplets of a sector matrix whose row r holds its diagonal
    ``diag[r]`` and ``off_value`` at column ``flips[b][r]`` for every bond b
    with ``flips[b][r] >= 0``.  Each row's columns are sorted in place
    (no row holds a column twice), so the triplets come out in
    lexsorted (row, col) order without a global sort."""
    dim = len(states)
    cols = np.empty((dim, len(flips) + 1), np.int64)
    cols[:, 0] = np.arange(dim)
    for b, f in enumerate(flips):
        cols[:, b + 1] = f
    cols.sort(axis=1)
    rows = np.broadcast_to(np.arange(dim)[:, None], cols.shape)
    keep = cols >= 0
    r, c = rows[keep], cols[keep]
    v = np.where(r == c, diag[r], np.asarray(off_value, dtype)).astype(dtype)
    return r.astype(np.int32), c.astype(np.int32), v


def _heisenberg_triplets(L, n_up, J, Jz, pbc, dtype):
    if Jz is None:
        Jz = J
    states = sz_sector_basis(L, n_up)
    dim = len(states)
    bonds = _bonds(L, pbc)
    # diagonal: Jz sum sz_i sz_j with sz = +-1/2 (accumulated in the
    # sector's dtype, bond by bond)
    diag = np.zeros(dim, dtype)
    for (i, j) in bonds:
        bi = (states >> i) & 1
        bj = (states >> j) & 1
        diag += Jz * (bi - 0.5) * (bj - 0.5)
    # off-diagonal: J/2 on each anti-aligned bond, whose flip stays in the
    # sector (and is anti-aligned again, so the matrix is symmetric)
    flips = []
    for (i, j) in bonds:
        movable = ((states >> i) & 1) != ((states >> j) & 1)
        f = np.full(dim, -1, np.int64)
        f[movable] = np.searchsorted(states, states[movable] ^ ((1 << i) | (1 << j)))
        flips.append(f)
    return _row_sorted_triplets(states, flips, diag, J / 2, dtype) + (dim,)


def _sector_triplets(L, n_up, J, Jz, pbc, dtype):
    """(rows, cols, vals, dim) of one sector in (row, col) order: the
    native enumerator for f64 where the library is available (its
    column-major output lexsorted), the numpy builder otherwise."""
    if np.dtype(dtype) == np.float64 and native.native_available():
        with annotate("eigenex.build.enumerate", native=True):
            r, c, v, dim = native.heisenberg_sector(L, n_up, J, J if Jz is None else Jz, pbc)
        with annotate("eigenex.build.lexsort"):
            order = np.lexsort((c, r))
            return r[order].astype(np.int32), c[order].astype(np.int32), v[order], dim
    with annotate("eigenex.build.enumerate", native=False):
        return _heisenberg_triplets(L, n_up, J, Jz, pbc, dtype)


@annotate("eigenex.build")
def heisenberg_sector_coo(
    L: int,
    n_up: int,
    J: float = 1.0,
    Jz: float | None = None,
    pbc: bool = False,
    dtype=np.float64,
    device=None,
) -> COOMatrix:
    """XXZ chain H = sum_b J/2 (S+_i S-_j + S-_i S+_j) + Jz S^z_i S^z_j
    restricted to the total-S_z sector with ``n_up`` up spins, as a COO
    matrix over the sector basis, on ``device`` (the card unless told
    otherwise).  Runs under the span ``eigenex.build``, its stages under
    ``eigenex.build.<stage>``."""
    r, c, v, dim = _sector_triplets(L, n_up, J, Jz, pbc, dtype)
    return _coo_on(r, c, v, (dim, dim), resolve_device(device))


def sector_structure(L: int) -> AddIndices:
    """Per-axis block structure of the full 2^L space ordered by
    magnetization sector: block k has dim C(L, k)."""
    return AddIndices([comb(L, k) for k in range(L + 1)])


def heisenberg_block_hamiltonian(
    L: int,
    J: float = 1.0,
    Jz: float | None = None,
    pbc: bool = False,
    dtype=np.float64,
    storage: str = "sparse",
    block_shape: tuple[int, int] | None = None,
    device=None,
) -> BlockTensor:
    """The full-chain Hamiltonian as a rank-2 BlockTensor over the S_z
    sector structure -- block-diagonal because H conserves S_z (cf. the
    selection rule block_tensor.hpp:2014-2029) -- on ``device`` (the
    card unless told otherwise).

    storage: "sparse" (default) keeps each sector block as its COOMatrix
    (O(nnz) memory); "bsr" packs each sector into the BSR-ELL layout of
    :class:`~eigenex_tpu_torch.sparse.bsr.BSRMatrix`, whose product on the
    card is the ``bsr_spmv`` kernel; "dense" stores dense blocks, the
    reference's design (block_tensor.hpp:1204-1206), for small L.

    ``block_shape`` of the BSR packs defaults to (32, 128) on a CUDA
    device -- the kernel takes 128 columns a block and keeps 4 of each
    warp's 16 row accumulators busy at 32 rows (at the JAX package's TPU
    choice of 8 rows, 1) -- and to (4, 4) elsewhere, as the JAX package
    off the TPU.  Sectors smaller than a block are padded up to one."""
    if storage not in ("sparse", "bsr", "dense"):
        raise ValueError(f"storage must be sparse|bsr|dense, got {storage!r}")
    device = resolve_device(device)
    s = sector_structure(L)
    bt = BlockTensor([s, s], dtype=dtype, device=device)
    if storage == "bsr" and block_shape is None:
        block_shape = (32, 128) if device.type == "cuda" else (4, 4)
    for n_up in range(L + 1):
        r, c, v, dim = _sector_triplets(L, n_up, J, Jz, pbc, dtype)
        if storage == "dense":
            dense = np.zeros((dim, dim), v.dtype)
            dense[r, c] = v
            bt.set_block((n_up, n_up), dense)
        elif storage == "sparse":
            bt.set_block((n_up, n_up), _coo_on(r, c, v, (dim, dim), device))
        else:
            bt.set_block((n_up, n_up), bsr_from_coo_arrays(
                r, c, v, (dim, dim), block_shape, device=device))
    return bt


def heisenberg_ground_state(
    L: int,
    J: float = 1.0,
    Jz: float | None = None,
    pbc: bool = False,
    options: LanczosOptions | None = None,
    device=None,
):
    """Ground-state energy/vector by a per-sector Lanczos sweep on
    ``device`` (the card unless told otherwise).

    Returns (energy, sector_n_up, sector_vector, per_sector_energies)."""
    device = resolve_device(device)
    energies = {}
    best = (np.inf, None, None)
    for n_up in range(L + 1):
        coo = heisenberg_sector_coo(L, n_up, J, Jz, pbc, device=device)
        dim = coo.shape[0]
        if dim == 1:
            e = float(coo.val[0])
            vec = torch.ones((1, 1), dtype=torch.float64, device=device)
        else:
            opts = options or LanczosOptions(
                max_eigenvalues=1, tolerance=1e-13, max_subspace=min(dim, 200)
            )
            res = LanczosEigenSolver(coo.as_linear_operator(), opts).compute()
            e = float(res.eigenvalues[0])
            vec = res.eigenvectors
        energies[n_up] = e
        if e < best[0]:
            best = (e, n_up, vec)
    return best[0], best[1], best[2], energies


# ---------------------------------------------------------------------------
# Transverse-field Ising chain -- the OTHER symmetry class: Z2 spin-flip
# parity P = prod sigma^z (popcount parity) instead of U(1) total-S_z
# ---------------------------------------------------------------------------
def parity_sector_basis(L: int, parity: int) -> np.ndarray:
    """All length-L bit states whose up-spin count has the given parity
    (0 = even, 1 = odd), ascending -- the basis of one Z2 sector of any
    parity-conserving Hamiltonian (sigma^x sigma^x bonds flip spins in
    pairs)."""
    if parity not in (0, 1):
        raise EigenexError("parity must be 0 (even) or 1 (odd)")
    states = np.arange(1 << L, dtype=np.int64)
    return states[(_popcount(states, L) & 1) == parity]


def tfi_parity_sector_coo(
    L: int,
    J: float = 1.0,
    h: float = 1.0,
    parity: int = 0,
    pbc: bool = True,
    dtype=np.float64,
    device=None,
) -> COOMatrix:
    """Transverse-field Ising chain H = -J sum_b sx_i sx_j - h sum_i sz_i
    restricted to one Z2 parity sector (dim 2^{L-1}), as a COO matrix on
    ``device`` (the card unless told otherwise).

    The sx sx bond flips two adjacent spins (popcount parity preserved);
    the field term is diagonal.  The ground state lives in the EVEN sector
    (parity=0).  PBC spectra are exactly solvable by Jordan-Wigner free
    fermions -- :func:`tfi_ground_energy_exact` is the closed-form oracle."""
    states = parity_sector_basis(L, parity)
    dim = len(states)
    # diagonal: -h sum sz with sz = +1 for bit 1
    diag = (-h * (2 * _popcount(states, L) - L)).astype(dtype)
    # off-diagonal: -J sx_i sx_j flips bits i, j on EVERY state
    flips = [np.searchsorted(states, states ^ ((1 << i) | (1 << j))) for i, j in _bonds(L, pbc)]
    r, c, v = _row_sorted_triplets(states, flips, diag, -J, dtype)
    return _coo_on(r, c, v, (dim, dim), resolve_device(device))


def tfi_ground_energy_exact(L: int, J: float = 1.0, h: float = 1.0) -> float:
    """Closed-form PBC ground energy via Jordan-Wigner free fermions:
    E0 = -1/2 sum_m eps(k_m), eps(k) = 2 sqrt(J^2 + h^2 - 2 J h cos k) over
    the antiperiodic (even-parity/Neveu-Schwarz) momenta k_m = (2m+1) pi / L."""
    ks = (2 * np.arange(L) + 1) * np.pi / L
    eps = 2.0 * np.sqrt(J * J + h * h - 2.0 * J * h * np.cos(ks))
    return float(-0.5 * np.sum(eps))
