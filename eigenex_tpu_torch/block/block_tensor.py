"""Block-sparse tensor keyed by per-axis symmetry-sector (block) indices.

Counterpart of ``eigenex_tpu/block/block_tensor.py`` (the reference's
include/cmpt/eigen_ex/block_tensor.hpp: the live CRTP
``BlockTensorBase``/``BlockTensor``, :1176-2456, plus its einsum
specializations :2458-2869; the deprecated ``old::`` namespace is not
reproduced).

Storage model (cf. block_tensor.hpp:1204-1206): per-axis block structure
= :class:`~eigenex_tpu_torch.core.indices.AddIndices`, stored blocks = a
Python ``dict`` mapping sector-index tuples to dense torch tensors on
the tensor's device (the card unless told otherwise).  Only nonzero
blocks are stored; contraction skips block pairs whose sector indices
mismatch -- the quantum-number conservation selection rule (:2014-2029).

- The block key set is host-side Python data; per-block compute is
  dense torch ops.
- Contraction groups same-shaped block pairs and runs each group as one
  batched product on stacked blocks (:meth:`BlockTensor.contract`,
  :func:`block_einsum`), at "highest" f32 matmul precision whatever the
  caller has set.
- A stored block is never written into.  Every update builds a new
  tensor, and a tensor handed to :meth:`BlockTensor.set_block` or
  :meth:`BlockTensor.add_block` is copied in, so neither its owner nor
  this tensor sees the other's later writes (JAX arrays are immutable,
  and the JAX package relies on that).
"""

from __future__ import annotations

from itertools import product as _product
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core.indices import AddIndices
from ..ops.einsum import einsum_labels
from ..utils.device import resolve_device
from ..utils.exceptions import BlockTensorError
from ..utils.precision import highest_f32_matmul
from ..utils.tolerance import as_torch_dtype, real_dtype_of

__all__ = [
    "BlockTensor",
    "block_einsum",
    "block_tensor_norm",
    "block_tensor_squared_norm",
    "is_sparse_block",
]


def _as_structure(s) -> AddIndices:
    if isinstance(s, AddIndices):
        return s
    return AddIndices(s)


def is_sparse_block(blk) -> bool:
    """True when a stored block is a sparse container (COO/BSR) rather
    than a dense tensor: symmetry-sector Hamiltonians keep each sector
    sparse and apply it through the container's matvec."""
    from ..sparse.bsr import BSRMatrix
    from ..sparse.coo import COOMatrix

    return isinstance(blk, (COOMatrix, BSRMatrix))


class BlockTensor:
    """Block-sparse tensor (cf. BlockTensorBase block_tensor.hpp:1176 and
    concrete BlockTensor :2291).  ``dtype`` is a torch or numpy dtype;
    the blocks live on ``device``, the card unless told otherwise."""

    def __init__(
        self,
        structures: Sequence[AddIndices | Sequence[int]],
        blocks: Mapping[tuple, object] | None = None,
        dtype=torch.float32,
        device=None,
    ):
        self.structures: tuple[AddIndices, ...] = tuple(_as_structure(s) for s in structures)
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)
        self.blocks: dict[tuple, object] = {}
        if blocks:
            for key, arr in blocks.items():
                self.set_block(tuple(key), arr)

    # -- shape/introspection (block_tensor.hpp:1222-1268) ----------------
    @property
    def ndim(self) -> int:
        return len(self.structures)

    @property
    def dims(self) -> tuple[int, ...]:
        """Total per-axis dims (cf. dimensions :1222)."""
        return tuple(s.dim for s in self.structures)

    @property
    def block_dims(self) -> tuple[int, ...]:
        """Number of blocks per axis (cf. blockDimensions :1240)."""
        return tuple(s.num_blocks for s in self.structures)

    def intra_block_dims(self, key: tuple) -> tuple[int, ...]:
        """Shape of the block at sector ``key`` (cf. intraBlockDimensions
        :1252-1268)."""
        key = self._norm_key(key)
        return tuple(s.block_dims[b] for s, b in zip(self.structures, key))

    def _norm_key(self, key: tuple) -> tuple:
        if len(key) != self.ndim:
            raise BlockTensorError(f"block key {key} has wrong rank (expect {self.ndim})")
        return tuple(int(b) % s.num_blocks for b, s in zip(key, self.structures))

    def block_keys(self):
        return self.blocks.keys()

    @property
    def num_stored_blocks(self) -> int:
        return len(self.blocks)

    def block_pytree(self) -> dict:
        """The device-data view of this tensor: a dict of its blocks."""
        return dict(self.blocks)

    def with_blocks(self, blocks: Mapping[tuple, object]) -> "BlockTensor":
        out = BlockTensor(self.structures, dtype=self.dtype, device=self.device)
        out.blocks = dict(blocks)
        return out

    def _empty(self, structures, dtype=None) -> "BlockTensor":
        return BlockTensor(structures, dtype=self.dtype if dtype is None else dtype,
                           device=self.device)

    def _copy_in(self, arr) -> torch.Tensor:
        """A caller's array as a block: a copy of this tensor's dtype on
        its device, never a view of the caller's data."""
        if isinstance(arr, torch.Tensor):
            return arr.to(device=self.device, dtype=self.dtype, copy=True)
        return torch.tensor(np.asarray(arr), dtype=self.dtype, device=self.device)

    # -- element access (block_tensor.hpp:1274-1335) ---------------------
    def _locate(self, multi: Sequence[int]) -> tuple[tuple, tuple]:
        key = tuple(s.first(i) for s, i in zip(self.structures, multi))
        intra = tuple(s.second(i) for s, i in zip(self.structures, multi))
        return key, intra

    def get_element(self, multi: Sequence[int]):
        """Value at a global multi-index; zero if the block is absent
        (cf. getElement :1274-1301)."""
        self._require_dense("get_element")
        key, intra = self._locate(multi)
        blk = self.blocks.get(key)
        if blk is None:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        return blk[intra]

    def _updated_element(self, multi, value, add: bool) -> "BlockTensor":
        key, intra = self._locate(multi)
        blk = self.blocks.get(key)
        new = (torch.zeros(self.intra_block_dims(key), dtype=self.dtype, device=self.device)
               if blk is None else blk.clone())
        new[intra] = (new[intra] + value) if add else value
        self.blocks[key] = new
        return self

    def set_element(self, multi: Sequence[int], value) -> "BlockTensor":
        """Set one element, creating its block on demand
        (cf. setElement :1568-1611, creation :1574-1581).  Mutates self
        (the block is replaced by an updated copy)."""
        self._require_dense("set_element")
        return self._updated_element(multi, value, add=False)

    def add_element(self, multi: Sequence[int], value) -> "BlockTensor":
        self._require_dense("add_element")
        return self._updated_element(multi, value, add=True)

    @property
    def has_sparse_blocks(self) -> bool:
        return any(is_sparse_block(b) for b in self.blocks.values())

    def _require_dense(self, what: str):
        if self.has_sparse_blocks:
            raise BlockTensorError(
                f"{what} requires dense blocks; this tensor stores sparse "
                "(COO/BSR) containers -- apply it through block_operator, "
                "or densify the blocks first"
            )

    # -- block mutators (block_tensor.hpp:1510-1640) ---------------------
    def set_block(self, key: tuple, arr) -> "BlockTensor":
        """cf. setBlock :1614-1630 (shape-checked).

        Rank-2 tensors also accept sparse containers (COOMatrix /
        BSRMatrix) as blocks, moved to this tensor's device; BSR blocks may
        be zero-padded up from the sector dims (the padding rows/cols are
        structurally zero and block_operator slices them away)."""
        key = self._norm_key(key)
        exp = self.intra_block_dims(key)
        if is_sparse_block(arr):
            if self.ndim != 2:
                raise BlockTensorError("sparse blocks require a rank-2 tensor")
            if any(s < e for s, e in zip(arr.shape, exp)):
                raise BlockTensorError(
                    f"sparse block {key} covers {tuple(arr.shape)} < expected {exp}"
                )
            self.blocks[key] = arr if arr.device == self.device else arr.to(self.device)
            return self
        arr = self._copy_in(arr)
        if tuple(arr.shape) != exp:
            raise BlockTensorError(f"block {key} expects shape {exp}, got {tuple(arr.shape)}")
        self.blocks[key] = arr
        return self

    def add_block(self, key: tuple, arr) -> "BlockTensor":
        """Accumulating insert (cf. addBlock :1510-1529)."""
        return self._accumulate(key, self._copy_in(arr))

    def _accumulate(self, key: tuple, arr: torch.Tensor) -> "BlockTensor":
        """:meth:`add_block` of a tensor this module computed (no copy-in)."""
        key = self._norm_key(key)
        arr = arr.to(self.dtype)
        exp = self.intra_block_dims(key)
        if tuple(arr.shape) != exp:
            raise BlockTensorError(f"block {key} expects shape {exp}, got {tuple(arr.shape)}")
        cur = self.blocks.get(key)
        self.blocks[key] = arr if cur is None else cur + arr
        return self

    def mul_block(self, key: tuple, factor) -> "BlockTensor":
        """cf. mulBlock :1532-1545."""
        key = self._norm_key(key)
        if key in self.blocks:
            self.blocks[key] = self.blocks[key] * factor
        return self

    def erase_block(self, key: tuple) -> "BlockTensor":
        """cf. eraseBlock :1632-1640."""
        self.blocks.pop(self._norm_key(key), None)
        return self

    # -- conversions (block_tensor.hpp:1337-1410,1642-1672) --------------
    def _slices(self, key: tuple, structures=None) -> tuple:
        structures = self.structures if structures is None else structures
        return tuple(
            slice(int(s.offsets[b]), int(s.offsets[b]) + s.block_dims[b])
            for s, b in zip(structures, key)
        )

    def to_dense(self) -> torch.Tensor:
        """cf. makeDenseTensor :1337-1360.  Sparse blocks densify (their
        structural padding sliced away)."""
        out = torch.zeros(self.dims, dtype=self.dtype, device=self.device)
        for key, blk in self.blocks.items():
            exp = self.intra_block_dims(key)
            if is_sparse_block(blk):
                blk = torch.as_tensor(blk.to_dense()).to(self.device)
                blk = blk[tuple(slice(0, e) for e in exp)]
            out[self._slices(key)] = blk.to(self.dtype)
        return out

    @classmethod
    def from_dense(
        cls,
        t,
        structures: Sequence[AddIndices | Sequence[int]],
        *,
        drop_zero_blocks: bool = True,
        dtype=None,
        device=None,
    ) -> "BlockTensor":
        """cf. setFromDenseTensor :1642-1672 (skips all-zero blocks).  The
        blocks are cut on the host and land on ``device``."""
        t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        structures = tuple(_as_structure(s) for s in structures)
        if tuple(s.dim for s in structures) != t.shape:
            raise BlockTensorError(
                f"structures cover {tuple(s.dim for s in structures)} but tensor is {t.shape}"
            )
        out = cls(structures, dtype=dtype or t.dtype, device=device)
        for key in np.ndindex(*(s.num_blocks for s in structures)):
            blk = t[out._slices(key)]
            if drop_zero_blocks and not np.any(blk):
                continue
            out.set_block(tuple(key), blk)
        return out

    def stored_values(self) -> torch.Tensor:
        """All stored elements as one flat vector
        (cf. makeFiniteElementsVector :1362-1381, implementing the intent)."""
        self._require_dense("stored_values")
        if not self.blocks:
            return torch.zeros((0,), dtype=self.dtype, device=self.device)
        return torch.cat([b.reshape(-1) for _, b in sorted(self.blocks.items())])

    def equals_blocks(self, other: "BlockTensor") -> bool:
        """Same structure and same stored key set (cf. equalsBlocks :1389-1404)."""
        return (
            self.structures == other.structures
            and set(self.blocks.keys()) == set(other.blocks.keys())
        )

    def cast(self, dtype) -> "BlockTensor":
        """cf. cast :1406-1418."""
        self._require_dense("cast")
        out = self._empty(self.structures, as_torch_dtype(dtype))
        out.blocks = {k: v.to(out.dtype) for k, v in self.blocks.items()}
        return out

    def conjugate(self) -> "BlockTensor":
        """cf. conjugateInPlace :1770-1775 (functional here)."""
        self._require_dense("conjugate")
        return self.with_blocks({k: torch.conj_physical(v) for k, v in self.blocks.items()})

    def scalar_multiple(self, c) -> "BlockTensor":
        """cf. scalarMultiple :1777-1784."""
        return self.with_blocks(
            {
                k: (v.scalar_multiple(c) if is_sparse_block(v) else v * c)
                for k, v in self.blocks.items()
            }
        )

    # -- structure transforms (block_tensor.hpp:1675-1768) ---------------
    def shuffle(self, perm: Sequence[int]) -> "BlockTensor":
        """Permute axes (cf. shuffleInPlace :1675-1696)."""
        self._require_dense("shuffle")
        perm = tuple(int(p) for p in perm)
        if sorted(perm) != list(range(self.ndim)):
            raise BlockTensorError(f"invalid permutation {perm}")
        out = self._empty([self.structures[p] for p in perm])
        for key, blk in self.blocks.items():
            out._accumulate(tuple(key[p] for p in perm), blk.permute(perm))
        return out

    def block_shuffle(self, axis: int, block_perm: Sequence[int]) -> "BlockTensor":
        """Permute the *blocks* along one axis (cf. blockShuffleInPlace
        :1698-1745): new block b comes from old block block_perm[b]."""
        self._require_dense("block_shuffle")
        s = self.structures[axis]
        block_perm = tuple(int(p) for p in block_perm)
        if sorted(block_perm) != list(range(s.num_blocks)):
            raise BlockTensorError(f"invalid block permutation {block_perm}")
        inv = {p: i for i, p in enumerate(block_perm)}
        structures = list(self.structures)
        structures[axis] = AddIndices([s.block_dims[p] for p in block_perm])
        out = self._empty(structures)
        for key, blk in self.blocks.items():
            nk = list(key)
            nk[axis] = inv[key[axis]]
            out._accumulate(tuple(nk), blk)
        return out

    def reblock(self, structures: Sequence[AddIndices | Sequence[int]]) -> "BlockTensor":
        """Re-partition under new per-axis block structures covering the
        same dims (cf. reblock :1762-1768).

        Block-wise overlap slicing: each stored block is cut along the
        new per-axis boundaries and its pieces accumulated into the
        overlapping new blocks -- O(stored data) work and memory, never a
        dense prod(dims) round-trip."""
        self._require_dense("reblock")
        structures = tuple(_as_structure(s) for s in structures)
        if tuple(s.dim for s in structures) != self.dims:
            raise BlockTensorError("reblock structures must cover identical dims")
        out = self._empty(structures)

        def overlaps(old_s: AddIndices, old_b: int, new_s: AddIndices):
            """(new_block, old_local_slice, new_local_slice) triples for
            one axis."""
            o0 = int(old_s.offsets[old_b])
            o1 = o0 + int(old_s.block_dims[old_b])
            res = []
            for nb in range(new_s.num_blocks):
                n0 = int(new_s.offsets[nb])
                n1 = n0 + int(new_s.block_dims[nb])
                lo, hi = max(o0, n0), min(o1, n1)
                if lo < hi:
                    res.append((nb, slice(lo - o0, hi - o0), slice(lo - n0, hi - n0)))
            return res

        for key, blk in self.blocks.items():
            per_axis = [
                overlaps(self.structures[ax], key[ax], structures[ax])
                for ax in range(self.ndim)
            ]
            for combo in _product(*per_axis):
                new_key = tuple(c[0] for c in combo)
                old_sl = tuple(c[1] for c in combo)
                new_sl = tuple(c[2] for c in combo)
                cur = out.blocks.get(new_key)
                new = (torch.zeros(out.intra_block_dims(new_key), dtype=self.dtype,
                                   device=self.device) if cur is None else cur.clone())
                new[new_sl] += blk[old_sl].to(self.dtype)
                out.blocks[new_key] = new
        return out

    def truncate(self, threshold: float) -> "BlockTensor":
        """Drop blocks whose max |value| <= threshold (cf. truncate :1747-1760)."""
        self._require_dense("truncate")
        out = self._empty(self.structures)
        for key, blk in self.blocks.items():
            if float(blk.abs().max()) > threshold:
                out.blocks[key] = blk
        return out

    # -- elementwise arithmetic (block_tensor.hpp:1786-1828,2381-2416) ---
    def _check_same_structure(self, other: "BlockTensor"):
        if self.structures != other.structures:
            raise BlockTensorError("block structures differ")

    def __add__(self, other: "BlockTensor") -> "BlockTensor":
        self._require_dense("__add__")
        other._require_dense("__add__")
        self._check_same_structure(other)
        out = self._empty(self.structures, torch.promote_types(self.dtype, other.dtype))
        out.blocks = {k: v.to(out.dtype) for k, v in self.blocks.items()}
        for key, blk in other.blocks.items():
            out._accumulate(key, blk)
        return out

    def __sub__(self, other: "BlockTensor") -> "BlockTensor":
        return self + other.scalar_multiple(-1)

    def __mul__(self, c) -> "BlockTensor":
        if isinstance(c, BlockTensor):
            # elementwise product keeps only common blocks (zeros elsewhere)
            self._check_same_structure(c)
            out = self._empty(self.structures, torch.promote_types(self.dtype, c.dtype))
            for key in self.blocks.keys() & c.blocks.keys():
                out.blocks[key] = self.blocks[key] * c.blocks[key]
            return out
        return self.scalar_multiple(c)

    __rmul__ = __mul__

    def __truediv__(self, c) -> "BlockTensor":
        return self.scalar_multiple(1.0 / c)

    def __neg__(self):
        return self.scalar_multiple(-1)

    # -- contraction (block_tensor.hpp:1924-2094) ------------------------
    @highest_f32_matmul()
    def contract(self, other: "BlockTensor", pairs: Sequence[tuple[int, int]]) -> "BlockTensor":
        """Block-sparse contraction over axis ``pairs`` [(axA, axB), ...].

        Structure check (:1944-1958): contracted axes must share their
        AddIndices.  Selection rule (:2014-2029): a block pair
        contributes only if the sector indices match on every contracted
        axis.  Pairs with identical shapes and result key are stacked and
        contracted as ONE batched einsum, then accumulated by result key
        (:2050-2051)."""
        self._require_dense("contract")
        other._require_dense("contract")
        pairs = [(int(a), int(b)) for a, b in pairs]
        for a, b in pairs:
            if self.structures[a] != other.structures[b]:
                raise BlockTensorError(
                    f"contracted axes ({a},{b}) have different block structures"
                )
        axA = [a for a, _ in pairs]
        axB = [b for _, b in pairs]
        keepA = [i for i in range(self.ndim) if i not in axA]
        keepB = [i for i in range(other.ndim) if i not in axB]
        out_structures = [self.structures[i] for i in keepA] + [
            other.structures[i] for i in keepB
        ]
        out_dtype = torch.promote_types(self.dtype, other.dtype)
        out = self._empty(out_structures, out_dtype)

        # index other's blocks by their contracted-sector signature
        sigB: dict[tuple, list[tuple]] = {}
        for kb in other.blocks:
            sigB.setdefault(tuple(kb[b] for b in axB), []).append(kb)

        # group (kA, kB) pairs by (blockA shape, blockB shape, result key)
        # so each group runs as ONE stacked einsum
        groups: dict[tuple, list[tuple]] = {}
        for ka, blkA in self.blocks.items():
            sig = tuple(ka[a] for a in axA)
            for kb in sigB.get(sig, ()):
                out_key = tuple(ka[i] for i in keepA) + tuple(kb[i] for i in keepB)
                gkey = (tuple(blkA.shape), tuple(other.blocks[kb].shape), out_key)
                groups.setdefault(gkey, []).append((ka, kb))

        # the batched product of lax.dot_general: batch axis first, then A's
        # free axes, then B's free axes
        letters = "abcdefghijklmnopqrstuvwxy"
        labA = [letters[i] for i in range(self.ndim)]
        labB = [letters[self.ndim + i] for i in range(other.ndim)]
        for a, b in pairs:
            labB[b] = labA[a]
        subs = ("z" + "".join(labA) + ",z" + "".join(labB) + "->z"
                + "".join(labA[i] for i in keepA) + "".join(labB[i] for i in keepB))
        partial_results: dict[tuple, list] = {}
        for (shA, shB, out_key), pair_list in groups.items():
            A_stack = torch.stack([self.blocks[ka].to(out_dtype) for ka, _ in pair_list])
            B_stack = torch.stack([other.blocks[kb].to(out_dtype) for _, kb in pair_list])
            batched = torch.einsum(subs, A_stack, B_stack)
            del A_stack, B_stack
            partial_results.setdefault(out_key, []).append(batched.sum(dim=0))
        for out_key, parts in partial_results.items():
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            out._accumulate(out_key, total)
        return out

    def trace(self, axis_a: int, axis_b: int) -> "BlockTensor":
        """Partial trace over two axes with equal structure -- only
        diagonal blocks contribute (cf. trace :2105-2168, diagonal-block
        filter :2142-2148)."""
        self._require_dense("trace")
        a, b = int(axis_a), int(axis_b)
        if self.structures[a] != self.structures[b]:
            raise BlockTensorError("traced axes have different block structures")
        keep = [i for i in range(self.ndim) if i not in (a, b)]
        out = self._empty([self.structures[i] for i in keep])
        for key, blk in self.blocks.items():
            if key[a] != key[b]:
                continue
            traced = torch.diagonal(blk, dim1=a, dim2=b).sum(dim=-1)
            out._accumulate(tuple(key[i] for i in keep), traced)
        return out

    def full_trace(self) -> torch.Tensor:
        """Scalar sum_i T[i, i] for a rank-2 block tensor."""
        if self.ndim != 2:
            raise BlockTensorError("full_trace requires rank 2")
        self._require_dense("full_trace")
        tot = torch.zeros((), dtype=self.dtype, device=self.device)
        for key, blk in self.blocks.items():
            if key[0] == key[1]:
                tot = tot + torch.trace(blk)
        return tot

    def axis_fixed(self, axis: int, index: int) -> "BlockTensor":
        """Fix one global index along ``axis``, producing a rank-(N-1)
        tensor (cf. axisFixed :2171-2288, slice+reshape :2253)."""
        self._require_dense("axis_fixed")
        axis = int(axis)
        s = self.structures[axis]
        b = s.first(index)
        intra = s.second(index)
        keep = [i for i in range(self.ndim) if i != axis]
        out = self._empty([self.structures[i] for i in keep])
        for key, blk in self.blocks.items():
            if key[axis] != b:
                continue
            out._accumulate(tuple(key[i] for i in keep), torch.select(blk, axis, intra))
        return out

    # -- norms (block_tensor.hpp:2426-2440) ------------------------------
    def squared_norm(self) -> torch.Tensor:
        from ..sparse.bsr import BSRMatrix
        from ..sparse.coo import COOMatrix

        rdt = real_dtype_of(self.dtype)
        tot = torch.zeros((), dtype=rdt, device=self.device)
        for blk in self.blocks.values():
            if isinstance(blk, COOMatrix):
                v = blk.val
            elif isinstance(blk, BSRMatrix):
                v = blk.data  # padding is zero
            else:
                v = blk
            tot = tot + (v.abs() ** 2).sum().to(rdt)
        return tot

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.squared_norm())

    def __repr__(self):
        return (
            f"BlockTensor(dims={self.dims}, block_dims={self.block_dims}, "
            f"stored={self.num_stored_blocks}, dtype={self.dtype}, device={self.device})"
        )


def block_tensor_squared_norm(bt: BlockTensor) -> torch.Tensor:
    """cf. blockTensorSquaredNorm block_tensor.hpp:2426-2436"""
    return bt.squared_norm()


def block_tensor_norm(bt: BlockTensor) -> torch.Tensor:
    """cf. blockTensorNorm block_tensor.hpp:2438-2440"""
    return bt.norm()


# ---------------------------------------------------------------------------
# Block-sparse einsum (cf. the einsum ToImpl specializations for BlockTensor,
# block_tensor.hpp:2458-2869)
# ---------------------------------------------------------------------------
class _BlockFrom:
    def __init__(self, tensors, in_labels):
        self._tensors = tensors
        self._in_labels = in_labels

    def to(self, out_labels: Sequence[str]) -> BlockTensor:
        return block_einsum(self._tensors, self._in_labels, tuple(out_labels))


class _BlockEinsum:
    def __init__(self, tensors):
        self._tensors = tensors

    def from_(self, *in_labels) -> _BlockFrom:
        if len(in_labels) != len(self._tensors):
            raise BlockTensorError("one label list per tensor required")
        return _BlockFrom(self._tensors, tuple(tuple(l) for l in in_labels))

    From = from_


def block_einsum_entry(tensors):
    for t in tensors:
        if not isinstance(t, BlockTensor):
            raise BlockTensorError("cannot mix BlockTensor and dense operands in einsum")
    return _BlockEinsum(tensors)


#: set by every block_einsum call to the number of block-key
#: combinations it enumerated -- test instrumentation for the
#: O(matching pairs) enumeration
_LAST_CANDIDATE_COUNT = 0


@highest_f32_matmul()
def block_einsum(
    tensors: Sequence[BlockTensor],
    in_labels: Sequence[Sequence[str]],
    out_labels: Sequence[str],
) -> BlockTensor:
    """General 1- or 2-tensor block einsum with the sector selection rule:
    all axes sharing a label must hold the same block index for a block
    combination to contribute (block_tensor.hpp:2651-2684); per-group
    dense einsum (:2696-2699) accumulates into the result key.
    """
    if len(tensors) not in (1, 2):
        raise BlockTensorError("block einsum supports 1 or 2 tensors")
    for t in tensors:
        t._require_dense("block einsum")
    # label -> list of (tensor_idx, axis)
    label_axes: dict[str, list[tuple[int, int]]] = {}
    for ti, labs in enumerate(in_labels):
        if len(labs) != tensors[ti].ndim:
            raise BlockTensorError(
                f"tensor {ti} has rank {tensors[ti].ndim} but {len(labs)} labels"
            )
        for ax, lab in enumerate(labs):
            label_axes.setdefault(lab, []).append((ti, ax))
    for lab, sites in label_axes.items():
        s0 = tensors[sites[0][0]].structures[sites[0][1]]
        for ti, ax in sites[1:]:
            if tensors[ti].structures[ax] != s0:
                raise BlockTensorError(
                    f"label {lab!r} spans axes with different block structures"
                )
    for lab in out_labels:
        if lab not in label_axes:
            raise BlockTensorError(f"output label {lab!r} not present in inputs")
    out_structures = [tensors[label_axes[l][0][0]].structures[label_axes[l][0][1]] for l in out_labels]
    out_dtype = tensors[0].dtype
    for t in tensors[1:]:
        out_dtype = torch.promote_types(out_dtype, t.dtype)
    out = tensors[0]._empty(out_structures, out_dtype)

    def sector_of(lab: str, keys: tuple) -> int:
        ti, ax = label_axes[lab][0]
        return keys[ti][ax]

    def self_ok(ti: int, key: tuple) -> bool:
        # labels repeated WITHIN one tensor select its diagonal sectors
        for sites in label_axes.values():
            vals = {key[ax] for t, ax in sites if t == ti}
            if len(vals) > 1:
                return False
        return True

    # shared-label signature join: index tensor B's block keys by their
    # shared-label sectors and look each A key up -- O(|A| + |B| + matching
    # pairs), not the O(|A|·|B|) all-combos loop
    global _LAST_CANDIDATE_COUNT
    if len(tensors) == 1:
        combos = [(k,) for k in tensors[0].blocks if self_ok(0, k)]
    else:
        shared = [
            lab for lab, sites in label_axes.items()
            if any(t == 0 for t, _ in sites) and any(t == 1 for t, _ in sites)
        ]
        ax_of = {
            (lab, ti): next(ax for t, ax in label_axes[lab] if t == ti)
            for lab in shared
            for ti in (0, 1)
        }

        def sig(ti, key):
            return tuple(key[ax_of[(lab, ti)]] for lab in shared)

        sig_b: dict[tuple, list[tuple]] = {}
        for kb in tensors[1].blocks:
            if self_ok(1, kb):
                sig_b.setdefault(sig(1, kb), []).append(kb)
        combos = [
            (ka, kb)
            for ka in tensors[0].blocks
            if self_ok(0, ka)
            for kb in sig_b.get(sig(0, ka), ())
        ]
    _LAST_CANDIDATE_COUNT = len(combos)  # test instrumentation

    # group contributing combos by (block shapes, result key) so each
    # group runs as ONE batched einsum on stacked blocks
    groups: dict[tuple, list[tuple]] = {}
    for keys in combos:
        out_key = tuple(sector_of(l, keys) for l in out_labels)
        shapes = tuple(tuple(tensors[i].blocks[keys[i]].shape) for i in range(len(tensors)))
        groups.setdefault((shapes, out_key), []).append(keys)

    batch = "__batch__"
    batched_in = tuple((batch,) + tuple(labs) for labs in in_labels)
    for (shapes, out_key), key_list in groups.items():
        stacks = [
            torch.stack([tensors[i].blocks[keys[i]].to(out_dtype) for keys in key_list])
            for i in range(len(tensors))
        ]
        # batch label absent from the output: einsum contracts it directly,
        # never materializing the (B, *out_block) intermediate
        val = einsum_labels(stacks, batched_in, tuple(out_labels))
        del stacks
        out._accumulate(out_key, val)
    return out
