"""The port's ``block_operator`` (``block/operator.py``) against the JAX
package's on rank-2 block tensors built from the same numpy-seeded
blocks: ``matvec`` and ``matmat`` to 1e-12 relative (f64) for dense
groups, mixed shapes, and COO and BSR sector blocks (padded BSR packs
included); Lanczos through the operator to the dense oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eigenex_tpu.block.block_tensor as jbt
from eigenex_tpu.block.hamiltonians import heisenberg_block_hamiltonian as j_heis
from eigenex_tpu.block.operator import block_operator as j_block_operator
from eigenex_tpu.core.indices import AddIndices as JAddIndices
from eigenex_tpu_torch import AddIndices, BlockTensor, LanczosEigenSolver, LanczosOptions
from eigenex_tpu_torch.block.hamiltonians import heisenberg_block_hamiltonian
from eigenex_tpu_torch.block.operator import block_operator
from eigenex_tpu_torch.utils.exceptions import BlockTensorError

torch.set_num_threads(1)


def close(got, want, rel=1e-12):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want)


def pair(structures, keys, seed):
    rng = np.random.default_rng(seed)
    port = BlockTensor([AddIndices(s) for s in structures], dtype=np.float64, device="cpu")
    ref = jbt.BlockTensor([JAddIndices(s) for s in structures], dtype=np.float64)
    for key in keys:
        blk = rng.standard_normal(port.intra_block_dims(key))
        port.set_block(key, blk)
        ref.set_block(key, jnp.asarray(blk))
    return port, ref


CASES = {
    "mixed shapes": ([[2, 3, 1], [4, 2]], [(0, 0), (1, 1), (2, 0), (1, 0)]),
    "one group": ([[3] * 5, [3] * 5], [(i, i) for i in range(5)]),
    "many blocks": ([[4] * 24, [4] * 24], [(i, j) for i in range(24) for j in range(24)
                                           if (i + j) % 3 == 0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_groups_match_reference(name):
    port, ref = pair(*CASES[name], seed=1)
    op, jop = block_operator(port), j_block_operator(ref)
    assert op.shape == jop.shape and op.device.type == "cpu"
    rng = np.random.default_rng(2)
    x = rng.standard_normal(op.shape[1])
    X = rng.standard_normal((op.shape[1], 3))
    close(op.matvec(torch.as_tensor(x)), jop.matvec(jnp.asarray(x)))
    close(op.matmat(torch.as_tensor(X)), np.asarray(ref.to_dense()) @ X)


@pytest.mark.parametrize("storage,block_shape", [("sparse", None), ("bsr", (4, 4)),
                                                 ("bsr", (8, 16)), ("dense", None)])
def test_sector_blocks_match_reference(storage, block_shape):
    L = 5
    bt = heisenberg_block_hamiltonian(L, storage=storage, block_shape=block_shape, device="cpu")
    jt = j_heis(L, storage=storage, block_shape=block_shape)
    assert bt.has_sparse_blocks == jt.has_sparse_blocks == (storage != "dense")
    op, jop = block_operator(bt), j_block_operator(jt)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(2**L)
    X = rng.standard_normal((2**L, 4))
    close(op.matvec(torch.as_tensor(x)), jop.matvec(jnp.asarray(x)))
    dense = np.asarray(j_heis(L, storage="dense").to_dense())
    close(op.matvec(torch.as_tensor(x)), dense @ x)
    close(op.matmat(torch.as_tensor(X)), dense @ X)


def test_lanczos_through_block_operator_matches_dense():
    bt = heisenberg_block_hamiltonian(6, storage="dense", device="cpu")
    res = LanczosEigenSolver(block_operator(bt), LanczosOptions(
        max_eigenvalues=1, tolerance=1e-13, max_subspace=64, seed=0)).compute()
    ref = np.linalg.eigvalsh(bt.to_dense().numpy()).min()
    assert abs(float(res.eigenvalues[0]) - ref) <= 1e-10


def test_rank_check_and_dense_only_guards():
    with pytest.raises(BlockTensorError):
        block_operator(BlockTensor([[2, 2]], dtype=np.float64, device="cpu"))
    bt = heisenberg_block_hamiltonian(6, storage="sparse", device="cpu")
    for bad in (lambda: bt.contract(bt, [(1, 0)]), lambda: bt.shuffle((1, 0)),
                lambda: bt.get_element((0, 0)), lambda: bt.cast(np.float32)):
        with pytest.raises(BlockTensorError, match="dense blocks"):
            bad()
    dense = heisenberg_block_hamiltonian(6, storage="dense", device="cpu").to_dense().numpy()
    np.testing.assert_allclose(float(bt.norm()), np.linalg.norm(dense), rtol=1e-12)
    np.testing.assert_array_equal(bt.to_dense().numpy(), dense)
    bsr = heisenberg_block_hamiltonian(6, storage="bsr", device="cpu")
    np.testing.assert_array_equal(bsr.to_dense().numpy(), dense)
    np.testing.assert_allclose(float(bsr.squared_norm()), np.linalg.norm(dense) ** 2, rtol=1e-12)
    with pytest.raises(BlockTensorError, match="covers"):
        bt.set_block((3, 3), bt.blocks[(1, 1)])
