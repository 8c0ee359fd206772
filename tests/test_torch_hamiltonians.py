"""The port's spin-chain builders (``block/hamiltonians.py``) against the
JAX package's: every sector's triplets exactly equal (rows, columns,
values and their order; L <= 12, all sectors, open and periodic, f64 and
f32), the block Hamiltonian's keys and blocks, and BASELINE config 3 at
L = 14 in f64 -- the Lanczos ground state through ``block_operator`` on
COO sector blocks within 1e-10 of the reference's and of the port's own
direct route on the S_z = 0 sector."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenex_tpu.block import hamiltonians as ref
from eigenex_tpu.block.operator import block_operator as j_block_operator
from eigenex_tpu.solvers.lanczos import LanczosEigenSolver as JLanczos
from eigenex_tpu.solvers.lanczos import LanczosOptions as JOptions
from eigenex_tpu_torch import LanczosEigenSolver, LanczosOptions, csr_from_coo
from eigenex_tpu_torch.block import hamiltonians as port
from eigenex_tpu_torch.block.operator import block_operator
from eigenex_tpu_torch.sparse.bsr import BSRMatrix
from eigenex_tpu_torch.utils.exceptions import EigenexError

from _reference_native import NOT_LOADED, ensure_reference_native

ensure_reference_native()

torch.set_num_threads(1)


def same_triplets(got, want):
    assert got.shape == want.shape
    for g, w in ((got.row, want.row), (got.col, want.col), (got.val, want.val)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("L", [2, 3, 5, 8, 12])
@pytest.mark.parametrize("pbc", [False, True])
def test_sector_triplets_equal_reference(L, pbc):
    for n_up in range(L + 1):
        np.testing.assert_array_equal(port.sz_sector_basis(L, n_up), ref.sz_sector_basis(L, n_up))
        same_triplets(port.heisenberg_sector_coo(L, n_up, pbc=pbc, Jz=0.7, device="cpu"),
                      ref.heisenberg_sector_coo(L, n_up, pbc=pbc, Jz=0.7))
        same_triplets(port.heisenberg_sector_coo(L, n_up, 0.3, pbc=pbc, dtype=np.float32,
                                                 device="cpu"),
                      ref.heisenberg_sector_coo(L, n_up, 0.3, pbc=pbc, dtype=np.float32))
    for parity in (0, 1):
        np.testing.assert_array_equal(port.parity_sector_basis(L, parity),
                                      ref.parity_sector_basis(L, parity))
        same_triplets(port.tfi_parity_sector_coo(L, 0.8, 1.3, parity, pbc, device="cpu"),
                      ref.tfi_parity_sector_coo(L, 0.8, 1.3, parity, pbc))
    assert port.sector_structure(L) .block_dims == ref.sector_structure(L).block_dims


def test_block_hamiltonian_matches_reference():
    L = 7
    for storage in ("sparse", "dense", "bsr"):
        bt = port.heisenberg_block_hamiltonian(L, storage=storage, device="cpu")
        jt = ref.heisenberg_block_hamiltonian(L, storage=storage)
        assert set(bt.block_keys()) == set(jt.block_keys()) == {(k, k) for k in range(L + 1)}
        np.testing.assert_array_equal(bt.to_dense().numpy(), np.asarray(jt.to_dense()))
        assert bt.device.type == "cpu" and bt.dtype == torch.float64
    bsr = port.heisenberg_block_hamiltonian(L, storage="bsr", device="cpu")
    assert all(isinstance(b, BSRMatrix) and b.block_shape == (4, 4) for b in bsr.blocks.values())
    big = port.heisenberg_block_hamiltonian(L, dtype=np.float32, storage="bsr",
                                            block_shape=(32, 128), device="cpu")
    blk = big.blocks[(0, 0)]  # a dimension-1 sector padded up to one block
    assert blk.shape == (32, 128) and blk.dtype == torch.float32
    np.testing.assert_allclose(big.to_dense().numpy(), bsr.to_dense().numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        port.heisenberg_block_hamiltonian(4, storage="csr", device="cpu")
    with pytest.raises(EigenexError):
        port.parity_sector_basis(4, 2)


def test_tfi_closed_form():
    for L, J, h in ((8, 1.0, 1.0), (8, 0.7, 1.1)):
        assert port.tfi_ground_energy_exact(L, J, h) == ref.tfi_ground_energy_exact(L, J, h)
        H = np.zeros((2**L, 2**L))
        for par in (0, 1):
            basis = port.parity_sector_basis(L, par)
            H[np.ix_(basis, basis)] = port.tfi_parity_sector_coo(L, J, h, par, device="cpu").to_dense()
        assert abs(np.linalg.eigvalsh(H)[0] - port.tfi_ground_energy_exact(L, J, h)) < 1e-10


def test_ground_state_sweep_matches_reference():
    e, sector, vec, energies = port.heisenberg_ground_state(6, device="cpu")
    je, jsector, _, jenergies = ref.heisenberg_ground_state(6)
    assert sector == jsector == 3
    assert abs(e - je) <= 1e-10
    assert energies.keys() == jenergies.keys()
    assert all(abs(energies[k] - jenergies[k]) <= 1e-10 for k in energies)
    assert vec.device.type == "cpu" and vec.shape[0] == 20


def test_config3_L14_against_reference_and_direct_route():
    L = 14
    opts = dict(max_eigenvalues=1, tolerance=1e-13, max_subspace=140, compute_eigenvectors=False)
    bt = port.heisenberg_block_hamiltonian(L, storage="sparse", device="cpu")
    assert bt.has_sparse_blocks
    res = LanczosEigenSolver(block_operator(bt), LanczosOptions(**opts)).compute()
    assert res.converged
    direct = LanczosEigenSolver(
        csr_from_coo(port.heisenberg_sector_coo(L, L // 2, device="cpu")).as_linear_operator(),
        LanczosOptions(**opts)).compute()
    jres = JLanczos(j_block_operator(ref.heisenberg_block_hamiltonian(L, storage="sparse")),
                    JOptions(**opts)).compute()
    e, e_direct, e_ref = (float(r.eigenvalues[0]) for r in (res, direct, jres))
    assert abs(e - e_direct) <= 1e-10, (e, e_direct)
    assert abs(e - e_ref) <= 1e-10, (e, e_ref)


def test_config3_L14_native_accelerated_route_against_reference():
    """The route of the config-3 benchmark at L = 14: the native sector
    enumerator, lexsorted -> accelerate(symmetric=True) (native RCM, bf16
    pack) -> eigsh in f32 -> f64 Rayleigh refinement, in both packages;
    refined energies within 1e-10 of each other and of the sector's dense
    ground state."""
    from eigenex_tpu import native as j_native
    from eigenex_tpu.solvers.api import eigsh as j_eigsh
    from eigenex_tpu.solvers.refine import rayleigh_refine as j_refine
    from eigenex_tpu.sparse.accelerate import accelerate as j_accelerate
    from eigenex_tpu.sparse.coo import COOMatrix as JCOO
    from eigenex_tpu_torch import accelerate, eigsh, native, rayleigh_refine
    from eigenex_tpu_torch.convert import coo_from_numpy

    L = 14
    assert j_native.native_available(), NOT_LOADED
    native.reset_native_calls()
    r, c, v, dim = native.heisenberg_sector(L, L // 2, 1.0, 1.0, False)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    acc = accelerate((r, c, v, (dim, dim)), symmetric=True, device="cpu")
    assert acc.stats["dtype"] == "bfloat16" and acc.matrix.upper_cols.shape[1] == acc.stats["ku"]
    calls = native.native_calls()
    assert all(calls.get(k) == 1 for k in ("heisenberg_sector", "build_csr", "rcm_permutation",
                                           "blk_widths", "sym_bsr_pack_sorted_bf16")), calls
    res = eigsh(acc, k=1, which="SA", tol=1e-8, max_subspace=160)
    lam, resid = rayleigh_refine(coo_from_numpy(r, c, v, (dim, dim), device="cpu"), res.eigenvectors)

    jr, jc, jv, _ = j_native.heisenberg_sector(L, L // 2, 1.0, 1.0, False)
    jorder = np.lexsort((jc, jr))
    jr, jc, jv = jr[jorder], jc[jorder], jv[jorder]
    assert np.array_equal(jr, r) and np.array_equal(jv, v)
    jacc = j_accelerate((jr, jc, jv, (dim, dim)), symmetric=True)
    assert np.array_equal(acc.perm, jacc.perm)
    jres = j_eigsh(jacc, k=1, which="SA", tol=1e-8, max_subspace=160)
    jlam, _ = j_refine(JCOO(jr.astype(np.int32), jc.astype(np.int32), jv, (dim, dim)),
                       np.asarray(jres.eigenvectors))
    H = np.zeros((dim, dim))
    H[r, c] = v
    exact = float(np.linalg.eigvalsh(H)[0])
    assert res.converged and lam.shape == (1,) and resid[0] <= 1e-4
    assert abs(lam[0] - jlam[0]) <= 1e-10, (lam[0], jlam[0])
    assert abs(lam[0] - exact) <= 1e-10, (lam[0], exact)
