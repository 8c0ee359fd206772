"""Block-sparse tensor demo: symmetry sectors, selection rule, einsum,
and the Heisenberg ground state (BASELINE config 3).

Counterpart of ``samples/sample_block_tensor.py``."""

from __future__ import annotations

import numpy as np
import torch

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.block.hamiltonians import heisenberg_block_hamiltonian
from eigenex_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    dev = resolve_device(device)
    L = 8
    # dense blocks: this sample demos the block einsum
    H = heisenberg_block_hamiltonian(L, storage="dense", device=dev)
    print("Heisenberg chain L =", L)
    print("block structure:", H.structures[0])
    print("stored blocks:", sorted(H.block_keys()), "(diagonal only — Sz conservation)")

    e, sector, vec, energies = ext.heisenberg_ground_state(L, device=dev)
    print(f"ground energy E0 = {e:.10f} in sector n_up = {sector}")
    print("per-sector minima:", {k: round(v, 6) for k, v in energies.items()})

    # block einsum with the selection rule
    psi = ext.BlockTensor([H.structures[1]], dtype=torch.float64, device=dev)
    psi.set_block((sector,), torch.as_tensor(np.asarray(vec.cpu() if isinstance(vec, torch.Tensor)
                                                        else vec)[:, 0], device=dev))
    hpsi = ext.einsum(H, psi).from_(["i", "j"], ["j"]).to(["i"])
    print("H|psi> stored sectors:", sorted(hpsi.block_keys()))
    ray = float(sum(torch.vdot(psi.blocks[k], hpsi.blocks[k]).item() for k in psi.blocks))
    print(f"Rayleigh quotient <psi|H|psi> = {ray:.10f} (== E0)")
    return dict(e0=float(e), sector=sector, sector_minima=dict(energies),
                stored_blocks=sorted(H.block_keys()), hpsi_sectors=sorted(hpsi.block_keys()),
                rayleigh=ray)


if __name__ == "__main__":
    from ._cli import run

    run(main)
