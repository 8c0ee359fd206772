"""Transverse-field Ising chain at its critical point: the two parity
sectors' lowest levels, held to the free-fermion closed form.

Counterpart of ``samples/sample_tfi.py``."""

from __future__ import annotations

import numpy as np

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.block.hamiltonians import tfi_ground_energy_exact, tfi_parity_sector_coo
from eigenex_tpu_torch.utils.device import resolve_device


def main(device=None) -> dict:
    dev = resolve_device(device)
    L, J, h = 16, 1.0, 1.0  # the quantum-critical point h = J
    print(f"TFI chain: L={L}, J={J}, h={h} (critical), PBC")

    out = {}
    for parity, name in ((0, "even"), (1, "odd")):
        coo = tfi_parity_sector_coo(L, J, h, parity=parity, device=dev)
        res = ext.eigsh(coo, k=2, which="SA", tol=1e-14, max_subspace=140)
        print(f"  {name} sector (dim {coo.shape[0]:,}): "
              f"E0 = {res.eigenvalues[0]:.12f}, E1 = {res.eigenvalues[1]:.12f}")
        out[name] = np.asarray(res.eigenvalues)
        out[f"{name}_dim"] = int(coo.shape[0])
        if parity == 0:
            exact = tfi_ground_energy_exact(L, J, h)
            err = abs(res.eigenvalues[0] - exact)
            print(f"  free-fermion E0 = {exact:.12f}  (|err| = {err:.2e})")
            assert err < 1e-9, err
            out["exact"] = exact

    print("OK")
    return out


if __name__ == "__main__":
    from ._cli import run

    run(main)
