"""Imaginary-time TEBD of the transverse-field Ising chain in Vidal's
canonical form, built from the library's tensor SVD and labeled einsum,
held to exact diagonalisation.

Counterpart of ``samples/sample_tebd_ising.py``."""

from __future__ import annotations

import numpy as np
import torch

import eigenex_tpu_torch as ext
from eigenex_tpu_torch.utils.device import resolve_device

L, J, G, CHI = 8, 1.0, 1.0, 16
SCHEDULE = ((0.1, 200), (0.02, 500), (0.005, 700), (0.002, 800))

Z = np.diag([1.0, -1.0])
X = np.array([[0.0, 1.0], [1.0, 0.0]])
I2 = np.eye(2)


def h_bond(first, last):
    """Two-site bond term; the transverse field is split half/half onto
    interior bonds, fully onto chain-edge sites."""
    gl = G * (1.0 if first else 0.5)
    gr = G * (1.0 if last else 0.5)
    return -J * np.kron(Z, Z) - gl * np.kron(X, I2) - gr * np.kron(I2, X)


def dense_h():
    H = np.zeros((2**L, 2**L))

    def kron_chain(site_ops):
        M = site_ops[0]
        for m in site_ops[1:]:
            M = np.kron(M, m)
        return M

    for i in range(L - 1):
        mats = [I2] * L
        mats[i] = Z
        mats[i + 1] = Z
        H += -J * kron_chain(mats)
    for i in range(L):
        mats = [I2] * L
        mats[i] = X
        H += -G * kron_chain(mats)
    return H


def main(device=None) -> dict:
    dev = resolve_device(device)

    def gate(h, tau):
        w, U = np.linalg.eigh(h)
        return torch.as_tensor((U * np.exp(-tau * w)) @ U.T, device=dev).reshape(2, 2, 2, 2)

    # Vidal canonical form: Γ[i] (χl, 2, χr), λ[i] on bond i (i = 0..L-2)
    gam = [torch.as_tensor(np.random.default_rng(0).standard_normal((1, 2, 1)), device=dev)
           for _ in range(L)]
    gam = [g / torch.linalg.norm(g) for g in gam]
    lam = [torch.ones((1,), dtype=torch.float64, device=dev) for _ in range(L - 1)]
    ones = lambda k: torch.ones((k,), dtype=torch.float64, device=dev)  # noqa: E731

    def apply_gate(i, g2):
        """TEBD update of bond i in canonical form, via the library ops."""
        lam_l = lam[i - 1] if i > 0 else ones(gam[i].shape[0])
        lam_r = lam[i + 1] if i + 1 < L - 1 else ones(gam[i + 1].shape[2])
        a = ext.contract_vector_as_diagonal(gam[i], lam_l, axis=0)
        a = ext.contract_vector_as_diagonal(a, lam[i], axis=2)
        b = ext.contract_vector_as_diagonal(gam[i + 1], lam_r, axis=2)
        theta = ext.einsum(a, b).from_(["l", "p", "m"], ["m", "q", "r"]).to(["l", "p", "q", "r"])
        theta = (
            ext.einsum(g2, theta)
            .from_(["p", "q", "s", "t"], ["l", "s", "t", "r"])
            .to(["l", "p", "q", "r"])
        )
        svd = ext.tensor_svd(theta, left_axes=2)
        chi = min(CHI, int(svd.get_rank(1e-12)))
        tr = svd.truncated(rank=max(chi, 1), pad=False)
        s = tr.singular_values / torch.linalg.norm(tr.singular_values)
        inv_l = torch.where(lam_l > 1e-12, 1.0 / torch.where(lam_l > 1e-12, lam_l, 1.0), 0.0)
        inv_r = torch.where(lam_r > 1e-12, 1.0 / torch.where(lam_r > 1e-12, lam_r, 1.0), 0.0)
        gam[i] = ext.contract_vector_as_diagonal(tr.tensor_u, inv_l, axis=0)
        b_new = tr.tensor_v.permute(2, 0, 1)  # (chi, q, r)
        gam[i + 1] = ext.contract_vector_as_diagonal(b_new, inv_r, axis=2)
        lam[i] = s

    def sweep(gates):
        for parity in (0, 1):
            for i in range(parity, L - 1, 2):
                apply_gate(i, gates[i])

    def dense_state():
        a = [ext.contract_vector_as_diagonal(gam[i], lam[i], axis=2) if i < L - 1 else gam[i]
             for i in range(L)]
        psi = a[0]
        for t in a[1:]:
            psi = ext.einsum(psi, t).from_(["l", "a", "m"], ["m", "b", "r"]).to(["l", "a", "b", "r"])
            psi = psi.reshape(psi.shape[0], -1, psi.shape[-1])
        v = psi.cpu().numpy().reshape(-1)
        return v / np.linalg.norm(v)

    Hd = dense_h()
    e_exact = float(np.linalg.eigvalsh(Hd).min())

    print(f"TFIM chain L={L}, J={J}, g={G}, chi={CHI} (Vidal-form TEBD)")
    energies = []
    for tau, n_sweeps in SCHEDULE:
        gates = [gate(h_bond(i == 0, i + 2 == L), tau) for i in range(L - 1)]
        for _ in range(n_sweeps):
            sweep(gates)
        v = dense_state()
        e = float(v @ Hd @ v)
        energies.append(e)
        print(f"  tau={tau:<6} E = {e:.10f}   (exact {e_exact:.10f}, err {abs(e-e_exact):.2e})")

    assert abs(e - e_exact) < 1e-5, "TEBD must reach the exact ground energy"
    print("PASS: canonical TEBD via tensor_svd + einsum DSL matches exact diagonalization")
    return dict(energies=energies, exact=e_exact,
                bond_dims=[int(x.shape[0]) for x in lam])


if __name__ == "__main__":
    from ._cli import run

    run(main)
