"""accelerate(): RCM reorder + dense-block pack of a scalar-sparse operator,
the one-call solve in permuted space, the complex-Hermitian real embedding,
save/load, and the same pack row-partitioned over a mesh.

Counterpart of ``samples/sample_accelerate.py``.  The mesh is eight shards
of the one device (``make_mesh(devices=[device] * 8)``); the saved pack goes
to a temporary directory that is removed afterwards."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import scipy.sparse as sp

from eigenex_tpu_torch import make_mesh
from eigenex_tpu_torch.solvers.api import eigsh
from eigenex_tpu_torch.sparse.accelerate import AcceleratedOperator, accelerate
from eigenex_tpu_torch.utils.device import resolve_device

MESH_SHARDS = 8


def chain_triplets(rng, n: int = 2000):
    """A disordered 1-D chain with random long-range shortcuts."""
    rows = [np.arange(n), np.arange(n - 1), np.arange(1, n)]
    cols = [np.arange(n), np.arange(1, n), np.arange(n - 1)]
    vals = [rng.uniform(-1, 1, n), -np.ones(n - 1), -np.ones(n - 1)]
    # shortcuts destroy the natural band -- RCM has to earn its keep
    sr = rng.integers(0, n, 150)
    sc = (sr + rng.integers(5, n // 3, 150)) % n
    w = rng.uniform(-0.5, 0.5, 150)
    rows += [sr, sc]
    cols += [sc, sr]
    vals += [w, w]
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    return r, c, v, (n, n)


def ring_triplets(rng, m: int = 600):
    """A complex Hermitian ring with random phases on its bonds."""
    phases = np.exp(1j * rng.uniform(0, 2 * np.pi, m))
    rc = np.concatenate([np.arange(m), np.arange(m - 1), np.arange(1, m), [0, m - 1]])
    cc = np.concatenate([np.arange(m), np.arange(1, m), np.arange(m - 1), [m - 1, 0]])
    vv = np.concatenate(
        [rng.standard_normal(m).astype(complex), phases[:-1], np.conj(phases[:-1]),
         [phases[-1], np.conj(phases[-1])]]
    )
    return rc, cc, vv, (m, m)


def main(device=None) -> dict:
    dev = resolve_device(device)
    # --- a disordered 1-D chain with random long-range shortcuts ----------
    rng = np.random.default_rng(0)
    r, c, v, (n, _) = chain_triplets(rng)
    acc = accelerate((r, c, v, (n, n)), device=dev)
    st = acc.stats
    print(
        f"pack: symmetric={acc.symmetric} dtype={st['dtype']} "
        f"bandwidth {st['bandwidth_before']} -> {st['bandwidth_after']} "
        f"fill={st['fill']*100:.2f}%"
    )

    # one-call solve in permuted space; eigenvectors restored automatically
    res = eigsh(acc, k=3, which="SA", tol=1e-10)
    lam = np.asarray(res.eigenvalues)
    print("lowest eigenvalues:", np.round(lam, 8))

    A = sp.csr_matrix((v, (r, c)), shape=(n, n))
    V = np.asarray(res.eigenvectors)
    residuals = []
    for j in range(3):
        x = V[:, j] / np.linalg.norm(V[:, j])
        residuals.append(float(np.linalg.norm(A @ x - lam[j] * x)))
        print(f"  residual |A x - lambda x| for pair {j}: {residuals[-1]:.2e}")

    # --- complex Hermitian rides the same pipeline (real embedding) -------
    rc, cc, vv, (m, _) = ring_triplets(rng)
    accz = accelerate((rc, cc, vv, (m, m)), device=dev)
    print(
        f"\ncomplex Hermitian ring: complexified={accz.complexified} "
        f"symmetric={accz.symmetric} (the [[A,-B],[B,A]] embedding is real-symmetric)"
    )
    resz = eigsh(accz, k=2, which="SA", tol=1e-10)
    lamz = np.asarray(resz.eigenvalues)
    Z = np.asarray(resz.eigenvectors)  # complex, original coordinates
    Az = sp.csr_matrix((vv, (rc, cc)), shape=(m, m))
    z0 = Z[:, 0] / np.linalg.norm(Z[:, 0])
    complex_residual = float(np.linalg.norm(Az @ z0 - lamz[0] * z0))
    print("lowest two:", np.round(lamz, 8))
    print(f"  complex residual: {complex_residual:.2e}")

    # --- pack once, reload forever -----------------------------------------
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "operator.npz")
        acc.save(path)
        back = AcceleratedOperator.load(path, device=dev)
        x = rng.standard_normal(n)
        y1 = acc.restore(np.asarray(acc.as_linear_operator().matvec(acc.embed(x)).cpu()))
        y2 = back.restore(np.asarray(back.as_linear_operator().matvec(back.embed(x)).cpu()))
        round_trip = bool(np.array_equal(y1, y2))
        print(f"\nsave/load round-trip matvec bitwise equal: {round_trip}")

    # --- the same pack, row-partitioned over a mesh -------------------------
    # eigsh(acc, mesh=...) shards the packed SymBSR container over the
    # sym_halo ring: the path for a pack past one device's memory.  Here the
    # shards share one device; the same code drives a mesh of cards.
    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    res_m = eigsh(acc, k=3, which="SA", tol=1e-8, mesh=mesh)
    res_1 = eigsh(acc, k=3, which="SA", tol=1e-8)
    delta = float(np.abs(np.asarray(res_m.eigenvalues) - np.asarray(res_1.eigenvalues)).max())
    print(f"\nmesh({mesh.size} devices) vs single-device eigenvalues: "
          f"max delta {delta:.2e} (restored to original coordinates on both routes)")
    return dict(stats={k: st[k] for k in ("dtype", "bandwidth_before", "bandwidth_after",
                                          "fill", "nnz")},
                symmetric=bool(acc.symmetric), eigenvalues=lam, residuals=residuals,
                complexified=bool(accz.complexified), complex_eigenvalues=lamz,
                complex_residual=complex_residual, round_trip=round_trip,
                mesh_eigenvalues=np.asarray(res_m.eigenvalues),
                one_device_eigenvalues=np.asarray(res_1.eigenvalues), mesh_delta=delta)


if __name__ == "__main__":
    from ._cli import run

    run(main)
