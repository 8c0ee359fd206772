"""CPU studies behind numbers in PERF.md that no test asserts (not collected
by pytest: the file name does not start with ``test_``).

Run from the repository root on the CPU:

    JAX_PLATFORMS=cpu python tests/cpu_studies.py ks-tail      # Krylov-Schur restart tail, both packages
    python tests/cpu_studies.py rehearse                        # the card phases' API at a tenth of the size
    python tests/cpu_studies.py tridiag                         # two tridiagonal solvers at config 1's shift
    JAX_PLATFORMS=cpu python tests/cpu_studies.py ks-ritz      # what eigs(tol=) bounds on a non-normal operand
    python tests/cpu_studies.py ks-convdiff [--nx 316] [--count 48] [--seed 18] [--out f.json]
    JAX_PLATFORMS=cpu python tests/cpu_studies.py ks-convdiff-ref --indices 3,7 [--nx 316]

``ks-tail``: f32 ``eigs(k=4, which="LM", tol=1e-6)`` on the upwind
convection-diffusion COO at nx = 100 (BASELINE config 2's operator), start
vector ``np.random.default_rng(4)``, in the JAX package and in the port:
restarts to converge, the residual bound of every restart, where the first
Arnoldi fill parts, the compression order of the reference, and one-ulp
changes of the start vector.  ``rehearse``: the ``svds_accelerated`` and
``expm_accelerated`` phases of ``chip_smoke.py`` on the CPU, 40,000 x 20,000
and n = 8192.  ``tridiag``: LAPACK ``gtsv`` against a Thomas sweep at
sigma = -1e-6 (condition 3.6e6).  ``ks-ritz``: f32 ``eigs(k=2, tol=1e-5,
accelerate=True)`` on config 2 at nx = 40, seeds 0-39, in both packages: the
returned eigenvectors' residuals over |lambda|, their residuals' component in
span(X) over sqrt(k) tol max|lambda|, the same with the Schur vectors of
span(X) or swapped columns in X's place.
``ks-convdiff``: BASELINE config 2's request, ``eigs(k=4, which="LM",
tol=1e-6, max_restarts=400, v0)``, on the benchmark cell's path
(``eigbench/configs/convdiff_316.py``'s operand, ``accelerate``, then
``eigs`` on the float32 general pack; on the card where there is one), from
``--count`` float32 start vectors drawn on the host from (``--seed``,
index), so that any machine can draw any one of them again; imports no JAX.
Per vector: restarts, matvecs, the kept dimension at each restart (from
the trace: the subspace less the steps of the next chunk), and the
returned pairs' largest backward error and shortfall as
``eigbench/reference/convection_diffusion.judge`` computes them; then the
distribution.  ``ks-convdiff-ref``: the JAX package's ``eigs`` on the CPU
from the vectors of the given indices, on the same float32 triplets and
``accelerate=True``, read the same way.
"""

import dataclasses
import math
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (its builders and the counting wrapper)
import eigenex_tpu_torch as ext  # noqa: E402


def ks_tail():
    import jax.numpy as jnp

    import eigenex_tpu.solvers.arnoldi as ja
    import eigenex_tpu_torch.solvers.arnoldi as pa
    import eigenex_tpu_torch.solvers.restart as prs
    from eigenex_tpu.solvers.api import eigs as j_eigs
    from eigenex_tpu.sparse.coo import COOMatrix as JCOO

    r, c, v, n = cs.convection_diffusion_coo(100)
    v = v.astype(np.float32)
    jcoo = JCOO(jnp.asarray(r.astype(np.int32)), jnp.asarray(c.astype(np.int32)), jnp.asarray(v),
                (n, n))
    pcoo = ext.COOMatrix(torch.as_tensor(r.astype(np.int32)), torch.as_tensor(c.astype(np.int32)),
                         torch.as_tensor(v), (n, n))
    v0 = np.random.default_rng(4).standard_normal(n).astype(np.float32)

    def run(v0):
        ref = j_eigs(jcoo, k=4, which="LM", tol=1e-6, v0=jnp.asarray(v0), max_restarts=400)
        got = ext.eigs(pcoo, k=4, which="LM", tol=1e-6, v0=torch.as_tensor(v0), max_restarts=400,
                       device="cpu")
        return ref, got

    ref, got = run(v0)
    scale = float(np.abs(ref.eigenvalues).max())
    print(f"restarts: reference {len(ref.trace.residuals) - 1}, port {len(got.trace.residuals) - 1}")
    for i in range(min(8, len(ref.trace.residuals), len(got.trace.residuals))):
        print(f"  restart {i}: residual bound {ref.trace.residuals[i] / scale:.3e} (reference) "
              f"{got.trace.residuals[i] / scale:.3e} (port)")
    x = torch.as_tensor(v0 / np.linalg.norm(v0))
    y_ref = np.asarray(jcoo.as_linear_operator().matvec(jnp.asarray(x.numpy())))
    print("first matvec bit-equal:", bool(np.array_equal(y_ref, pcoo.matvec(x).numpy())))
    jop, pop = jcoo.as_linear_operator(), pcoo.as_linear_operator()
    sj = ja.arnoldi_steps(jop, ja.init_arnoldi_state(jop, 48, jnp.asarray(v0)), 48)
    sp = pa.arnoldi_steps(pop, pa.init_arnoldi_state(pop, 48, torch.as_tensor(v0)), 48)
    Hj, Hp = np.asarray(sj.H), sp.H.numpy()
    diff = np.linalg.norm(Hj - Hp, axis=0) / np.linalg.norm(Hj, axis=0)
    print(f"first fill: Hessenberg column 0 parts at {diff[0]:.2e}, columns "
          f"{diff.min():.1e}-{diff.max():.1e}")
    own = prs._restart_into

    def reference_order(state, Yk, block, row):
        # the port's restart write, its kept rows the reference's product (V^T Yk)^T
        Y = torch.as_tensor(np.asarray(Yk)).to(device=state.V.device, dtype=state.V.dtype)
        kept = (state.V[: Y.shape[0]].T @ Y).T
        state = own(state, Yk, block, row)
        state.V[: Y.shape[1]] = kept
        return state

    prs._restart_into = reference_order
    try:
        got2 = ext.eigs(pcoo, k=4, which="LM", tol=1e-6, v0=torch.as_tensor(v0), max_restarts=400,
                        device="cpu")
    finally:
        prs._restart_into = own
    print(f"port with the reference's compression order: {len(got2.trace.residuals) - 1} restarts")
    for k in range(4):
        vp = v0.copy()
        i = np.random.default_rng(100 + k).integers(0, n)
        vp[i] = np.nextafter(vp[i], np.float32(np.inf))
        a, b = run(vp)
        print(f"one-ulp change #{k}: reference {len(a.trace.residuals) - 1} restarts, "
              f"port {len(b.trace.residuals) - 1}")


def rehearse():
    import scipy.sparse as sp

    r, c, v, shape = cs.banded_rect_triplets(40_000, 20_000, cs.SVDS_BW, cs.SVDS_PER_ROW, cs.SEED)
    applied = {"matvec": 0, "matmat": 0}
    acc = ext.accelerate((r, c, v, shape), device="cpu")
    acc = dataclasses.replace(acc, matrix=cs.counted(acc.matrix, applied))
    adj = acc.adjoint_matrix()
    print(f"svds packs: A {tuple(acc.matrix.data.shape)}, A^H {tuple(adj.data.shape)}")
    U, s, Vh = ext.svds(acc, k=cs.SVDS_K, tol=cs.SVDS_TOL)
    A = sp.csr_matrix((v, (r, c)), shape=shape)
    V = np.conj(Vh).T
    print(f"svds: {applied['matvec']} Gram matvecs, ||A v - s u|| / s_1 "
          f"{(np.linalg.norm(A @ V - U * s, axis=0) / s[0]).max():.1e}, ||U^T U - I|| "
          f"{np.linalg.norm(U.T @ U - np.eye(cs.SVDS_K)):.1e}")
    n = 8192
    rng = np.random.default_rng(cs.SEED + 7)
    ra = np.repeat(np.arange(n), 2)
    ca = ra + rng.integers(1, 24, size=len(ra))
    keep = ca < n
    ra, ca = ra[keep], ca[keep]
    va = np.round(rng.standard_normal(len(ra)) * 8) / 8
    trip = (np.concatenate([ra, ca, np.arange(n)]), np.concatenate([ca, ra, np.arange(n)]),
            np.concatenate([va, va, np.full(n, 4.0)]), (n, n))
    sym = ext.accelerate(trip, symmetric=True, device="cpu")
    lo, hi = sym.matrix.estimate_eigenvalue_range()
    rho = max(abs(float(lo)), abs(float(hi)))
    x = -math.floor(cs.EXPM_X_RHO / rho * 1e6) / 1e6
    applied = {"matvec": 0, "matmat": 0}
    sym = dataclasses.replace(sym, matrix=cs.counted(sym.matrix, applied))
    v0 = sym.embed(np.random.default_rng(11).standard_normal(n))
    y_l = ext.expm_multiply(sym, v0, x, method="lanczos", num_steps=cs.EXPM_STEPS)
    lanczos = applied["matvec"]
    y_t = ext.expm_multiply(sym, v0, x, method="taylor_auto", tol=cs.EXPM_TAYLOR_TOL)
    print(f"expm: rho {rho}, x {x}, applications {lanczos} (Lanczos) "
          f"{applied['matvec'] - lanczos} (Taylor), relative difference "
          f"{float(torch.linalg.vector_norm(y_l - y_t) / torch.linalg.vector_norm(y_t)):.1e}")


def tridiag():
    from scipy.linalg import lapack

    n, sigma = cs.TRIDIAG_N, cs.TRIDIAG_SIGMA
    d = np.full(n, 2.0) - sigma
    off = np.full(n - 1, -1.0)
    B = np.random.default_rng(0).standard_normal((n, 2))
    Y = lapack.dgtsv(off, d, off, B)[3]
    c, dp = np.zeros(n), np.zeros_like(B)  # Thomas sweep, no pivoting
    c[0], dp[0] = off[0] / d[0], B[0] / d[0]
    for i in range(1, n):
        m = d[i] - off[i - 1] * c[i - 1]
        c[i] = off[i] / m if i < n - 1 else 0.0
        dp[i] = (B[i] - off[i - 1] * dp[i - 1]) / m
    X = np.zeros_like(B)
    X[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        X[i] = dp[i] - c[i] * X[i + 1]
    print(f"gtsv against a Thomas sweep: {np.max(np.linalg.norm(Y - X, axis=0) / np.linalg.norm(X, axis=0)):.1e}")


def ks_ritz():
    import scipy.sparse as sp

    from eigenex_tpu.solvers.api import eigs as j_eigs

    torch.set_num_threads(1)  # as the port's tests run: f32 Krylov-Schur here follows any rounding change
    r, c, v, n = cs.convection_diffusion_coo(40)
    A = sp.csr_matrix((v, (r, c)), shape=(n, n))
    t = A.tocoo()  # the triplets in the order the tests pass them
    trip = (t.row, t.col, t.data.astype(np.float32), t.shape)
    k, tol = 2, 1e-5

    def in_span(lam, X):
        R = A @ X - X * lam[None, :]
        return np.max(np.linalg.norm(np.linalg.qr(X)[0].conj().T @ R, axis=0)
                      / np.linalg.norm(X, axis=0))

    for package in ("port", "reference"):
        rows = []
        for seed in range(40):
            if package == "port":
                res = ext.eigs(trip, k=k, tol=tol, seed=seed, accelerate=True, device="cpu")
            else:
                res = j_eigs(trip, k=k, tol=tol, seed=seed, accelerate=True)
            lam = np.asarray(res.eigenvalues, np.complex128)
            X = np.asarray(res.eigenvectors, np.complex128)
            limit = np.sqrt(k) * tol * np.abs(lam).max()
            residual = np.max(np.linalg.norm(A @ X - X * lam[None, :], axis=0)
                              / np.linalg.norm(X, axis=0) / np.abs(lam))
            rows.append((residual, in_span(lam, X) / limit,
                         in_span(lam, np.linalg.qr(X)[0]) / limit, in_span(lam, X[:, ::-1]) / limit))
        a = np.asarray(rows)
        print(f"{package}, seeds 0-39: eigenvector residual / |lambda| max {a[:, 0].max():.2e}; "
              f"in span(X) / limit max {a[:, 1].max():.2e}; Schur vectors in X's place "
              f"min {a[:, 2].min():.2e}; swapped columns min {a[:, 3].min():.2e}")


def _convdiff_args():
    import argparse

    ap = argparse.ArgumentParser(prog=f"cpu_studies.py {sys.argv[1]}")
    ap.add_argument("--nx", type=int, default=316)
    ap.add_argument("--count", type=int, default=48)
    ap.add_argument("--seed", type=int, default=18)
    ap.add_argument("--indices", default="")
    ap.add_argument("--out", default="")
    return ap.parse_args(sys.argv[2:])


CONVDIFF_REQUEST = {"k": 4, "which": "LM", "tol": 1e-6, "max_restarts": 400}


def convdiff_start(n: int, seed: int, index: int) -> np.ndarray:
    """Start vector ``index`` of ``seed``: float32, drawn on the host."""
    return np.random.default_rng([seed, index]).standard_normal(n).astype(np.float32)


def _convdiff_reading(params, index, res, wall, m=48) -> dict:
    from eigbench.reference import convection_diffusion

    lam = None if res.eigenvalues is None else np.asarray(res.eigenvalues)
    X = None if res.eigenvectors is None else np.asarray(res.eigenvectors)
    numbers, _ = convection_diffusion.judge(params, CONVDIFF_REQUEST, [(lam, X)], "cpu", 0)
    steps = np.diff(np.asarray(res.trace.iterations))
    return dict(index=index, converged=bool(res.converged), restarts=len(steps),
                matvecs=int(res.iterations), kept=[int(m - s) for s in steps],
                resid=numbers["resid"][0], shortfall=numbers["shortfall"][0], wall_s=round(wall, 3))


def _convdiff_row(r: dict) -> None:
    print(f"{r['index']:3d} converged={r['converged']!s:5} restarts={r['restarts']:4d} "
          f"matvecs={r['matvecs']:6d} kept={sorted(set(r['kept']))} resid={r['resid']:.3e} "
          f"shortfall={r['shortfall']:+.3e} {r['wall_s']:.2f}s", flush=True)


def _convdiff_report(rows: list, out: str, **head) -> None:
    import json
    import statistics

    restarts = [r["restarts"] for r in rows]
    failed = [r["index"] for r in rows if not r["converged"]]
    print(f"{len(rows)} vectors: restarts median {statistics.median(restarts)}, min {min(restarts)}, "
          f"max {max(restarts)}; unconverged {len(failed)} {failed}; largest resid "
          f"{max(r['resid'] for r in rows):.3e}")
    if out:
        pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out).write_text(json.dumps(dict(head, rows=rows)) + "\n")


def ks_convdiff():
    import time

    from eigbench import core

    args = _convdiff_args()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    params = {"nx": args.nx, "conv": 0.4}
    config = core.load_module(ROOT / "eigbench" / "configs" / "convdiff_316.py", "config")
    acc = config.pack(config.operand(params), device)
    n = args.nx * args.nx
    indices = [int(i) for i in args.indices.split(",")] if args.indices else range(args.count)
    rows = []
    for i in indices:
        v0 = torch.as_tensor(convdiff_start(n, args.seed, i), device=device)
        t0 = time.perf_counter()
        res = ext.eigs(acc, v0=v0, **CONVDIFF_REQUEST)
        rows.append(_convdiff_reading(params, i, res, time.perf_counter() - t0))
        _convdiff_row(rows[-1])
    print(f"device {torch.cuda.get_device_name(0) if device == 'cuda' else 'cpu'}")
    _convdiff_report(rows, args.out, nx=args.nx, seed=args.seed, device=device)


def ks_convdiff_ref():
    import time

    import jax.numpy as jnp

    from eigbench import core
    from eigenex_tpu.solvers.api import eigs as j_eigs

    args = _convdiff_args()
    params = {"nx": args.nx, "conv": 0.4}
    config = core.load_module(ROOT / "eigbench" / "configs" / "convdiff_316.py", "config")
    r, c, v, shape = config.operand(params)
    trip = (r, c, v.astype(np.float32), shape)
    rows = []
    for i in [int(i) for i in args.indices.split(",")]:
        t0 = time.perf_counter()
        res = j_eigs(trip, v0=jnp.asarray(convdiff_start(shape[0], args.seed, i)),
                     accelerate=True, **CONVDIFF_REQUEST)
        rows.append(_convdiff_reading(params, i, res, time.perf_counter() - t0))
        _convdiff_row(rows[-1])
    _convdiff_report(rows, args.out, nx=args.nx, seed=args.seed, device="cpu", package="eigenex_tpu")


if __name__ == "__main__":
    torch.set_num_threads(4)
    {"ks-tail": ks_tail, "rehearse": rehearse, "tridiag": tridiag, "ks-ritz": ks_ritz,
     "ks-convdiff": ks_convdiff, "ks-convdiff-ref": ks_convdiff_ref}[sys.argv[1]]()
