"""Plain reference of the spin-1/2 XXZ chain in one total-S_z sector.

H = sum over bonds (i, j) of J/2 (S+_i S-_j + S-_i S+_j) + Jz S^z_i S^z_j,
on the basis of the L-bit states with ``n_up`` bits set, ascending.  The
row of a state is its rank in the combinatorial number system, so the
row of each spin flip follows from the state's bits alone: moving the
t-th set bit from position i to i + 1 adds C(i, t - 1) to the rank, and
moving it back subtracts the same.  No search and no global sort.

``judge`` holds the pairs a solve returned against the operator rebuilt
here and against its k lowest (or highest) eigenvalues from a float64
Lanczos run; ``control`` puts that Lanczos run in the solver's place in
a lower precision.
"""

from __future__ import annotations

import warnings
from math import comb

import numpy as np
import torch

from .lanczos import lanczos
from .precision import round_tf32

#: float64 reference eigenvalues: estimates |beta s| below this share of |theta|
REFERENCE_TOL = 1e-12
REFERENCE_MAX_STEPS = 1200


def sector_states(L: int, n_up: int) -> np.ndarray:
    """The L-bit states with ``n_up`` bits set, ascending (int64)."""
    states = np.arange(1 << L, dtype=np.int64)
    count = np.zeros(states.shape, np.int8)
    for i in range(L):
        count += ((states >> i) & 1).astype(np.int8)
    return states[count == n_up]


def bonds(L: int, pbc: bool) -> list[tuple[int, int]]:
    return [(i, i + 1) for i in range(L - 1)] + ([(L - 1, 0)] if pbc and L > 2 else [])


def flip_rows(states: np.ndarray, i: int, j: int) -> np.ndarray:
    """Row of the state with the spins at sites i and j exchanged, for every
    state whose two spins differ; -1 elsewhere."""
    bi = (states >> i) & 1
    bj = (states >> j) & 1
    movable = bi != bj
    out = np.full(states.shape, -1, np.int64)
    if j != i + 1:  # the periodic bond: look the flipped state up
        out[movable] = np.searchsorted(states, states[movable] ^ ((1 << i) | (1 << j)))
        return out
    below = np.zeros(states.shape, np.int64)  # set bits at sites 0..i
    for p in range(i + 1):
        below += (states >> p) & 1
    # binom[t + 1] = C(i, t), with C(i, -1) = 0
    binom = np.array([comb(i, t) if t >= 0 else 0 for t in range(-1, i + 2)], np.int64)
    rank = np.arange(states.size, dtype=np.int64)
    up = movable & (bi == 1)     # the t-th set bit (t = below) moves from i to i + 1
    down = movable & (bj == 1)   # the t-th set bit (t = below + 1) moves from i + 1 to i
    out[up] = rank[up] + binom[below[up]]
    out[down] = rank[down] - binom[below[down] + 1]
    return out


def csr_arrays(L: int, n_up: int, J: float, Jz: float, pbc: bool):
    """(crow, col, val, dim) of the sector's matrix in CSR, columns sorted."""
    states = sector_states(L, n_up)
    dim = states.size
    bl = bonds(L, pbc)
    diag = np.zeros(dim)
    for i, j in bl:
        diag += Jz * (((states >> i) & 1) - 0.5) * (((states >> j) & 1) - 0.5)
    cols = np.empty((dim, len(bl) + 1), np.int64)
    cols[:, 0] = np.arange(dim)
    for b, (i, j) in enumerate(bl):
        cols[:, b + 1] = flip_rows(states, i, j)
    del states
    cols.sort(axis=1)
    keep = cols >= 0
    counts = keep.sum(axis=1)
    rows = np.repeat(np.arange(dim), counts)
    col = cols[keep]
    del cols, keep
    val = np.where(col == rows, diag[rows], J / 2)
    crow = np.zeros(dim + 1, np.int64)
    np.cumsum(counts, out=crow[1:])
    return crow, col, val, dim


def operator(params: dict, device, dtype=torch.float64) -> torch.Tensor:
    """The sector's matrix as a torch CSR tensor on ``device``."""
    crow, col, val, dim = csr_arrays(params["L"], params["n_up"], params["J"], params["Jz"],
                                     params["pbc"])
    return csr_tensor(torch.from_numpy(crow), torch.from_numpy(col),
                      torch.from_numpy(val).to(dtype), dim).to(device)


def csr_tensor(crow, col, val, dim: int) -> torch.Tensor:
    with warnings.catch_warnings():  # torch calls its CSR support beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col, val, size=(dim, dim), check_invariants=False)


def _matvec(H: torch.Tensor):
    return lambda x: (H @ x.unsqueeze(1)).squeeze(1)


def eigenvalues(H: torch.Tensor, k: int, which: str, seed: int):
    """The k lowest or highest eigenvalues of H, float64, ascending."""
    n = H.shape[0]
    theta, _, _ = lanczos(_matvec(H), n, k, which=which, tol=REFERENCE_TOL,
                          max_steps=REFERENCE_MAX_STEPS, seed=seed, device=H.device)
    return theta


def judge(params: dict, request: dict, answers, device, seed: int):
    """Per answer: ``resid`` = the largest ||H x - lam x|| / (|lam| ||x||)
    over its pairs, in float64 on the operator rebuilt here, and
    ``eig_err`` = the largest |lam_i - lam_ref_i| / |lam_ref_i|.  An answer
    with another number of pairs, or with a value that is not finite,
    reads inf.  Returns ({name: [value per answer]}, notes)."""
    k, which = request["k"], request.get("which", "SA")
    H = operator(params, device)
    n = H.shape[0]
    ref = eigenvalues(H, k, which, seed)
    numbers = {"resid": [], "eig_err": []}
    for lam, X in answers:
        lam = None if lam is None else np.asarray(lam)
        X = None if X is None else np.asarray(X)
        if (lam is None or X is None or lam.shape != (k,) or X.shape != (n, k)
                or not np.isfinite(lam).all() or not np.isfinite(X).all()):
            numbers["resid"].append(float("inf"))
            numbers["eig_err"].append(float("inf"))
            continue
        order = np.argsort(lam.real)
        lam, X = lam.real[order].astype(np.float64), X[:, order]
        numbers["eig_err"].append(float(np.max(np.abs(lam - ref) / np.abs(ref))))
        Xd = torch.as_tensor(X, device=device).to(torch.float64)
        lam_d = torch.as_tensor(lam, device=device)
        R = H @ Xd - Xd * lam_d
        rel = torch.linalg.vector_norm(R, dim=0) / (lam_d.abs() * torch.linalg.vector_norm(Xd, dim=0))
        numbers["resid"].append(float(rel.max()))
    return numbers, {"reference_eigenvalues": ref.tolist()}


def control_solver(params: dict, request: dict, device, max_steps: int = 1200):
    """The float64 reference put in the solver's place one precision below
    the solver's float32 with TF32 off: float32 Lanczos whose every product
    takes TF32 inputs.  Returns ``solve(v0) -> (eigenvalues, eigenvectors
    as a host array)`` over the operator built once here."""
    H = operator(params, device, torch.float32)
    H = csr_tensor(H.crow_indices(), H.col_indices(), round_tf32(H.values()), H.shape[0])
    n = H.shape[0]
    matvec = _matvec(H)

    def solve(v0):
        theta, X, _ = lanczos(lambda x: matvec(round_tf32(x)), n, request["k"],
                              which=request.get("which", "SA"), tol=request["tol"],
                              max_steps=max_steps, seed=0, device=device, dtype=torch.float32,
                              rounding=round_tf32, v0=v0)
        return theta, X.cpu().numpy()

    return solve
