"""What the sample tests hold: each JAX sample (``samples/``), run as a
script by ``runpy.run_path``, against the port's counterpart
(``eigenex_tpu_torch/samples``) run by ``main(device="cpu")``.

``CHECKS[name](g, got)`` compares the reference script's globals ``g``
with the port's returned dict ``got``.  Tolerances: 1e-10 for f64
eigenvalues and energies of the same operator, bit-equal for index
arithmetic, counts and pack statistics, and for f32 iterations the sample's
own scale (its solves run at tolerance 1e-8: 1e-6 on the eigenvalues).
Where a sample draws its input from ``jax.random`` the port's ``main`` is
given the reference's input; estimates from random probes (KPM) and the
iteration counts of random-start solvers are held to the truth, not to
each other, because the two packages' generators differ.
"""

from __future__ import annotations

import importlib
import runpy
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
EIG = 1e-10  # f64 eigenvalues and energies
F32 = 1e-6  # f32 iterations at the samples' tolerance of 1e-8


def run_reference(name: str) -> dict:
    return runpy.run_path(str(ROOT / "samples" / f"{name}.py"), run_name="__main__")


def run_port(name: str, **kw) -> dict:
    module = importlib.import_module(f"eigenex_tpu_torch.samples.{name}")
    return module.main(device="cpu", **kw)


def host(x) -> np.ndarray:
    return np.asarray(x)


def close(a, b, tol=EIG, rel=False):
    a, b = host(a), host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.maximum(np.abs(b), 1.0) if rel else 1.0
    err = np.max(np.abs(a - b) / scale) if a.size else 0.0
    assert err <= tol, (err, tol, a, b)


def pairs_close(a, b, tol=EIG):
    """Complex eigenvalues held conjugation-insensitively (conjugate pairs
    tie in |lambda|, so their order may differ)."""
    key = lambda z: (round(abs(z), 8), z.real, abs(z.imag))  # noqa: E731
    close(sorted(host(a), key=key), sorted(host(b), key=key), tol)


def check_lanczos1(g, got):
    res = g["res"]
    close(got["eigenvalues"], res.eigenvalues)
    close(got["eigenvectors"], np.asarray(res.eigenvectors))
    assert got["termination"] == str(res.termination)


def check_arnoldi(g, got):
    pairs_close(got["eigenvalues"], g["res"].eigenvalues)
    assert got["identity"] < 1e-10 and np.max(got["residuals"]) < 1e-10


def check_block_tensor(g, got):
    assert got["sector"] == g["sector"]
    close(got["e0"], g["e"])
    assert sorted(got["sector_minima"]) == sorted(g["energies"])
    close([got["sector_minima"][k] for k in sorted(g["energies"])],
          [g["energies"][k] for k in sorted(g["energies"])])
    assert got["stored_blocks"] == sorted(g["H"].block_keys())
    assert got["hpsi_sectors"] == sorted(g["hpsi"].block_keys())
    close(got["rayleigh"], g["ray"])


def check_dtensor(g, got):
    for key, ref in (("contract", g["C"]), ("batched", g["Z"]), ("kron", g["K"]),
                     ("sum", g["S"])):
        labels, values = got[key]
        assert labels == tuple(ref.labels), (key, labels, ref.labels)
        close(values, np.asarray(ref.to_array()), 1e-12)


def check_lanczos2(g, got):
    lo, hi = g["lo"], g["hi"]
    assert got["range"] == (float(lo), float(hi))
    close(got["eigenvalues"], g["res"].eigenvalues)
    close(got["oracle"], g["ref"][:3])
    assert got["converged"] and g["res"].converged and np.max(got["residuals"]) < 1e-10


def check_lobpcg(g, got):
    close(got["prec_eigenvalues"], g["prec"].eigenvalues)
    # both pencil solves stop at the sample's 300-iteration cap short of tol
    # 1e-12 (from their random starts the reference needs 386 iterations, the
    # port 438): held at the sample's own rtol of 1e-9 to the closed form
    close(got["pencil_eigenvalues"], g["res"].eigenvalues, 1e-9, rel=True)
    close(got["pencil_eigenvalues"], got["closed_form"], 1e-9, rel=True)
    close(got["oracle"], g["ref"], 0.0)
    assert got["prec_converged"] and g["prec"].converged
    # the reference's point: the preconditioner pays, on either package
    assert (not got["plain_converged"]) or got["prec_iterations"] < got["plain_iterations"]


def check_matrix_market(g, got):
    assert (got["nnz"], got["loaded_nnz"], got["triangle_nnz"]) == (
        int(g["A"].nnz), int(g["B"].nnz), int(g["tri"].nnz))
    close(got["eigenvalues"], g["res"].eigenvalues)


def check_product_indices(g, got):
    pi, pj = g["pi"], g["pj"]
    assert got["dims"] == tuple(int(d) for d in pi.dims) and got["size"] == int(pi.size)
    assert got["round_trips"] == [(f, tuple(int(m) for m in pi.indices(f)),
                                   int(pi.absolute_index(pi.indices(f)))) for f in range(pi.size)]
    assert got["merged_dims"] == tuple(int(d) for d in pj.dims)
    assert got["merged"] == {(i, j): int(pj.absolute_index((i, j)))
                             for i in range(2) for j in range(3)}


def check_spectrum_slicing(g, got):
    close(got["bounds"], (g["lo"], g["hi"]))
    assert got["true_count"] == g["true_count"]
    # stochastic estimates: each package's within one eigenvalue of the truth
    assert abs(got["count"] - g["true_count"]) < 1.0 and abs(g["count"] - g["true_count"]) < 1.0
    assert abs(got["dos_integral"] - 400) < 1.0
    close(got["eigenvalues"], np.sort(np.asarray(g["res"].eigenvalues)))
    close(got["mesh_eigenvalues"], np.sort(np.asarray(g["res_m"].eigenvalues)))


def check_tebd_ising(g, got):
    close(got["exact"], g["e_exact"])
    close(got["energies"][-1], g["e"])
    assert got["bond_dims"] == [int(x.shape[0]) for x in g["lam"]]


def check_tfi(g, got):
    close(got["exact"], g["exact"])
    assert got["even_dim"] == got["odd_dim"] == 2 ** 15
    close(got["odd"], g["res"].eigenvalues)  # the script's last solve is the odd sector
    close(got["even"][0], got["exact"])


def check_tpu_hybrid(g, got):
    close(got["oracle"], g["ref"], 0.0)
    close(got["f32_eigenvalues"], g["res"].eigenvalues, F32)
    close(got["inverse_iteration"], g["lam_ii"])
    close(got["inverse_iteration"], got["oracle"])
    close(got["rayleigh"], g["lam_r"], 1e-9)


def check_accelerate(g, got):
    st = g["st"]
    assert got["stats"] == {k: st[k] for k in got["stats"]}
    assert got["symmetric"] == bool(g["acc"].symmetric)
    assert got["complexified"] == bool(g["accz"].complexified) and got["round_trip"]
    # f32 packs: the sample's solves at f32 scale
    close(got["eigenvalues"], g["lam"], F32)
    close(got["complex_eigenvalues"], g["lamz"], F32)
    assert max(got["residuals"]) < 1e-5 and got["complex_residual"] < 1e-5
    close(got["mesh_eigenvalues"], g["res_m"].eigenvalues, F32)
    assert got["mesh_delta"] < F32


CHECKS = {name[len("check_"):]: fn for name, fn in globals().items() if name.startswith("check_")}
#: the port's ``main`` keyword arguments taken from the reference's globals
INPUTS = {"arnoldi": lambda g: {"A": np.array(g["A"])}}


def check_sample(short: str) -> None:
    name = f"sample_{short}"
    g = run_reference(name)
    kw = INPUTS.get(short, lambda g: {})(g)
    got = run_port(name, **kw)
    CHECKS[short](g, got)
