"""The GMRES shift-invert route of ``eigs`` on the benchmark cell's path
(``eigbench/configs/convdiff_128.py``: the upwind convection-diffusion
triplets, ``accelerate``'s general 32x128 pack, then ``eigs(acc, k=2,
which="LM", sigma, tol, inner_tol, v0)``), at small sizes on the CPU,
against the plain reference ``eigbench/reference/convection_diffusion_sigma.py``
(ARPACK on an exact float64 LU of A - sigma I) and the closed form.

The operators are drawn from a seed: nx in 8-12, convection c in [0.1,
0.3], sigma above the spectrum.  ``accelerate`` packs values in float32 and
casts them to the storage dtype, as the JAX package's does, so c is drawn on
float32's grid near 1 (a multiple of 2^-23): -1 - c and -1 + c are then
stored exactly, and a float64 pack holds the operator the reference builds.
In float64 the eigenvalues are held to 1e-8 relative: the eigenvector
matrix's condition, about ((1 + c) / (1 - c))^(nx - 1), is at most about
1e3 there, so a backward error near 1e-12 moves them by about 1e-9.  At
larger nx or c the forward error is no longer a test of the solver, and
float32 is held to its backward error only.
"""

import json

import numpy as np
import pytest
import torch

import eigenex_tpu_torch as ext
from eigbench import core
from eigbench.reference import convection_diffusion_sigma as ref
from eigenex_tpu_torch.solvers.gmres import shift_invert_operator_general
from eigenex_tpu_torch.utils import profiling

torch.set_num_threads(1)

CONFIG = core.load_module(core.BENCH / "configs" / "convdiff_128.py", "config")
K = 2
#: float32: the cell's request; float64: tol and inner target near the dtype's reach
TOLS = {torch.float32: (1e-5, 1e-5), torch.float64: (1e-12, 1e-12)}
COUNTERS = {"si.applications": "applications", "si.matvecs": "matvecs",
            "si.fallbacks": "fallbacks", "si.cgls_iterations": "iterations"}


def case(seed: int, dtype=torch.float64):
    """(params, request, v0) of a seeded operator."""
    rng = np.random.default_rng([22, seed])
    conv = round(rng.uniform(0.1, 0.3) * 2**23) / 2**23
    params = {"nx": int(rng.integers(8, 13)), "conv": conv}
    tol, inner_tol = TOLS[dtype]
    sigma = float(ref.dominant_magnitude(params) + rng.uniform(0.2, 1.0))
    request = {"k": K, "which": "LM", "sigma": sigma, "tol": tol, "inner_tol": inner_tol}
    v0 = rng.standard_normal(params["nx"] ** 2)
    return params, request, v0


def nearest_distinct(params: dict, sigma: float, k: int) -> np.ndarray:
    """The k distinct closed-form eigenvalues nearest sigma (a double one
    once: one start vector spans one copy of it)."""
    lam = ref.eigenvalues(params)
    lam = lam[np.argsort(np.abs(lam - sigma), kind="stable")]
    distinct = [lam[0]]
    for x in lam[1:]:
        if abs(x - distinct[-1]) > 1e-9 * abs(x):
            distinct.append(x)
    return np.array(distinct[:k])


def solve(params, request, v0, dtype):
    acc = ext.accelerate(CONFIG.operand(params), device="cpu", dtype=dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return ext.eigs(acc, v0=torch.as_tensor(v0.astype(np_dtype)), **request)


def counted() -> dict:
    return {**profiling.counters("si."), **profiling.counters("gmres.")}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_pairs_nearest_sigma_match_the_reference(dtype, seed):
    params, request, v0 = case(seed, dtype)
    res = solve(params, request, v0, dtype)
    assert res.converged and res.inner_stats["fallbacks"] == 0
    lam = np.asarray(res.eigenvalues)
    numbers, _ = ref.judge(params, request, [(lam, res.eigenvectors)], "cpu", 0)
    if dtype == torch.float32:
        assert numbers["resid"][0] < 1e-4
        return
    assert numbers["resid"][0] < 1e-10
    want = nearest_distinct(params, request["sigma"], K)
    np.testing.assert_allclose(lam, want, rtol=1e-8)
    lam_ref, _ = ref.solve(params, request, v0)
    np.testing.assert_allclose(lam, lam_ref, rtol=1e-8)
    np.testing.assert_allclose(lam_ref, want, rtol=1e-8)


@pytest.mark.parametrize("route", ["eigs", "fallback"])
def test_counters_equal_the_operator_stats(route):
    """After a solve, or a direct application whose restart and cycle cap
    are too small to converge (so that it falls back to CGLS), the counter
    store has grown by the shift-invert operator's ``stats``; each
    application ran at least one GMRES cycle and spent host time."""
    params, request, v0 = case(0, torch.float32)
    before = counted()
    if route == "eigs":
        stats = solve(params, request, v0, torch.float32).inner_stats
    else:
        acc = ext.accelerate(CONFIG.operand(params), device="cpu")
        si = shift_invert_operator_general(acc.matrix, request["sigma"], restart=2, cycles=1,
                                           tol=1e-6)
        si.matvec(acc.embed(torch.as_tensor(v0, dtype=torch.float32)))
        stats = si.stats
        assert stats["applications"] == 1 and stats["fallbacks"] == 1
        assert stats["iterations"] > 0
    grown = {name: value - before.get(name, 0) for name, value in counted().items()}
    assert {name: grown.get(name, 0) for name in COUNTERS} == {
        name: stats[key] for name, key in COUNTERS.items()}
    assert grown["gmres.cycles"] >= stats["applications"] >= 1
    assert grown["si.apply_ms"] > 0 and grown["gmres.host_ms"] > 0


@pytest.mark.cuda
def test_inner_matvecs_are_the_general_spmv_launches():
    """On the card every product with A inside the applications is one
    ``bsr_spmv`` launch, graph replays included, and the closing
    true-residual check two ``bsr_spmm`` launches (the real and imaginary
    parts of the eigenvector block), as ``chip_smoke.py``'s phase eigs_sigma
    requires."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or interpret mode")
    params = {"nx": 40, "conv": 0.4}
    request = json.loads((core.BENCH / "traffic" / "sigma.json").read_text())["kwargs"]
    acc = ext.accelerate(CONFIG.operand(params), device="cuda")
    v0 = np.random.default_rng(7).standard_normal(params["nx"] ** 2).astype(np.float32)
    before = {**profiling.counters("launch."), **counted()}
    res = ext.eigs(acc, v0=torch.as_tensor(v0, device="cuda"), **request)
    after = {**profiling.counters("launch."), **counted()}
    grown = {name: value - before.get(name, 0) for name, value in after.items()}
    assert res.converged and res.inner_stats["fallbacks"] == 0
    assert grown["si.matvecs"] == res.inner_stats["matvecs"] == grown["launch.bsr_spmv"]
    assert grown.get("launch.bsr_spmm", 0) == 2
    assert {name for name, value in grown.items() if name.startswith("launch.") and value} == {
        "launch.bsr_spmv", "launch.bsr_spmm"}
