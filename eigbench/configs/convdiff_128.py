"""BASELINE config 2's stencil under the shift-invert spectral
transformation of its north star: the 2-D upwind convection-diffusion
5-point stencil, convection 0.4, on a 128 x 128 grid (n = 16,384, 81,408
nonzeros), whose pairs nearest a shift are found by ``eigs(sigma=)`` with
GMRES inner solves.  The triplets, the float32 general pack of 32x128
blocks and the pack's function are ``convdiff_316.py``'s.

Cut: nx 316 -> 128 (n 99,856 -> 16,384).  At nx = 316 float64 ARPACK on an
exact LU of A - 8.5 I needs about 2,252 outer applications, each an inner
GMRES(48) solve of about 50 matvecs: 11-20 s a solve, one or two in a
30 s window.  nx = 128 is the size ``chip_smoke.py``'s phase eigs_sigma runs.
"""

from eigbench.configs.convdiff_316 import operand, pack, triplets  # noqa: F401

SOURCE = ("https://github.com/versmc/cmpt-eigenex (BASELINE.json configs[1], config 2's stencil; "
          "its pairs nearest sigma by GMRES shift-invert eigs; nx = 128 as chip_smoke.py phase 12)")
REDUCED = ["nx"]
#: why ``nx`` is cut, as measured
REDUCED_WHY = ("nx 316 -> 128 (n 99,856 -> 16,384): shift-invert needs about 2,252 outer "
               "applications of ~50 inner matvecs a solve at nx = 316 (float64 ARPACK on an exact "
               "LU, measured), 11-20 s a solve, one or two a 30 s window")
#: set here, not by the source
ASSUMED = {"conv": 0.4, "storage": "float32",
           "sigma": "8.5 (the traffic's): above the real spectrum (at most 7.664 at nx = 128) and "
                    "the field of values' real part (about 8), where GMRES(48) converges in one "
                    "cycle; at an interior 7.5 it stagnates and every application falls back to CGLS"}
PARAMS = {"nx": 128, "conv": 0.4}
STORAGE = "float32"
SYMMETRIC = False
REFERENCE = "convection_diffusion_sigma"
