#!/usr/bin/env python3
"""Start-up proof of the PyTorch/CUDA port on one NVIDIA GPU.

Run it from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels of ``eigenex_tpu_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card, and drives
the port's main paths -- symmetric ``eigsh`` end to end through the SpMV
kernels, and the block solvers (LOBPCG, block Lanczos, the Chebyshev window
filter) through the SpMM kernels -- at full size:

1. ``device``            card, power limit, versions; TF32 must be off.
2. ``build``             seconds to build the kernels (nvcc) and the native host builders (g++).
3. ``kernels``           each kernel against its plain version, every regime,
                         f32 and bf16 storage, with times and bounds; the SpMM
                         kernels over the panel and per column, also on panels
                         whose column norms spread over twelve decades, and
                         beside that against the product on f64 blocks and
                         against the plain-PyTorch model of their split products.
4. ``eigsh_banded``      n = 262,144 banded symmetric operator (f32 half
                         storage), ``eigsh(k=4, which="LA")``.
5. ``eigsh_accelerated`` n = 262,144 scalar-sparse operator -> ``accelerate``
                         (RCM + bf16 blocks) -> ``eigsh`` -> eigenvectors restored.
6. ``eigsh_bsr``         ``eigsh`` on the same operator in full BSR storage (a few restarts).
7. ``lobpcg_banded``     ``eigsh(k=4, which="LA", preconditioner=...)`` on the banded
                         operator: the LOBPCG route, every block product an SpMM launch.
8. ``block_lanczos_banded``  ``BlockLanczosEigenSolver`` on it, block width 8.
9. ``window_accelerated``    ``eigsh_window`` on the bf16 accelerated operator of phase 5,
                         the window set from the eigenvalues that phase returned.
10. ``lobpcg_bsr``       a few LOBPCG iterations on the full-storage operator, so the
                         general SpMM kernel lies on a path.
11. ``eigs_accelerated`` the general path at full width, BASELINE config 2: the upwind
                         convection-diffusion stencil at nx = 316 (n = 99,856) ->
                         ``eigs(k=4, which="LM", accelerate=True)``: on the card the f32
                         row-compressed storage (498,016 entries, 4.4 MB; its (3124, 5, 32,
                         128) general pack would read 256 MB) on ``csr_spmv``; then the same
                         request on that general pack (``block_matrix()``, the storage an
                         operator with full blocks keeps) on ``bsr_spmv``, held alike.
12. ``eigs_sigma``       GMRES shift-invert ``eigs(sigma=...)`` on the same stencil at a
                         reduced nx = 128 (every outer matvec is a whole inner solve); the
                         benchmark times the same request in its cell ``convdiff_128.sigma``
                         (``eigbench/traffic/sigma.json``), from seeded start vectors; then
                         on its general pack: ``bsr_spmv`` inner matvecs, ``bsr_spmm`` checks.
13. ``eigsh_complex_accelerated``  a complex Hermitian hopping chain at n = 2^18 through
                         the real embedding (n = 2^19, f32) on the symmetric SpMV kernel.
14. ``expm_accelerated`` ``expm_multiply`` on the bf16 accelerated operator of phase 5,
                         by Lanczos (64 steps) and by the step-split Taylor series, one
                         real x < 0 with |x| rho <= 20; the two held together.
15. ``tridiag_si``       BASELINE config 1 at its full size: the lowest 5 pairs of the
                         n = 10^4 Laplacian through the exact tridiagonal shift-invert
                         operator (cuSPARSE gtsv2, f64), one solve held to the host's LAPACK.
16. ``svds_accelerated`` ``svds(k=6)`` on a 400,000 x 200,000 rectangular operator
                         (3.2 M nnz, shuffled) -> bipartite RCM -> f32 32x128 packs of A and
                         A^H: both Gram matvecs on the general SpMV kernel.
17. ``svds_config4``     BASELINE config 4: the truncated SVD of a (6, 8, 7, 5) f64 tensor by
                         Lanczos on its Gram operator, on the card.
18. ``block_heisenberg`` BASELINE config 3 at L = 22, f64: ``heisenberg_block_hamiltonian``
                         (23 COO sector blocks, 4,194,304 rows) -> ``block_operator`` ->
                         Lanczos ground state, held to 1e-10 against the direct route: the
                         S_z = 0 sector through ``save_matrix_market`` / ``load_matrix_market``
                         and ``csr_from_coo``.
19. ``block_heisenberg_bsr``  the same chain at L = 20 in f32 with every sector packed at 32x128
                         (21 packs, 7.6 GB): one ``bsr_spmv`` launch a sector a matvec.
20. ``block_dense``      L = 16 with dense sector blocks (the largest 12,870^2, f64):
                         ``BlockTensor.contract`` and the block einsum of H.H, the trace
                         identity, and the dense-group ``block_operator`` ground state.
21. ``native_parity``    the native host builders against the numpy routes at L = 18 on
                         the card's host: sector triplets, ``coo_shrink``, ``bsr_pack``,
                         and the symmetric and general packers fed one permutation, each
                         bit for bit.
22. ``filter_complex``   ``eigsh_window`` and ``eigsh_range`` on the complexified pack of
                         phase 13, the window taken from ``eigsh``'s lowest eigenvalues on
                         that pack: the doubled spectrum deduped, every block product one
                         ``sym_bsr_spmm`` launch.
23. ``mtx_raw``          the S_z = 0 sector file of phase 18 read back with
                         ``expand_symmetry=False`` (the native parser): the stored triangle,
                         which mirrored gives the built sector bit for bit.
24. ``heisenberg_l24``   BASELINE config 3 at its published size, L = 24, the S_z = 0 sector
                         (2,704,156 rows, 35.2 M nnz), as ``benchmarks/bench_heisenberg.py``
                         runs it: native sector enumerator -> ``accelerate(symmetric=True)``
                         (native RCM; on the card the row-compressed bf16 storage, 0.21 GiB)
                         -> ``csr_spmv`` -> f32 Lanczos -> f64 Rayleigh refinement, held to
                         the published E0; the SpMV time by ``utils.benchtime.chain_slope``,
                         one CUDA-graph replay against the eager product, and the 8.4 GiB
                         half-storage pack of the same triplets (``block_matrix()``, the
                         operand of phases 27 and 32) with ``sym_bsr_spmv`` timed beside.
25. ``mesh_kernels``     the distributed layer on shards of the one card: every matvec mode
                         (allgather, colsplit, halo, sym_halo) split at 4 shards, and the 2x2
                         panel grid, of the f32 banded operator, its bf16 twin and the bf16 pack
                         of phase 5: every shard-local product (matvec and matmat) against its
                         plain version (the SpMM also against its split model), the mesh product
                         against the one-device product, sym_halo re-runs bit-equal, launches
                         per shard and matvec.
26. ``mesh_modes``       ``eigsh(k=4, which="LA", mesh=...)`` on the banded operator over 4
                         shards in each mode and over a 2x2 grid, against the single device:
                         launches = matvecs x shards x parts.
27. ``heisenberg_l24_mesh``  config 3 at L = 24 through the config-5b composition
                         ``eigsh(acc, mesh=4 shards)``: the pack of phase 24 (not rebuilt) on the
                         sym_halo ring, E0 after the same f64 Rayleigh step against phase 24's and
                         the published one to 1e-10 (runs phase 24 first).
28. ``mesh_general``     ``eigs(mesh=...)`` (Krylov-Schur) on the general pack of the nx = 128
                         stencil (``block_matrix()`` of its row-compressed storage) in allgather
                         and colsplit and on a 2x4 grid, held as phase 11 holds its pairs,
                         beside one device on the same pack (``bsr_spmv`` once a matvec);
                         ``svds(mesh=...)`` on config 4's matrix.
29. ``mesh_filters``     ``eigsh_window`` and ``eigsh_range`` with ``mesh=`` on the bf16 pack of
                         phase 5 (one ``sym_bsr_spmm`` a shard a product), and
                         ``DistributedLOBPCGSolver`` on the banded operator, each beside its
                         single-device run.
30. ``config5``          BASELINE configs 5a (halo shift-invert Lanczos, n = 512) and 5b (the
                         accelerate x mesh composition, n = 1200) on 8 shards, f64.
31. ``multiprocess_banded``  the mesh across processes (``eigenex_tpu_torch.parallel.multiproc``
                         workers on cuda:0, gloo): 64 allgather Lanczos steps on 2 processes x 2
                         shards and the sym_halo ``eigsh`` on 4 processes x 1 shard of the banded
                         operator, bit-equal across processes and to the one-process mesh of 4
                         shards, eigenvalues against the single device.
32. ``heisenberg_l24_multiprocess``  config 3 at L = 24 on 2 processes x 2 shards: the pack of phase
                         24 saved once and loaded by the workers into host memory, each placing
                         only its own shards (device peak below the pack), E0 after the same f64
                         Rayleigh step bit-equal across processes and to phase 27's, within 1e-12
                         of phase 24's; µs a psum across processes (runs phase 24 first).
33. ``samples``          the 13 samples of ``eigenex_tpu_torch/samples`` on the card, each held to
                         its own CPU run (1e-10 for f64 results, 1e-6 for f32 iterations), and
                         sample_accelerate's kernels against their plain versions at its shapes.
34. ``derived_adjoint``  matrix-free operators with no adjoint, whose A^H autograd derives through
                         the kernels' backward (a launch of the same kernel): (a) a closure over
                         each kernel at its main-path shape (the config-2 pack of phase 11, the
                         banded operator f32 and bf16, 12-column panels for the SpMMs), its derived
                         A^H x and A^H X (a forward and a backward launch) bit-equal to the explicit
                         adjoint, with times, and ``csr_spmv`` on the row-compressed config-2
                         storage (its backward on the transposed storage); (b) the interior-sigma
                         (7.5) shift-invert of the config-2 storage on a closure, every application
                         falling back to CGLS on the derived adjoint, bit-equal to the same
                         operator with the explicit adjoint;
                         (c) ``eigs(closure, sigma=8.5)`` on phase 12's operand from phase 12's
                         start, its eigenvalues bit-equal to phase 12's.
35. ``mesh_adjoint``     the mesh operators' explicit adjoint on 4 shards of the card: each mode's
                         reverse product (allgather, colsplit and the 2x2 grid on the config-2
                         pack of phase 11, ``block_matrix()``; halo and sym_halo on the banded
                         operator of phase 4)
                         against the one-device A^H y, its ms beside the forward's, its launches a
                         shard piece; one application of the mesh shift-invert at the interior
                         sigma of phase 34, whose CGLS fallback takes the reverse products, against
                         one device; the allgather reverse product on 2 processes x 2 shards,
                         bit-equal to the one-process mesh.
36. ``chunk_graphs``     the CUDA graphs of the Arnoldi chunk (``solvers/chunk_graph.py``):
                         ``eigsh_banded``, ``eigsh_accelerated``, ``eigs_accelerated``,
                         ``eigs_sigma`` (each on both general storages) and
                         ``heisenberg_l24`` each solved eagerly
                         (``eager_chunks()``) and with graphs in turns (E G G E), at their
                         full widths: seconds, ms a matvec, graphs captured, replays, capture
                         ms, pool bytes and device peak of every run, the graph counts beside
                         their prediction, launches = matvecs in both routes, and every run's
                         eigenvalues and eigenvectors bit-equal to the first eager run's.

Every main path runs its Krylov chunks through the graph set of its solve: where a
thick-restart, Krylov-Schur or GMRES solve repeats a chunk's key on a kernel operator, the
chunk is captured once and replayed; a replay adds the launches its capture recorded.

Each phase prints one JSON line.  Any failure ends the run with a non-zero
exit code: no phase's exception is caught and passed over, nothing carries on
on the CPU, and no kernel gives way to its plain version.  Without a CUDA
device the script exits non-zero and prints no result.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path, error, times and bound
(``sym_bsr_spmv``, ``sym_bsr_spmm`` and ``csr_spmv`` twice each: their f32 and their bf16
main case, each with the launches of the phases on that storage).  ``accelerate()`` stores
the operators of phases 5, 11, 12 and 13 row-compressed on the card (fewer bytes than their
block packs), so their solves launch ``csr_spmv``; the block filters and mesh phases on them
take ``block_matrix()``.  The ``kernels``
line also gives each SpMV wrapper's host time per call.

Phases 18-20 build their operator once, on the host, and move it to the card through the
``BlockTensor`` constructor, timing the two stages apart; phase 19 checks the card's default
block shape on a small chain built on the card.  ``kernels`` adds ``bsr_spmv`` at the S_z = 0
sector pack of phase 19, which the result line lists as a second ``bsr_spmv`` entry carrying
that phase's launches; phase 24 adds ``csr_spmv`` at the L = 24 row-compressed storage, a
third ``csr_spmv`` entry carrying that phase's launches (phase 27's ``sym_bsr_spmv`` launches
join the mesh entries).
The mesh phases' solves (26-30) are main paths driven like the others, their launches
counted from 0 for each solve; the products of phase 25 are comparisons, as phase 3's are.
Phases 31-32 count the workers' launches in the workers (each sets its counts to 0 before
its solve) and add them up.  Phase 33 counts each sample's card run from 0 and prints the
counts in its own line only: the samples are not the main path, and the result line's cases
are timed at the main path's shapes; it holds sample_accelerate's kernels against their
plain versions at that sample's shapes instead.

The host stages run on the native builders (``eigenex_tpu_torch.native``, built with
``g++``).  Every phase whose host stages they serve -- 5, 11, 13, 16, 18, 19 and 24 --
prints the native calls it made, and fails if there were none; phases 5, 11, 13, 16, 18 and
19 also time the same host stages on the numpy route (the library switched off), the
route of the port before the native builders, and print both.

Phases 14, 16 and 22 hold the kernels' launch counts against an independent count
of operator applications: the container behind the solve is replaced by a
subclass that counts its ``matvec``/``matmat`` calls (``counted``) and then
calls the container's own product.

Options (none is needed): ``--phases a,b,c`` runs a subset (the result line
is then not printed), ``--profile`` repeats the ``eigsh_banded``, ``window_accelerated``,
``lobpcg_banded``, ``eigs_accelerated``, ``block_heisenberg``, ``block_heisenberg_bsr`` and
``heisenberg_l24`` solves under ``torch.profiler`` and prints the device's busy and idle
share and the kernels by time (phases ``profile``, ``profile_window``, ``profile_lobpcg``,
``profile_eigs``, ``profile_block``, ``profile_block_bsr``, ``profile_l24``; ``eigsh_banded``
and ``eigs_accelerated`` with graphs and eagerly, ``route`` says which), the device
time of each kernel of one SpMV and one SpMM product at the main-path shapes (phase
``profile_kernels``), and a derived and an explicit adjoint product on the config-2 pack, and
64 CGLS iterations on each, with the host events that take their time (phases
``profile_derived_adjoint``, ``profile_derived_adjoint_cgls``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import scipy.sparse as sp  # imported once, here: its import is no phase's host stage
import torch

from eigenex_tpu_torch import (
    BlockLanczosEigenSolver,
    BlockLanczosOptions,
    BlockTensor,
    COOMatrix,
    cgls_solve,
    accelerate,
    csr_from_coo,
    einsum,
    heisenberg_block_hamiltonian,
    heisenberg_sector_coo,
    load_matrix_market,
    save_matrix_market,
    eigs,
    LanczosEigenSolver,
    LanczosOptions,
    LinearOperator,
    eigsh,
    eigsh_range,
    eigsh_window,
    expm_multiply,
    jacobi_preconditioner,
    lobpcg,
    native,
    rayleigh_refine,
    shift_invert_operator_general,
    svds,
    sym_bsr_from_bsr,
    tridiagonal_operator,
    tridiagonal_shift_invert_operator,
    truncated_svd_via_lanczos,
)
from eigenex_tpu_torch.block.operator import block_operator
from eigenex_tpu_torch.parallel import (
    DistributedLOBPCGSolver,
    Mesh,
    distributed_lanczos_steps,
    make_mesh,
    mesh_operator,
    mesh_operator_2d,
    pad_bsr_for_mesh,
    place_on_mesh,
)
from eigenex_tpu_torch.parallel.distributed import distributed_arnoldi_steps
from eigenex_tpu_torch.parallel.shard_map import P, shard_map
from eigenex_tpu_torch.solvers.api import _accelerated_v0
from eigenex_tpu_torch.solvers.arnoldi import arnoldi_steps, init_arnoldi_state
from eigenex_tpu_torch.solvers.lanczos import init_lanczos_state, tridiagonal_eigh
from eigenex_tpu_torch.solvers.lobpcg import LOBPCGOptions, LOBPCGSolver
from eigenex_tpu_torch.convert import bsr_from_numpy, coo_from_numpy
from eigenex_tpu_torch.core.operators import pullback
from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.solvers import chunk_graph, direct
from eigenex_tpu_torch.sparse.bsr import BSRMatrix, bsr_from_coo_arrays
from eigenex_tpu_torch.sparse.sym_bsr import SymBSRMatrix
from eigenex_tpu_torch.sparse.sym_csr import SymCSRMatrix
from eigenex_tpu_torch.utils import benchtime

# ---------------------------------------------------------------------------
# stated tolerances and sizes
# ---------------------------------------------------------------------------
KERNEL_REL_TOL = 1e-5      # ||kernel - plain|| / ||plain||, plain on the same blocks lifted to f32;
                           # the SpMM kernels also per column of the panel
MODEL_REL_TOL = 1e-6       # SpMM kernel against cuda_spmv.spmm_split_model (its split products, exact, summed
                           # in f64), worst column: the kernel's f32 sums only; a dropped third part shows (8e-6)
BANDED_TOL = 1e-5          # eigsh tol, phase eigsh_banded
BANDED_RESID_LIMIT = 1e-4  # ||A x - lambda x|| / |lambda| of every returned pair
ACCEL_TOL = 1e-5           # eigsh tol, phase eigsh_accelerated
ACCEL_RESID_LIMIT = 1e-4   # same residual, in f64 on the host against the original triplets
BSR_RESID_LIMIT = 5e-2     # same residual of the unconverged pairs of phase eigsh_bsr (3 restarts)
BSR_TOP_RITZ_GAP = 1e-3    # ... whose top Ritz value lies within this relative distance of lambda_max
TIMED_LAUNCHES = 20        # timed samples per kernel and per plain version, after warm-up
SPMM_WIDTHS = (1, 8, 12, 16)  # panel widths p of the SpMM checks; 12 = LOBPCG's 3b panel at k=4
MAIN_WIDTH = 12            # ... and the width whose times go into the result line
WINDOW_WIDTH = 8           # block_size of phase window_accelerated: the bf16 main case of sym_bsr_spmm
SCALED_WIDTH = 12          # columns of the badly scaled panels, norms spread over 1e-6 .. 1e6
LOBPCG_CAP = 60            # block iterations of phase lobpcg_banded (it does not reach 1e-5 by then)
LOBPCG_RESID_LIMIT = 5e-2  # ||A x - theta x|| / |theta| of its four pairs at the cap, plain version
LOBPCG_RITZ_GAP = 1e-2     # each Ritz value within this relative distance below its eigenvalue
BLOCK_SUBSPACE = 512       # phase block_lanczos_banded: block 8, at most 64 block steps
BLOCK_RESID_LIMIT = 1e-2   # same residual of its four pairs (the solver stops on Ritz change 1e-5)
BLOCK_RITZ_GAP = 1e-3      # each Ritz value within this relative distance below its eigenvalue
WINDOW_DEGREE = 100        # filter degree of phase window_accelerated
WINDOW_TOL = 1e-5          # its tol; eigenvalues against phase eigsh_accelerated within 1e-4 relative
WINDOW_RESID_LIMIT = 1e-4  # f64 host residual of every pair it returns, original triplets
LOBPCG_BSR_ITERS = 12      # block iterations of phase lobpcg_bsr
LOBPCG_BSR_RESID_LIMIT = 0.15   # relative residual of its pairs after those, plain version
LOBPCG_BSR_AGREE = 1e-3    # the solver's residual norms (kernel) against the plain version's
CD_NX = 316                # phase eigs_accelerated: BASELINE config 2, n = 316^2 = 99,856
CD_CONV = 0.4              # its upwind convection coefficient
CD_PACK = (3124, 5, 32, 128)  # ... and the general pack accelerate() must give it (f32)
EIGS_K = 4                 # eigs(k, which="LM", tol, max_restarts) of phase eigs_accelerated
EIGS_TOL = 1e-6
EIGS_MAX_RESTARTS = 400    # not the default 100: in f32 the Krylov-Schur restarts of this operator
                           # wander along its pseudospectrum before the four residual bounds meet
                           # 1e-6 together, 28-276 restarts by start vector at nx = 100 on the CPU
                           # (PERF.md); 100 were not enough on the card at nx = 316
EIGS_RESID_LIMIT = 1e-4    # ||A x - lambda x|| / |lambda| of every pair, host f64, original triplets
EIGS_BELOW_TOP = 5e-2      # each Re(lambda) at least the closed-form top minus this, and inside the
                           # numerical range of A (which holds every Ritz value).  Not "within 5e-2 of
                           # the closed-form top": the forward problem is ill-posed at nx = 316 (its
                           # symmetrizer's condition is ~1e58), and f64 ARPACK already misses the
                           # closed form by 0.04-0.08 at nx = 80-100 (PERF.md)
SIGMA_NX = 128             # phase eigs_sigma: the same stencil at n = 16,384 (reduced: one outer
                           # matvec is a whole GMRES solve).  This request (SIGMA_NX, CD_CONV, SIGMA,
                           # SIGMA_K, SIGMA_TOL, SIGMA_INNER_TOL) is the benchmark cell
                           # convdiff_128.sigma's: keep it equal to eigbench/traffic/sigma.json and
                           # eigbench/configs/convdiff_128.py
SIGMA = 8.5                # its shift: just above the spectrum (real parts <= 7.67), where GMRES(48)
                           # converges in one cycle; at an interior 7.5 it stagnates and every
                           # solve falls back to CGLS, which misses an f32 target (PERF.md)
SIGMA_K = 2
SIGMA_TOL = 1e-5
SIGMA_INNER_TOL = 1e-5     # the GMRES target; the default (1e-2 of tol = 1e-7) is below f32's reach
SIGMA_RESID_LIMIT = 1e-4
DA_SIGMA = 7.5             # phase derived_adjoint (b): the interior shift of the nx = 316 stencil where
                           # GMRES(48) stagnates, so every application falls back to CGLS
DA_APPLICATIONS = 3        # ... applied to this many seeded vectors (about 2 s each a route)
DA_PANEL = MAIN_WIDTH      # (a): the columns of the SpMM vjps
CHAIN_N = 2 ** 18          # phase eigsh_complex_accelerated: complex Hermitian chain, embedded 2^19
CHAIN_TOL = 1e-6
CHAIN_RESID_LIMIT = 1e-4   # host complex128 ||H z - lambda z|| / |lambda| of the restored vector

EXPM_STEPS = 64            # phase expm_accelerated: Lanczos steps of expm_multiply(method="lanczos")
EXPM_X_RHO = 20.0          # |x| times the Gershgorin bound of the spectral radius, x < 0
EXPM_TAYLOR_TOL = 1e-7     # the Taylor series' stop (term norm / sum norm): f32's reach, not the
                           # f32 default 1e-4, which would leave 1e-4 in each of the sub-steps
EXPM_AGREE = 1e-4          # ||lanczos - taylor_auto|| / ||taylor_auto||
TRIDIAG_N = 10_000         # phase tridiag_si: BASELINE config 1 at its full size, f64
TRIDIAG_SIGMA = -1e-6
TRIDIAG_ERR_LIMIT = 1e-10  # max |lambda_k - (2 - 2 cos(k pi / (n + 1)))| over the lowest 5
TRIDIAG_COLS = 8           # columns of the matmats held to the host's LAPACK solve:
TRIDIAG_SOLVE_LIMIT = 1e-12  # worst column's relative difference from LAPACK gtsv on the same bands
TRIDIAG_WELL_SIGMA = -1.0  # shifted to -1 (condition 5); at sigma itself (condition 3.6e6) two
                           # stable solvers part by up to eps * condition = 8.1e-10 (1.3e-11 measured),
                           # so there the gtsv2 solve's backward error is held to the limit instead,
                           # and its forward difference to eps * condition
SVDS_SHAPE = (400_000, 200_000)  # phase svds_accelerated: the operator of
SVDS_BW, SVDS_PER_ROW = 600, 8   # benchmarks/bench_svds_rect.py at its defaults (seed 0)
SVDS_K, SVDS_TOL = 6, 1e-5
SVDS_RESID_LIMIT = 1e-4    # ||A v_j - s_j u_j|| / s_1, host f64 on the original triplets
SVDS_ORTH_LIMIT = 1e-4     # ||U^T U - I|| (Frobenius)
CONFIG4_ERR_LIMIT = 1e-10  # phase svds_config4: singular values against numpy.linalg.svd
HEIS_L = 22                # phase block_heisenberg: BASELINE config 3 at L = 22, 2^22 rows, f64
CONFIG3_OPTIONS = dict(max_eigenvalues=1, tolerance=1e-13, max_subspace=140,
                       compute_eigenvectors=False)  # config 3's Lanczos options
CONFIG3_ERR_LIMIT = 1e-10  # |E_block - E_direct|, config 3's bound
HEIS_BSR_L = 20            # phase block_heisenberg_bsr: 21 sector packs at 32x128, f32
CARD_BSR_BLOCK = (32, 128)  # heisenberg_block_hamiltonian's default BSR block shape on a CUDA device
BSR_LANCZOS = dict(max_eigenvalues=1, tolerance=1e-6, max_subspace=200,
                   compute_eigenvectors=False)  # f32: Ritz change 1e-6 (f32's reach is ~1e-7)
BSR_E0_REL_LIMIT = 1e-5    # its E0 against the f64 E0 of the S_z = 0 sector, relative
HEIS_DENSE_L = 16          # phase block_dense: 17 dense sector blocks, 4.8 GB of f64
DENSE_REL_LIMIT = 1e-12    # contract against block einsum per block; trace(H.H) against ||H||_F^2
DENSE_E0_LIMIT = 1e-10     # dense-block against sparse-block ground state
PARITY_L = 18              # phase native_parity: the S_z = 0 sector at L = 18 (48,620 rows)
FILTER_K = 4               # phase filter_complex: eigsh(k, which="SA") on the complex chain's pack;
FILTER_DEGREE = 120        # the window holds its lowest 3 eigenvalues; filter degree of both solves
FILTER_BLOCK = 8           # block_size (doubled on the real embedding)
FILTER_TOL = 1e-5          # tol of both filter solves; eigenvalues against eigsh within 1e-4 relative
FILTER_AGREE = 1e-4
L24 = 24                   # phase heisenberg_l24: BASELINE config 3 at its published size
L24_DIM = 2_704_156        # C(24, 12), the S_z = 0 sector
L24_E0 = -10.453785760409  # its ground energy as BASELINE.md:179,342 publishes it
L24_E0_LIMIT = 1e-8        # |E0 (f64 Rayleigh quotient) - published|
L24_RESID_LIMIT = 1e-4     # ||H x - E0 x|| / |E0| of the refined pair, f64 on the host
L24_SOLVE = dict(k=1, which="SA", tol=1e-8, max_subspace=160)  # benchmarks/bench_heisenberg.py
L24_CHAIN = dict(k_lo=16, k_hi=80, reps=5)  # benchtime.chain_slope of its SpMV

BLOCK = 128
NBR = 2048                 # 2048 block rows of 128 -> n = 262,144
SEED = 0

#: peak rates by card, NVIDIA's data sheets: device memory bytes/s, then flop/s by
#: the unit a kernel multiplies on: f32 FMA outside the tensor cores, and the dense
#: (no sparsity) tensor-core rates for bf16, TF32 and f64 inputs (f64: the library's
#: dense products of phase block_dense).  The first key found in the card's name is used.
PEAKS = (
    ("H200", 4.8e12, {"f32_cuda_cores": 67e12, "bf16_tensor_cores": 989e12, "tf32_tensor_cores": 495e12,
                      "f64_tensor_cores": 67e12}),
    ("H100 PCIe", 2.0e12, {"f32_cuda_cores": 51e12, "bf16_tensor_cores": 756e12, "tf32_tensor_cores": 378e12,
                           "f64_tensor_cores": 51e12}),
    ("H100 NVL", 3.9e12, {"f32_cuda_cores": 60e12, "bf16_tensor_cores": 835e12, "tf32_tensor_cores": 417e12,
                          "f64_tensor_cores": 60e12}),
    ("H100", 3.35e12, {"f32_cuda_cores": 67e12, "bf16_tensor_cores": 989e12, "tf32_tensor_cores": 495e12,
                       "f64_tensor_cores": 67e12}),
)
#: the unit each kernel multiplies on, by block storage: the SpMV kernels use f32 FMAs on
#: widened blocks, the SpMM kernels mma.sync on bf16 inputs (bf16 blocks, X in three bf16
#: parts) or TF32 inputs (f32 blocks, 3xTF32).  The bound divides the FUNCTION's flops
#: (2 per stored entry and column, not the split's three passes) by that unit's rate.
OPS_UNIT = {
    ("bsr_spmv", "float32"): "f32_cuda_cores", ("bsr_spmv", "bfloat16"): "f32_cuda_cores",
    ("sym_bsr_spmv", "float32"): "f32_cuda_cores", ("sym_bsr_spmv", "bfloat16"): "f32_cuda_cores",
    ("bsr_spmm", "float32"): "tf32_tensor_cores", ("bsr_spmm", "bfloat16"): "bf16_tensor_cores",
    ("sym_bsr_spmm", "float32"): "tf32_tensor_cores", ("sym_bsr_spmm", "bfloat16"): "bf16_tensor_cores",
    ("csr_spmv", "float32"): "f32_cuda_cores", ("csr_spmv", "bfloat16"): "f32_cuda_cores",
}

REPLACES = {
    "bsr_spmv": "eigenex_tpu/ops/pallas_spmv.py:91",
    "sym_bsr_spmv": "eigenex_tpu/ops/pallas_spmv.py:210",
    "bsr_spmm": "eigenex_tpu/ops/pallas_spmv.py:984",
    "sym_bsr_spmm": "eigenex_tpu/ops/pallas_spmv.py:849",
    "csr_spmv": "none: row-compressed storage of low-fill symmetric operators, on the card only",
}
ALSO_REPLACES = {
    "bsr_spmv": ["eigenex_tpu/ops/pallas_spmv.py:39 (_dot_mode/_sdot precision rule)"],
    "sym_bsr_spmv": [
        "eigenex_tpu/ops/pallas_spmv.py:600 (_sym_spmv_kernel)",
        "eigenex_tpu/ops/pallas_spmv.py:355 (_sym_spmv_ring_kernel)",
        "eigenex_tpu/ops/pallas_spmv.py:39 (_dot_mode/_sdot precision rule)",
    ],
    "bsr_spmm": ["eigenex_tpu/ops/pallas_spmv.py:39 (_dot_mode/_sdot precision rule)"],
    "sym_bsr_spmm": [
        "eigenex_tpu/ops/pallas_spmv.py:745 (_sym_spmm_stream_kernel)",
        "eigenex_tpu/ops/pallas_spmv.py:500 (_sym_spmm_ring_kernel)",
        "eigenex_tpu/ops/pallas_spmv.py:39 (_dot_mode/_sdot precision rule)",
    ],
    "csr_spmv": [],
}
#: the cases whose times stand for a kernel in the result line: the shapes and
#: storages its main paths give it, one entry of the line each, found by the words
#: of its case name.  An entry with "phases" carries those phases' launches, times
#: its share of each (a phase whose every product launches a kernel once on each of
#: two or three containers gives each container's entry 1/2 or 1/3: the phases
#: check their launch counts exactly); the other entries of a kernel carry the
#: rest, split by block storage where there are several.  bsr_spmv: the (3124, 5,
#: 32, 128) f32 pack of config 2 (``block_matrix()``; the 32x128 f32 packs of the
#: general block routes, on one device and on a mesh), the S_z = 0 sector pack of phase
#: block_heisenberg_bsr, and the shard-local containers of each mesh_modes run and of
#: heisenberg_l24_mesh, and the reverse pieces ("<role>^H") of phase mesh_adjoint's
#: modes (its sym_halo reverse product is the forward one).  sym_bsr_spmv: f32 and
#: bf16 blocks of reach 1 (eigsh_banded, derived_adjoint) and the in-panel packs of the
#: mesh phases.  csr_spmv: the row-compressed operators accelerate() makes on the card,
#: f32 config 2 (eigs_accelerated) and the nx = 128 stencil (eigs_sigma), bf16
#: (eigsh_accelerated, expm_accelerated), f32 (the complex chain's embedding, and the
#: other f32 phases) and the L = 24 sector (heisenberg_l24).  bsr_spmm and
#: sym_bsr_spmm: the f32 12-column panel of LOBPCG, the bf16 8-column block of the
#: window filter (sym_bsr_spmm),
#: and the mesh_filters phases' shard-local containers at those widths; phase
#: derived_adjoint's vjps at DA_PANEL columns: bsr_spmm forward on the config-2 pack
#: and backward on its adjoint pack (a half each), sym_bsr_spmm on the bf16 banded
#: operator (its f32 one is the LOBPCG case).
#: Mesh cases are timed on shard TIMED_SHARD_1D (TIMED_SHARD on the grid).
_HALF, _THIRD = Fraction(1, 2), Fraction(1, 3)
_L24M = f"mesh: L={L24} sym_halo"
_F32M = "mesh: f32 full"
_BF16M = "mesh: bf16 pack sym_halo"
_CD2M = "mesh: config-2 f32"
MAIN_CASES = {
    "bsr_spmv": [dict(match=("config-2 pack", " f32")),
                 dict(match=("sector pack", " f32"), phases={"block_heisenberg_bsr": 1}),
                 dict(match=(f"{_F32M} allgather main ",),
                      phases={"mesh_modes_allgather": 1, "multiprocess_banded_allgather": 1}),
                 dict(match=(f"{_F32M} colsplit main ",), phases={"mesh_modes_colsplit": 1}),
                 *(dict(match=(f"{_F32M} halo {role} ",), phases={"mesh_modes_halo": _THIRD})
                   for role in ("main", "left", "right")),
                 *(dict(match=(f"{_F32M} sym_halo {role} ",),
                        phases={"mesh_modes_sym_halo": _HALF, "multiprocess_banded_sym_halo": _HALF,
                                "mesh_adjoint_sym_halo": _HALF})
                   for role in ("right", "right_adj")),
                 dict(match=(f"{_F32M} grid main ",), phases={"mesh_modes_grid": 1}),
                 dict(match=(f"{_CD2M} allgather main^H ",),
                      phases={"mesh_adjoint_allgather": 1, "mesh_adjoint_multiprocess": 1}),
                 dict(match=(f"{_CD2M} colsplit main^H ",), phases={"mesh_adjoint_colsplit": 1}),
                 dict(match=(f"{_CD2M} grid main^H ",), phases={"mesh_adjoint_grid": 1}),
                 *(dict(match=(f"{_F32M} halo {role}^H ",), phases={"mesh_adjoint_halo": _THIRD})
                   for role in ("main", "left", "right")),
                 *(dict(match=(f"{_L24M} {role} ",),
                        phases={"heisenberg_l24_mesh": _HALF, "heisenberg_l24_multiprocess": _HALF})
                   for role in ("right", "right_adj"))],
    "sym_bsr_spmv": [dict(match=("banded", " f32")), dict(match=("banded", " bf16")),
                     dict(match=(f"{_F32M} sym_halo main ",),
                          phases={"mesh_modes_sym_halo": 1, "multiprocess_banded_sym_halo": 1,
                                  "mesh_adjoint_sym_halo": 1}),
                     dict(match=(f"{_L24M} main ",),
                          phases={"heisenberg_l24_mesh": 1, "heisenberg_l24_multiprocess": 1})],
    "bsr_spmm": [dict(match=("banded", " f32", f"p={MAIN_WIDTH} ")),
                 *(dict(match=(f"config-2 {what} ", f"p={DA_PANEL} "),
                        phases={"derived_adjoint_config2_f32": _HALF})
                   for what in ("pack", "adjoint pack")),
                 *(dict(match=(f"{_F32M} sym_halo {role} ", f"p={MAIN_WIDTH} "),
                        phases={"mesh_filters_lobpcg": _HALF}) for role in ("right", "right_adj")),
                 *(dict(match=(f"{_BF16M} {role} ", f"p={WINDOW_WIDTH} "),
                        phases={"mesh_filters_window": _HALF, "mesh_filters_range": _HALF})
                   for role in ("right", "right_adj"))],
    "sym_bsr_spmm": [dict(match=("banded", " f32", f"p={MAIN_WIDTH} ")),
                     dict(match=("banded", " bf16", f"p={WINDOW_WIDTH} ")),
                     dict(match=("banded", " bf16", f"p={DA_PANEL} "),
                          phases={"derived_adjoint_banded_bf16": 1}),
                     dict(match=(f"{_F32M} sym_halo main ", f"p={MAIN_WIDTH} "),
                          phases={"mesh_filters_lobpcg": 1}),
                     dict(match=(f"{_BF16M} main ", f"p={WINDOW_WIDTH} "),
                          phases={"mesh_filters_window": 1, "mesh_filters_range": 1})],
    "csr_spmv": [dict(match=("config-2 row-compressed", " f32"), phases={"eigs_accelerated": 1}),
                 dict(match=(f"nx={SIGMA_NX} stencil row-compressed",), phases={"eigs_sigma": 1}),
                 dict(match=("accelerated banded", " bf16")),
                 dict(match=("complex chain embedding", " f32")),
                 dict(match=(f"L={L24} S_z=0",), phases={"heisenberg_l24": 1})],
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


@contextlib.contextmanager
def numpy_route():
    """The host stages with the native builders switched off: the numpy and
    scipy route of a machine without ``g++``, the port's route before them."""
    available = native.native_available
    native.native_available = lambda: False
    try:
        yield
    finally:
        native.native_available = available


def native_total(phase: str, calls: dict) -> int:
    """The native calls a phase made, all wrappers together; a phase whose
    host stages the native builders serve fails without any."""
    total = sum(calls.values())
    if total <= 0:
        fail(f"{phase}: no native call: the host stages took the numpy route")
    return total


def numpy_route_pack(operand, **kw) -> dict:
    """The host seconds of ``accelerate(operand, **kw)`` on the numpy route,
    packed on the host: the comparison for a native pack."""
    with numpy_route():
        t0 = time.time()
        acc = accelerate(operand, device="cpu", **kw)
        seconds = time.time() - t0
    return dict(pack_seconds_wall=seconds, pack_stages=acc.stats["pack_stages"],
                bandwidth_after=acc.stats["bandwidth_after"])


def sorted_slots(data: np.ndarray, cols: np.ndarray, rows: np.ndarray, tcols: np.ndarray, bm: int,
                 bn: int):
    """A BSR-ELL pack of the triplets (rows, tcols) with each block row's real
    slots in column order: the native ``bsr_pack`` fills a row's slots in the
    order its blocks first occur, the numpy packer in column order.  Padding
    slots, which both leave zero at column 0, stay last."""
    nbr, kmax = cols.shape
    width = int(tcols.max()) // bn + 1
    blocks = np.unique((rows // bm) * width + tcols // bn)  # the real blocks
    real = np.bincount(blocks // width, minlength=nbr)  # ... a block row
    key = np.where(np.arange(kmax)[None, :] < real[:, None], cols, np.iinfo(np.int32).max)
    order = np.argsort(key, axis=1, kind="stable")
    return (np.take_along_axis(data, order[:, :, None, None], axis=1),
            np.take_along_axis(cols, order, axis=1))


def card_peaks(name: str):
    for key, bw, rates in PEAKS:
        if key in name:
            return key, bw, rates
    return "H100 (assumed: card not in table)", PEAKS[-1][1], PEAKS[-1][2]


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------
def banded_block_bsr_numpy(nbr: int, bm: int, seed: int = 0):
    """Block-tridiagonal symmetric operator with Gaussian blocks, full
    storage, built on the host: (data (nbr, 3, bm, bm) f32, cols (nbr, 3))."""
    rng = np.random.default_rng(seed)
    data = np.zeros((nbr, 3, bm, bm), np.float32)
    cols = np.zeros((nbr, 3), np.int32)
    diag = rng.standard_normal((nbr, bm, bm), dtype=np.float32)
    off = rng.standard_normal((nbr - 1, bm, bm), dtype=np.float32)
    for r in range(nbr):
        data[r, 0] = (diag[r] + diag[r].T) / 2
        cols[r, 0] = r
        slot = 1
        if r > 0:
            data[r, slot] = off[r - 1].T
            cols[r, slot] = r - 1
            slot += 1
        if r + 1 < nbr:
            data[r, slot] = off[r]
            cols[r, slot] = r + 1
    return data, cols


def random_sym_blocks(nbr: int, b: int, upper_cols: np.ndarray, band_reach: int, gen) -> SymBSRMatrix:
    """SymBSR with Gaussian blocks made on the card from ``gen``; slots whose
    column is not above the diagonal are padding (column 0, zero block)."""
    dev = gen.device
    ku = upper_cols.shape[1]
    diag = torch.randn((nbr, b, b), generator=gen, device=dev)
    diag = (diag + diag.transpose(1, 2)) / 2
    upper = torch.randn((nbr, ku, b, b), generator=gen, device=dev)
    real = upper_cols > np.arange(nbr)[:, None]
    upper[torch.as_tensor(~real).to(dev)] = 0
    cols = torch.as_tensor(np.where(real, upper_cols, 0).astype(np.int32)).to(dev)
    n = nbr * b
    return SymBSRMatrix(diag.contiguous(), upper.contiguous(), cols, (n, n), band_reach)


def scattered_cols(nbr: int, ku: int, seed: int) -> np.ndarray:
    """ku distinct random columns above the diagonal per block row (fewer
    near the bottom: the rest are padding)."""
    rng = np.random.default_rng(seed)
    cols = np.zeros((nbr, ku), np.int64)
    for r in range(nbr):
        avail = nbr - 1 - r
        take = min(ku, avail)
        if take:
            cols[r, :take] = r + 1 + np.sort(rng.choice(avail, size=take, replace=False))
    return cols


def far_reach_cols(nbr: int, distances) -> np.ndarray:
    rows = np.arange(nbr)[:, None]
    cols = rows + np.asarray(distances)[None, :]
    return np.where(cols < nbr, cols, 0)


def convection_diffusion_coo(nx: int, conv: float = CD_CONV):
    """5-point Laplacian + upwind convection on an nx x nx grid, BASELINE
    config 2 (the operator of ``benchmarks/bench_arnoldi.py``): host triplets
    (rows, cols, vals, n), row-major sorted."""
    n = nx * nx
    i = np.arange(nx)
    jj, ii = np.meshgrid(i, i)  # ii: row block (y), jj: col (x)
    u = (ii * nx + jj).ravel()
    rows, cols, vals = [u], [u], [np.full(n, 4.0)]

    def add(mask, dst_offset, val):
        uu = u[mask.ravel()]
        rows.append(uu)
        cols.append(uu + dst_offset)
        vals.append(np.full(len(uu), val))

    add(ii > 0, -nx, -1.0 - conv)
    add(ii < nx - 1, +nx, -1.0 + conv)
    add(jj > 0, -1, -1.0 - conv)
    add(jj < nx - 1, +1, -1.0 + conv)
    r = np.concatenate(rows).astype(np.int64)
    c = np.concatenate(cols).astype(np.int64)
    v = np.concatenate(vals)
    order = np.lexsort((c, r))
    return r[order], c[order], v[order], n


def convection_diffusion_top(nx: int, count: int, conv: float = CD_CONV) -> np.ndarray:
    """The ``count`` largest eigenvalues of that operator in closed form: the
    real Kronecker sum 4 + 2 sqrt(1 - c^2) (cos(i pi/(nx+1)) + cos(j pi/(nx+1)))."""
    cg = np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    lam = 4 + 2 * np.sqrt(1 - conv**2) * (cg[:, None] + cg[None, :])
    return np.sort(lam.ravel())[::-1][:count]


def convection_diffusion_range(nx: int, conv: float = CD_CONV) -> tuple[float, float]:
    """Bounds of the numerical range {x^H A x : |x| = 1} of that operator, which
    holds every Ritz value of an orthogonal projection: (largest real part,
    largest |imaginary part|), the extreme eigenvalues of its symmetric part
    4 - (discrete 2-D Laplacian stencil) and of its skew part (2c in each of
    the two directions)."""
    cos1 = np.cos(np.pi / (nx + 1))
    return 4 + 4 * cos1, 4 * conv * cos1


def build_complex_hopping(n: int, seed: int = 0):
    """Complex Hermitian hopping chain of ``benchmarks/bench_complex.py``:
    H[i,i] real; H[i,i+1], H[i,i+2] random-phase hops (conjugate mirrors
    stored).  Returns the full (both-triangle) triplets."""
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal(n)
    t1 = np.exp(1j * rng.uniform(0, 2 * np.pi, n - 1))
    t2 = 0.5 * np.exp(1j * rng.uniform(0, 2 * np.pi, n - 2))
    rows = [np.arange(n), np.arange(n - 1), np.arange(1, n), np.arange(n - 2), np.arange(2, n)]
    cols = [np.arange(n), np.arange(1, n), np.arange(n - 1), np.arange(2, n), np.arange(n - 2)]
    vals = [diag.astype(complex), t1, np.conj(t1), t2, np.conj(t2)]
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def banded_rect_triplets(m: int, n: int, bw: int, per_row: int, seed: int = 0):
    """The rectangular operator of ``benchmarks/bench_svds_rect.py``: ``per_row``
    Gaussian entries a row near the matched diagonal j ~ i n / m, within
    ``bw``, then rows and columns shuffled so that the bipartite RCM has to
    find the band again."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), per_row)
    c = (r * n) // m + rng.integers(-bw, bw, size=len(r))
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r))
    pr, pc = rng.permutation(m), rng.permutation(n)
    return pr[r], pc[c], v, (m, n)


def counted(container, counts: dict):
    """``container`` as a subclass of its own type that adds one to
    ``counts["matvec"]`` / ``counts["matmat"]`` at each product and then
    computes it as the container does (its wrapper launches the kernel): the
    count of operator applications a phase holds the launch counts against."""
    base = type(container)

    class Counted(base):
        def matvec(self, x):
            counts["matvec"] += 1
            return base.matvec(self, x)

        def matmat(self, X):
            counts["matmat"] += 1
            return base.matmat(self, X)

    return Counted(*(getattr(container, f.name) for f in dataclasses.fields(container)))


def coo_on(r, c, v, n: int, dev) -> COOMatrix:
    """The port's COO container of host triplets, on the card."""
    return COOMatrix(torch.as_tensor(r.astype(np.int32)).to(dev),
                     torch.as_tensor(c.astype(np.int32)).to(dev),
                     torch.as_tensor(v).to(dev), (n, n))


# ---------------------------------------------------------------------------
# measuring
# ---------------------------------------------------------------------------
def host_us_per_call(fn, calls: int = 100) -> float:
    """Host time to queue one call: ``calls`` calls queued without a
    synchronisation, on the host clock, divided by ``calls``.  The device
    is idle at the start and 100 launches do not fill the launch queue, so
    no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def time_ms(fn, count: int = TIMED_LAUNCHES, batch: int = 8, warm: int = 3) -> float:
    """Time of one call: median over ``count`` samples, each the CUDA-event
    time of ``batch`` back-to-back calls divided by ``batch``, warm.  Queuing a
    batch keeps the device fed, so a sample is the device's time per call and
    not the host's time to issue one.  The operators but a mesh's boundary
    pieces are far larger than the L2 cache, so every call streams its blocks
    from device memory; a boundary piece of a few blocks stays in L2."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(count):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / batch)
    return statistics.median(samples)


def bound(nbytes: int, flops: int, peaks, unit: str) -> tuple[float, str]:
    """Least time for the work, in ms, and what sets it; ``unit`` names the
    rate of ``PEAKS`` the operations are held against."""
    _, bw, rates = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / rates[unit] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bsr_work(bsr) -> tuple[int, int]:
    """(bytes, flops) of one general SpMV: every stored slot is read once
    (padding cannot be told from data without reading it), x read and y
    written once."""
    nbytes = (bsr.data.numel() * bsr.data.element_size() + bsr.block_cols.numel() * 4
              + bsr.shape[1] * 4 + bsr.shape[0] * 4)
    return nbytes, 2 * bsr.data.numel()


def sym_work(sym) -> tuple[int, int]:
    """(bytes, flops) of one symmetric SpMV on THIS operator: diagonal blocks
    and REAL upper slots read once (padding slots are skipped), column ids and
    the column index, x read and y written once; each upper block applied
    twice."""
    b = sym.block_shape[0]
    nbr = sym.n_block_rows
    n_real = int(sym.column_index()[1].numel())
    item = sym.upper_data.element_size()
    nbytes = ((nbr + n_real) * b * b * item + sym.upper_cols.numel() * 4
              + (nbr + 1 + n_real) * 4 + sym.shape[1] * 4 + sym.shape[0] * 4)
    return nbytes, 2 * (nbr + 2 * n_real) * b * b


def csr_work(csr) -> tuple[int, int]:
    """(bytes, flops) of one row-compressed SpMV: each stored entry's value and
    int32 column and the int32 row pointers read once, x read and y written
    once (the gathers of x are L2 traffic, not counted)."""
    nbytes = (csr.nnz * (csr.val.element_size() + 4) + (csr.shape[0] + 1) * 4
              + csr.shape[1] * 4 + csr.shape[0] * 4)
    return nbytes, 2 * csr.nnz


def bsr_spmm_work(bsr, p: int) -> tuple[int, int]:
    """(bytes, flops) of one general SpMM at width p: every stored slot read
    once for all p columns, X read and Y written once."""
    nbytes = (bsr.data.numel() * bsr.data.element_size() + bsr.block_cols.numel() * 4
              + (bsr.shape[1] + bsr.shape[0]) * p * 4)
    return nbytes, 2 * bsr.data.numel() * p


def sym_spmm_work(sym, p: int) -> tuple[int, int, int]:
    """(bytes, flops, scratch bytes) of one symmetric SpMM on THIS operator at
    width p: diagonal blocks and REAL upper slots read once for all p columns,
    column ids and the column index, X read and Y written once; each upper
    block applied twice.  The scratch bytes are the two-pass schedule's own
    traffic -- the (n_real, b, p) f32 partials written by pass 1 and read by
    pass 2 -- and are no input or output of the function: they are reported
    beside the bound, not inside it."""
    b = sym.block_shape[0]
    nbr = sym.n_block_rows
    n_real = int(sym.column_index()[1].numel())
    item = sym.upper_data.element_size()
    nbytes = ((nbr + n_real) * b * b * item + sym.upper_cols.numel() * 4
              + (nbr + 1 + n_real) * 4 + (sym.shape[1] + sym.shape[0]) * p * 4)
    return nbytes, 2 * (nbr + 2 * n_real) * b * b * p, 2 * n_real * b * p * 4


def library_ms(lib, dtype, x, ref):
    """Time of ``lib @ x`` for a ``torch.sparse_bsr_tensor`` ``lib`` with
    blocks of ``dtype``, once it agrees with ``ref``, the plain version on the
    same blocks lifted to f32 (1e-2 relative in bf16, where x is rounded to
    bf16 for the call; 1e-4 in f32).  The yardstick only: used nowhere in the
    port.  Returns (ms or None, note)."""
    try:
        vector = x.ndim == 1
        xcol = x.to(dtype)[:, None] if vector else x.to(dtype)
        y = (lib @ xcol).float()
        ref = ref[:, None] if vector else ref
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        if not rel < (1e-2 if dtype == torch.bfloat16 else 1e-4):
            return None, f"library product disagrees (rel {rel:.2e})"
        return time_ms(lambda: lib @ xcol, count=5), "torch.sparse_bsr_tensor @ " + ("x" if vector else "X")
    except (RuntimeError, NotImplementedError) as e:  # the yardstick only, never the port
        return None, f"not supported here: {str(e).splitlines()[0][:120]}"


def retiled_bsr_tensor(bsr):
    """The ELL slots of ``bsr`` as a ``torch.sparse_bsr_tensor``, columns
    sorted in each block row.  PyTorch's CUDA BSR product takes square blocks
    only, so (bm, bn) blocks are cut into g x g tiles, g = gcd(bm, bn): the
    same stored entries, zeros included."""
    nbr, kmax, bm, bn = bsr.data.shape
    g = math.gcd(bm, bn)
    rs, cs = bm // g, bn // g
    # tile (s, t) of slot k of block row r -> block row r*rs + s, column cols[r,k]*cs + t
    tiles = bsr.data.reshape(nbr, kmax, rs, g, cs, g).permute(0, 2, 1, 4, 3, 5)
    tiles = tiles.reshape(nbr * rs, kmax * cs, g, g)
    cols = (bsr.block_cols.long()[:, :, None] * cs + torch.arange(cs, device=bsr.device))
    cols = cols.reshape(nbr, 1, kmax * cs).expand(-1, rs, -1).reshape(nbr * rs, kmax * cs)
    cols, order = torch.sort(cols, dim=1, stable=True)
    tiles = torch.gather(tiles, 1, order[:, :, None, None].expand(-1, -1, g, g))
    width = kmax * cs
    crow = torch.arange(0, (nbr * rs + 1) * width, width, dtype=torch.int64, device=bsr.device)
    return torch.sparse_bsr_tensor(crow, cols.reshape(-1), tiles.reshape(-1, g, g), size=bsr.shape)


def library_bsr_ms(bsr, x):
    """``library_ms`` of the general product: the ELL slots of ``bsr`` as a
    ``torch.sparse_bsr_tensor`` (:func:`retiled_bsr_tensor`)."""
    lib = retiled_bsr_tensor(bsr)
    lifted = bsr.astype(torch.float32)
    ref = (cuda_spmv.bsr_spmv_plain(lifted, x) if x.ndim == 1
           else cuda_spmv.bsr_spmm_plain(lifted, x))
    ms, note = library_ms(lib, bsr.dtype, x, ref)
    bm, bn = bsr.block_shape
    if ms is not None and bm != bn:
        g = math.gcd(bm, bn)
        note += f" (blocks cut into {g}x{g} tiles: CUDA BSR takes square blocks)"
    return ms, note


def library_sym_ms(sym, x):
    """``library_ms`` of the symmetric product: PyTorch has no half storage,
    so the operator is expanded to full storage -- the diagonal blocks, the
    real upper blocks and their transposes, columns sorted in each block row
    -- and that call reads about twice the blocks the kernel reads."""
    nbr, ku, b, _ = sym.upper_data.shape
    dev = sym.device
    r = torch.arange(nbr, device=dev)
    cols = sym.upper_cols.long()
    real = cols > r[:, None]
    rr, cc = r[:, None].expand(-1, ku)[real], cols[real]
    upper = sym.upper_data[real]
    rows, colsf = torch.cat([r, rr, cc]), torch.cat([r, cc, rr])
    order = torch.argsort(rows * nbr + colsf)
    blocks = torch.cat([sym.diag_data, upper, upper.transpose(1, 2)])[order].contiguous()
    del upper
    crow = torch.zeros(nbr + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=nbr), 0)
    lib = torch.sparse_bsr_tensor(crow, colsf[order], blocks, size=sym.shape)
    lifted = sym.astype(torch.float32)
    ref = (cuda_spmv.sym_bsr_spmv_plain(lifted, x) if x.ndim == 1
           else cuda_spmv.sym_bsr_spmm_plain(lifted, x))
    del lifted
    out = library_ms(lib, sym.dtype, x, ref)
    del lib, blocks
    return out


def library_csr_ms(csr, x):
    """``library_ms`` of the row-compressed product: the same rows as a
    ``torch.sparse_csr_tensor`` (int64 indices, which PyTorch's CUDA product
    takes)."""
    ref = cuda_spmv.csr_spmv_plain(csr.astype(torch.float32), x)
    lib = torch.sparse_csr_tensor(csr.rowptr.long(), csr.col.long(), csr.val, size=csr.shape)
    ms, note = library_ms(lib, csr.dtype, x, ref)
    if ms is None and csr.dtype != torch.float32:  # the values lifted to f32: 2 bytes more an entry
        lib = torch.sparse_csr_tensor(csr.rowptr.long(), csr.col.long(), csr.val.float(),
                                      size=csr.shape)
        ms, lifted = library_ms(lib, torch.float32, x, ref)
        note = f"{note}; {lifted} with the values lifted to f32" if ms is not None else note
    del lib
    return ms, note.replace("sparse_bsr_tensor", "sparse_csr_tensor")


def graph_replay_equal(op, x) -> bool:
    """One product of ``op`` captured into a CUDA graph (after an eager
    warm-up on the capture's stream) and replayed, against an eager product."""
    eager = op.matvec(x)
    xs = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        op.matvec(xs)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with cuda_spmv.launch_tally(), torch.cuda.graph(graph):
        ys = op.matvec(xs)
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(ys, eager))


def sigma_check_launches(res, per_column: bool) -> int:
    """The launches of the true-residual check closing a shift-invert ``eigs`` of
    SIGMA_K pairs, which applies A to the real and the imaginary part of a complex
    eigenvector block apart: one SpMV a column of each part (``per_column``: the
    row-compressed storage, or a closure with no matmat), else one SpMM a part."""
    complex_ = torch.as_tensor(res.eigenvectors).is_complex()  # host array or card tensor
    return (2 if complex_ else 1) * (SIGMA_K if per_column else 1)


def spmv_kernel_of(acc) -> str:
    """The SpMV kernel an accelerated symmetric operator's products launch."""
    return "csr_spmv" if acc.stats.get("storage") == "row_compressed" else "sym_bsr_spmv"


def check_kernel(name: str, case: str, op, x, peaks, plain_samples=(TIMED_LAUNCHES, 8)) -> dict:
    """One kernel on one operator: against its plain version, timed, bounded
    (``plain_samples``: samples and calls a sample of the plain version's
    time, fewer on the largest operators)."""
    is_sym = name == "sym_bsr_spmv"
    wrapper, plain = {"bsr_spmv": (cuda_spmv.bsr_spmv, cuda_spmv.bsr_spmv_plain),
                      "sym_bsr_spmv": (cuda_spmv.sym_bsr_spmv, cuda_spmv.sym_bsr_spmv_plain),
                      "csr_spmv": (cuda_spmv.csr_spmv, cuda_spmv.csr_spmv_plain)}[name]
    before = cuda_spmv.launch_counts()[name]
    y = wrapper(op, x)
    torch.cuda.synchronize()
    if cuda_spmv.launch_counts()[name] != before + 1:
        fail(f"{name}[{case}]: the wrapper did not count its launch")
    lifted = op.astype(torch.float32)
    ref = plain(lifted, x)
    del lifted
    abs_err = float((y - ref).abs().max())
    rel_err = float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref))
    if not (np.isfinite(rel_err) and rel_err <= KERNEL_REL_TOL):
        fail(f"{name}[{case}]: rel err {rel_err:.3e} against the plain version exceeds {KERNEL_REL_TOL}")
    out = dict(kernel=name, case=case, storage=str(op.dtype).replace("torch.", ""),
               max_rel_err=rel_err, max_abs_err=abs_err)
    y2 = wrapper(op, x)
    torch.cuda.synchronize()
    if not torch.equal(y, y2):
        fail(f"{name}[{case}]: two runs on the same input are not bit-equal")
    out["bit_equal_rerun"] = True
    out["kernel_ms"] = time_ms(lambda: wrapper(op, x))
    out["host_us_per_call"] = host_us_per_call(lambda: wrapper(op, x))
    out["plain_ms"] = time_ms(lambda: plain(op, x), count=plain_samples[0], batch=plain_samples[1])
    nbytes, flops = (sym_work(op) if is_sym else csr_work(op) if name == "csr_spmv"
                     else bsr_work(op))
    out["ops_unit"] = OPS_UNIT[name, out["storage"]]
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, peaks, out["ops_unit"])
    out["bytes"] = nbytes
    out["share_of_bound_rate"] = out["bound_ms"] / out["kernel_ms"]
    if is_sym:
        out["library_ms"], out["library"] = library_sym_ms(op, x)
        if out["library_ms"] is not None:
            out["library"] += " on the operator expanded to full storage (about twice the blocks)"
    elif name == "csr_spmv":
        out["library_ms"], out["library"] = library_csr_ms(op, x)
    else:
        out["library_ms"], out["library"] = library_bsr_ms(op, x)
    out["launches"] = cuda_spmv.launch_counts()[name] - before  # this check's own launches
    return out


def check_spmm(name: str, case: str, op, X, peaks) -> dict:
    """One SpMM kernel on one operator and one panel: through the container's
    ``matmat`` (the route the solvers take) against its plain version, timed,
    bounded.  ``case`` ends with the panel width as ``p=<width> ``."""
    is_sym = name == "sym_bsr_spmm"
    wrapper = cuda_spmv.sym_bsr_spmm if is_sym else cuda_spmv.bsr_spmm
    plain = cuda_spmv.sym_bsr_spmm_plain if is_sym else cuda_spmv.bsr_spmm_plain
    p = X.shape[1]
    before = cuda_spmv.launch_counts()[name]
    Y = op.matmat(X)
    torch.cuda.synchronize()
    if cuda_spmv.launch_counts()[name] != before + 1:
        fail(f"{name}[{case}]: matmat on CUDA tensors did not launch (and count) the kernel")
    lifted = op.astype(torch.float32)
    ref = plain(lifted, X)
    del lifted
    abs_err = float((Y - ref).abs().max())
    rel_err = float(torch.linalg.norm(Y - ref) / torch.linalg.norm(ref))
    if tuple(Y.shape) != (op.shape[0], p) or not (np.isfinite(rel_err) and rel_err <= KERNEL_REL_TOL):
        fail(f"{name}[{case}]: rel err {rel_err:.3e} against the plain version exceeds {KERNEL_REL_TOL}")
    # every column to the same limit: a norm over the panel hides a column of small norm
    col_err = float((torch.linalg.vector_norm(Y - ref, dim=0)
                     / torch.linalg.vector_norm(ref, dim=0)).max())
    if not (np.isfinite(col_err) and col_err <= KERNEL_REL_TOL):
        fail(f"{name}[{case}]: rel err {col_err:.3e} of the worst column exceeds {KERNEL_REL_TOL}")
    out = dict(kernel=name, case=case, storage=str(op.dtype).replace("torch.", ""), p=p,
               max_rel_err=rel_err, max_col_rel_err=col_err, max_abs_err=abs_err)

    def worst_column(other):
        diff = torch.linalg.vector_norm(Y.double() - other.double(), dim=0)
        return float((diff / torch.linalg.vector_norm(other.double(), dim=0)).max())

    # reported beside the limit: the same stored blocks and X multiplied in f64
    out["max_col_rel_err_f64"] = worst_column(plain(op.astype(torch.float64), X.double()))
    # the model the CPU tests hold to the f64 product is what the card computes
    model_err = worst_column(cuda_spmv.spmm_split_model(op, X))
    if not (np.isfinite(model_err) and model_err <= MODEL_REL_TOL):
        fail(f"{name}[{case}]: rel err {model_err:.3e} of the worst column against the model "
             f"of the split products exceeds {MODEL_REL_TOL}")
    out["max_col_rel_err_model"] = model_err
    if is_sym:
        Y2 = wrapper(op, X)
        torch.cuda.synchronize()
        if not torch.equal(Y, Y2):
            fail(f"{name}[{case}]: two runs on the same input are not bit-equal")
        out["bit_equal_rerun"] = True
    if p == 1:
        # one column is the matvec: held to the SpMV kernel as well
        spmv = cuda_spmv.sym_bsr_spmv if is_sym else cuda_spmv.bsr_spmv
        y = spmv(op, X[:, 0].contiguous())
        rel1 = float(torch.linalg.vector_norm(Y[:, 0] - y) / torch.linalg.vector_norm(y))
        if not rel1 <= KERNEL_REL_TOL:
            fail(f"{name}[{case}]: p=1 differs from the SpMV kernel by {rel1:.3e}")
        out["rel_err_vs_spmv_kernel"] = rel1
    del ref, Y
    out["kernel_ms"] = time_ms(lambda: wrapper(op, X))
    out["plain_ms"] = time_ms(lambda: plain(op, X), count=5, batch=4)
    out["ops_unit"] = OPS_UNIT[name, out["storage"]]
    if is_sym:
        nbytes, flops, scratch = sym_spmm_work(op, p)
        out["bound_ms_with_scratch"] = bound(nbytes + scratch, flops, peaks, out["ops_unit"])[0]
    else:
        nbytes, flops = bsr_spmm_work(op, p)
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, peaks, out["ops_unit"])
    out["bytes"], out["flops"] = nbytes, flops
    out["share_of_bound_rate"] = out["bound_ms"] / out["kernel_ms"]
    main_widths = ((MAIN_WIDTH, "float32"), (WINDOW_WIDTH, "bfloat16"), (DA_PANEL, "bfloat16"))
    if is_sym and (p, out["storage"]) in main_widths:
        out["library_ms"], out["library"] = library_sym_ms(op, X)
        if out["library_ms"] is not None:
            out["library"] += " on the operator expanded to full storage (about twice the blocks)"
    elif is_sym:
        out["library_ms"] = None
        out["library"] = "timed at the main-path widths only (f32 p=12, bf16 p=8 and 12)"
    else:
        out["library_ms"], out["library"] = library_bsr_ms(op, X)
    out["launches"] = cuda_spmv.launch_counts()[name] - before  # this check's own launches
    return out


def profile_solve(fn) -> dict:
    """One solve under ``torch.profiler``, reduced by the benchmark's reducer
    (``eigbench/devtrace.py``): wall time under the profiler, the time the
    device was busy (the union of its events' intervals), the device
    operations that took most of it, and the longest idle gaps, each named
    by the innermost program span or torch operation running in it.  The
    idle share is left out: busy over this wall counts the profiler's own
    host time as idle (the benchmark's ``device_idle`` divides by unprofiled
    walls)."""
    from eigbench import devtrace

    profiled = devtrace.profile(fn)
    out = dict(iterations=profiled["solve"].iterations,
               wall_ms_under_profiler=profiled["window_s"] * 1e3,
               device_busy_ms=profiled["busy_s"] * 1e3,
               top_device_events=profiled["breakdown"]["device_ops"],
               idle_gaps=profiled["breakdown"]["idle_gaps"])
    if profiled["busy_s"] <= 0:
        out["note"] = "the profiler recorded no device time on this machine"
    return out


def profile_product(op, X, calls: int = 40) -> dict:
    """One product under ``torch.profiler``, ``matvec`` for a vector X and
    ``matmat`` for a panel: the device time of each of its kernels apart
    (pass 1 and pass 2 of an SpMM), which CUDA events around a launch cannot
    tell from the gaps between them; beside it the events' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    product = op.matvec if X.ndim == 1 else op.matmat
    ms = time_ms(lambda: product(X))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            product(X)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            kernels[e.key[:80]] = us / max(e.count, 1)
    return dict(storage=str(op.dtype).replace("torch.", ""), p=1 if X.ndim == 1 else X.shape[1],
                ms_by_events=ms,
                us_a_launch_by_kernel=kernels, us_a_product=sum(kernels.values()))


#: phase chunk_graphs: what one graph run of each case should make, written before the
#: first run on the card: keys = distinct (k_start, num_steps, ...) of the solve's chunks,
#: captures = the keys seen twice or more (each is warmed up once, then captured)
GRAPH_PREDICTION = {
    "eigsh_banded": dict(keys=2, captures=1),  # (0, 64), then (12, 52) at each of 4 restarts
    "eigsh_accelerated": dict(keys=1, captures=0),  # one chunk of 64 steps: converged there
    "eigs_accelerated": dict(keys="2-3", captures="1-2"),  # (0, 48), (12, 36), (11, 37)
    "eigs_sigma": dict(keys="2-4", captures=1),  # the outer solve's 1-3 (a closure: eager),
                                                 # and GMRES(48)'s (0, 48) on the shifted pack
    "eigs_accelerated_block": dict(keys="2-3", captures="1-2"),  # as eigs_accelerated
    "eigs_sigma_block": dict(keys="2-4", captures=1),  # as eigs_sigma
    "heisenberg_l24": dict(keys=1, captures=0),  # one chunk of 160 steps
}
GRAPH_ROUTES = ("eager", "graphs", "graphs", "eager")  # the runs of a case, in turns


def host_array(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def chunk_graphs_case(case: str, solve, matvecs_of, launches_of, replaying: bool) -> dict:
    """Phase chunk_graphs, one case: ``solve()`` run eagerly (``eager_chunks``) and
    with graphs in turns, each run timed from a synchronised start to a synchronised
    end, with its matvecs, its launches (= ``launches_of(res)``, else the phase
    fails), the graph counts, the bytes the captures added and the device peak;
    every run's eigenvalues and eigenvectors against the first eager run's, bit for
    bit (else the phase fails).  ``replaying``: a case whose graph runs must capture
    and replay (its solve repeats a key), else the phase fails."""
    runs, first = [], None
    t_case = time.time()
    for route in GRAPH_ROUTES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chunk_graph.reset_graph_counts()
        cuda_spmv.reset_launch_counts()
        with chunk_graph.eager_chunks() if route == "eager" else contextlib.nullcontext():
            t0 = time.time()
            res = solve()
            torch.cuda.synchronize()
            seconds = time.time() - t0
        counts = chunk_graph.graph_counts()
        launches = cuda_spmv.launch_counts()
        matvecs = matvecs_of(res)
        values, vectors = host_array(res.eigenvalues), host_array(res.eigenvectors)
        if first is None:
            first = (values, vectors)
        same = bool(np.array_equal(values, first[0]) and np.array_equal(vectors, first[1]))
        runs.append(dict(route=route, seconds=seconds, matvecs=matvecs,
                         ms_per_matvec=seconds * 1e3 / max(matvecs, 1),
                         graphs_captured=counts["captures"], replays=counts["replays"],
                         keys=counts["keys"], warmups=counts["warmups"],
                         eager_chunks=counts["eager"], capture_ms=counts["capture_ms"],
                         pool_bytes=counts["pool_bytes"],
                         peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         launches={k: v for k, v in launches.items() if v},
                         bit_equal_to_first_eager=same))
        if launches != launches_of(res):
            fail(f"chunk_graphs {case} ({route}): launches {launches}, expected {launches_of(res)}")
        if not same:
            fail(f"chunk_graphs {case} ({route}): eigenvalues or eigenvectors differ from the "
                 "first eager run's")
        if route == "eager" and counts["captures"] + counts["replays"] + counts["warmups"]:
            fail(f"chunk_graphs {case}: eager_chunks() left graphs on: {counts}")
        if route == "graphs" and replaying and not (counts["captures"] and counts["replays"]):
            fail(f"chunk_graphs {case}: the graph run captured or replayed nothing: {counts}")
    out = dict(case=case, prediction=GRAPH_PREDICTION[case], runs=runs,
               seconds=time.time() - t_case)
    emit("chunk_graphs", **out)
    return out


def profile_calls(fn, calls: int = 50) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler``: wall ms and device
    busy ms a call, and the host events that took most of the host's time (self
    CPU time, the autograd engine's thread included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = prof.key_averages()
    device = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                 if e.device_type == DeviceType.CUDA)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU and e.key != "cudaDeviceSynchronize"),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return dict(calls=calls, wall_ms_a_call=wall_ms / calls, device_busy_ms_a_call=device / 1e3 / calls,
                top_host_events=[dict(name=e.key[:80], calls=e.count,
                                      self_cpu_us_a_call=e.self_cpu_time_total / calls)
                                 for e in host[:12]])


def residuals(matvec, lam, X) -> list[float]:
    """||A x - lambda x|| / |lambda| per column, A applied by ``matvec``."""
    out = []
    for j, l in enumerate(lam):
        x = X[:, j].contiguous()
        r = matvec(x) - float(l) * x
        out.append(float(torch.linalg.vector_norm(r)) / abs(float(l)))
    return out


def block_residuals(matmat, lam, X) -> list[float]:
    """The same residuals with A applied to the whole block by ``matmat``."""
    lam_t = torch.as_tensor(np.asarray(lam), dtype=X.dtype, device=X.device)
    R = matmat(X.contiguous()) - X * lam_t[None, :]
    return (torch.linalg.vector_norm(R, dim=0) / lam_t.abs()).tolist()


def check_ritz_below(phase: str, ritz, eigenvalues, gap: float) -> None:
    """Ritz values of a symmetric operator against its eigenvalues, both
    ascending and matched from the top: the i-th largest Ritz value never
    exceeds the i-th largest eigenvalue (Cauchy interlacing; 1e-4 relative
    allowed for f32 rounding) and lies within ``gap`` relative below it."""
    ritz, eigenvalues = np.asarray(ritz, np.float64), np.asarray(eigenvalues, np.float64)
    ref = eigenvalues[len(eigenvalues) - len(ritz):]
    if not (np.isfinite(ritz).all() and np.all(ritz <= ref * (1 + 1e-4))
            and np.all(ritz >= ref * (1 - gap))):
        fail(f"{phase}: Ritz values {ritz.tolist()} against eigenvalues {ref.tolist()} (gap {gap})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the distributed layer: shards of one card
# ---------------------------------------------------------------------------
MESH_SHARDS = 4            # the 1-D mesh of the mesh phases: four shards of cuda:0
MESH_GRID = (2, 2)         # ... and the 2-D mesh of the panel grid
MESH_PANEL = 8             # panel width of the shard-local SpMM checks
MESH_EIG_REL = 1e-5        # mesh_modes: eigenvalues against the single-device eigsh, relative
L24_MESH_E0_LIMIT = 1e-10  # heisenberg_l24_mesh: E0 (same f64 Rayleigh step) against phase
                           # heisenberg_l24's and against the published value
MESH_FILTER_REL = 1e-4     # mesh_filters: window/range eigenvalues against the single device
MESH_RANGE_MOMENTS = 320   # ... and the KPM moments of its eigsh_range
LOBPCG_MESH_ITERS = 600    # ... and the cap of its LOBPCG pair, both run to tol 1e-5 (the CPU
                           # at this size: 230 and 225 iterations)
LOBPCG_MESH_REL = 1e-5     # ... their eigenvalues against each other, relative (CPU: 8.9e-7)
CONFIG5_LIMIT = 1e-9       # config5: 5a against the closed form, 5b against eigvalsh (f64)
CONFIG5_SHARDS = 8
CONFIG5A_STEPS = 8         # outer shift-invert Lanczos steps of 5a; the CI test runs 32, and 8
                           # already reach 2e-16 on the CPU: each step is a whole inner CG solve
                           # (about 600 iterations, 4 collectives each, of 8 shard threads), and
                           # 32 took 151 s on an H100


def card_mesh(dev, shards: int = MESH_SHARDS) -> Mesh:
    """A 1-D mesh of ``shards`` shards, all on the card ``dev``."""
    return make_mesh(devices=[dev] * shards)


def card_grid(dev, shape=MESH_GRID) -> Mesh:
    return Mesh(np.array([dev] * (shape[0] * shape[1]), dtype=object).reshape(shape),
                ("rows", "cols"))


def shard_pieces(mesh_op):
    """The per-shard containers behind a mesh operator (1-D or grid)."""
    held = mesh_op._params
    return (held.parts if hasattr(held, "parts") else held).pieces


def time_shard_parts(tag: str, mode: str, shard: int, parts, peaks, kernel_cases: list,
                     widths=(), spmv: bool = True, plain_samples=(TIMED_LAUNCHES, 8),
                     reverse: bool = False) -> None:
    """Every container of one shard, timed and bounded as the kernels of phase
    kernels are (``check_kernel``, and ``check_spmm`` at each of ``widths``),
    into ``kernel_cases`` under "mesh: <tag> <mode> <role> shard <s> ...": the
    shapes and storages a mesh phase gives the kernels, which MAIN_CASES
    matches to the phases it claims.  ``reverse``: the adjoint pieces the
    shard's reverse products built instead, as roles "<role>^H"."""
    pieces = ({f"{role}^H": c for role, c in parts.reverse_roles().items()} if reverse
              else parts.roles())
    for role, c in pieces.items():
        sym = isinstance(c, SymBSRMatrix)
        storage = "bf16" if c.dtype == torch.bfloat16 else "f32"
        shape = "x".join(map(str, (c.diag_data if sym else c.data).shape))
        case = f"mesh: {tag} {mode} {role} shard {shard} {shape} {storage}"
        if spmv:
            x = torch.randn(c.shape[1], device=c.device)
            kernel_cases.append(check_kernel("sym_bsr_spmv" if sym else "bsr_spmv", case, c, x,
                                             peaks, plain_samples))
        for w in widths:
            X = torch.randn((c.shape[1], w), device=c.device)
            kernel_cases.append(check_spmm("sym_bsr_spmm" if sym else "bsr_spmm",
                                           f"{case} p={w} ", c, X, peaks))


def rel_to(y, ref) -> float:
    """||y - ref|| / ||ref||, 0 when both are zero (an empty halo part)."""
    d = float(torch.linalg.vector_norm((y - ref).double()))
    r = float(torch.linalg.vector_norm(ref.double()))
    return d / r if r > 0 else (0.0 if d == 0 else float("inf"))


def col_rel_to(Y, ref) -> float:
    d = torch.linalg.vector_norm((Y - ref).double(), dim=0)
    r = torch.linalg.vector_norm(ref.double(), dim=0)
    ok = r > 0
    if not bool(ok.all()) and bool((d[~ok] != 0).any()):
        return float("inf")
    return float((d[ok] / r[ok]).max()) if bool(ok.any()) else 0.0


#: the shard whose containers are timed: one with both neighbours on the 1-D mesh
#: (its left and right parts hold blocks), a diagonal panel on the grid
TIMED_SHARD = {"grid": 0}
TIMED_SHARD_1D = 1


def mesh_kernels_phase(bsr32, pack, dev, gen, peaks, kernel_cases) -> None:
    """Every mode's split at 4 shards (and the 2x2 grid) of the f32 banded
    operator, its bf16 twin and the bf16 accelerated pack: every shard-local
    container's product (matvec and matmat) against its plain version, the
    SpMM also against the split model; the mesh product against the
    single-device one; sym_halo products re-run bit-equal; launches per
    shard and matvec.  One shard's containers of the operands the main
    path's mesh phases run (the f32 operator in every mode: mesh_modes, and
    its sym_halo matmat at 12 columns: LOBPCG; the bf16 pack's sym_halo
    matmat at 8: the window and range filters) are timed as the result
    line's cases of those phases."""
    mesh, grid = card_mesh(dev), card_grid(dev)
    operands = [("f32 full", bsr32, ("allgather", "colsplit", "halo", "sym_halo", "grid")),
                ("bf16 full", bsr32.astype(torch.bfloat16), ("allgather", "colsplit", "halo", "grid")),
                ("bf16 pack", pack, ("sym_halo",))]
    cases = []
    for tag, op, modes in operands:
        for mode in modes:
            before = torch.cuda.memory_allocated()
            t0 = time.time()
            mop = (mesh_operator_2d(op, grid) if mode == "grid"
                   else mesh_operator(op, mesh, matvec_mode=mode))
            torch.cuda.synchronize()
            split_s = time.time() - t0
            placed = torch.cuda.memory_allocated() - before
            worst_mv = worst_mm = worst_model = 0.0
            kinds = []
            for s, parts in enumerate(shard_pieces(mop)):
                for c in parts.roles().values():
                    kinds.append(type(c).__name__)
                    xs = torch.randn(c.shape[1], generator=gen, device=dev)
                    y, yp = c.matvec(xs), c._plain_matvec(xs)
                    worst_mv = max(worst_mv, rel_to(y, yp))
                    Xs = torch.randn((c.shape[1], MESH_PANEL), generator=gen, device=dev)
                    Y, Yp = c.matmat(Xs), c._plain_matmat(Xs)
                    worst_mm = max(worst_mm, col_rel_to(Y, Yp))
                    worst_model = max(worst_model, col_rel_to(Y.double(),
                                                              cuda_spmv.spmm_split_model(c, Xs)))
                    if isinstance(c, SymBSRMatrix) or mode == "sym_halo":
                        if not (torch.equal(y, c.matvec(xs)) and torch.equal(Y, c.matmat(Xs))):
                            fail(f"mesh_kernels [{tag} {mode}] shard {s}: re-run not bit-equal")
            if not worst_mv <= KERNEL_REL_TOL or not worst_mm <= KERNEL_REL_TOL:
                fail(f"mesh_kernels [{tag} {mode}]: shard products differ from the plain versions "
                     f"by {worst_mv:.3e} (SpMV) / {worst_mm:.3e} (SpMM, worst column)")
            if not worst_model <= MODEL_REL_TOL:
                fail(f"mesh_kernels [{tag} {mode}]: SpMM against the split model {worst_model:.3e}")
            timed = {"f32 full": (MAIN_WIDTH,) if mode == "sym_halo" else (),
                     "bf16 pack": (WINDOW_WIDTH,)}.get(tag)
            if timed is not None:
                shard = TIMED_SHARD.get(mode, TIMED_SHARD_1D)
                time_shard_parts(tag, mode, shard, shard_pieces(mop)[shard], peaks, kernel_cases,
                                 widths=timed, spmv=tag == "f32 full")
            # the mesh product against the one-device product of the same container
            n = op.shape[0]
            x = torch.randn(n, generator=gen, device=dev)
            X = torch.randn((n, MESH_PANEL), generator=gen, device=dev)
            cuda_spmv.reset_launch_counts()
            y = mop.matvec(x)
            torch.cuda.synchronize()
            per_matvec = cuda_spmv.launch_counts()
            cuda_spmv.reset_launch_counts()
            Y = mop.matmat(X)
            torch.cuda.synchronize()
            per_matmat = cuda_spmv.launch_counts()
            rel_mv, rel_mm = rel_to(y, op.matvec(x)), col_rel_to(Y, op.matmat(X))
            if not rel_mv <= KERNEL_REL_TOL or not rel_mm <= KERNEL_REL_TOL:
                fail(f"mesh_kernels [{tag} {mode}]: mesh product against one device {rel_mv:.3e} / "
                     f"{rel_mm:.3e}")
            bit_equal = None
            if mode == "sym_halo":
                bit_equal = bool(torch.equal(y, mop.matvec(x)) and torch.equal(Y, mop.matmat(X)))
                if not bit_equal:
                    fail(f"mesh_kernels [{tag} {mode}]: two mesh products are not bit-equal")
            shards = mesh.size if mode != "grid" else grid.size
            cases.append(dict(
                operand=tag, mode=mode, shards=shards, storage=str(op.dtype).replace("torch.", ""),
                split_seconds=split_s, placed_bytes=placed, containers_per_shard=len(kinds) // shards,
                container_kinds=sorted(set(kinds)), worst_spmv_rel_err=worst_mv,
                worst_spmm_col_rel_err=worst_mm, worst_spmm_col_rel_err_model=worst_model,
                mesh_vs_one_device_matvec=rel_mv, mesh_vs_one_device_matmat=rel_mm,
                launches_per_matvec={k: v for k, v in per_matvec.items() if v},
                launches_per_matmat={k: v for k, v in per_matmat.items() if v},
                launches_per_shard_per_matvec={k: v / shards for k, v in per_matvec.items() if v},
                bit_equal_rerun=bit_equal))
            del mop
            torch.cuda.empty_cache()
    emit("mesh_kernels", devices=f"{MESH_SHARDS} shards of {dev} (grid {MESH_GRID})",
         spmv_rel_tol=KERNEL_REL_TOL, spmm_col_rel_tol=KERNEL_REL_TOL, model_rel_tol=MODEL_REL_TOL,
         cases=cases)


def mesh_modes_phase(bsr32, sym32, banded_eigenvalues, banded_ms, drive, dev) -> dict:
    """eigsh(k=4, which="LA") on the n = 262,144 banded operator over a
    4-shard mesh of the card in each mode, and over a 2x2 mesh (the panel
    grid): eigenvalues against the single-device eigsh, true residuals, and
    launches = matvecs x shards x parts.  Returns the runs by mode and the
    host costs by shard count."""
    if banded_eigenvalues is None:
        res = eigsh(sym32, k=4, which="LA", tol=BANDED_TOL, max_restarts=400)
        banded_eigenvalues = np.asarray(res.eigenvalues, np.float64)
    mesh, grid = card_mesh(dev), card_grid(dev)
    runs = []
    # (mode, operand, mesh, launches a shard a matvec)
    plan = (("allgather", bsr32, mesh, {"bsr_spmv": 1}), ("colsplit", bsr32, mesh, {"bsr_spmv": 1}),
            ("halo", bsr32, mesh, {"bsr_spmv": 3}),
            ("sym_halo", sym32, mesh, {"sym_bsr_spmv": 1, "bsr_spmv": 2}),
            ("grid", bsr32, grid, {"bsr_spmv": 1}))
    for mode, op, m, per in plan:
        # the split and placement alone; the solve places its own, as a user's call
        # does, and its seconds include that
        t0 = time.time()
        placed = mesh_operator_2d(op, m) if mode == "grid" else place_on_mesh(op, m, matvec_mode=mode)
        torch.cuda.synchronize()
        place_s = time.time() - t0
        del placed
        res, seconds, counts = drive(
            f"mesh_modes_{mode}", op,
            lambda: eigsh(op, k=4, which="LA", tol=BANDED_TOL, max_restarts=400, mesh=m,
                          matvec_mode="allgather" if mode == "grid" else mode))
        lam = np.asarray(res.eigenvalues, np.float64)
        rr = residuals(sym32._plain_matvec, res.eigenvalues, res.eigenvectors)
        rel = float(np.max(np.abs(lam - banded_eigenvalues) / np.abs(banded_eigenvalues)))
        want = {k: 0 for k in cuda_spmv.KERNEL_SOURCES}
        want.update({k: res.iterations * m.size * v for k, v in per.items()})
        runs.append(dict(mode=mode, shards=m.size, storage=str(op.dtype).replace("torch.", ""),
                         converged=res.converged, matvecs=res.iterations, eigenvalues=lam.tolist(),
                         max_rel_err_vs_one_device=rel, rel_residuals=rr, launches=counts,
                         launches_expected=want, seconds=seconds, place_seconds=place_s,
                         ms_per_matvec=seconds * 1e3 / max(res.iterations, 1)))
        if not res.converged:
            fail(f"mesh_modes [{mode}]: not converged ({res.termination})")
        if not rel <= MESH_EIG_REL:
            fail(f"mesh_modes [{mode}]: eigenvalues {lam} against one device {banded_eigenvalues}")
        if not max(rr) <= BANDED_RESID_LIMIT:
            fail(f"mesh_modes [{mode}]: residual {max(rr):.3e} exceeds {BANDED_RESID_LIMIT}")
        if counts != want:
            fail(f"mesh_modes [{mode}]: launches {counts}, expected {want}")
    costs = mesh_host_costs(sym32, dev)
    emit("mesh_modes", n=sym32.shape[0], k=4, which="LA", tol=BANDED_TOL,
         eig_rel_limit=MESH_EIG_REL, resid_limit=BANDED_RESID_LIMIT,
         one_device_eigenvalues=banded_eigenvalues.tolist(), one_device_ms_per_matvec=banded_ms,
         runs=runs, by_shard_count=costs)
    return dict(runs={r["mode"]: r for r in runs}, by_shard_count=costs)


def mesh_host_costs(sym, dev, steps: int = 64) -> dict:
    """What a step costs by shard count on one card: wall ms of a distributed
    Arnoldi step (sym_halo, ``steps`` steps from a fresh state, synchronised
    at the end) beside the one-device step, and the wall µs of a psum of 4 KB
    and of an empty shard_map call.  At this size a step is host-bound."""
    op = sym.as_linear_operator()
    out = {}
    arnoldi_steps(op, init_arnoldi_state(op, steps, seed=0), 8)
    torch.cuda.synchronize()
    t0 = time.time()
    arnoldi_steps(op, init_arnoldi_state(op, steps, seed=0), steps)
    torch.cuda.synchronize()
    out["one_device_ms_per_step"] = (time.time() - t0) / steps * 1e3
    for shards in (1, 2, 4, 8):
        mesh = card_mesh(dev, shards)
        placed = place_on_mesh(sym, mesh, matvec_mode="sym_halo")
        distributed_arnoldi_steps(sym, init_arnoldi_state(op, steps, seed=0), 8, mesh,
                                  matvec_mode="sym_halo", halo_parts=placed)
        torch.cuda.synchronize()
        t0 = time.time()
        distributed_arnoldi_steps(sym, init_arnoldi_state(op, steps, seed=0), steps, mesh,
                                  matvec_mode="sym_halo", halo_parts=placed)
        torch.cuda.synchronize()
        step_ms = (time.time() - t0) / steps * 1e3
        x = torch.ones(shards * 1024, device=dev)

        def psums(c, v, count=200):
            for _ in range(count):
                v = c.psum(v, "rows")
            return v

        run = shard_map(psums, mesh, (P("rows"),), P("rows"))
        run(x)
        torch.cuda.synchronize()
        t0 = time.time()
        run(x)
        torch.cuda.synchronize()
        psum_us = (time.time() - t0) / 200 * 1e6
        empty = shard_map(lambda c, v: v, mesh, (P("rows"),), P("rows"))
        empty(x)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(100):
            empty(x)
        torch.cuda.synchronize()
        out[f"shards_{shards}"] = dict(ms_per_step=step_ms, psum_us=psum_us,
                                       empty_shard_map_us=(time.time() - t0) / 100 * 1e6)
        del placed
    return out


MESH_ADJOINT_REL = 1e-5     # mesh_adjoint: each reverse product against the one-device A^H y, relative
MESH_ADJOINT_CALLS = 8      # ... reverse (and forward) products a mode, timed and counted
MESH_SI_RESID_FACTOR = 1.5  # ... (b): the mesh application's true residual within this factor of
                            # the one device's
#: launches of one reverse product on 4 shards (the 2x2 grid: 4 panels), by mode
MESH_ADJOINT_LAUNCHES = {"allgather": {"bsr_spmv": 4}, "colsplit": {"bsr_spmv": 4},
                         "grid": {"bsr_spmv": 4}, "halo": {"bsr_spmv": 12},
                         "sym_halo": {"sym_bsr_spmv": 4, "bsr_spmv": 8}}


def host_ms(fn, calls: int = MESH_ADJOINT_CALLS) -> float:
    """Wall ms of one call of ``fn``, synchronised, over ``calls`` calls after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) / calls * 1e3


def mesh_adjoint_phase(acc_cd, bsr32, drive, record, dev, peaks, kernel_cases) -> None:
    """Phase 35: the mesh operators' explicit adjoint, on 4 shards of the card.
    (a) Each mode's reverse product (``rmatvec``): allgather, colsplit and the
    2x2 panel grid on the config-2 pack of phase 11 (f32, 32x128 blocks; its
    block columns padded to a multiple of 4), halo and sym_halo on the f32
    banded operator of phase 4 (the two modes need square blocks; that
    operator is symmetric, A^T = A), each against
    the one-device A^H y (the pack's ``kernel_adjoint()``), its ms beside the
    mode's matvec, its launches a shard piece counted from 0 over
    MESH_ADJOINT_CALLS calls (a main path: the result line gives them to the
    reverse pieces of one shard, timed here at their shapes; sym_halo's
    reverse product is its forward one).  (b) One application of the mesh
    shift-invert operator of the config-2 pack at DA_SIGMA in allgather,
    where GMRES stagnates and CGLS takes the reverse products, against the
    same application on one device: fallbacks, CGLS iterations and true
    residuals (a comparison: its launches, forward and reverse pieces in a
    ratio the data sets, are printed in this line only).  (c) The allgather
    reverse product on 2 processes x 2 shards of the card, bit-equal to the
    one-process mesh of 4 shards."""
    from eigenex_tpu_torch.parallel.multiproc import save_operator, scenario_reverse, spawn

    t_phase = time.time()
    pack = acc_cd.block_matrix()
    cd_adj = pack.kernel_adjoint()  # cached since phase kernels
    n_cd = pack.shape[0]
    # colsplit and the grid split the 781 block columns of 128 over the shards: the pack
    # padded (zero block rows of 32, and as many columns) to 784, as pad_bsr_for_mesh does
    bm, bn = pack.block_shape
    padded = pad_bsr_for_mesh(pack, MESH_SHARDS * bn // bm)
    mesh, grid = card_mesh(dev), card_grid(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    plan = (("allgather", "config-2 f32", padded, mesh), ("colsplit", "config-2 f32", padded, mesh),
            ("grid", "config-2 f32", padded, grid), ("halo", "f32 full", bsr32, mesh),
            ("sym_halo", "f32 full", bsr32, mesh))
    modes = []
    for mode, tag, op, m in plan:
        mop = mesh_operator_2d(op, m) if mode == "grid" else mesh_operator(op, m, matvec_mode=mode)
        y = torch.randn(op.shape[0], generator=gen, device=dev)
        t0 = time.time()
        x = mop.rmatvec(y)  # builds the reverse pieces of every shard
        torch.cuda.synchronize()
        first_s = time.time() - t0
        if op is bsr32:
            ref = bsr32.matvec(y)  # A^H = A
        else:
            ref = torch.zeros_like(x)
            ref[:n_cd] = cd_adj.matvec(y[:n_cd].contiguous())
        rel = rel_to(x, ref)
        bit_equal = bool(torch.equal(x, mop.rmatvec(y)))
        _, seconds, counts = drive(f"mesh_adjoint_{mode}", op,
                                   lambda: [mop.rmatvec(y) for _ in range(MESH_ADJOINT_CALLS)])
        want = {k: MESH_ADJOINT_CALLS * MESH_ADJOINT_LAUNCHES[mode].get(k, 0)
                for k in cuda_spmv.KERNEL_SOURCES}
        shard = TIMED_SHARD.get(mode, TIMED_SHARD_1D)
        parts = shard_pieces(mop)[shard]
        if mode != "sym_halo":  # its pieces are the forward ones, timed by phase mesh_kernels
            time_shard_parts(tag, mode, shard, parts, peaks, kernel_cases, reverse=True)
        modes.append(dict(
            mode=mode, operand=tag, shape=list(op.shape), pack=list(op.data.shape),
            shards=m.size, rel_err_vs_one_device=rel, rel_limit=MESH_ADJOINT_REL,
            bit_equal_rerun=bit_equal, first_call_seconds=first_s,
            ms_per_rmatvec=seconds * 1e3 / MESH_ADJOINT_CALLS,
            ms_per_matvec=host_ms(lambda: mop.matvec(y)),
            reverse_pieces={role: list(c.data.shape) for role, c in parts.reverse_roles().items()},
            launches=counts, launches_expected=want,
            launches_per_shard_per_rmatvec={k: v / (MESH_ADJOINT_CALLS * m.size)
                                            for k, v in counts.items() if v}))
        if not (rel <= MESH_ADJOINT_REL and bit_equal):
            fail(f"mesh_adjoint [{mode}]: reverse product against one device {rel:.3e} "
                 f"(limit {MESH_ADJOINT_REL}), re-run bit-equal {bit_equal}")
        if counts != want:
            fail(f"mesh_adjoint [{mode}]: launches {counts}, expected {want}")
        del mop, x, y, ref
    torch.cuda.empty_cache()

    # (b) one application of the interior-sigma shift-invert, on the mesh and on one device
    v = acc_cd.embed(np.random.default_rng(SEED + 35).standard_normal(acc_cd.orig_shape[1]))
    r_cd, c_cd, v_cd, n = convection_diffusion_coo(CD_NX)
    A64 = sp.csr_matrix((v_cd, (r_cd, c_cd)), shape=(n, n))
    x_host = acc_cd.restore(v).astype(np.float64)
    si_runs = {}
    for where, op in (("one_device", pack),
                      ("mesh", mesh_operator(pack, mesh, matvec_mode="allgather"))):
        si = shift_invert_operator_general(op, DA_SIGMA, tol=SIGMA_INNER_TOL)
        cuda_spmv.reset_launch_counts()
        t0 = time.time()
        y = si.matvec(v)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        yh = acc_cd.restore(y).astype(np.float64)
        resid = float(np.linalg.norm(A64 @ yh - DA_SIGMA * yh - x_host) / np.linalg.norm(x_host))
        si_runs[where] = dict(stats=dict(si.stats), true_residual=resid, seconds=seconds,
                              launches=cuda_spmv.launch_counts())
    one, on_mesh = si_runs["one_device"], si_runs["mesh"]

    # (c) the allgather reverse product across processes, against the one-process mesh
    with tempfile.TemporaryDirectory(dir=MP_WORK) as work:
        spec = dict(kind="npz", path=str(Path(work) / "config2_pack.npz"))
        save_operator(spec["path"], padded)  # the shapes of (a)'s allgather pieces
        t0 = time.time()
        got = spawn("reverse", 2, [str(dev)] * 2,
                    dict(operator=spec, modes=["allgather"], seed=SEED, calls=MESH_ADJOINT_CALLS),
                    timeout=MP_TIMEOUT, threads=worker_threads(2))
        spawn_s = time.time() - t0
        here = scenario_reverse(card_mesh(dev), spec, ["allgather"], seed=SEED)["allgather"]
    mp_counts = sum_launches([g["allgather"] for g in got])
    record("mesh_adjoint_multiprocess", "float32", mp_counts)
    mp_equal = all(g["allgather"]["digest"] == here["digest"] for g in got)
    mp_want = {k: MESH_ADJOINT_CALLS * MESH_ADJOINT_LAUNCHES["allgather"].get(k, 0)
               for k in cuda_spmv.KERNEL_SOURCES}
    emit("mesh_adjoint", devices=f"{MESH_SHARDS} shards of {dev} (grid {MESH_GRID})", modes=modes,
         shift_invert=dict(sigma=DA_SIGMA, tol=SIGMA_INNER_TOL, mode="allgather", **si_runs,
                           resid_factor_limit=MESH_SI_RESID_FACTOR),
         multiprocess=dict(processes=2, shards_per_process=2, mode="allgather",
                           bit_equal_to_one_process_mesh=mp_equal,
                           digest=here["digest"], norm=here["norm"],
                           ms_per_rmatvec=[g["allgather"]["seconds"] * 1e3 / MESH_ADJOINT_CALLS
                                           for g in got],
                           spawn_wall_seconds=spawn_s, launches=mp_counts,
                           launches_expected=mp_want, backend=got[0]["backend"]),
         seconds=time.time() - t_phase)
    same = {k: one["stats"][k] for k in ("fallbacks", "iterations")} == \
        {k: on_mesh["stats"][k] for k in ("fallbacks", "iterations")}
    if not (same and one["stats"]["fallbacks"] == 1 and on_mesh["stats"]["adjoint_forwards"] == 0):
        fail(f"mesh_adjoint: shift-invert on the mesh {on_mesh['stats']} against one device "
             f"{one['stats']}: expected the same single CGLS fallback and iterations")
    if not (np.isfinite(on_mesh["true_residual"])
            and on_mesh["true_residual"] <= MESH_SI_RESID_FACTOR * one["true_residual"]):
        fail(f"mesh_adjoint: shift-invert true residual {on_mesh['true_residual']:.3e} on the mesh, "
             f"{one['true_residual']:.3e} on one device (factor limit {MESH_SI_RESID_FACTOR})")
    if not mp_equal or mp_counts != mp_want:
        fail(f"mesh_adjoint: across processes bit-equal {mp_equal}, launches {mp_counts} "
             f"(expected {mp_want})")


def heisenberg_l24_mesh_phase(acc24, triplets, e0_one, solve_one, drive, dev, peaks,
                              kernel_cases) -> dict:
    """BASELINE config 3 at L = 24 through the config-5b composition: the
    pack of phase heisenberg_l24 (not rebuilt) row-partitioned over four
    shards of the card on the sym_halo ring, the same f64 Rayleigh step,
    E0 held to phase heisenberg_l24's and to the published value.  Before
    the solve, the split it runs: every shard's containers (the in-panel
    half-stored pack, the boundary blocks and their adjoint) against their
    plain versions and re-run bit-equal, and one shard's timed as the
    result line's cases of this phase."""
    r, c, v, dim = triplets
    sym24 = acc24.matrix
    mesh = card_mesh(dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    mop = mesh_operator(sym24, mesh, matvec_mode="sym_halo")
    torch.cuda.synchronize()
    split_s = time.time() - t0
    split_bytes = torch.cuda.memory_allocated() - before
    split_peak = torch.cuda.max_memory_allocated() - before
    gen = torch.Generator(device=dev).manual_seed(SEED + L24)
    pieces = []
    for s, parts in enumerate(shard_pieces(mop)):
        for role, piece in parts.roles().items():
            xs = torch.randn(piece.shape[1], generator=gen, device=dev)
            y = piece.matvec(xs)
            err = rel_to(y, piece._plain_matvec(xs))
            bit_equal = bool(torch.equal(y, piece.matvec(xs)))
            pieces.append(dict(shard=s, role=role, kind=type(piece).__name__,
                               shape=list(piece.shape), rel_err=err, bit_equal_rerun=bit_equal))
            if not (err <= KERNEL_REL_TOL and bit_equal):
                fail(f"heisenberg_l24_mesh: shard {s} {role} against its plain version {err:.3e} "
                     f"(limit {KERNEL_REL_TOL}), re-run bit-equal {bit_equal}")
    time_shard_parts(f"L={L24}", "sym_halo", TIMED_SHARD_1D, shard_pieces(mop)[TIMED_SHARD_1D],
                     peaks, kernel_cases, plain_samples=(5, 4))
    del mop, y, xs
    torch.cuda.empty_cache()
    # the solve places its own split, as a user's call does: its seconds include it
    res, seconds, counts = drive("heisenberg_l24_mesh", sym24,
                                 lambda: eigsh(acc24, mesh=mesh, **L24_SOLVE))
    peak = torch.cuda.max_memory_allocated()
    # the same call again, outside the counted run: the caching allocator now holds
    # the blocks the first call's split took from the device
    t0 = time.time()
    eigsh(acc24, mesh=mesh, **L24_SOLVE)
    torch.cuda.synchronize()
    seconds_again = time.time() - t0
    t0 = time.time()
    lam, resid = rayleigh_refine(coo_from_numpy(r, c, v, (dim, dim), device="cpu"),
                                 res.eigenvectors)
    refine_s = time.time() - t0
    e0, rel_resid = float(lam[0]), float(resid[0] / abs(lam[0]))
    matvecs = res.iterations
    want = {k: 0 for k in cuda_spmv.KERNEL_SOURCES}
    want.update(sym_bsr_spmv=matvecs * mesh.size, bsr_spmv=2 * matvecs * mesh.size)
    emit("heisenberg_l24_mesh", L=L24, sector_dim=dim, shards=mesh.size, mode="sym_halo",
         options=L24_SOLVE, converged=res.converged, termination=res.termination, matvecs=matvecs,
         e0_f32=float(res.eigenvalues[0]), seconds=seconds,
         ms_per_matvec=seconds * 1e3 / max(matvecs, 1), seconds_second_call=seconds_again,
         one_device_seconds=solve_one["seconds"], one_device_ms_per_matvec=solve_one["ms_per_matvec"],
         one_device_matvecs=solve_one["matvecs"], split_seconds=split_s,
         split_gib=split_bytes / 2 ** 30, split_peak_gib=split_peak / 2 ** 30,
         pack_gib=acc24.stats["bytes"] / 2 ** 30, peak_device_gib=peak / 2 ** 30,
         shard_pieces=pieces, piece_rel_tol=KERNEL_REL_TOL,
         launches=counts, sym_bsr_spmv_launches=counts["sym_bsr_spmv"],
         boundary_bsr_spmv_launches=counts["bsr_spmv"], launches_expected=want,
         refine_seconds=refine_s, e0_f64=e0, e0_one_device=e0_one, e0_published=L24_E0,
         e0_diff_one_device=abs(e0 - e0_one), e0_abs_err=abs(e0 - L24_E0),
         e0_limit=L24_MESH_E0_LIMIT, rel_residual_f64=rel_resid, resid_limit=L24_RESID_LIMIT)
    if not res.converged:
        fail(f"heisenberg_l24_mesh: not converged ({res.termination})")
    if counts != want:
        fail(f"heisenberg_l24_mesh: launches {counts}, expected {want}")
    if not (abs(e0 - e0_one) <= L24_MESH_E0_LIMIT and abs(e0 - L24_E0) <= L24_MESH_E0_LIMIT):
        fail(f"heisenberg_l24_mesh: E0 {e0!r} against one device {e0_one!r} and the published "
             f"{L24_E0}: beyond {L24_MESH_E0_LIMIT}")
    if not rel_resid <= L24_RESID_LIMIT:
        fail(f"heisenberg_l24_mesh: residual {rel_resid:.3e} exceeds {L24_RESID_LIMIT}")
    return dict(e0_f32=float(res.eigenvalues[0]), e0_f64=e0, matvecs=matvecs, seconds=seconds,
                ms_per_matvec=seconds * 1e3 / max(matvecs, 1))


def mesh_general_phase(drive, dev) -> None:
    """eigs(mesh=) (Krylov-Schur) on the f32 general pack of the nx = 128
    stencil (``block_matrix()`` of its row-compressed storage) in allgather and
    colsplit, and on a 2x4 mesh (the panel grid), each held as the single-device
    eigs on the same pack is held, beside it; svds(mesh=) on config 4's matrix
    against numpy."""
    r, c, v, n = convection_diffusion_coo(SIGMA_NX)
    acc_s = accelerate(coo_on(r, c, v, n, dev))
    A64 = sp.csr_matrix((v, (r, c)), shape=(n, n))
    kw = dict(k=SIGMA_K, which="LM", tol=SIGMA_TOL, max_restarts=EIGS_MAX_RESTARTS)
    pack = acc_s.block_matrix()
    blocked = dataclasses.replace(acc_s, matrix=pack)
    one, seconds_one, counts_one = drive("mesh_general_one_device", pack,
                                         lambda: eigs(blocked, **kw))
    if counts_one != {k: (one.iterations if k == "bsr_spmv" else 0)
                      for k in cuda_spmv.KERNEL_SOURCES}:
        fail(f"mesh_general [one device]: launches {counts_one} for {one.iterations} matvecs")
    lam_one = np.asarray(one.eigenvalues, np.complex128)
    top = convection_diffusion_top(SIGMA_NX, SIGMA_K)
    re_max, im_max = convection_diffusion_range(SIGMA_NX)
    runs = []

    def held(tag, res, seconds, counts, restore):
        # the top of this operator's spectrum is ill-posed in f32 (PERF.md, phase
        # eigs_accelerated): two backward-stable solves part there by ~1e-3, so each
        # run is held as the single-device phase is -- converged, backward error,
        # inside the dominant strip -- and its distance from one device is reported
        lam = np.asarray(res.eigenvalues, np.complex128)
        X = np.asarray(restore(res.eigenvectors), np.complex128)
        rr = (np.linalg.norm(A64 @ X - X * lam[None, :], axis=0) / np.abs(lam)).tolist()
        key = lambda z: np.sort_complex(z.real + 1j * np.abs(z.imag))
        rel = float(np.max(np.abs(key(lam) - key(lam_one))) / np.abs(lam_one).max())
        in_strip = bool(np.all(lam.real >= top[0] - EIGS_BELOW_TOP) and np.all(lam.real <= re_max)
                        and np.all(np.abs(lam.imag) <= im_max))
        runs.append(dict(run=tag, converged=res.converged, matvecs=res.iterations,
                         eigenvalues_re=lam.real.tolist(), eigenvalues_im=lam.imag.tolist(),
                         rel_diff_from_one_device=rel, rel_residuals_f64_host=rr,
                         in_dominant_strip=in_strip, launches=counts, seconds=seconds,
                         ms_per_matvec=seconds * 1e3 / max(res.iterations, 1)))
        if not res.converged:
            fail(f"mesh_general [{tag}]: not converged ({res.termination})")
        if not max(rr) <= SIGMA_RESID_LIMIT or not in_strip:
            fail(f"mesh_general [{tag}]: eigenvalues {lam} (one device {lam_one}), residuals {rr}, "
                 f"in the dominant strip {in_strip}")

    for mode in ("allgather", "colsplit"):
        res, seconds, counts = drive(f"mesh_general_{mode}", acc_s.matrix,
                                     lambda: eigs(acc_s, mesh=card_mesh(dev), matvec_mode=mode, **kw))
        held(mode, res, seconds, counts, lambda V: V)
        if counts["bsr_spmv"] != res.iterations * MESH_SHARDS:
            fail(f"mesh_general [{mode}]: launches {counts} for {res.iterations} matvecs")
    # the 2x4 mesh: the single-controller Krylov-Schur over the panel-grid operator
    grid = card_grid(dev, (2, 4))
    res, seconds, counts = drive("mesh_general_grid", pack, lambda: eigs(pack, mesh=grid, **kw))
    held("grid 2x4", res, seconds, counts, lambda V: acc_s.restore(V))
    # svds(mesh=) on config 4's operator (f64: the plain route, as on one device)
    t4 = np.random.default_rng(SEED).standard_normal((6, 8, 7, 5)).reshape(48, 35)
    rows, cols = np.nonzero(t4)
    coo4 = COOMatrix(torch.as_tensor(rows.astype(np.int32)).to(dev),
                     torch.as_tensor(cols.astype(np.int32)).to(dev),
                     torch.as_tensor(t4[rows, cols]).to(dev), (48, 35))
    U, s4, Vh = svds(coo4, k=3, tol=1e-14, mesh=card_mesh(dev))
    s_np = np.linalg.svd(t4, compute_uv=False)[:3]
    err4 = float(np.max(np.abs(s4 - s_np)))
    emit("mesh_general", n=n, nx=SIGMA_NX, pack=list(pack.data.shape), storage="float32",
         shards=MESH_SHARDS, grid=[2, 4], k=SIGMA_K, which="LM", tol=SIGMA_TOL,
         one_device=dict(eigenvalues_re=lam_one.real.tolist(), eigenvalues_im=lam_one.imag.tolist(),
                         matvecs=one.iterations, launches=counts_one, seconds=seconds_one),
         resid_limit=SIGMA_RESID_LIMIT, below_top_limit=EIGS_BELOW_TOP, closed_form_top=top.tolist(),
         runs=runs, svds_config4=dict(
             singular_values=s4.tolist(), numpy=s_np.tolist(), max_abs_err=err4,
             limit=CONFIG4_ERR_LIMIT, device=str(U.device)))
    if not err4 <= CONFIG4_ERR_LIMIT:
        fail(f"mesh_general: svds(mesh=) error {err4:.3e} exceeds {CONFIG4_ERR_LIMIT}")


def mesh_filters_phase(acc, trip, sym32, window_ref, drive, dev) -> None:
    """eigsh_window(mesh=) and eigsh_range(mesh=) on the bf16 accelerated
    pack (sym_halo matmat: one sym_bsr_spmm a shard a product), held to the
    single-device window; DistributedLOBPCGSolver on the banded operator,
    held to LOBPCGSolver with the same start."""
    mesh = card_mesh(dev)
    A64 = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3]).tocsr()
    if window_ref is None:
        lam2 = eigsh(acc, k=2, which="LA", tol=ACCEL_TOL, seed=3, max_restarts=400).eigenvalues
        l1, l2 = float(lam2[0]), float(lam2[1])
        window = (l1 - 0.5 * (l2 - l1), l2 + 0.5 * (l2 - l1))
        one = eigsh_window(acc, window, block_size=8, degree=WINDOW_DEGREE, tol=WINDOW_TOL,
                           max_iterations=40, seed=4)
        window_ref = (window, np.asarray(one.eigenvalues, np.float64), None, one.iterations)
    window, lam_one, seconds_one, rounds_one = window_ref
    res, seconds, counts = drive("mesh_filters_window", acc.matrix, lambda: eigsh_window(
        acc, window, block_size=8, degree=WINDOW_DEGREE, tol=WINDOW_TOL, max_iterations=40,
        seed=4, mesh=mesh))
    lam_w = np.asarray(res.eigenvalues, np.float64)
    Xw = np.asarray(res.eigenvectors, np.float64)
    rr_w = (np.linalg.norm(A64 @ Xw - Xw * lam_w[None, :], axis=0) / np.abs(lam_w)).tolist()
    rel_w = float(np.max(np.abs(np.sort(lam_w) - np.sort(lam_one)) / np.abs(lam_one)))
    # KPM counts over this narrow top window need many moments: at 80 the count of its 3
    # eigenvalues comes out at 68 (11 slices), at 320 at 5 (one slice) on the CPU
    res_r, seconds_r, counts_r = drive("mesh_filters_range", acc.matrix, lambda: eigsh_range(
        acc, window, block_size=8, slack=2, degree=WINDOW_DEGREE, tol=WINDOW_TOL,
        max_iterations=40, n_moments=MESH_RANGE_MOMENTS, seed=4, mesh=mesh))
    lam_r = np.asarray(res_r.eigenvalues, np.float64)
    found = [bool(np.any(np.abs(lam_r - l) <= MESH_FILTER_REL * abs(l))) for l in lam_one]
    # LOBPCG: the same solver and start on one device and on the mesh, each run to
    # convergence: before it, two roundings of one iteration part where the Ritz
    # values still move (6.3e-5 at 60 iterations on an H100, 1.2e-3 at 20 on the CPU)
    opts = LOBPCGOptions(largest=True, tolerance=BANDED_TOL, max_iterations=LOBPCG_MESH_ITERS,
                         seed=SEED + 2)
    t0 = time.time()
    one_l = LOBPCGSolver(sym32.as_linear_operator(), opts, block_size=4).compute()
    torch.cuda.synchronize()
    seconds_one_l = time.time() - t0
    res_l, seconds_l, counts_l = drive("mesh_filters_lobpcg", sym32, lambda: DistributedLOBPCGSolver(
        sym32, mesh, opts, block_size=4).compute())
    rel_l = float(np.max(np.abs(np.asarray(res_l.eigenvalues) - np.asarray(one_l.eigenvalues))
                         / np.abs(np.asarray(one_l.eigenvalues))))
    rr_l = block_residuals(sym32._plain_matmat, res_l.eigenvalues, res_l.eigenvectors)
    emit("mesh_filters", shards=MESH_SHARDS, window=window, degree=WINDOW_DEGREE, tol=WINDOW_TOL,
         window_mesh=dict(eigenvalues=lam_w.tolist(), converged=res.converged, rounds=res.iterations,
                          rel_residuals_f64_host=rr_w, launches=counts, seconds=seconds),
         window_one_device=dict(eigenvalues=lam_one.tolist(), rounds=rounds_one, seconds=seconds_one),
         window_rel_err=rel_w, range_mesh=dict(eigenvalues=lam_r.tolist(), converged=res_r.converged,
                                               found_one_device=found, launches=counts_r,
                                               seconds=seconds_r),
         lobpcg=dict(eigenvalues_mesh=np.asarray(res_l.eigenvalues).tolist(),
                     eigenvalues_one_device=np.asarray(one_l.eigenvalues).tolist(),
                     converged=[res_l.converged, one_l.converged],
                     iterations=[res_l.iterations, one_l.iterations],
                     rel_diff_from_one_device=rel_l, rel_residuals=rr_l,
                     resid_limit=BANDED_RESID_LIMIT, launches=counts_l,
                     seconds=[seconds_l, seconds_one_l]), rel_limit=MESH_FILTER_REL,
         lobpcg_rel_limit=LOBPCG_MESH_REL)
    if not res.converged or not rel_w <= MESH_FILTER_REL or not max(rr_w) <= WINDOW_RESID_LIMIT:
        fail(f"mesh_filters: window {lam_w} against one device {lam_one} ({rel_w:.3e}), "
             f"residuals {rr_w}")
    if not all(found) or not res_r.converged:
        fail(f"mesh_filters: eigsh_range found {lam_r} (converged {res_r.converged}), "
             f"one device {lam_one}")
    if not (res_l.converged and one_l.converged):
        fail(f"mesh_filters: LOBPCG not converged in {LOBPCG_MESH_ITERS} iterations "
             f"(mesh {res_l.iterations}, one device {one_l.iterations})")
    if not rel_l <= LOBPCG_MESH_REL or not max(rr_l) <= BANDED_RESID_LIMIT:
        fail(f"mesh_filters: LOBPCG eigenvalues {res_l.eigenvalues} ({rel_l:.3e} from one device, "
             f"limit {LOBPCG_MESH_REL}), residuals {rr_l}")
    for tag, cnt in (("window", counts), ("range", counts_r)):
        if cnt["sym_bsr_spmm"] <= 0 or cnt["sym_bsr_spmm"] % MESH_SHARDS:
            fail(f"mesh_filters [{tag}]: launches {cnt}: one sym_bsr_spmm a shard a product")


def config5_phase(drive, dev) -> None:
    """BASELINE configs 5a and 5b at their CI sizes on an 8-shard mesh of
    the card, in f64 (the plain route, as on one device): 5a the halo
    shift-invert Lanczos of the n = 512 Laplacian against the closed form
    (``CONFIG5A_STEPS`` outer steps), 5b eigsh over the RCM + half-storage
    pack against eigvalsh."""
    mesh = card_mesh(dev, CONFIG5_SHARDS)
    n = 512
    ar = np.arange(n)
    rows = np.concatenate([ar, ar[:-1], ar[1:]])
    cols = np.concatenate([ar, ar[1:], ar[:-1]])
    vals = np.concatenate([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    bsr = pad_bsr_for_mesh(bsr_from_coo_arrays(rows, cols, vals, (n, n), (4, 4), device=dev),
                           CONFIG5_SHARDS)
    sigma = -1e-4
    t0 = time.time()
    state = init_lanczos_state(bsr.as_linear_operator(), CONFIG5A_STEPS, seed=0)
    state = distributed_lanczos_steps(bsr, state, CONFIG5A_STEPS, mesh, matvec_mode="halo",
                                      shift_invert_sigma=sigma, cg_tol=1e-13, cg_max_iters=3000)
    k = int(state.k)
    seconds_a = time.time() - t0
    theta = tridiagonal_eigh(state.alpha[:k].cpu().numpy(), state.beta[:k].cpu().numpy(),
                             eigvals_only=True)
    err_a = abs(sigma + 1.0 / theta[-1] - (2 - 2 * np.cos(np.pi / (n + 1))))
    # 5b: the packed operator row-partitioned in one call
    rng = np.random.default_rng(53)
    nb, bw = 1200, 64
    r = np.repeat(np.arange(nb), 4)
    c = r + rng.integers(1, bw, size=len(r))
    keep = c < nb
    r, c = r[keep], c[keep]
    v = np.round(rng.standard_normal(len(r)) * 8) / 8
    rr = np.concatenate([r, c, np.arange(nb)])
    cc = np.concatenate([c, r, np.arange(nb)])
    vv = np.concatenate([v, v, np.full(nb, 4.0)])
    shuf = rng.permutation(nb)
    trip = (shuf[rr], shuf[cc], vv, (nb, nb))
    acc = accelerate(trip, block=8, dtype=np.float64)
    res, seconds_b, counts = drive("config5b", acc.matrix,
                                   lambda: eigsh(acc, k=3, which="SA", tol=1e-10, mesh=mesh))
    dense = sp.coo_matrix((vv, (trip[0], trip[1])), shape=(nb, nb)).toarray()
    ev = np.sort(np.linalg.eigvalsh(dense))
    err_b = float(np.abs(np.asarray(res.eigenvalues) - ev[:3]).max())
    emit("config5", shards=CONFIG5_SHARDS, device=str(dev), limit=CONFIG5_LIMIT,
         config5a=dict(n=n, mode="halo", sigma=sigma, steps=k, cg_tol=1e-13, abs_err=err_a,
                       seconds=seconds_a, reduced="8 outer steps of the CI test's 32"),
         config5b=dict(n=nb, eigenvalues=np.asarray(res.eigenvalues).tolist(),
                       eigvalsh=ev[:3].tolist(), abs_err=err_b, matvecs=res.iterations,
                       seconds=seconds_b, launches=counts))
    if not err_a <= CONFIG5_LIMIT:
        fail(f"config5: 5a error {err_a:.3e} exceeds {CONFIG5_LIMIT}")
    if not err_b <= CONFIG5_LIMIT * max(np.abs(ev).max(), 1.0):
        fail(f"config5: 5b error {err_b:.3e} exceeds {CONFIG5_LIMIT}")
    if any(counts.values()):
        fail(f"config5: launches {counts}: f64 blocks take the plain route")


# ---------------------------------------------------------------------------
# the mesh across processes and the samples
# ---------------------------------------------------------------------------
MP_STEPS = 64              # multiprocess_banded: allgather Lanczos steps on 2 processes x 2 shards
MP_EIG_REL = 1e-7          # multiprocess_banded: eigenvalues against the one-device eigsh, relative
L24_MP_E0_LIMIT = 1e-12    # heisenberg_l24_multiprocess: E0 (same f64 Rayleigh step) against
                           # phase heisenberg_l24's
MP_TIMEOUT = 300.0         # seconds a spawn of workers may take (their start included)
L24_MP_TIMEOUT = 600.0
MP_WORK = Path(__file__).resolve().parent / "eigenex_tpu_torch" / "build"  # git-ignored


def worker_threads(nproc: int) -> int:
    """Intra-op threads of each of ``nproc`` workers: the host's cores shared
    out, so that their thread pools do not fight over them."""
    import os

    return max(1, (os.cpu_count() or 1) // nproc)


def sum_launches(results) -> dict:
    """The workers' own launch counts of their solve, summed over processes."""
    out = {k: 0 for k in cuda_spmv.KERNEL_SOURCES}
    for res in results:
        for k, c in res["launches"].items():
            out[k] += c
    return out


def replicated_equal(results, key) -> bool:
    return all(r[key] == results[0][key] for r in results[1:])


def multiprocess_banded_phase(bsr32, sym32, mesh_runs, banded_eigenvalues, record, dev,
                              work) -> None:
    """The two scenarios of tests/test_multiprocess.py at full width, on the
    banded operator of eigsh_banded, each process a worker of
    ``eigenex_tpu_torch.parallel.multiproc`` on the one card (gloo): allgather
    Lanczos steps on 2 processes x 2 shards, and eigsh in sym_halo on 4
    processes x 1 shard.  Replicated outputs bit-equal across processes and
    to the one-process mesh of 4 shards (the same steps here; the sym_halo
    run of mesh_modes), eigenvalues within MP_EIG_REL of the one-device
    eigsh, and launches = steps (matvecs) x shards x parts, summed from the
    workers' own counters."""
    from eigenex_tpu_torch.parallel.multiproc import psum_us, save_operator, scenario_steps, spawn

    bsr_path, sym_path = work / "banded_bsr.npz", work / "banded_sym.npz"
    save_operator(bsr_path, bsr32)
    save_operator(sym_path, sym32)
    steps_kw = dict(operator=dict(kind="npz", path=str(bsr_path)), steps=MP_STEPS,
                    max_subspace=MP_STEPS + 1, seed=SEED, matvec_mode="allgather")
    t0 = time.time()
    steps = spawn("steps", 2, [str(dev)] * 2, steps_kw, timeout=MP_TIMEOUT,
                  threads=worker_threads(2))
    steps_wall = time.time() - t0
    one = scenario_steps(card_mesh(dev), **steps_kw)
    counts_ag = sum_launches(steps)
    want_ag = {k: 0 for k in cuda_spmv.KERNEL_SOURCES}
    want_ag["bsr_spmv"] = MP_STEPS * MESH_SHARDS
    record("multiprocess_banded_allgather", "float32", counts_ag)
    steps_equal = replicated_equal(steps, "alpha") and replicated_equal(steps, "beta")
    steps_one = steps[0]["alpha"] == one["alpha"] and steps[0]["beta"] == one["beta"]

    solve = dict(k=4, which="LA", tol=BANDED_TOL, max_restarts=400, matvec_mode="sym_halo")
    t0 = time.time()
    sym = spawn("eigsh", MESH_SHARDS, [str(dev)],
                dict(operator=dict(kind="npz", path=str(sym_path)), solve=solve),
                timeout=MP_TIMEOUT, threads=worker_threads(MESH_SHARDS))
    sym_wall = time.time() - t0
    counts_sh = sum_launches(sym)
    matvecs = sym[0]["matvecs"]
    want_sh = {k: 0 for k in cuda_spmv.KERNEL_SOURCES}
    want_sh.update(sym_bsr_spmv=matvecs * MESH_SHARDS, bsr_spmv=2 * matvecs * MESH_SHARDS)
    record("multiprocess_banded_sym_halo", "float32", counts_sh)
    lam = np.asarray(sym[0]["eigenvalues"], np.float64)
    sym_equal = replicated_equal(sym, "eigenvalues") and replicated_equal(sym, "matvecs")
    one_mesh = mesh_runs.get("sym_halo") if mesh_runs else None
    if one_mesh is None:  # mesh_modes did not run: the same call on one process here
        res = eigsh(sym32, mesh=card_mesh(dev), **solve)
        one_mesh = dict(eigenvalues=np.asarray(res.eigenvalues, np.float64).tolist(),
                        matvecs=res.iterations, ms_per_matvec=None)
    sym_one = list(lam) == list(one_mesh["eigenvalues"]) and matvecs == one_mesh["matvecs"]
    rel = float(np.max(np.abs(lam - banded_eigenvalues) / np.abs(banded_eigenvalues)))
    psum_one = psum_us(card_mesh(dev))
    # the same processes' exchange with no card in it: a psum on CPU shards
    psum_cpu = spawn("psum", MESH_SHARDS, ["cpu"], {}, timeout=MP_TIMEOUT, threads=1)
    emit("multiprocess_banded", n=sym32.shape[0], backend=sym[0]["backend"],
         allgather=dict(processes=2, shards_per_process=2, steps=MP_STEPS,
                        bit_equal_across_processes=steps_equal,
                        bit_equal_to_one_process_mesh=steps_one, seconds=steps[0]["seconds"],
                        one_process_seconds=one["seconds"], spawn_wall_seconds=steps_wall,
                        launches=counts_ag, launches_expected=want_ag),
         sym_halo=dict(processes=MESH_SHARDS, shards_per_process=1, matvecs=matvecs,
                       worker_threads=worker_threads(MESH_SHARDS),
                       eigenvalues=lam.tolist(), bit_equal_across_processes=sym_equal,
                       bit_equal_to_one_process_mesh=sym_one,
                       max_rel_err_vs_one_device=rel, eig_rel_limit=MP_EIG_REL,
                       seconds=sym[0]["seconds"],
                       ms_per_matvec=sym[0]["seconds"] * 1e3 / max(matvecs, 1),
                       one_process_ms_per_matvec=one_mesh.get("ms_per_matvec"),
                       psum_us_across_processes=[r["psum_us"] for r in sym],
                       psum_us_across_processes_cpu_shards=[r["psum_us"] for r in psum_cpu],
                       psum_us_one_process=psum_one, spawn_wall_seconds=sym_wall,
                       kept_device_gib=[r.get("kept_gib") for r in sym],
                       host_peak_rss_gib=[r["host_peak_rss_gib"] for r in sym],
                       launches=counts_sh, launches_expected=want_sh))
    if not (steps_equal and steps_one):
        fail("multiprocess_banded: allgather steps differ across processes "
             f"({steps_equal}) or from the one-process mesh ({steps_one})")
    if counts_ag != want_ag or counts_sh != want_sh:
        fail(f"multiprocess_banded: launches {counts_ag} / {counts_sh}, expected "
             f"{want_ag} / {want_sh}")
    if not all(r["converged"] for r in sym) or not (sym_equal and sym_one):
        fail("multiprocess_banded: sym_halo eigsh not converged, or not bit-equal across "
             f"processes ({sym_equal}) and to the one-process mesh ({sym_one})")
    if not rel <= MP_EIG_REL:
        fail(f"multiprocess_banded: eigenvalues {lam} against one device {banded_eigenvalues}")


def l24_pack_for_workers(acc24, work: Path) -> dict:
    """The pack of phase heisenberg_l24 written once into ``work`` with
    ``AcceleratedOperator.save``, for the workers of
    heisenberg_l24_multiprocess to load (a full disk fails the phase), and
    its size on the card."""
    path = work / "l24_pack.npz"
    free = shutil.disk_usage(work).free
    t0 = time.time()
    acc24.save(str(path))
    return dict(disk_free_gib=free / 2 ** 30, save_seconds=time.time() - t0,
                pack_gib=acc24.stats["bytes"] / 2 ** 30, operator=dict(kind="accelerated", path=str(path)))


def heisenberg_l24_multiprocess_phase(pack, triplets, e0_one, solve_one, l24_mesh, record,
                                      dev, work) -> None:
    """BASELINE config 3 at L = 24 on 2 processes x 2 shards of the card
    (gloo): phase heisenberg_l24_mesh with the process boundary in the middle
    of the sym_halo ring.  The workers load the pack that
    :func:`l24_pack_for_workers` wrote into host memory (this process has
    freed its own copy) and place only their own shards, so that each
    process's device peak stays below the whole pack; rank 0 writes the
    Ritz vector, refined here by the same f64 Rayleigh step.  E0 within
    L24_MP_E0_LIMIT of heisenberg_l24's, bit-equal across processes and to
    heisenberg_l24_mesh's; launches summed from the workers' counters."""
    from eigenex_tpu_torch.parallel.multiproc import spawn

    r, c, v, dim = triplets
    operator = pack["operator"]
    vec_path = work / "l24_vector.npy"
    t0 = time.time()
    got = spawn("eigsh", 2, [str(dev)] * 2,
                dict(operator=operator, solve=L24_SOLVE, vectors_to=str(vec_path)),
                timeout=L24_MP_TIMEOUT, threads=worker_threads(2))
    wall = time.time() - t0
    psum_cpu = spawn("psum", 2, ["cpu"] * 2, {}, timeout=MP_TIMEOUT, threads=1)
    Path(operator["path"]).unlink()
    X = np.load(vec_path)
    vec_path.unlink()
    t0 = time.time()
    lam, resid = rayleigh_refine(coo_from_numpy(r, c, v, (dim, dim), device="cpu"), X)
    refine_s = time.time() - t0
    e0, rel_resid = float(lam[0]), float(resid[0] / abs(lam[0]))
    counts = sum_launches(got)
    matvecs = got[0]["matvecs"]
    want = {k: 0 for k in cuda_spmv.KERNEL_SOURCES}
    want.update(sym_bsr_spmv=MESH_SHARDS * matvecs, bsr_spmv=2 * MESH_SHARDS * matvecs)
    record("heisenberg_l24_multiprocess", "bfloat16", counts)
    e0_f32 = [res["eigenvalues"][0] for res in got]
    across = len(set(e0_f32)) == 1 and replicated_equal(got, "matvecs")
    same_as_mesh = None
    if l24_mesh is not None:
        same_as_mesh = (e0_f32[0] == l24_mesh["e0_f32"] and e0 == l24_mesh["e0_f64"]
                        and matvecs == l24_mesh["matvecs"])
    emit("heisenberg_l24_multiprocess", L=L24, sector_dim=dim, processes=2, shards_per_process=2,
         mode="sym_halo", backend=got[0]["backend"], operator=operator["kind"],
         pack_save_seconds=pack["save_seconds"], disk_free_gib=pack["disk_free_gib"],
         worker_threads=worker_threads(2), options=L24_SOLVE,
         converged=[res["converged"] for res in got], matvecs=matvecs,
         one_device_matvecs=solve_one["matvecs"], e0_f32=e0_f32, e0_f64=e0,
         e0_one_device=e0_one, e0_diff_one_device=abs(e0 - e0_one), e0_limit=L24_MP_E0_LIMIT,
         e0_published=L24_E0, rel_residual_f64=rel_resid, bit_equal_across_processes=across,
         bit_equal_to_one_process_mesh=same_as_mesh,
         seconds=[res["seconds"] for res in got],
         ms_per_matvec=got[0]["seconds"] * 1e3 / max(matvecs, 1),
         one_process_seconds=None if l24_mesh is None else l24_mesh["seconds"],
         one_process_ms_per_matvec=None if l24_mesh is None else l24_mesh["ms_per_matvec"],
         psum_us_across_processes=[res["psum_us"] for res in got],
         psum_us_across_processes_cpu_shards=[res["psum_us"] for res in psum_cpu],
         spawn_wall_seconds=wall, refine_seconds=refine_s,
         pack_device_gib=pack["pack_gib"], kept_device_gib=[res.get("kept_gib") for res in got],
         peak_device_gib=[res.get("peak_gib") for res in got],
         host_peak_rss_gib=[res["host_peak_rss_gib"] for res in got],
         launches=counts, sym_bsr_spmv_launches=counts["sym_bsr_spmv"],
         boundary_bsr_spmv_launches=counts["bsr_spmv"], launches_expected=want)
    if not all(res["converged"] for res in got):
        fail("heisenberg_l24_multiprocess: not converged")
    if not all(res["peak_gib"] < pack["pack_gib"] for res in got):
        fail(f"heisenberg_l24_multiprocess: a process's device peak "
             f"{[res['peak_gib'] for res in got]} GiB reaches the whole pack's "
             f"{pack['pack_gib']:.2f} GiB")
    if abs(matvecs - solve_one["matvecs"]) > L24_SOLVE["max_subspace"]:
        fail(f"heisenberg_l24_multiprocess: {matvecs} matvecs against {solve_one['matvecs']} "
             "on one device: more than a restart apart")
    if counts != want:
        fail(f"heisenberg_l24_multiprocess: launches {counts}, expected {want}")
    if not across or same_as_mesh is False:
        fail(f"heisenberg_l24_multiprocess: E0 {e0_f32} not bit-equal across processes "
             f"({across}) or to heisenberg_l24_mesh's ({same_as_mesh})")
    if not abs(e0 - e0_one) <= L24_MP_E0_LIMIT:
        fail(f"heisenberg_l24_multiprocess: E0 {e0!r} against heisenberg_l24's {e0_one!r}: "
             f"beyond {L24_MP_E0_LIMIT}")
    if not rel_resid <= L24_RESID_LIMIT:
        fail(f"heisenberg_l24_multiprocess: residual {rel_resid:.3e} exceeds {L24_RESID_LIMIT}")


EIG, F32 = 1e-10, 1e-6     # f64 eigenvalues; f32 iterations at the samples' tolerance of 1e-8
#: what each sample of eigenex_tpu_torch/samples, run on the card, is held to against its
#: CPU run: a tolerance on the numbers (relative to max(|x|, 1)), or "equal"; keys not
#: named are printed only
SAMPLE_HOLD = {
    "accelerate": dict(stats="equal", symmetric="equal", complexified="equal",
                       round_trip="equal", eigenvalues=F32, complex_eigenvalues=F32,
                       mesh_eigenvalues=F32, one_device_eigenvalues=F32),
    "arnoldi": dict(eigenvalues=EIG),
    "block_tensor": dict(e0=EIG, sector="equal", stored_blocks="equal", hpsi_sectors="equal",
                         rayleigh=EIG),
    "dtensor": dict(contract=1e-12, batched=1e-12, kron=1e-12, trace=1e-12, diag=1e-12,
                    sum=1e-12),
    "lanczos1": dict(eigenvalues=EIG, eigenvectors=1e-9),
    "lanczos2": dict(range=EIG, eigenvalues=EIG, oracle=EIG, converged="equal"),
    "lobpcg": dict(prec_eigenvalues=EIG, pencil_eigenvalues=1e-9, closed_form=0.0),
    "matrix_market": dict(nnz="equal", loaded_nnz="equal", triangle_nnz="equal",
                          eigenvalues=EIG),
    "product_indices": dict(dims="equal", size="equal", round_trips="equal",
                            merged_dims="equal", merged="equal"),
    "spectrum_slicing": dict(bounds=EIG, true_count="equal", count=1e-8, dos_integral=1e-8,
                             eigenvalues=EIG, mesh_eigenvalues=EIG),
    "tebd_ising": dict(energies=EIG, exact=EIG, bond_dims="equal"),
    "tfi": dict(even=EIG, odd=EIG, exact=EIG, even_dim="equal", odd_dim="equal"),
    "tpu_hybrid": dict(f32_eigenvalues=F32, rayleigh=1e-9, inverse_iteration=EIG, oracle=0.0),
}


def sample_diff(a, b) -> float:
    """max |a - b| / max(|b|, 1) over the numbers of two sample outputs."""
    if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], tuple):  # (labels, values)
        if a[0] != b[0]:
            return math.inf
        a, b = a[1], b[1]
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return math.inf
    if np.iscomplexobj(a) or np.iscomplexobj(b):  # conjugate pairs tie in |z|
        key = lambda z: (round(abs(z), 8), z.real, abs(z.imag))  # noqa: E731
        a, b = np.array(sorted(a.ravel(), key=key)), np.array(sorted(b.ravel(), key=key))
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))) if a.size else 0.0


def sample_accelerate_kernels(dev) -> dict:
    """The kernels of sample_accelerate at the shapes its card run gives
    them, each product against its plain version on the same inputs: the
    chain's pack and the complex ring's real embedding on one device, and
    every container of every shard of the chain's pack on the sample's
    sym_halo mesh.  These launches are comparisons, counted nowhere."""
    from eigenex_tpu_torch.samples import sample_accelerate as sa

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(0)  # the sample's own draws, in its order
    chain = accelerate(sa.chain_triplets(rng), device=dev)
    ring = accelerate(sa.ring_triplets(rng), device=dev)
    mesh = card_mesh(dev, sa.MESH_SHARDS)
    mop = mesh_operator(pad_bsr_for_mesh(chain.block_matrix(), mesh.size), mesh,
                        matvec_mode="sym_halo")
    containers = [("chain pack", chain.matrix), ("ring embedding pack", ring.matrix)] + [
        (f"chain pack sym_halo shard {s} {role}", c)
        for s, parts in enumerate(shard_pieces(mop)) for role, c in parts.roles().items()]
    out = {}
    for what, c in containers:
        x = torch.randn(c.shape[1], generator=gen, device=dev)
        if isinstance(c, SymCSRMatrix):
            shape, kernel = f"nnz={c.nnz}", "csr_spmv"
        else:
            shape = "x".join(map(str, (c.diag_data if isinstance(c, SymBSRMatrix) else c.data).shape))
            kernel = "sym_bsr_spmv" if isinstance(c, SymBSRMatrix) else "bsr_spmv"
        out[f"{kernel} {what} {shape} {str(c.dtype).replace('torch.', '')}"] = rel_to(
            c.matvec(x), c._plain_matvec(x))
    del mop
    return out


def launches_of(fn) -> dict:
    """The kernel launches of one call of ``fn``, by kernel (not main path)."""
    before = cuda_spmv.launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in cuda_spmv.launch_counts().items() if v - before[k]}


def derived_adjoint_phase(acc_cd, sym32, sigma_eigenvalues, drive, dev, gen, profile) -> None:
    """Phase 34: matrix-free operators with no adjoint, whose A^H comes from
    autograd through the kernels' backward (a launch of the same kernel).
    (a) A closure over each kernel at its main-path shape: the derived A^H x,
    and A^H X by a vjp of the closure's matmat, bit-equal to the explicit
    adjoint, with the time and launches of each.  (b) The interior-sigma
    shift-invert of the nx = 316 config-2 pack on a closure: every
    application falls back to CGLS on the derived adjoint, bit-equal to the
    same operator with the explicit adjoint.  (c) ``eigs(closure, sigma=)``
    as phase eigs_sigma runs its operand, from the same start.  ``profile``: a
    derived and an explicit A^H x on the config-2 pack, and 64 CGLS iterations
    on each route, under ``torch.profiler`` (phases ``profile_derived_adjoint``
    and ``profile_derived_adjoint_cgls``)."""
    t_phase = time.time()

    def closure(op, **kw):
        return LinearOperator(lambda p, v: p.matvec(v), op, op.shape, torch.float32, dev, **kw)

    # (a) each kernel, its derived adjoint against its explicit one
    cases = []
    for tag, op in (("config2_f32", acc_cd.block_matrix()),
                    ("config2_row_compressed_f32", acc_cd.matrix), ("banded_f32", sym32),
                    ("banded_bf16", sym32.astype(torch.bfloat16))):
        general = isinstance(op, (BSRMatrix, SymCSRMatrix))
        # the row-compressed storage has no SpMM: its products a column are SpMVs
        spmv, spmm = (("csr_spmv", None) if isinstance(op, SymCSRMatrix) else
                      ("bsr_spmv", "bsr_spmm") if general else ("sym_bsr_spmv", "sym_bsr_spmm"))
        adj = op.kernel_adjoint() if general else op  # A^H (cached); A^T = A for the symmetric pack
        mv = closure(op, matmat_fn=lambda p, X: p.matmat(X))
        x = torch.randn(op.shape[0], generator=gen, device=dev)
        G = torch.randn((op.shape[0], DA_PANEL), generator=gen, device=dev)
        explicit = {spmv: adj.matvec(x)}
        routes = {spmv: (lambda: mv.rmatvec(x), lambda: adj.matvec(x))}
        if spmm is not None:
            explicit[spmm] = adj.matmat(G)
            routes[spmm] = (lambda: pullback(mv.matmat, G, (op.shape[1], DA_PANEL), torch.float32),
                            lambda: adj.matmat(G))
        phase = "derived_adjoint_" + tag
        derived, _, counts = drive(phase, op, lambda: {k: r[0]() for k, r in routes.items()})
        if counts != {k: (2 if k in routes else 0) for k in cuda_spmv.KERNEL_SOURCES}:
            fail(f"{phase}: launches {counts}, expected a forward and a backward of {spmv} and {spmm}")
        for name, (run_derived, run_explicit) in routes.items():
            got = derived[name]
            if got.dtype != torch.float32 or got.requires_grad or not torch.equal(got, explicit[name]):
                fail(f"{phase}: the derived adjoint of {name} is not bit-equal to the explicit one")
            cases.append(dict(
                kernel=name, operator=tag, shape=list(op.shape),
                columns=DA_PANEL if name == spmm else 1, bit_equal=True,
                derived_ms=time_ms(run_derived), explicit_ms=time_ms(run_explicit),
                derived_host_us=host_us_per_call(run_derived, calls=20),
                explicit_host_us=host_us_per_call(run_explicit, calls=20),
                launches_derived=launches_of(run_derived),
                launches_explicit=launches_of(run_explicit)))
            if profile and name == "bsr_spmv":
                emit("profile_derived_adjoint", operator=tag, derived=profile_calls(run_derived),
                     explicit=profile_calls(run_explicit))
        del mv, explicit, derived, routes

    # (b) the interior-sigma shift-invert on a closure over the nx = 316 storage
    pack = acc_cd.matrix
    rng = np.random.default_rng(SEED + 34)
    xs = [rng.standard_normal(acc_cd.orig_shape[1]) for _ in range(DA_APPLICATIONS)]
    xe = [acc_cd.embed(v) for v in xs]
    si_e = shift_invert_operator_general(
        closure(pack, rmatvec_fn=lambda p, v: p.rmatvec(v)), DA_SIGMA, tol=SIGMA_INNER_TOL)
    si_d = shift_invert_operator_general(closure(pack), DA_SIGMA, tol=SIGMA_INNER_TOL)
    # the routes in turns, explicit first for even vectors and derived first for odd
    # ones (E D D E E D): the host's time drifts between runs by tens of percent
    y_e, y_d, ms_e, ms_d = [], [], [], []
    explicit_counts = dict.fromkeys(cuda_spmv.KERNEL_SOURCES, 0)
    counts = dict.fromkeys(cuda_spmv.KERNEL_SOURCES, 0)
    for i, v in enumerate(xe):
        for route in (("explicit", "derived") if i % 2 == 0 else ("derived", "explicit")):
            if route == "derived":
                y, seconds, got = drive(f"derived_adjoint_shift_invert_{i}", pack,
                                        lambda: si_d.matvec(v))
                y_d.append(y)
                ms_d.append(seconds * 1e3)
                counts = {k: counts[k] + got[k] for k in counts}
            else:
                cuda_spmv.reset_launch_counts()
                t0 = time.time()
                y_e.append(si_e.matvec(v))
                torch.cuda.synchronize()
                ms_e.append((time.time() - t0) * 1e3)
                explicit_counts = {k: explicit_counts[k] + c
                                   for k, c in cuda_spmv.launch_counts().items()}
    if profile:  # 64 CGLS iterations on (A - sigma I), its adjoint derived or explicit, in turns
        derived_op = closure(pack).shifted(-DA_SIGMA)
        explicit_op = closure(pack, rmatvec_fn=lambda p, v: p.rmatvec(v)).shifted(-DA_SIGMA)
        emit("profile_derived_adjoint_cgls", **{
            route: profile_calls(lambda: cgls_solve(shifted, xe[0], tol=0.0, max_iters=64), calls=3)
            for route, shifted in (("derived", derived_op), ("explicit", explicit_op),
                                   ("explicit_again", explicit_op), ("derived_again", derived_op))})
    r_cd, c_cd, v_cd, n_cd = convection_diffusion_coo(CD_NX)
    A64 = sp.csr_matrix((v_cd, (r_cd, c_cd)), shape=(n_cd, n_cd))

    def true_residual(x, y):
        y = acc_cd.restore(y).astype(np.float64)
        return float(np.linalg.norm(A64 @ y - DA_SIGMA * y - x) / np.linalg.norm(x))

    res_d = [true_residual(x, y) for x, y in zip(xs, y_d)]
    res_e = [true_residual(x, y) for x, y in zip(xs, y_e)]
    st_d, st_e = dict(si_d.stats), dict(si_e.stats)
    shift_invert = dict(
        n=n_cd, storage=acc_cd.stats["storage"], shape=list(pack.shape), sigma=DA_SIGMA,
        tol=SIGMA_INNER_TOL,
        applications=DA_APPLICATIONS, stats_derived=st_d, stats_explicit=st_e,
        cgls_iterations=st_d["iterations"], true_residuals_derived=res_d,
        true_residuals_explicit=res_e, bit_equal=all(torch.equal(a, b) for a, b in zip(y_d, y_e)),
        ms_per_application_derived=ms_d, ms_per_application_explicit=ms_e,
        launches_derived=counts, launches_explicit=explicit_counts)

    # (c) eigs(closure, sigma=) as phase eigs_sigma runs its accelerated operand
    r, c, v, n = convection_diffusion_coo(SIGMA_NX)
    acc_s = accelerate(coo_on(r, c, v, n, dev))
    solve = dict(k=SIGMA_K, sigma=SIGMA, tol=SIGMA_TOL, inner_tol=SIGMA_INNER_TOL)
    if sigma_eigenvalues is None:  # phase eigs_sigma did not run
        sigma_eigenvalues = np.asarray(eigs(acc_s, **solve).eigenvalues, np.complex128)
    op_s = closure(acc_s.matrix)
    v0 = _accelerated_v0(acc_s, None, 0)  # where eigs(acc_s) starts: seed 0
    res, seconds, counts_c = drive("derived_adjoint_eigs_sigma", acc_s.matrix,
                                   lambda: eigs(op_s, v0=v0, **solve))
    lam = np.asarray(res.eigenvalues, np.complex128)
    X = np.asarray(acc_s.restore(res.eigenvectors), np.complex128)
    A64s = sp.csr_matrix((v, (r, c)), shape=(n, n))
    rr = (np.linalg.norm(A64s @ X - X * lam[None, :], axis=0) / np.abs(lam)).tolist()
    st_c = res.inner_stats
    # the true-residual check applies the closure (no matmat) to each column of the
    # eigenvector block, real and imaginary parts apart when it is complex
    check = sigma_check_launches(res, per_column=True)
    want_c = {k: 0 for k in cuda_spmv.KERNEL_SOURCES}
    want_c["csr_spmv"] = st_c["matvecs"] + st_c["adjoint_forwards"] + check
    eigs_sigma = dict(n=n, sigma=SIGMA, eigenvalues_re=lam.real.tolist(),
                      eigenvalues_im=lam.imag.tolist(),
                      eigs_sigma_eigenvalues_re=sigma_eigenvalues.real.tolist(),
                      eigenvalues_bit_equal=bool(np.array_equal(lam, sigma_eigenvalues)),
                      rel_residuals_f64_host=rr, resid_limit=SIGMA_RESID_LIMIT,
                      converged=res.converged, termination=res.termination, inner_stats=dict(st_c),
                      launches=counts_c, seconds=seconds)
    emit("derived_adjoint", kernels=cases, shift_invert=shift_invert, eigs_sigma=eigs_sigma,
         seconds=time.time() - t_phase)

    if st_d["fallbacks"] != DA_APPLICATIONS or st_d["iterations"] <= 0:
        fail(f"derived_adjoint: {st_d['fallbacks']} CGLS fallbacks ({st_d['iterations']} "
             f"iterations) in {DA_APPLICATIONS} applications at sigma = {DA_SIGMA}")
    if not shift_invert["bit_equal"]:
        fail("derived_adjoint: the shift-invert results differ from the explicit adjoint's")
    if not all(np.isfinite(d) and d <= e for d, e in zip(res_d, res_e)):
        fail(f"derived_adjoint: true residuals {res_d} worse than the explicit route's {res_e}")
    if ({k: st_d[k] for k in ("matvecs", "iterations", "fallbacks")}
            != {k: st_e[k] for k in ("matvecs", "iterations", "fallbacks")}
            or st_e["adjoint_forwards"] != 0 or st_d["adjoint_forwards"] <= 0):
        fail(f"derived_adjoint: inner stats {st_d} against the explicit route's {st_e}")
    if counts != {**{k: 0 for k in cuda_spmv.KERNEL_SOURCES},
                  "csr_spmv": st_d["matvecs"] + st_d["adjoint_forwards"]}:
        fail(f"derived_adjoint: shift-invert launches {counts} for inner stats {st_d}")
    if res.termination == "inner_solve_failure" or not max(rr) <= SIGMA_RESID_LIMIT:
        fail(f"derived_adjoint: eigs on the closure: {res.termination}, residuals {rr}")
    if not eigs_sigma["eigenvalues_bit_equal"]:
        fail(f"derived_adjoint: eigs on the closure gave {lam}, phase eigs_sigma {sigma_eigenvalues}")
    if counts_c != want_c:
        fail(f"derived_adjoint: eigs on the closure launched {counts_c}, expected {want_c}")


def samples_phase(dev) -> None:
    """Every sample of eigenex_tpu_torch/samples on the card, each held to
    the same sample's CPU run here (SAMPLE_HOLD), with each card run's
    launches counted from 0 and printed in this phase's line; and the
    kernels of sample_accelerate, the one sample that launches any, held
    against their plain versions at its shapes.  The samples are not the
    main path: their launches stay out of the result line, whose cases are
    timed at the main path's shapes."""
    import io

    from eigenex_tpu_torch.samples import (sample_accelerate, sample_arnoldi, sample_block_tensor,
                                           sample_dtensor, sample_lanczos1, sample_lanczos2,
                                           sample_lobpcg, sample_matrix_market,
                                           sample_product_indices, sample_spectrum_slicing,
                                           sample_tebd_ising, sample_tfi, sample_tpu_hybrid)

    modules = dict(accelerate=sample_accelerate, arnoldi=sample_arnoldi,
                   block_tensor=sample_block_tensor, dtensor=sample_dtensor,
                   lanczos1=sample_lanczos1, lanczos2=sample_lanczos2, lobpcg=sample_lobpcg,
                   matrix_market=sample_matrix_market, product_indices=sample_product_indices,
                   spectrum_slicing=sample_spectrum_slicing, tebd_ising=sample_tebd_ising,
                   tfi=sample_tfi, tpu_hybrid=sample_tpu_hybrid)
    out = {}
    bad = []
    for name, mod in modules.items():
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.time()
            cpu = mod.main(device="cpu")
            cpu_s = time.time() - t0
            cuda_spmv.reset_launch_counts()
            t0 = time.time()
            card = mod.main(device=str(dev))
            torch.cuda.synchronize()
            card_s = time.time() - t0
        counts = cuda_spmv.launch_counts()
        held = {}
        for key, tol in SAMPLE_HOLD[name].items():
            if tol == "equal":
                ok = card[key] == cpu[key]
                held[key] = ok
            else:
                d = sample_diff(card[key], cpu[key])
                ok = d <= tol
                held[key] = dict(diff=d, tol=tol)
            if not ok:
                bad.append(f"{name}.{key}")
        out[name] = dict(card_seconds=card_s, cpu_seconds=cpu_s, held=held,
                         launches={k: c for k, c in counts.items() if c})
    kernels = sample_accelerate_kernels(dev)
    emit("samples", eig_tol=EIG, f32_tol=F32, samples=out,
         accelerate_kernels_rel_err=kernels, kernel_rel_tol=KERNEL_REL_TOL)
    if bad:
        fail(f"samples: the card's run differs from the CPU's in {bad}")
    wrong = {k: e for k, e in kernels.items() if not e <= KERNEL_REL_TOL}
    if wrong:
        fail(f"samples: sample_accelerate's kernels against their plain versions: {wrong}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="", help="comma-separated subset of phases to run")
    ap.add_argument("--profile", action="store_true",
                    help="repeat some of the solves under torch.profiler")
    args = ap.parse_args()
    only = {p for p in args.phases.split(",") if p}
    nbr = NBR

    def wanted(phase: str) -> bool:
        return not only or phase in only

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures on the card and does not fall back to the CPU")
    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mtx_dir = tempfile.TemporaryDirectory()  # the sector file of phases 18 and 23

    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is True: f32 products would run in TF32")
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         allow_tf32=False, peak_table_row=peaks[0], peak_bytes_per_s=peaks[1],
         peak_flops_by_unit=peaks[2])

    # -- 2. build -----------------------------------------------------------
    t0 = time.time()
    libs = cuda_spmv.build_kernels()
    build_s = time.time() - t0
    # the native host builders, built here so that no phase's host seconds hold
    # the compiler; a machine with nvcc has g++, so nothing falls back to numpy
    t0 = time.time()
    if not native.native_available():
        fail("the native host builders did not build (g++)")
    native_build_s = time.time() - t0
    ptxas = {}
    for name, path in libs.items():
        log = path.with_suffix(".so.log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, libraries={k: p.name for k, p in libs.items()},
         flags=" ".join(cuda_spmv.NVCC_FLAGS), ptxas=ptxas, native_seconds=native_build_s,
         native_library=native.library_path().name, native_flags=" ".join(native.GXX_FLAGS))

    # -- operators shared by the phases --------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn(nbr * BLOCK, generator=gen, device=dev)
    # start vectors have a generator of their own, so that a solve does not
    # depend on which other phases ran before it
    gen_v0 = torch.Generator(device=dev)
    gen_v0.manual_seed(SEED + 100)
    v0_banded = torch.randn(nbr * BLOCK, generator=gen_v0, device=dev)
    v0_bsr = torch.randn(nbr * BLOCK, generator=gen_v0, device=dev)
    t0 = time.time()
    data, cols = banded_block_bsr_numpy(nbr, BLOCK, seed=SEED)
    bsr32 = bsr_from_numpy(data, cols, (nbr * BLOCK, nbr * BLOCK), device=dev)
    del data
    sym32 = sym_bsr_from_bsr(bsr32)
    if sym32.band_reach != 1:
        fail(f"banded operator: band_reach {sym32.band_reach}, expected 1")
    setup_s = time.time() - t0

    # BASELINE config 2, packed once: the main-path shape of the general SpMV
    # kernel (phase kernels) and the operand of phase eigs_accelerated
    if (wanted("kernels") or wanted("eigs_accelerated") or wanted("derived_adjoint")
            or wanted("mesh_adjoint") or wanted("chunk_graphs")):
        r_cd, c_cd, v_cd, n_cd = convection_diffusion_coo(CD_NX)
        coo_cd = coo_on(r_cd, c_cd, v_cd, n_cd, dev)
        native.reset_native_calls()
        t0 = time.time()
        acc_cd = accelerate(coo_cd)  # what eigs(coo_cd, accelerate=True) does first
        cd_pack_s = time.time() - t0
        cd_native = native.native_calls()
        # on the card the stencil fills 1 % of its general pack: stored row-compressed
        if (acc_cd.stats["storage"] != "row_compressed" or acc_cd.stats["kmax"] != CD_PACK[1]
                or acc_cd.matrix.dtype != torch.float32):
            fail(f"config-2 storage: {acc_cd.stats['storage']} {acc_cd.matrix.dtype}, block pack "
                 f"kmax {acc_cd.stats['kmax']}, expected row_compressed float32 beside kmax "
                 f"{CD_PACK[1]}")

    kernel_cases: list[dict] = []
    # -- 3. kernels ----------------------------------------------------------
    if wanted("kernels"):
        storages = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
        # panels of the SpMM checks: columns of one seeded (n, 16) block
        panel = torch.randn((nbr * BLOCK, max(SPMM_WIDTHS)), generator=gen, device=dev)
        panels = {w: panel[:, :w].contiguous() for w in SPMM_WIDTHS}
        del panel

        def spmm_cases(name, case, op, widths=panels):
            for w, X in widths.items():
                kernel_cases.append(check_spmm(name, f"{case} p={w} ", op, X, peaks))

        for dt, tag in storages:
            kernel_cases.append(check_kernel(
                "bsr_spmv", f"banded {nbr}x3x{BLOCK}^2 {tag}", bsr32.astype(dt), x, peaks))
            spmm_cases("bsr_spmm", f"banded {nbr}x3x{BLOCK}^2 {tag}", bsr32.astype(dt))
            kernel_cases.append(check_kernel(
                "sym_bsr_spmv", f"banded reach=1 ku=1 {tag} (stream regime)",
                sym32.astype(dt), x, peaks))
            spmm_cases("sym_bsr_spmm", f"banded reach=1 ku=1 {tag} (stream regime)",
                       sym32.astype(dt))
        scattered = random_sym_blocks(nbr, BLOCK, scattered_cols(nbr, 3, SEED + 1), -1, gen)
        for dt, tag in storages:
            kernel_cases.append(check_kernel(
                "sym_bsr_spmv", f"scattered reach=-1 ku=3 {tag} (resident regime)",
                scattered.astype(dt), x, peaks))
            spmm_cases("sym_bsr_spmm", f"scattered reach=-1 ku=3 {tag} (resident regime)",
                       scattered.astype(dt))
        del scattered
        far_d = (1, 2, 100, 485)
        far = random_sym_blocks(nbr, BLOCK, far_reach_cols(nbr, far_d), max(far_d), gen)
        for dt, tag in storages:
            kernel_cases.append(check_kernel(
                "sym_bsr_spmv", f"far reach={max(far_d)} ku=4 {tag} (ring regime)",
                far.astype(dt), x, peaks))
            spmm_cases("sym_bsr_spmm", f"far reach={max(far_d)} ku=4 {tag} (ring regime)",
                       far.astype(dt))
        del far
        # other block shapes the kernels take, at a modest size: several 128-column
        # chunks per row, more than one pass of 128 rows, and short blocks
        wide = random_sym_blocks(256, 256, far_reach_cols(256, (1, 37)), 37, gen)
        xw = torch.randn(wide.shape[1], generator=gen, device=dev)
        wide_panels = {w: torch.randn((wide.shape[1], w), generator=gen, device=dev)
                       for w in SPMM_WIDTHS}
        for dt, tag in storages:
            kernel_cases.append(check_kernel(
                "sym_bsr_spmv", f"256x256 blocks reach=37 ku=2 {tag}", wide.astype(dt), xw, peaks))
            spmm_cases("sym_bsr_spmm", f"256x256 blocks reach=37 ku=2 {tag}", wide.astype(dt),
                       wide_panels)
        del wide, wide_panels
        for bm, bn in ((8, 128), (320, 256)):
            nbr_g, nbc_g, kmax_g = 512, 96, 4
            gdata = torch.randn((nbr_g, kmax_g, bm, bn), generator=gen, device=dev)
            gcols = torch.randint(0, nbc_g, (nbr_g, kmax_g), generator=gen, device=dev,
                                  dtype=torch.int32)
            general = BSRMatrix(gdata, gcols, (nbr_g * bm, nbc_g * bn))
            xg = torch.randn(nbc_g * bn, generator=gen, device=dev)
            general_panels = {w: torch.randn((nbc_g * bn, w), generator=gen, device=dev)
                              for w in SPMM_WIDTHS}
            for dt, tag in storages:
                kernel_cases.append(check_kernel(
                    "bsr_spmv", f"rectangular {bm}x{bn} blocks kmax=4 {tag}",
                    general.astype(dt), xg, peaks))
                spmm_cases("bsr_spmm", f"rectangular {bm}x{bn} blocks kmax=4 {tag}",
                           general.astype(dt), general_panels)
            del general, gdata, general_panels
        # badly scaled panels on bf16-exact (dyadic) blocks: column norms spread over
        # 1e-6 .. 1e6, so the per-column limit is the one that binds; one case per SpMM
        # kernel and storage, on the banded operators with their blocks rounded to eighths
        dyadic = lambda t: torch.round(t * 8) / 8
        bsr_dy = BSRMatrix(dyadic(bsr32.data), bsr32.block_cols, bsr32.shape)
        sym_dy = SymBSRMatrix(dyadic(sym32.diag_data), dyadic(sym32.upper_data), sym32.upper_cols,
                              sym32.shape, sym32.band_reach)
        scale = 10.0 ** torch.linspace(-6, 6, SCALED_WIDTH, device=dev)
        scaled = {SCALED_WIDTH: (torch.randn((nbr * BLOCK, SCALED_WIDTH), generator=gen, device=dev)
                                 * scale[None, :]).contiguous()}
        for dt, tag in storages:
            spmm_cases("bsr_spmm", f"scaled columns 1e-6..1e6, dyadic blocks {nbr}x3x{BLOCK}^2 {tag}",
                       bsr_dy.astype(dt), scaled)
            spmm_cases("sym_bsr_spmm", f"scaled columns 1e-6..1e6, dyadic blocks reach=1 ku=1 {tag}",
                       sym_dy.astype(dt), scaled)
        del bsr_dy, sym_dy, scaled
        # the general SpMV on the f32 block pack of BASELINE config 2: the pack the
        # mesh routes take (block_matrix(), phases mesh_adjoint and mesh_general)
        cd_pack = acc_cd.block_matrix()
        if tuple(cd_pack.data.shape) != CD_PACK:
            fail(f"config-2 pack: {tuple(cd_pack.data.shape)}, expected {CD_PACK}")
        x_cd = torch.randn(cd_pack.shape[1], generator=gen, device=dev)
        kernel_cases.append(check_kernel(
            "bsr_spmv", "config-2 pack " + "x".join(map(str, CD_PACK)) + " f32", cd_pack, x_cd,
            peaks))
        # ... the row-compressed storage the general path takes on the card: config 2
        # (phase eigs_accelerated), its transpose (the explicit adjoint of phase
        # derived_adjoint) and the nx = 128 stencil (phase eigs_sigma)
        kernel_cases.append(check_kernel(
            "csr_spmv", f"config-2 row-compressed n={n_cd} f32 (main path)", acc_cd.matrix,
            x_cd, peaks))
        kernel_cases.append(check_kernel(
            "csr_spmv", f"config-2 transposed row-compressed n={n_cd} f32",
            acc_cd.matrix.kernel_adjoint(), x_cd, peaks))
        acc_128 = accelerate(coo_on(*convection_diffusion_coo(SIGMA_NX), dev))
        x_128 = torch.randn(acc_128.shape[1], generator=gen, device=dev)
        kernel_cases.append(check_kernel(
            "csr_spmv", f"nx={SIGMA_NX} stencil row-compressed n={SIGMA_NX ** 2} f32 (main path)",
            acc_128.matrix, x_128, peaks))
        del acc_128, x_128
        # ... its adjoint pack (the backward of phase derived_adjoint's products, built
        # once on the host and cached), and the general SpMM on both at the width of that
        # phase's vjps: the forward on the pack, the backward on its adjoint
        cd_adj = cd_pack.kernel_adjoint()
        cd_adj_shape = "x".join(map(str, cd_adj.data.shape))
        kernel_cases.append(check_kernel(
            "bsr_spmv", f"config-2 adjoint pack {cd_adj_shape} f32", cd_adj, x_cd, peaks))
        for what, pack in (("config-2 pack " + "x".join(map(str, CD_PACK)), cd_pack),
                           (f"config-2 adjoint pack {cd_adj_shape}", cd_adj)):
            X_cd = torch.randn((pack.shape[1], DA_PANEL), generator=gen, device=dev)
            kernel_cases.append(check_spmm("bsr_spmm", f"{what} f32 p={DA_PANEL} ", pack, X_cd, peaks))
        del cd_adj, X_cd
        # ... and at the largest sector pack of phase block_heisenberg_bsr: the S_z = 0
        # sector of the L = 20 chain at the card's default 32x128 blocks, mostly padding
        sector = heisenberg_sector_coo(HEIS_BSR_L, HEIS_BSR_L // 2, dtype=np.float32, device="cpu")
        sector_pack = bsr_from_coo_arrays(sector.row.numpy(), sector.col.numpy(),
                                          sector.val.numpy(), sector.shape, CARD_BSR_BLOCK, device=dev)
        x_sector = torch.randn(sector_pack.shape[1], generator=gen, device=dev)
        kernel_cases.append(check_kernel(
            "bsr_spmv", f"L={HEIS_BSR_L} S_z=0 sector pack "
            + "x".join(map(str, sector_pack.data.shape)) + " f32 (main path)",
            sector_pack, x_sector, peaks))
        del sector, sector_pack, x_sector
        torch.cuda.empty_cache()
        emit("kernels", rel_tol=KERNEL_REL_TOL, model_rel_tol=MODEL_REL_TOL,
             timed_samples=TIMED_LAUNCHES, calls_per_sample=8, cases=kernel_cases)
        if args.profile:
            emit("profile_kernels", products={
                "sym_bsr_spmv banded f32": profile_product(sym32, x),
                "sym_bsr_spmv banded bf16": profile_product(sym32.astype(torch.bfloat16), x),
                "sym_bsr_spmm banded f32": profile_product(sym32, panels[MAIN_WIDTH]),
                "sym_bsr_spmm banded bf16": profile_product(sym32.astype(torch.bfloat16),
                                                            panels[WINDOW_WIDTH]),
                "bsr_spmm banded f32": profile_product(bsr32, panels[MAIN_WIDTH]),
                "bsr_spmm banded bf16": profile_product(bsr32.astype(torch.bfloat16),
                                                        panels[MAIN_WIDTH]),
                "bsr_spmv config-2 pack f32": profile_product(cd_pack, x_cd)})
        del panels, cd_pack, x_cd

    main_launches = {name: 0 for name in cuda_spmv.KERNEL_SOURCES}
    window_ref = None  # (window, eigenvalues, seconds, rounds) of phase window_accelerated
    per_phase: dict[str, dict] = {}
    phase_storage: dict[str, str] = {}

    def drive(phase: str, op, fn):
        """Run one main-path phase, a solve on ``op``, with the launch counts
        set to 0 just before it and read just after; the block storage of
        ``op`` is kept for the split of a kernel's launches by storage."""
        phase_storage[phase] = str(op.dtype).replace("torch.", "")
        cuda_spmv.reset_launch_counts()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.time() - t0
        counts = cuda_spmv.launch_counts()
        per_phase[phase] = counts
        for name, c in counts.items():
            main_launches[name] += c
        return out, seconds, counts

    def record(phase: str, storage: str, counts: dict) -> None:
        """A main-path phase whose launches were counted elsewhere (by the
        worker processes), from 0."""
        phase_storage[phase] = storage
        per_phase[phase] = {k: counts.get(k, 0) for k in cuda_spmv.KERNEL_SOURCES}
        for name, c in per_phase[phase].items():
            main_launches[name] += c

    def only_kernel(name: str, count: int) -> dict:
        """The launch counts of a phase that went through one kernel only."""
        return {k: (count if k == name else 0) for k in cuda_spmv.KERNEL_SOURCES}

    # -- 4. eigsh_banded: the main path at full width --------------------------
    lam_max = None
    banded_eigenvalues = None
    banded_ms = None  # ms per matvec of the single-device eigsh_banded
    graph_cases = []  # phase chunk_graphs, case by case
    if wanted("eigsh_banded") or wanted("chunk_graphs"):
        def solve_banded():
            return eigsh(sym32, k=4, which="LA", v0=v0_banded, tol=BANDED_TOL, max_restarts=400)

        res, seconds, counts = drive("eigsh_banded", sym32, solve_banded)
        X = res.eigenvectors
        rr = residuals(sym32._plain_matvec, res.eigenvalues, X)
        report = dict(n=sym32.shape[0], nnz_applied=sym32.nnz_applied, storage="float32",
                      k=4, which="LA", tol=BANDED_TOL, resid_limit=BANDED_RESID_LIMIT,
                      converged=res.converged, termination=res.termination,
                      eigenvalues=res.eigenvalues.tolist(), rel_residuals=rr,
                      matvecs=res.iterations, launches=counts, seconds=seconds,
                      ms_per_matvec=seconds * 1e3 / max(res.iterations, 1),
                      operator_setup_seconds=setup_s)
        emit("eigsh_banded", **report)
        if not res.converged:
            fail(f"eigsh_banded: not converged ({res.termination}) after {res.iterations} matvecs")
        if tuple(X.shape) != (sym32.shape[0], 4) or not bool(torch.isfinite(X).all()):
            fail("eigsh_banded: eigenvectors are not finite (n, 4)")
        if not max(rr) <= BANDED_RESID_LIMIT:
            fail(f"eigsh_banded: residual {max(rr):.3e} exceeds {BANDED_RESID_LIMIT}")
        if counts != only_kernel("sym_bsr_spmv", res.iterations):
            fail(f"eigsh_banded: launches {counts} for {res.iterations} matvecs")
        banded_eigenvalues = np.asarray(res.eigenvalues, np.float64)
        banded_ms = report["ms_per_matvec"]
        lam_max = float(res.eigenvalues[-1])
        if args.profile:
            emit("profile", solve="eigsh_banded", route="graphs", **profile_solve(solve_banded))
            with chunk_graph.eager_chunks():
                emit("profile", solve="eigsh_banded", route="eager", **profile_solve(solve_banded))
        # -- 36. chunk_graphs: each case eager and with graphs in turns ---------------
        if wanted("chunk_graphs"):
            graph_cases.append(chunk_graphs_case(
                "eigsh_banded", solve_banded, lambda r: r.iterations,
                lambda r: only_kernel("sym_bsr_spmv", r.iterations), replaying=True))

    # -- 26. mesh_modes: eigsh on the banded operator over a 4-shard mesh, each mode --
    mesh_runs = None
    if wanted("mesh_modes"):
        mesh_runs = mesh_modes_phase(bsr32, sym32, banded_eigenvalues, banded_ms, drive, dev)["runs"]

    # -- 31. multiprocess_banded: the mesh across processes (2 x 2 and 4 x 1) -------------
    MP_WORK.mkdir(parents=True, exist_ok=True)
    if wanted("multiprocess_banded"):
        if banded_eigenvalues is None:
            banded_eigenvalues = np.asarray(eigsh(sym32, k=4, which="LA", tol=BANDED_TOL,
                                                  max_restarts=400).eigenvalues, np.float64)
        with tempfile.TemporaryDirectory(dir=MP_WORK) as work:
            multiprocess_banded_phase(bsr32, sym32, mesh_runs, banded_eigenvalues, record, dev,
                                      Path(work))

    # -- 5. eigsh_accelerated --------------------------------------------------
    if (wanted("eigsh_accelerated") or wanted("window_accelerated") or wanted("expm_accelerated")
            or wanted("mesh_kernels") or wanted("mesh_filters") or wanted("chunk_graphs")):
        n_a = nbr * BLOCK
        rng = np.random.default_rng(SEED + 7)
        r_a = np.repeat(np.arange(n_a), 2)
        c_a = r_a + rng.integers(1, 24, size=len(r_a))
        keep = c_a < n_a
        r_a, c_a = r_a[keep], c_a[keep]
        v_a = np.round(rng.standard_normal(len(r_a)) * 8) / 8  # dyadic: bf16-exact
        trip = (np.concatenate([r_a, c_a, np.arange(n_a)]),
                np.concatenate([c_a, r_a, np.arange(n_a)]),
                np.concatenate([v_a, v_a, np.full(n_a, 4.0)]), (n_a, n_a))
        native.reset_native_calls()
        t0 = time.time()
        acc = accelerate(trip, symmetric=True)
        acc_pack_s = time.time() - t0
        acc_native = native.native_calls()
        if acc.matrix.dtype != torch.bfloat16:
            fail(f"eigsh_accelerated: dyadic values packed as {acc.matrix.dtype}, expected bfloat16")

    if wanted("eigsh_accelerated") or wanted("window_accelerated") or wanted("chunk_graphs"):
        def solve_accelerated():
            return eigsh(acc, k=2, which="LA", tol=ACCEL_TOL, seed=3, max_restarts=400)

        res, seconds, counts = drive("eigsh_accelerated", acc.matrix, solve_accelerated)
        A64 = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3]).tocsr()
        X = np.asarray(res.eigenvectors, np.float64)
        lam = np.asarray(res.eigenvalues, np.float64)
        rr = (np.linalg.norm(A64 @ X - X * lam[None, :], axis=0) / np.abs(lam)).tolist()
        stats = {k: v for k, v in acc.stats.items()}
        emit("eigsh_accelerated", n=n_a, nnz=int(A64.nnz), pack=stats, k=2, which="LA",
             tol=ACCEL_TOL, resid_limit=ACCEL_RESID_LIMIT, converged=res.converged,
             termination=res.termination, eigenvalues=lam.tolist(), rel_residuals_f64_host=rr,
             matvecs=res.iterations, launches=counts, seconds=seconds,
             ms_per_matvec=seconds * 1e3 / max(res.iterations, 1), pack_seconds_wall=acc_pack_s,
             pack_native_calls=acc_native,
             pack_numpy_route=numpy_route_pack(trip, symmetric=True))
        native_total("eigsh_accelerated", acc_native)
        if not res.converged:
            fail(f"eigsh_accelerated: not converged ({res.termination})")
        if X.shape != (n_a, 2) or not np.isfinite(X).all():
            fail("eigsh_accelerated: restored eigenvectors are not finite (n, 2)")
        if not max(rr) <= ACCEL_RESID_LIMIT:
            fail(f"eigsh_accelerated: residual {max(rr):.3e} exceeds {ACCEL_RESID_LIMIT}")
        acc_kernel = spmv_kernel_of(acc)
        if counts != only_kernel(acc_kernel, res.iterations):
            fail(f"eigsh_accelerated: launches {counts} for {res.iterations} matvecs")
        if acc_kernel == "csr_spmv":
            # the row-compressed operator accelerate() made: the result line's bf16 case
            x_a = acc.embed(np.random.default_rng(SEED + 8).standard_normal(n_a))
            kernel_cases.append(check_kernel(
                "csr_spmv", f"accelerated banded n={n_a} nnz={acc.matrix.nnz} row-compressed "
                f"bf16 (main path)", acc.matrix, x_a, peaks))
            del x_a
        if wanted("chunk_graphs"):
            graph_cases.append(chunk_graphs_case(
                "eigsh_accelerated", solve_accelerated, lambda r: r.iterations,
                lambda r: only_kernel(acc_kernel, r.iterations), replaying=False))

        # -- 9. window_accelerated: the filter path held against the Lanczos path ----
        if wanted("window_accelerated"):
            l1, l2 = float(lam[0]), float(lam[1])
            window = (l1 - 0.5 * (l2 - l1), l2 + 0.5 * (l2 - l1))

            def solve_window():
                return eigsh_window(acc, window, block_size=8, degree=WINDOW_DEGREE,
                                    tol=WINDOW_TOL, max_iterations=40, seed=4)

            res, seconds, counts = drive("window_accelerated", acc.matrix, solve_window)
            lam_w = np.asarray(res.eigenvalues, np.float64)
            window_ref = (window, lam_w, seconds, res.iterations)
            report = dict(n=n_a, storage="bfloat16", window=window, block_size=8,
                          degree=WINDOW_DEGREE, tol=WINDOW_TOL, converged=res.converged,
                          termination=res.termination, outer_iterations=res.iterations,
                          eigenvalues=lam_w.tolist(), eigenvalues_from_eigsh_accelerated=[l1, l2],
                          launches=counts, seconds=seconds, resid_limit=WINDOW_RESID_LIMIT)
            Xw = None
            if res.eigenvectors is not None:
                Xw = np.asarray(res.eigenvectors, np.float64)
                report["rel_residuals_f64_host"] = (
                    np.linalg.norm(A64 @ Xw - Xw * lam_w[None, :], axis=0) / np.abs(lam_w)).tolist()
            emit("window_accelerated", **report)
            if not res.converged:
                fail(f"window_accelerated: not converged ({res.termination})")
            if Xw is None or Xw.shape != (n_a, len(lam_w)) or not np.isfinite(Xw).all():
                fail("window_accelerated: restored eigenvectors are not finite (n, found)")
            # the two eigenvalues the Lanczos path returned lie in the window: both found
            for l in (l1, l2):
                if not np.any(np.abs(lam_w - l) <= 1e-4 * abs(l)):
                    fail(f"window_accelerated: eigenvalue {l} of eigsh_accelerated not found in {lam_w}")
            if not max(report["rel_residuals_f64_host"]) <= WINDOW_RESID_LIMIT:
                fail(f"window_accelerated: residual {max(report['rel_residuals_f64_host']):.3e} "
                     f"exceeds {WINDOW_RESID_LIMIT}")
            # a round is `degree` filter products and one Rayleigh-Ritz product
            if counts != only_kernel("sym_bsr_spmm", res.iterations * (WINDOW_DEGREE + 1)):
                fail(f"window_accelerated: launches {counts} for {res.iterations} rounds")
            if args.profile:
                emit("profile_window", solve="window_accelerated", **profile_solve(solve_window))

    if wanted("expm_accelerated"):
        # -- 14. expm_accelerated: exp(xA) v on the symmetric kernel, two ways --------
        lo, hi = acc.matrix.estimate_eigenvalue_range()
        rho = max(abs(float(lo)), abs(float(hi)))
        x_exp = -math.floor(EXPM_X_RHO / rho * 1e6) / 1e6  # |x| rho <= 20
        applied = {"matvec": 0, "matmat": 0}
        acc_e = dataclasses.replace(acc, matrix=counted(acc.matrix, applied))
        v_exp = acc_e.embed(np.random.default_rng(SEED + 11).standard_normal(n_a))

        def solve_expm():
            out = {}
            for method, kw in (("lanczos", dict(num_steps=EXPM_STEPS)),
                               ("taylor_auto", dict(tol=EXPM_TAYLOR_TOL))):
                before = applied["matvec"]
                t0 = time.time()
                y = expm_multiply(acc_e, v_exp, x_exp, method=method, **kw)
                torch.cuda.synchronize()
                out[method] = (y, time.time() - t0, applied["matvec"] - before)
            return out

        out, seconds, counts = drive("expm_accelerated", acc.matrix, solve_expm)
        y_l, y_t = out["lanczos"][0], out["taylor_auto"][0]
        finite = bool(torch.isfinite(y_l).all() and torch.isfinite(y_t).all())
        agree = float(torch.linalg.vector_norm(y_l - y_t) / torch.linalg.vector_norm(y_t))
        n_div = math.ceil(abs(x_exp) * rho)
        emit("expm_accelerated", n=n_a, storage="bfloat16", x=x_exp, gershgorin_rho=rho,
             abs_x_times_rho=abs(x_exp) * rho, lanczos_steps=EXPM_STEPS,
             taylor_tol=EXPM_TAYLOR_TOL, taylor_substeps=n_div,
             applications={m: o[2] for m, o in out.items()},
             seconds={m: o[1] for m, o in out.items()},
             ms_per_application={m: o[1] * 1e3 / max(o[2], 1) for m, o in out.items()},
             norm_v=float(torch.linalg.vector_norm(v_exp)),
             norm_result=float(torch.linalg.vector_norm(y_t)), rel_diff=agree,
             agree_limit=EXPM_AGREE, launches=counts, seconds_total=seconds)
        if tuple(y_l.shape) != (acc.shape[0],) or not finite:
            fail("expm_accelerated: results are not finite vectors of the operator's size")
        if not agree <= EXPM_AGREE:
            fail(f"expm_accelerated: lanczos and taylor_auto differ by {agree:.3e} > {EXPM_AGREE}")
        if out["lanczos"][2] != EXPM_STEPS:
            fail(f"expm_accelerated: {out['lanczos'][2]} applications for {EXPM_STEPS} Lanczos steps")
        if counts != only_kernel(spmv_kernel_of(acc), applied["matvec"]) or applied["matmat"]:
            fail(f"expm_accelerated: launches {counts} for {applied['matvec']} applications")
        del acc_e, v_exp, out, y_l, y_t

    # -- 25. mesh_kernels: every shard-local product of every mode against its plain version --
    if wanted("mesh_kernels"):
        mesh_kernels_phase(bsr32, acc.block_matrix(), dev, gen, peaks, kernel_cases)

    # -- 29. mesh_filters: the block filters and LOBPCG over a 4-shard mesh -------------
    if wanted("mesh_filters"):
        mesh_filters_phase(acc, trip, sym32, window_ref, drive, dev)

    if (wanted("eigsh_accelerated") or wanted("window_accelerated") or wanted("expm_accelerated")
            or wanted("mesh_kernels") or wanted("mesh_filters") or wanted("chunk_graphs")):
        del acc

    # -- 6. eigsh_bsr: kernel A on a path ---------------------------------------
    if wanted("eigsh_bsr"):
        res, seconds, counts = drive(
            "eigsh_bsr", bsr32,
            lambda: eigsh(bsr32, k=2, which="LA", v0=v0_bsr, tol=1e-3, max_subspace=24,
                          max_restarts=3))
        lam = res.eigenvalues
        # the residual is taken with the plain version, so a kernel that was
        # wrong in a way the Lanczos recurrence absorbs (a scaled product) shows
        rr = residuals(lambda v: cuda_spmv.bsr_spmv_plain(bsr32, v), lam, res.eigenvectors)
        emit("eigsh_bsr", n=bsr32.shape[0], storage="float32", k=2, which="LA",
             max_subspace=24, max_restarts=3, converged=res.converged,
             termination=res.termination, ritz_values=lam.tolist(), rel_residuals=rr,
             resid_limit=BSR_RESID_LIMIT, top_ritz_gap_limit=BSR_TOP_RITZ_GAP,
             matvecs=res.iterations, launches=counts, seconds=seconds,
             lambda_max_from_eigsh_banded=lam_max)
        if not (np.isfinite(lam).all() and bool(torch.isfinite(res.eigenvectors).all())):
            fail("eigsh_bsr: non-finite Ritz pairs")
        if counts != only_kernel("bsr_spmv", res.iterations) or res.iterations < 24:
            fail(f"eigsh_bsr: launches {counts} for {res.iterations} matvecs")
        if not max(rr) <= BSR_RESID_LIMIT:
            fail(f"eigsh_bsr: residual {max(rr):.3e} exceeds {BSR_RESID_LIMIT}")
        # a Ritz value of a symmetric operator never exceeds its largest
        # eigenvalue, and after 66 matvecs the top one has all but reached it
        if lam_max is not None and not (
                lam_max * (1 - BSR_TOP_RITZ_GAP) <= lam[-1] <= lam_max * (1 + 1e-4)):
            fail(f"eigsh_bsr: top Ritz value {lam[-1]} against lambda_max {lam_max}")

    def lobpcg_products(res) -> int:
        """Block products of a LOBPCG run: one per iteration, one more per soft restart."""
        return res.iterations + sum("dropping P" in e for e in res.trace.events)

    # -- 7. lobpcg_banded: this slice's path at full width ---------------------------
    if wanted("lobpcg_banded"):
        # T = (diag(A) - sigma)^-1 with sigma the Gershgorin upper bound: the Jacobi
        # preconditioner of A - sigma I, the definite operator whose low end is A's top end
        upper_bound = float(sym32.estimate_eigenvalue_range()[1])

        def solve_lobpcg():
            return eigsh(sym32, k=4, which="LA", tol=BANDED_TOL, max_iterations=LOBPCG_CAP,
                         seed=SEED + 2,
                         preconditioner=jacobi_preconditioner(sym32, sigma=upper_bound))

        res, seconds, counts = drive("lobpcg_banded", sym32, solve_lobpcg)
        X = res.eigenvectors
        rr = block_residuals(sym32._plain_matmat, res.eigenvalues, X)
        emit("lobpcg_banded", n=sym32.shape[0], storage="float32", k=4, which="LA",
             preconditioner=f"jacobi, sigma={upper_bound:.4f} (Gershgorin upper bound)",
             tol=BANDED_TOL, max_iterations=LOBPCG_CAP, converged=res.converged,
             termination=res.termination, iterations=res.iterations,
             block_products=lobpcg_products(res), ritz_values=res.eigenvalues.tolist(),
             eigenvalues_from_eigsh_banded=None if banded_eigenvalues is None
             else banded_eigenvalues.tolist(),
             rel_residuals=rr, resid_limit=LOBPCG_RESID_LIMIT, ritz_gap_limit=LOBPCG_RITZ_GAP,
             launches=counts, seconds=seconds,
             ms_per_iteration=seconds * 1e3 / max(res.iterations, 1))
        if tuple(X.shape) != (sym32.shape[0], 4) or not bool(torch.isfinite(X).all()):
            fail("lobpcg_banded: eigenvectors are not finite (n, 4)")
        if not max(rr) <= LOBPCG_RESID_LIMIT:
            fail(f"lobpcg_banded: residual {max(rr):.3e} exceeds {LOBPCG_RESID_LIMIT}")
        if banded_eigenvalues is not None:
            check_ritz_below("lobpcg_banded", res.eigenvalues, banded_eigenvalues, LOBPCG_RITZ_GAP)
        if counts != only_kernel("sym_bsr_spmm", lobpcg_products(res)):
            fail(f"lobpcg_banded: launches {counts} for {lobpcg_products(res)} block products")
        if args.profile:
            emit("profile_lobpcg", solve="lobpcg_banded", **profile_solve(solve_lobpcg))

    # -- 8. block_lanczos_banded -------------------------------------------------------
    if wanted("block_lanczos_banded"):
        options = BlockLanczosOptions(
            block_size=8, max_subspace=BLOCK_SUBSPACE, max_eigenvalues=4,
            eigenvalue_indices=(-4, -3, -2, -1), tolerance=BANDED_TOL, seed=SEED + 3)
        res, seconds, counts = drive(
            "block_lanczos_banded", sym32,
            lambda: BlockLanczosEigenSolver(sym32, options).compute())
        X = res.eigenvectors
        rr = block_residuals(sym32._plain_matmat, res.eigenvalues, X)
        steps = res.iterations // 8
        emit("block_lanczos_banded", n=sym32.shape[0], storage="float32", block_size=8,
             max_subspace=BLOCK_SUBSPACE, tol=BANDED_TOL, converged=res.converged,
             termination=res.termination, krylov_dimension=res.iterations, block_steps=steps,
             ritz_values=res.eigenvalues.tolist(),
             eigenvalues_from_eigsh_banded=None if banded_eigenvalues is None
             else banded_eigenvalues.tolist(),
             rel_residuals=rr, resid_limit=BLOCK_RESID_LIMIT, ritz_gap_limit=BLOCK_RITZ_GAP,
             launches=counts, seconds=seconds, ms_per_block_step=seconds * 1e3 / max(steps, 1))
        if res.termination not in ("converged", "max_iterations"):
            fail(f"block_lanczos_banded: terminated with {res.termination}")
        if tuple(X.shape) != (sym32.shape[0], 4) or not bool(torch.isfinite(X).all()):
            fail("block_lanczos_banded: eigenvectors are not finite (n, 4)")
        if not max(rr) <= BLOCK_RESID_LIMIT:
            fail(f"block_lanczos_banded: residual {max(rr):.3e} exceeds {BLOCK_RESID_LIMIT}")
        if banded_eigenvalues is not None:
            check_ritz_below("block_lanczos_banded", res.eigenvalues, banded_eigenvalues,
                             BLOCK_RITZ_GAP)
        if counts != only_kernel("sym_bsr_spmm", steps) or steps < 8:
            fail(f"block_lanczos_banded: launches {counts} for {steps} block steps")

    # -- 10. lobpcg_bsr: the general SpMM kernel on a path -----------------------------
    if wanted("lobpcg_bsr"):
        res, seconds, counts = drive(
            "lobpcg_bsr", bsr32,
            lambda: lobpcg(bsr32, 4, largest=True, tol=BANDED_TOL,
                           max_iterations=LOBPCG_BSR_ITERS, seed=SEED + 2))
        lam = res.eigenvalues  # descending, as lobpcg(largest=True) returns them
        # the residuals are taken with the plain version and held against the
        # norms the solver computed through the kernel: a kernel that was wrong
        # in a way the Rayleigh-Ritz absorbs would part the two
        rr = block_residuals(lambda X: cuda_spmv.bsr_spmm_plain(bsr32, X), lam, res.eigenvectors)
        emit("lobpcg_bsr", n=bsr32.shape[0], storage="float32", k=4, largest=True,
             max_iterations=LOBPCG_BSR_ITERS, termination=res.termination,
             iterations=res.iterations, block_products=lobpcg_products(res),
             ritz_values=lam.tolist(), rel_residuals=rr, resid_limit=LOBPCG_BSR_RESID_LIMIT,
             max_abs_residual_from_solver=res.trace.residuals[-1],
             max_abs_residual_plain=max(r * abs(l) for r, l in zip(rr, lam)),
             agree_limit=LOBPCG_BSR_AGREE, launches=counts, seconds=seconds,
             lambda_max_from_eigsh_banded=lam_max)
        if not (np.isfinite(lam).all() and bool(torch.isfinite(res.eigenvectors).all())):
            fail("lobpcg_bsr: non-finite Ritz pairs")
        if not max(rr) <= LOBPCG_BSR_RESID_LIMIT:
            fail(f"lobpcg_bsr: residual {max(rr):.3e} exceeds {LOBPCG_BSR_RESID_LIMIT}")
        plain_max = max(r * abs(l) for r, l in zip(rr, lam))
        if not abs(plain_max - res.trace.residuals[-1]) <= LOBPCG_BSR_AGREE * plain_max:
            fail(f"lobpcg_bsr: the solver's residual {res.trace.residuals[-1]} (kernel) against "
                 f"{plain_max} (plain version)")
        if lam_max is not None and not (0.9 * lam_max <= lam[0] <= lam_max * (1 + 1e-4)):
            fail(f"lobpcg_bsr: top Ritz value {lam[0]} against lambda_max {lam_max}")
        if counts != only_kernel("bsr_spmm", lobpcg_products(res)):
            fail(f"lobpcg_bsr: launches {counts} for {lobpcg_products(res)} block products")

    # -- 11. eigs_accelerated: the general path at full width, BASELINE config 2 -------
    if wanted("eigs_accelerated") or wanted("chunk_graphs"):
        n = n_cd
        A64 = sp.csr_matrix((v_cd, (r_cd, c_cd)), shape=(n, n))
        top = convection_diffusion_top(CD_NX, 10)
        re_max, im_max = convection_diffusion_range(CD_NX)

        def solve_eigs():
            # eigs(coo_cd, accelerate=True) is accelerate(coo_cd), then this call
            return eigs(acc_cd, k=EIGS_K, which="LM", tol=EIGS_TOL, max_restarts=EIGS_MAX_RESTARTS)

        # the same request on the general pack of the same operator (block_matrix()):
        # the storage accelerate() keeps for an operator whose blocks are full
        acc_cd_block = dataclasses.replace(acc_cd, matrix=acc_cd.block_matrix())

        def solve_eigs_block():
            return eigs(acc_cd_block, k=EIGS_K, which="LM", tol=EIGS_TOL,
                        max_restarts=EIGS_MAX_RESTARTS)

        def pairs(res):
            """The eigenvalues, the f64 host residuals of the restored pairs and
            whether the eigenvalues lie in the dominant strip."""
            X = np.asarray(res.eigenvectors, np.complex128)
            lam = np.asarray(res.eigenvalues, np.complex128)
            rr = (np.linalg.norm(A64 @ X - X * lam[None, :], axis=0) / np.abs(lam)).tolist()
            in_strip = bool(np.all(lam.real >= top[0] - EIGS_BELOW_TOP)
                            and np.all(lam.real <= re_max) and np.all(np.abs(lam.imag) <= im_max))
            return X, lam, rr, in_strip

        def held(tag, res, counts, kernel):
            """Phase eigs_accelerated's checks of one storage's solve."""
            X, lam, rr, in_strip = pairs(res)
            if not res.converged:
                fail(f"{tag}: not converged ({res.termination}) after {res.iterations} matvecs")
            if X.shape != (n, EIGS_K) or not np.isfinite(X).all():
                fail(f"{tag}: restored eigenvectors are not finite (n, k)")
            if not max(rr) <= EIGS_RESID_LIMIT:
                fail(f"{tag}: residual {max(rr):.3e} exceeds {EIGS_RESID_LIMIT}")
            if not in_strip:
                fail(f"{tag}: eigenvalues {lam.tolist()} outside the dominant strip: Re at least "
                     f"{top[0] - EIGS_BELOW_TOP}, inside the numerical range (Re <= {re_max}, "
                     f"|Im| <= {im_max})")
            if counts != only_kernel(kernel, res.iterations):
                fail(f"{tag}: launches {counts} for {res.iterations} matvecs")

        res, seconds, counts = drive("eigs_accelerated", acc_cd.matrix, solve_eigs)
        res_b, seconds_b, counts_b = drive("eigs_accelerated_block", acc_cd_block.matrix,
                                           solve_eigs_block)
        _, lam, rr, in_strip = pairs(res)
        _, lam_b, rr_b, in_strip_b = pairs(res_b)
        key = lambda z: np.sort_complex(z.real + 1j * np.abs(z.imag))
        top_dist = [float(np.min(np.abs(top - l.real))) for l in lam]
        # the largest residual bound of the tracked Schur vectors at every 10th restart,
        # relative to the dominant |lambda|
        bound_history = (np.asarray(res.trace.residuals[::10]) / np.abs(lam).max()).tolist()
        emit("eigs_accelerated", n=n, nnz=int(A64.nnz), nx=CD_NX, conv=CD_CONV, k=EIGS_K,
             which="LM", tol=EIGS_TOL, converged=res.converged, termination=res.termination,
             eigenvalues_re=lam.real.tolist(), eigenvalues_im=lam.imag.tolist(),
             rel_residuals_f64_host=rr, resid_limit=EIGS_RESID_LIMIT,
             closed_form_top=top[:EIGS_K].tolist(), distance_to_closed_form_top=top_dist,
             numerical_range_re_max=re_max, numerical_range_abs_im_max=im_max,
             below_top_limit=EIGS_BELOW_TOP, in_dominant_strip=in_strip,
             matvecs=res.iterations, restarts=len(res.trace.residuals) - 1,
             max_restarts=EIGS_MAX_RESTARTS, residual_bound_every_10th_restart=bound_history,
             launches=counts, seconds=seconds, ms_per_matvec=seconds * 1e3 / max(res.iterations, 1),
             pack=dict(acc_cd.stats), pack_seconds_wall=cd_pack_s, pack_native_calls=cd_native,
             pack_numpy_route=numpy_route_pack(coo_cd),
             block_pack=dict(
                 shape=list(acc_cd_block.matrix.data.shape), converged=res_b.converged,
                 eigenvalues_re=lam_b.real.tolist(), eigenvalues_im=lam_b.imag.tolist(),
                 rel_residuals_f64_host=rr_b, in_dominant_strip=in_strip_b,
                 rel_diff_from_row_compressed=float(np.max(np.abs(key(lam_b) - key(lam)))
                                                    / np.abs(lam).max()),
                 matvecs=res_b.iterations, launches=counts_b, seconds=seconds_b,
                 ms_per_matvec=seconds_b * 1e3 / max(res_b.iterations, 1)))
        native_total("eigs_accelerated", cd_native)
        held("eigs_accelerated", res, counts, "csr_spmv")
        held("eigs_accelerated [block pack]", res_b, counts_b, "bsr_spmv")
        if args.profile:
            emit("profile_eigs", solve="eigs_accelerated", route="graphs",
                 **profile_solve(solve_eigs))
            with chunk_graph.eager_chunks():
                emit("profile_eigs", solve="eigs_accelerated", route="eager",
                     **profile_solve(solve_eigs))
        if wanted("chunk_graphs"):
            graph_cases.append(chunk_graphs_case(
                "eigs_accelerated", solve_eigs, lambda r: r.iterations,
                lambda r: only_kernel("csr_spmv", r.iterations), replaying=True))
            graph_cases.append(chunk_graphs_case(
                "eigs_accelerated_block", solve_eigs_block, lambda r: r.iterations,
                lambda r: only_kernel("bsr_spmv", r.iterations), replaying=True))
        del acc_cd_block
    if wanted("kernels") or wanted("eigs_accelerated") or wanted("chunk_graphs"):
        del coo_cd
    # -- 12. eigs_sigma: GMRES shift-invert on the row-compressed storage ---------------
    sigma_eigenvalues = None  # phase eigs_sigma's, held against phase derived_adjoint's (c)
    if wanted("eigs_sigma") or wanted("chunk_graphs"):
        r, c, v, n = convection_diffusion_coo(SIGMA_NX)
        acc_s = accelerate(coo_on(r, c, v, n, dev))
        A64 = sp.csr_matrix((v, (r, c)), shape=(n, n))
        # ... and on the general pack of the same operator (block_matrix())
        acc_s_block = dataclasses.replace(acc_s, matrix=acc_s.block_matrix())

        def solve_sigma():
            return eigs(acc_s, k=SIGMA_K, sigma=SIGMA, tol=SIGMA_TOL, inner_tol=SIGMA_INNER_TOL)

        def solve_sigma_block():
            return eigs(acc_s_block, k=SIGMA_K, sigma=SIGMA, tol=SIGMA_TOL,
                        inner_tol=SIGMA_INNER_TOL)

        def sigma_launches(res, block):
            """Every application of A inside the inner solves (and their residual
            checks) is one SpMV; the true-residual check adds its own launches."""
            if block:
                return {**only_kernel("bsr_spmv", res.inner_stats["matvecs"]),
                        "bsr_spmm": sigma_check_launches(res, per_column=False)}
            return only_kernel("csr_spmv", res.inner_stats["matvecs"]
                               + sigma_check_launches(res, per_column=True))

        def sigma_pairs(res):
            """The eigenvalues, the restored eigenvectors and their f64 host
            residuals."""
            X = np.asarray(res.eigenvectors, np.complex128)
            lam = np.asarray(res.eigenvalues, np.complex128)
            rr = (np.linalg.norm(A64 @ X - X * lam[None, :], axis=0) / np.abs(lam)).tolist()
            return lam, X, rr

        def sigma_held(tag, res, counts, block):
            """Phase eigs_sigma's checks of one storage's solve."""
            _, X, rr = sigma_pairs(res)
            if res.termination == "inner_solve_failure":
                fail(f"{tag}: the inner solve failed (true residual check)")
            if X.shape != (n, SIGMA_K) or not np.isfinite(X).all():
                fail(f"{tag}: restored eigenvectors are not finite (n, k)")
            if not max(rr) <= SIGMA_RESID_LIMIT:
                fail(f"{tag}: residual {max(rr):.3e} exceeds {SIGMA_RESID_LIMIT}")
            if counts != sigma_launches(res, block):
                fail(f"{tag}: launches {counts}, expected {sigma_launches(res, block)}")

        res, seconds, counts = drive("eigs_sigma", acc_s.matrix, solve_sigma)
        res_b, seconds_b, counts_b = drive("eigs_sigma_block", acc_s_block.matrix,
                                           solve_sigma_block)
        lam, _, rr = sigma_pairs(res)
        lam_b, _, rr_b = sigma_pairs(res_b)
        st, st_b = res.inner_stats, res_b.inner_stats
        key = lambda z: np.sort_complex(z.real + 1j * np.abs(z.imag))
        emit("eigs_sigma", n=n, nx=SIGMA_NX, reduced=f"nx {SIGMA_NX} of {CD_NX}: each outer matvec "
             "is a whole inner GMRES solve", sigma=SIGMA, sigma_moved_from=7.5, k=SIGMA_K,
             tol=SIGMA_TOL, inner_tol=SIGMA_INNER_TOL, converged=res.converged,
             termination=res.termination, eigenvalues_re=lam.real.tolist(),
             eigenvalues_im=lam.imag.tolist(), rel_residuals_f64_host=rr,
             resid_limit=SIGMA_RESID_LIMIT, outer_matvecs=res.iterations,
             inner_solves=st["applications"], inner_matvecs=st["matvecs"],
             cgls_fallbacks=st["fallbacks"], cgls_iterations=st["iterations"],
             launches=counts, seconds=seconds,
             ms_per_matvec=seconds * 1e3 / max(st["matvecs"], 1),
             closed_form_top=convection_diffusion_top(SIGMA_NX, 2).tolist(), pack=dict(acc_s.stats),
             block_pack=dict(
                 shape=list(acc_s_block.matrix.data.shape), termination=res_b.termination,
                 eigenvalues_re=lam_b.real.tolist(), eigenvalues_im=lam_b.imag.tolist(),
                 rel_residuals_f64_host=rr_b,
                 rel_diff_from_row_compressed=float(np.max(np.abs(key(lam_b) - key(lam)))
                                                    / np.abs(lam).max()),
                 outer_matvecs=res_b.iterations, inner_matvecs=st_b["matvecs"],
                 cgls_fallbacks=st_b["fallbacks"], launches=counts_b, seconds=seconds_b,
                 ms_per_matvec=seconds_b * 1e3 / max(st_b["matvecs"], 1)))
        sigma_held("eigs_sigma", res, counts, block=False)
        sigma_held("eigs_sigma [block pack]", res_b, counts_b, block=True)
        sigma_eigenvalues = lam
        if wanted("chunk_graphs"):
            graph_cases.append(chunk_graphs_case(
                "eigs_sigma", solve_sigma, lambda r: r.inner_stats["matvecs"],
                lambda r: sigma_launches(r, False), replaying=True))
            graph_cases.append(chunk_graphs_case(
                "eigs_sigma_block", solve_sigma_block, lambda r: r.inner_stats["matvecs"],
                lambda r: sigma_launches(r, True), replaying=True))
        del acc_s, acc_s_block

    # -- 34. derived_adjoint: matrix-free adjoints through the kernels' backward ---------
    if wanted("derived_adjoint"):
        derived_adjoint_phase(acc_cd, sym32, sigma_eigenvalues, drive, dev, gen, args.profile)
    # -- 35. mesh_adjoint: the mesh operators' reverse products -----------------------------
    if wanted("mesh_adjoint"):
        MP_WORK.mkdir(parents=True, exist_ok=True)
        mesh_adjoint_phase(acc_cd, bsr32, drive, record, dev, peaks, kernel_cases)
    if (wanted("kernels") or wanted("eigs_accelerated") or wanted("derived_adjoint")
            or wanted("mesh_adjoint") or wanted("chunk_graphs")):
        del acc_cd

    # -- 13. eigsh_complex_accelerated: the real embedding on the symmetric kernel -----
    if wanted("eigsh_complex_accelerated") or wanted("filter_complex"):
        rc, cc, vc = build_complex_hopping(CHAIN_N, seed=SEED)
        trip_c = (rc, cc, vc, (CHAIN_N, CHAIN_N))
        native.reset_native_calls()
        t0 = time.time()
        acc_c = accelerate(trip_c, symmetric=True)
        pack_s = time.time() - t0
        chain_native = native.native_calls()
        if not (acc_c.complexified and acc_c.symmetric and acc_c.matrix.dtype == torch.float32
                and acc_c.n_work == 2 * CHAIN_N):
            fail(f"eigsh_complex_accelerated: pack {acc_c.stats}")
        H = sp.csr_matrix((vc, (rc, cc)), shape=(CHAIN_N, CHAIN_N))

    if wanted("eigsh_complex_accelerated"):
        res, seconds, counts = drive(
            "eigsh_complex_accelerated", acc_c.matrix,
            lambda: eigsh(acc_c, k=1, which="SA", tol=CHAIN_TOL, seed=SEED + 5))
        lam = np.asarray(res.eigenvalues, np.float64)
        Z = np.asarray(res.eigenvectors, np.complex128)
        rr = (np.linalg.norm(H @ Z - Z * lam[None, :], axis=0) / np.abs(lam)).tolist()
        emit("eigsh_complex_accelerated", n=CHAIN_N, n_embedded=acc_c.n_work, k=1, which="SA",
             tol=CHAIN_TOL, pack={k: v for k, v in acc_c.stats.items()},
             pack_seconds_host=pack_s, pack_native_calls=chain_native,
             pack_numpy_route=numpy_route_pack(trip_c, symmetric=True),
             converged=res.converged, termination=res.termination,
             eigenvalues=lam.tolist(), pairs_after_dedup=len(lam),
             rel_residuals_c128_host=rr, resid_limit=CHAIN_RESID_LIMIT, matvecs=res.iterations,
             launches=counts, seconds=seconds,
             ms_per_matvec=seconds * 1e3 / max(res.iterations, 1))
        native_total("eigsh_complex_accelerated", chain_native)
        if not res.converged:
            fail(f"eigsh_complex_accelerated: not converged ({res.termination})")
        if len(lam) != 1 or Z.shape != (CHAIN_N, 1) or not np.isfinite(Z).all():
            fail(f"eigsh_complex_accelerated: {len(lam)} pairs after the dedup, expected one")
        if not max(rr) <= CHAIN_RESID_LIMIT:
            fail(f"eigsh_complex_accelerated: residual {max(rr):.3e} exceeds {CHAIN_RESID_LIMIT}")
        if counts != only_kernel(spmv_kernel_of(acc_c), res.iterations):
            fail(f"eigsh_complex_accelerated: launches {counts} for {res.iterations} matvecs")
        if spmv_kernel_of(acc_c) == "csr_spmv":
            # the result line's f32 case of the row-compressed kernel
            x_c = acc_c.embed(np.random.default_rng(SEED + 13).standard_normal(CHAIN_N)
                              + 1j * np.random.default_rng(SEED + 14).standard_normal(CHAIN_N))
            kernel_cases.append(check_kernel(
                "csr_spmv", f"complex chain embedding n={acc_c.shape[0]} nnz={acc_c.matrix.nnz} "
                f"row-compressed f32 (main path)", acc_c.matrix, x_c, peaks))
            del x_c

    # -- 22. filter_complex: the window filter and KPM slicing on the real embedding --------
    if wanted("filter_complex"):
        # the reference eigenvalues: eigsh on the same pack (not a main-path phase)
        ref = eigsh(acc_c, k=FILTER_K, which="SA", tol=CHAIN_TOL, seed=SEED + 6)
        lam_ref = np.asarray(ref.eigenvalues, np.float64)
        window = (lam_ref[0] - 0.5 * (lam_ref[1] - lam_ref[0]), 0.5 * (lam_ref[2] + lam_ref[3]))
        inside = lam_ref[(lam_ref >= window[0]) & (lam_ref <= window[1])]
        applied = {"matvec": 0, "matmat": 0}
        # the filters run on the block pack (made on first need from a row-compressed pack)
        acc_f = dataclasses.replace(acc_c, matrix=counted(acc_c.block_matrix(), applied))
        filt = dict(degree=FILTER_DEGREE, tol=FILTER_TOL, max_iterations=40)

        def solve_filters():
            w = eigsh_window(acc_f, window, block_size=FILTER_BLOCK, seed=SEED + 7, **filt)
            window_products = applied["matmat"]
            r = eigsh_range(acc_f, window, block_size=FILTER_BLOCK, slack=3, seed=SEED + 8, **filt)
            return w, window_products, r

        (res_w, window_products, res_r), seconds, counts = drive(
            "filter_complex", acc_c.matrix, solve_filters)
        report = dict(n=CHAIN_N, n_embedded=acc_c.n_work, storage="float32", window=window,
                      eigsh_eigenvalues=lam_ref.tolist(), eigsh_matvecs=ref.iterations,
                      in_window=len(inside), block_size=FILTER_BLOCK,
                      embedded_block=2 * FILTER_BLOCK, agree_limit=FILTER_AGREE,
                      launches=counts, block_products=applied["matmat"],
                      matvecs=applied["matvec"], seconds=seconds, resid_limit=CHAIN_RESID_LIMIT, **filt)
        ok = True
        for name, res, products in (("window", res_w, window_products),
                                    ("range", res_r, applied["matmat"] - window_products)):
            lam = np.asarray(res.eigenvalues, np.float64)
            Z = res.eigenvectors
            rr = ([] if Z is None else
                  (np.linalg.norm(H @ Z - Z * lam[None, :], axis=0) / np.abs(lam)).tolist())
            gaps = np.diff(np.sort(lam))
            report[name] = dict(converged=res.converged, termination=res.termination,
                                outer_iterations=res.iterations, eigenvalues=lam.tolist(),
                                rel_residuals_c128_host=rr, block_products=products,
                                min_gap=float(gaps.min()) if gaps.size else None)
            ok &= (bool(res.converged) and len(lam) == len(inside) and Z is not None
                   and Z.shape == (CHAIN_N, len(lam)) and bool(np.isfinite(Z).all())
                   and max(rr, default=0.0) <= CHAIN_RESID_LIMIT
                   and all(np.any(np.abs(lam - l) <= FILTER_AGREE * abs(l)) for l in inside)
                   and (gaps.size == 0 or gaps.min() > FILTER_AGREE * np.abs(lam).max()))
        emit("filter_complex", **report)
        if not ok:
            fail(f"filter_complex: the window or the range did not give the {len(inside)} eigenvalues "
                 f"{inside.tolist()} of eigsh once each, converged, within {FILTER_AGREE}")
        # a window round is `degree` filter products and one Rayleigh-Ritz product
        if window_products != res_w.iterations * (FILTER_DEGREE + 1):
            fail(f"filter_complex: {window_products} window products for {res_w.iterations} rounds")
        want = only_kernel("sym_bsr_spmm", applied["matmat"])
        want["sym_bsr_spmv"] = applied["matvec"]
        if counts != want or applied["matmat"] == 0:
            fail(f"filter_complex: launches {counts} for {applied} products")
    if wanted("eigsh_complex_accelerated") or wanted("filter_complex"):
        del acc_c, H

    # -- 15. tridiag_si: BASELINE config 1 through cuSPARSE gtsv2 ---------------------
    if wanted("tridiag_si"):
        n = TRIDIAG_N
        d = np.full(n, 2.0)
        off = np.full(n - 1, -1.0)
        si = tridiagonal_shift_invert_operator(off, d, off, TRIDIAG_SIGMA, dtype=np.float64)
        # matmats on the card against LAPACK gtsv on the host, same bands and shift
        X = torch.randn((n, TRIDIAG_COLS), generator=gen, device=dev, dtype=torch.float64)

        def against_host(shift):
            card = tridiagonal_shift_invert_operator(off, d, off, shift, dtype=np.float64)
            host = tridiagonal_shift_invert_operator(off, d, off, shift, dtype=np.float64,
                                                     device="cpu")
            direct.reset_gtsv2_calls()
            Yc = card.matmat(X).cpu()
            if direct.gtsv2_calls() != 1:
                fail(f"tridiag_si: one matmat made {direct.gtsv2_calls()} gtsv2 calls")
            Yh = host.matmat(X.cpu())
            forward = float((torch.linalg.vector_norm(Yc - Yh, dim=0)
                             / torch.linalg.vector_norm(Yh, dim=0)).max())
            # backward error: ||(A - shift I) Y - X|| / (||A - shift I||_2 ||Y||), ||A||_2 < 4
            lap = tridiagonal_operator(off, d, off, device="cpu")
            R = lap.matmat(Yc) - shift * Yc - X.cpu()
            backward = float((torch.linalg.vector_norm(R, dim=0)
                              / ((4 + abs(shift)) * torch.linalg.vector_norm(Yc, dim=0))).max())
            return forward, backward

        well_forward, well_backward = against_host(TRIDIAG_WELL_SIGMA)
        solve_forward, solve_backward = against_host(TRIDIAG_SIGMA)
        lam_lo = 2 - 2 * np.cos(np.pi / (n + 1)) - TRIDIAG_SIGMA
        cond = (4 - TRIDIAG_SIGMA) / lam_lo
        forward_bound = float(np.finfo(np.float64).eps * cond)
        xv = X[:, 0].contiguous()
        ms_matvec = time_ms(lambda: si.matvec(xv))
        ms_matmat = time_ms(lambda: si.matmat(X))
        options = LanczosOptions(max_eigenvalues=5, eigenvalue_indices=(-5, -4, -3, -2, -1),
                                 tolerance=1e-14, max_subspace=40, reorthogonalize_interval=1,
                                 compute_eigenvectors=False)

        def solve_tridiag():
            direct.reset_gtsv2_calls()
            return LanczosEigenSolver(si, options).compute()

        res, seconds, counts = drive("tridiag_si", si, solve_tridiag)
        solves = direct.gtsv2_calls()
        theta = np.sort(np.asarray(res.eigenvalues))[::-1][:5]
        lam = np.sort(TRIDIAG_SIGMA + 1.0 / theta)
        exact = 2 - 2 * np.cos(np.arange(1, 6) * np.pi / (n + 1))
        err = float(np.max(np.abs(lam - exact)))
        emit("tridiag_si", n=n, dtype="float64", sigma=TRIDIAG_SIGMA, k=5, max_subspace=40,
             tol=1e-14, converged=res.converged, termination=res.termination,
             eigenvalues=lam.tolist(), closed_form=exact.tolist(), max_abs_err=err,
             err_limit=TRIDIAG_ERR_LIMIT, matvecs=res.iterations, gtsv2_solves=solves,
             seconds=seconds, ms_per_solve_in_solve=seconds * 1e3 / max(solves, 1),
             ms_per_solve_by_events=ms_matvec,
             ms_per_matmat_by_events={f"p={TRIDIAG_COLS}": ms_matmat},
             matmat_vs_host_lapack={
                 f"sigma={TRIDIAG_WELL_SIGMA}": dict(max_col_rel_diff=well_forward,
                                                     backward_err=well_backward),
                 f"sigma={TRIDIAG_SIGMA}": dict(max_col_rel_diff=solve_forward,
                                                backward_err=solve_backward,
                                                condition=cond, eps_times_condition=forward_bound)},
             solve_limit=TRIDIAG_SOLVE_LIMIT, launches=counts)
        if not err <= TRIDIAG_ERR_LIMIT:
            fail(f"tridiag_si: error {err:.3e} against the closed form exceeds {TRIDIAG_ERR_LIMIT}")
        if not (well_forward <= TRIDIAG_SOLVE_LIMIT and solve_backward <= TRIDIAG_SOLVE_LIMIT
                and well_backward <= TRIDIAG_SOLVE_LIMIT and solve_forward <= forward_bound):
            fail(f"tridiag_si: gtsv2 against the host LAPACK solve: difference {well_forward:.3e} "
                 f"at sigma {TRIDIAG_WELL_SIGMA}, {solve_forward:.3e} at {TRIDIAG_SIGMA} (bound "
                 f"{forward_bound:.3e}); backward errors {well_backward:.3e}, {solve_backward:.3e}")
        if solves != res.iterations or any(counts.values()):
            fail(f"tridiag_si: {solves} gtsv2 calls, launches {counts} for {res.iterations} matvecs")
        del si, X

    # -- 16. svds_accelerated: the Gram pipeline on two general packs -----------------
    if wanted("svds_accelerated"):
        r_s, c_s, v_s, shape_s = banded_rect_triplets(*SVDS_SHAPE, SVDS_BW, SVDS_PER_ROW, SEED)
        native.reset_native_calls()
        t0 = time.time()
        acc_s = accelerate((r_s, c_s, v_s, shape_s))  # what svds(..., accelerate=True) does first
        pack_s = time.time() - t0
        applied = {"matvec": 0, "matmat": 0}
        acc_s = dataclasses.replace(acc_s, matrix=counted(acc_s.matrix, applied))
        t0 = time.time()
        adj = acc_s.adjoint_matrix()  # packed once, kept on the operator
        adj_s = time.time() - t0
        svds_native = native.native_calls()
        mat_s = acc_s.matrix
        for what, b in (("pack", mat_s), ("adjoint pack", adj)):
            if b.dtype != torch.float32 or b.block_shape != (32, 128):
                fail(f"svds_accelerated: {what} {tuple(b.data.shape)} {b.dtype}, expected f32 32x128")
        packs = {}
        for what, b in (("A", mat_s), ("A^H", adj)):
            xb = torch.randn(b.shape[1], generator=gen, device=dev)
            case = check_kernel("bsr_spmv", f"svds {what} pack " + "x".join(map(str, b.data.shape))
                                + " f32", b, xb, peaks)
            packs[what] = dict(shape=list(b.data.shape), nbr=b.n_block_rows, kmax=b.k_max,
                               bytes=b.data.numel() * 4, bsr_spmv=case)
        del xb

        res_s, seconds, counts = drive(
            "svds_accelerated", mat_s, lambda: svds(acc_s, k=SVDS_K, tol=SVDS_TOL))
        U, s, Vh = res_s
        A64 = sp.csr_matrix((v_s, (r_s, c_s)), shape=shape_s)
        V = np.conj(Vh).T
        rv = (np.linalg.norm(A64 @ V - U * s[None, :], axis=0) / s[0]).tolist()
        ru = (np.linalg.norm(A64.T @ U - V * s[None, :], axis=0) / s[0]).tolist()
        orth = float(np.linalg.norm(U.T @ U - np.eye(SVDS_K)))
        gram = applied["matvec"]
        emit("svds_accelerated", m=shape_s[0], n=shape_s[1], nnz=int(A64.nnz), bw=SVDS_BW,
             per_row=SVDS_PER_ROW, k=SVDS_K, tol=SVDS_TOL, singular_values=s.tolist(),
             rel_residuals_av_su=rv, resid_limit=SVDS_RESID_LIMIT,
             rel_residuals_ahu_sv=ru, u_orthonormality=orth, orth_limit=SVDS_ORTH_LIMIT,
             pack=dict(acc_s.stats), pack_seconds_wall=pack_s, adjoint_pack_seconds=adj_s,
             pack_native_calls=svds_native,
             pack_numpy_route=numpy_route_pack((r_s, c_s, v_s, shape_s)), packs=packs, gram_matvecs=gram, recovery_products=applied["matmat"],
             launches=counts, seconds=seconds, ms_per_gram_matvec=seconds * 1e3 / max(gram, 1))
        finite = np.isfinite(s).all() and np.isfinite(U).all() and np.isfinite(Vh).all()
        if U.shape != (shape_s[0], SVDS_K) or Vh.shape != (SVDS_K, shape_s[1]) or not finite:
            fail("svds_accelerated: factors are not finite (m, k) and (k, n)")
        if not max(rv) <= SVDS_RESID_LIMIT:
            fail(f"svds_accelerated: residual {max(rv):.3e} exceeds {SVDS_RESID_LIMIT}")
        if not orth <= SVDS_ORTH_LIMIT:
            fail(f"svds_accelerated: ||U^T U - I|| = {orth:.3e} exceeds {SVDS_ORTH_LIMIT}")
        want = {k: 0 for k in cuda_spmv.KERNEL_SOURCES}
        want.update(bsr_spmv=2 * gram, bsr_spmm=applied["matmat"])
        if counts != want or gram == 0:
            fail(f"svds_accelerated: launches {counts}, expected {want}")
        native_total("svds_accelerated", svds_native)
        del acc_s, adj, mat_s, A64, U, Vh, V, res_s

    # -- 17. svds_config4: BASELINE config 4 on the card -----------------------------
    if wanted("svds_config4"):
        t4 = np.random.default_rng(SEED).standard_normal((6, 8, 7, 5))
        t4_dev = torch.as_tensor(t4, device=dev)
        out4, seconds, counts = drive(
            "svds_config4", t4_dev,
            lambda: truncated_svd_via_lanczos(t4_dev, left_axes=2, rank=3, tolerance=1e-14))
        u_np, s_np, vt_np = np.linalg.svd(t4.reshape(48, 35), full_matrices=False)
        s4 = out4.singular_values.cpu().numpy()
        err4 = float(np.max(np.abs(s4 - s_np[:3])))
        rec = out4.reconstruct().reshape(48, 35).cpu().numpy()
        rec_err = float(np.linalg.norm(rec - (u_np[:, :3] * s_np[:3]) @ vt_np[:3]))
        emit("svds_config4", shape=[6, 8, 7, 5], left_axes=2, rank=3, dtype="float64",
             device=str(out4.tensor_u.device), singular_values=s4.tolist(),
             numpy_singular_values=s_np[:3].tolist(), max_abs_err=err4,
             err_limit=CONFIG4_ERR_LIMIT, rank3_reconstruction_err=rec_err, seconds=seconds,
             launches=counts)
        if out4.tensor_u.device.type != "cuda":
            fail(f"svds_config4: the factors came back on {out4.tensor_u.device}")
        if not err4 <= CONFIG4_ERR_LIMIT:
            fail(f"svds_config4: singular-value error {err4:.3e} exceeds {CONFIG4_ERR_LIMIT}")
        if any(counts.values()):
            fail(f"svds_config4: launches {counts}: the dense Gram route launches no kernel")

    # -- 28. mesh_general: eigs and svds over meshes ----------------------------------
    if wanted("mesh_general"):
        mesh_general_phase(drive, dev)

    # -- 30. config5: BASELINE configs 5a and 5b on an 8-shard mesh of the card --------
    if wanted("config5"):
        config5_phase(drive, dev)

    # -- 18-20. the block layer: BASELINE config 3 and its kernel and dense routes -----
    def staged_block_hamiltonian(L: int, **kw):
        """``heisenberg_block_hamiltonian(L, **kw)`` built once on the host (BSR packs at
        the card's default block shape) and moved to the card by the ``BlockTensor``
        constructor: the operator the phase drives, with the seconds of each stage.
        Returns (operator, stage seconds, bytes moved)."""
        if kw.get("storage") == "bsr":
            kw = dict(kw, block_shape=CARD_BSR_BLOCK)
        native.reset_native_calls()
        t0 = time.time()
        host = heisenberg_block_hamiltonian(L, device="cpu", **kw)
        host_s = time.time() - t0
        calls = native.native_calls()
        t0 = time.time()
        bt = BlockTensor(host.structures, blocks=host.blocks, dtype=host.dtype, device=dev)
        torch.cuda.synchronize()
        transfer_s = time.time() - t0
        del host

        def parts(blk):
            if isinstance(blk, COOMatrix):
                return (blk.row, blk.col, blk.val)
            if isinstance(blk, BSRMatrix):
                return (blk.data, blk.block_cols)
            return (blk,)

        nbytes = sum(t.numel() * t.element_size() for b in bt.blocks.values() for t in parts(b))
        return bt, dict(host_build=host_s, transfer=transfer_s, native_calls=calls), nbytes

    def numpy_route_build(L: int, **kw) -> float:
        """Seconds of the same host build on the numpy route, for comparison."""
        if kw.get("storage") == "bsr":
            kw = dict(kw, block_shape=CARD_BSR_BLOCK)
        with numpy_route():
            t0 = time.time()
            host = heisenberg_block_hamiltonian(L, device="cpu", **kw)
            seconds = time.time() - t0
        del host
        return seconds

    def bit_equal_matvecs(op, n, dtype) -> bool:
        """Whether two products of one input are bit-equal (information only: the COO
        and dense-group scatters use atomics on the card)."""
        xb = torch.randn(n, generator=gen, device=dev, dtype=dtype)
        return bool(torch.equal(op.matvec(xb), op.matvec(xb)))

    def diagonal_keys(bt, L) -> bool:
        return sorted(bt.block_keys()) == [(k, k) for k in range(L + 1)]

    # -- 18. block_heisenberg: BASELINE config 3 at L = 22 ------------------------------
    sector_mtx = Path(mtx_dir.name) / f"heisenberg_L{HEIS_L}_sz0.mtx"  # read again by mtx_raw
    if wanted("block_heisenberg"):
        L = HEIS_L
        bt, stages, nbytes = staged_block_hamiltonian(L, storage="sparse")
        op = block_operator(bt)
        nnz = sum(b.nnz for b in bt.blocks.values())
        res, seconds, counts = drive(
            "block_heisenberg", op,
            lambda: LanczosEigenSolver(op, LanczosOptions(**CONFIG3_OPTIONS)).compute())
        e_block = float(res.eigenvalues[0])
        if args.profile:
            emit("profile_block", solve="block_heisenberg", **profile_solve(
                lambda: LanczosEigenSolver(op, LanczosOptions(**CONFIG3_OPTIONS)).compute()))
        bit_equal = bit_equal_matvecs(op, op.shape[1], torch.float64)
        v_heis = torch.randn(op.shape[1], generator=gen, device=dev, dtype=torch.float64)
        ms_matvec = time_ms(lambda: op.matvec(v_heis), count=5)
        keys = sorted(bt.block_keys())
        del op, bt, v_heis
        torch.cuda.empty_cache()
        # the direct route: the S_z = 0 sector through a .mtx file and CSR storage
        t0 = time.time()
        sector = heisenberg_sector_coo(L, L // 2)
        torch.cuda.synchronize()
        sector_s = time.time() - t0
        t0 = time.time()
        save_matrix_market(sector_mtx, sector, symmetry="symmetric",
                           comment=f"open Heisenberg chain L={L}, S_z=0 sector")
        save_s = time.time() - t0
        file_bytes = sector_mtx.stat().st_size
        t0 = time.time()
        loaded = load_matrix_market(sector_mtx)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        t0 = time.time()
        csr = csr_from_coo(loaded)
        torch.cuda.synchronize()
        csr_s = time.time() - t0
        same_sector = (loaded.nnz == sector.nnz and loaded.shape == sector.shape
                       and torch.equal(csr.row_ids, sector.row) and torch.equal(csr.indices, sector.col)
                       and torch.equal(csr.data, sector.val))
        del loaded, sector
        t0 = time.time()
        res_direct = LanczosEigenSolver(csr.as_linear_operator(),
                                        LanczosOptions(**CONFIG3_OPTIONS)).compute()
        torch.cuda.synchronize()
        direct_s = time.time() - t0
        e_direct = float(res_direct.eigenvalues[0])
        err = abs(e_block - e_direct)
        emit("block_heisenberg", L=L, dtype="float64", storage="sparse (COO sector blocks)",
             n=2 ** L, nnz=nnz, stored_block_keys=[list(k) for k in keys],
             stored_blocks=len(keys), all_diagonal=all(a == b for a, b in keys),
             options=CONFIG3_OPTIONS, converged=res.converged, termination=res.termination,
             matvecs=res.iterations, e_block=e_block, seconds=seconds,
             ms_per_matvec_in_solve=seconds * 1e3 / max(res.iterations, 1),
             ms_per_matvec_by_events=ms_matvec, setup_seconds=stages, operator_bytes=nbytes,
             host_build_seconds_numpy_route=numpy_route_build(L, storage="sparse"),
             matvecs_bit_equal=bit_equal, launches=counts,
             direct=dict(sector_rows=csr.shape[0], sector_nnz=csr.nnz,
                         sector_build_seconds=sector_s, mtx_save_seconds=save_s,
                         mtx_bytes=file_bytes, mtx_load_seconds=load_s,
                         csr_from_coo_seconds=csr_s, loaded_equals_built=same_sector,
                         converged=res_direct.converged, matvecs=res_direct.iterations,
                         seconds=direct_s, e_direct=e_direct),
             abs_err=err, err_limit=CONFIG3_ERR_LIMIT)
        del csr
        torch.cuda.empty_cache()
        if not (res.converged and res_direct.converged):
            fail(f"block_heisenberg: not converged (block {res.termination}, direct "
                 f"{res_direct.termination})")
        if len(keys) != L + 1 or not all(a == b for a, b in keys):
            fail(f"block_heisenberg: stored keys {keys}, expected {L + 1} diagonal sectors")
        if not same_sector:
            fail("block_heisenberg: the sector read back from the .mtx file differs from the one written")
        if not (np.isfinite(e_block) and err <= CONFIG3_ERR_LIMIT):
            fail(f"block_heisenberg: |E_block - E_direct| = {err:.3e} exceeds {CONFIG3_ERR_LIMIT}")
        if any(counts.values()):
            fail(f"block_heisenberg: launches {counts}: COO sectors launch no kernel")
        native_total("block_heisenberg", stages["native_calls"])

    # -- 23. mtx_raw: the stored triangle of the sector file, by the native parser -------
    if wanted("mtx_raw"):
        L = HEIS_L
        sector = heisenberg_sector_coo(L, L // 2, device="cpu")
        if not sector_mtx.exists():  # phase 18 did not run: write the file as it does
            save_matrix_market(sector_mtx, sector, symmetry="symmetric",
                               comment=f"open Heisenberg chain L={L}, S_z=0 sector")
        native.reset_native_calls()
        t0 = time.time()
        raw = load_matrix_market(sector_mtx, expand_symmetry=False)
        torch.cuda.synchronize()
        raw_s = time.time() - t0
        raw_native = native.native_calls()
        r, c, v = (t.cpu().numpy() for t in (raw.row, raw.col, raw.val))
        sr, sc, sv = (t.numpy() for t in (sector.row, sector.col, sector.val))
        n_diag = int(np.count_nonzero(sr == sc))
        want_nnz = (sector.nnz + n_diag) // 2
        off = r != c
        full = (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]), np.concatenate([v, v[off]]))
        order = np.lexsort((full[1], full[0]))
        expands = (len(order) == sector.nnz and all(
            np.array_equal(a[order], b) for a, b in zip(full, (sr, sc, sv))))
        emit("mtx_raw", L=L, file_bytes=sector_mtx.stat().st_size, sector_rows=sector.shape[0],
             sector_nnz=sector.nnz, diagonal=n_diag, stored_nnz=raw.nnz, expected_stored_nnz=want_nnz,
             lower_triangle=bool(np.all(r >= c)), device=str(raw.val.device),
             load_seconds=raw_s, native_calls=raw_native, expands_to_the_sector_bit_for_bit=expands)
        del raw, sector, full
        native_total("mtx_raw", raw_native)
        if not (np.all(r >= c) and len(r) == want_nnz):
            fail(f"mtx_raw: {len(r)} stored entries, expected (nnz + diag) / 2 = {want_nnz} below "
                 "the diagonal")
        if not expands:
            fail("mtx_raw: the stored triangle, mirrored, differs from the built sector")

    # -- 19. block_heisenberg_bsr: the kernel route at L = 20 ----------------------------
    if wanted("block_heisenberg_bsr"):
        L = HEIS_BSR_L
        bt, stages, nbytes = staged_block_hamiltonian(L, dtype=np.float32, storage="bsr")
        packs = [bt.blocks[(k, k)] for k in range(L + 1)]
        small = heisenberg_block_hamiltonian(4, dtype=np.float32, storage="bsr")
        defaults = {b.block_shape for b in small.blocks.values()}
        del small
        if defaults != {CARD_BSR_BLOCK} or any(b.dtype != torch.float32 for b in packs):
            fail(f"block_heisenberg_bsr: the card's default packs are {defaults}, not f32 "
                 f"{CARD_BSR_BLOCK}")
        per_sector = [dict(n_up=k, rows=int(bt.structures[0].block_dims[k]),
                           pack=list(b.data.shape), kmax=b.k_max,
                           fill=int(torch.count_nonzero(b.data)) / b.data.numel())
                      for k, b in enumerate(packs)]
        matvec_bytes = sum(bsr_work(b)[0] for b in packs)
        op = block_operator(bt)
        res, seconds, counts = drive(
            "block_heisenberg_bsr", op,
            lambda: LanczosEigenSolver(op, LanczosOptions(**BSR_LANCZOS)).compute())
        e32 = float(res.eigenvalues[0])
        if args.profile:
            emit("profile_block_bsr", solve="block_heisenberg_bsr", **profile_solve(
                lambda: LanczosEigenSolver(op, LanczosOptions(**BSR_LANCZOS)).compute()))
        bit_equal = bit_equal_matvecs(op, op.shape[1], torch.float32)
        v32 = torch.randn(op.shape[1], generator=gen, device=dev)
        ms_matvec = time_ms(lambda: op.matvec(v32), count=5)
        del op, bt, packs, v32
        torch.cuda.empty_cache()
        t0 = time.time()
        ref = LanczosEigenSolver(heisenberg_sector_coo(L, L // 2).as_linear_operator(),
                                 LanczosOptions(**CONFIG3_OPTIONS)).compute()
        torch.cuda.synchronize()
        ref_s = time.time() - t0
        e64 = float(ref.eigenvalues[0])
        rel = abs(e32 - e64) / abs(e64)
        emit("block_heisenberg_bsr", L=L, dtype="float32", storage="bsr (32x128 sector packs)",
             n=2 ** L, sectors=per_sector, operator_bytes=nbytes, bytes_per_matvec=matvec_bytes,
             options=BSR_LANCZOS, converged=res.converged, termination=res.termination,
             matvecs=res.iterations, e0_f32=e32, seconds=seconds,
             ms_per_matvec_in_solve=seconds * 1e3 / max(res.iterations, 1),
             ms_per_matvec_by_events=ms_matvec, setup_seconds=stages,
             host_build_seconds_numpy_route=numpy_route_build(L, dtype=np.float32, storage="bsr"),
             matvecs_bit_equal=bit_equal, launches=counts,
             e0_f64_sector=e64, f64_sector_matvecs=ref.iterations, f64_sector_seconds=ref_s,
             rel_err=rel, rel_limit=BSR_E0_REL_LIMIT)
        if not res.converged:
            fail(f"block_heisenberg_bsr: not converged ({res.termination})")
        if counts != only_kernel("bsr_spmv", (L + 1) * res.iterations):
            fail(f"block_heisenberg_bsr: launches {counts} for {res.iterations} matvecs "
                 f"over {L + 1} sectors")
        if not bit_equal:
            fail("block_heisenberg_bsr: two matvecs of one input differ (bsr_spmv is deterministic)")
        if not (np.isfinite(e32) and rel <= BSR_E0_REL_LIMIT):
            fail(f"block_heisenberg_bsr: E0 {e32} against the f64 sector's {e64}: rel {rel:.3e}")
        if stages["native_calls"].get("bsr_pack", 0) != L + 1:
            fail(f"block_heisenberg_bsr: native calls {stages['native_calls']}: the {L + 1} sector "
                 "packs did not go through bsr_pack")

    # -- 20. block_dense: the dense-block contractions at L = 16 ---------------------------
    if wanted("block_dense"):
        L = HEIS_DENSE_L
        H, stages, nbytes = staged_block_hamiltonian(L, storage="dense")
        dims = [int(d) for d in H.structures[0].block_dims]
        flops = sum(2 * d ** 3 for d in dims)
        cuda_spmv.reset_launch_counts()
        t0 = time.time()
        HH = H.contract(H, [(1, 0)])
        torch.cuda.synchronize()
        contract_s = time.time() - t0
        t0 = time.time()
        HH_e = einsum(H, H).from_(["i", "j"], ["j", "k"]).to(["i", "k"])
        torch.cuda.synchronize()
        einsum_s = time.time() - t0
        same_keys = sorted(HH.block_keys()) == sorted(HH_e.block_keys()) == sorted(H.block_keys())
        block_rel = max(float(torch.linalg.norm(HH.blocks[k] - HH_e.blocks[k])
                              / torch.linalg.norm(HH_e.blocks[k])) for k in HH.blocks)
        tr, sq = float(HH.full_trace()), float(H.squared_norm())
        trace_rel = abs(tr - sq) / sq
        contract_launches = cuda_spmv.launch_counts()
        del HH, HH_e
        torch.cuda.empty_cache()
        op = block_operator(H)
        res, seconds, counts = drive(
            "block_dense", op,
            lambda: LanczosEigenSolver(op, LanczosOptions(**CONFIG3_OPTIONS)).compute())
        bit_equal = bit_equal_matvecs(op, op.shape[1], torch.float64)
        vd = torch.randn(op.shape[1], generator=gen, device=dev, dtype=torch.float64)
        ms_matvec = time_ms(lambda: op.matvec(vd), count=5)
        del op, H, vd
        torch.cuda.empty_cache()
        sparse = block_operator(heisenberg_block_hamiltonian(L, storage="sparse"))
        ref = LanczosEigenSolver(sparse, LanczosOptions(**CONFIG3_OPTIONS)).compute()
        del sparse
        e_dense, e_sparse = float(res.eigenvalues[0]), float(ref.eigenvalues[0])
        peak = peaks[2]["f64_tensor_cores"]
        emit("block_dense", L=L, dtype="float64", storage="dense sector blocks",
             block_dims=dims, operator_bytes=nbytes, setup_seconds=stages,
             product_flops=flops, contract_seconds=contract_s, block_einsum_seconds=einsum_s,
             contract_tflops=flops / contract_s / 1e12, block_einsum_tflops=flops / einsum_s / 1e12,
             f64_peak_tflops=peak / 1e12, contract_share_of_f64_peak=flops / contract_s / peak,
             block_einsum_share_of_f64_peak=flops / einsum_s / peak,
             same_keys=same_keys, max_block_rel_diff=block_rel, trace_hh=tr,
             squared_norm_h=sq, trace_rel_diff=trace_rel, rel_limit=DENSE_REL_LIMIT,
             converged=res.converged, matvecs=res.iterations, e_dense=e_dense,
             e_sparse=e_sparse, e_abs_diff=abs(e_dense - e_sparse), e_limit=DENSE_E0_LIMIT,
             seconds=seconds, ms_per_matvec_in_solve=seconds * 1e3 / max(res.iterations, 1),
             ms_per_matvec_by_events=ms_matvec, matvecs_bit_equal=bit_equal,
             launches=counts, contraction_launches=contract_launches)
        if not same_keys:
            fail("block_dense: contract and block einsum give different keys")
        if not (block_rel <= DENSE_REL_LIMIT and trace_rel <= DENSE_REL_LIMIT):
            fail(f"block_dense: routes differ by {block_rel:.3e}, trace identity by {trace_rel:.3e}")
        if not (res.converged and ref.converged):
            fail("block_dense: a ground-state solve did not converge")
        if not abs(e_dense - e_sparse) <= DENSE_E0_LIMIT:
            fail(f"block_dense: dense {e_dense} against sparse {e_sparse}")
        if any(counts.values()) or any(contract_launches.values()):
            fail(f"block_dense: launches {counts}, {contract_launches}: dense blocks launch no kernel")

    # -- 21. native_parity: the native builders against the numpy routes, on the host ----
    if wanted("native_parity"):
        from eigenex_tpu_torch.block.hamiltonians import _heisenberg_triplets
        from eigenex_tpu_torch.sparse.accelerate import _pack_general, _pack_symmetric
        from eigenex_tpu_torch.sparse.accelerate import band_permutation
        from eigenex_tpu_torch.sparse.coo import _shrink

        L = PARITY_L
        seconds = {}
        native.reset_native_calls()

        def timed(key, fn):
            t0 = time.time()
            out = fn()
            seconds[key] = time.time() - t0
            return out

        r, c, v, dim = timed("sector_native", lambda: native.heisenberg_sector(L, L // 2, 1.0, 1.0, False))
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        nr, nc, nv, _ = timed("sector_numpy", lambda: _heisenberg_triplets(L, L // 2, 1.0, None, False,
                                                                            np.float64))
        equal = dict(sector=all(np.array_equal(a, b) for a, b in ((r, nr), (c, nc), (v, nv))))
        # every entry twice, shuffled: the merge adds each pair
        dup = np.random.default_rng(SEED + L).permutation(2 * len(v))
        dr, dc, dv = (np.concatenate([a, a])[dup] for a in (r, c, v))
        got = timed("coo_shrink_native", lambda: native.coo_shrink(dr, dc, dv, dim, 0.0))
        want = timed("coo_shrink_numpy", lambda: _shrink(dr.astype(np.int32), dc.astype(np.int32), dv,
                                                          dim, dim, 0.0))
        equal["coo_shrink"] = (all(np.array_equal(a, b) for a, b in zip(got, want))
                               and np.array_equal(got[2], 2 * v))
        # bsr_pack: the f32 sector at the card's 32x128 blocks, as phase 19 packs it
        v32 = v.astype(np.float32)
        got = timed("bsr_pack_native", lambda: bsr_from_coo_arrays(r, c, v32, (dim, dim), CARD_BSR_BLOCK,
                                                                    device="cpu"))
        with numpy_route():
            want = timed("bsr_pack_numpy", lambda: bsr_from_coo_arrays(r, c, v32, (dim, dim),
                                                                        CARD_BSR_BLOCK, device="cpu"))
        gd, gc = sorted_slots(got.data.numpy(), got.block_cols.numpy(), r, c, *CARD_BSR_BLOCK)
        wd, wc = sorted_slots(want.data.numpy(), want.block_cols.numpy(), r, c, *CARD_BSR_BLOCK)
        equal["bsr_pack"] = np.array_equal(gd, wd) and np.array_equal(gc, wc)
        del got, want, gd, wd
        # the accelerate() packers, fed one (native RCM) permutation
        perm = timed("rcm_native", lambda: band_permutation(r, c, dim, assume_symmetric=True))
        with numpy_route():
            perm_scipy = timed("rcm_scipy", lambda: band_permutation(r, c, dim, assume_symmetric=True))
        ip = np.empty(dim, np.int64)
        ip[perm] = np.arange(dim)
        pr, pc = ip[r], ip[c]
        n_pad = -(-dim // (32 * BLOCK)) * (32 * BLOCK)
        bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            (gs, skipped), (ws, _) = (
                timed(f"sym_pack_{tag}_{route}",
                      lambda use=use: _pack_symmetric(pr, pc, v, n_pad, BLOCK, dt, "cpu", use))
                for use, route in ((True, "native"), (False, "numpy")))
            equal[f"sym_pack_{tag}"] = (
                gs.band_reach == ws.band_reach and skipped == int(np.count_nonzero(pc // BLOCK < pr // BLOCK))
                and all(torch.equal(bits(a), bits(b)) for a, b in (
                    (gs.diag_data, ws.diag_data), (gs.upper_data, ws.upper_data),
                    (gs.upper_cols, ws.upper_cols))))
            gg, wg = (timed(f"general_pack_{tag}_{route}",
                            lambda use=use: _pack_general(pr, pc, v, n_pad, n_pad, *CARD_BSR_BLOCK, dt,
                                                          "cpu", use))
                      for use, route in ((True, "native"), (False, "numpy")))
            equal[f"general_pack_{tag}"] = (torch.equal(bits(gg.data), bits(wg.data))
                                            and torch.equal(gg.block_cols, wg.block_cols))
            del gs, ws, gg, wg
        calls = native.native_calls()
        ip_s = np.empty(dim, np.int64)
        ip_s[perm_scipy] = np.arange(dim)
        emit("native_parity", L=L, sector_rows=dim, nnz=len(v), bit_equal=equal,
             bandwidth_rcm_native=int(np.abs(pr - pc).max()),
             bandwidth_rcm_scipy=int(np.abs(ip_s[r] - ip_s[c]).max()),
             host_seconds=seconds, native_calls=calls)
        native_total("native_parity", calls)
        if not all(equal.values()):
            fail(f"native_parity: the native route differs from the numpy route: {equal}")

    # -- 24. heisenberg_l24: BASELINE config 3 at L = 24 on the native route -------------------
    if (wanted("heisenberg_l24") or wanted("heisenberg_l24_mesh")
            or wanted("heisenberg_l24_multiprocess") or wanted("chunk_graphs")):
        torch.cuda.reset_peak_memory_stats()
        native.reset_native_calls()
        host = {}
        t0 = time.time()
        r, c, v, dim = native.heisenberg_sector(L24, L24 // 2, 1.0, 1.0, False)
        host["sector_build"] = time.time() - t0
        t0 = time.time()
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        del order
        host["lexsort"] = time.time() - t0
        t0 = time.time()
        acc24 = accelerate((r, c, v, (dim, dim)), symmetric=True)
        torch.cuda.synchronize()
        host["accelerate"] = time.time() - t0
        calls = native.native_calls()
        st = acc24.stats
        main24 = acc24.matrix  # the storage accelerate() chose: row-compressed at L = 24
        kernel24 = spmv_kernel_of(acc24)
        values = np.unique(v)  # a handful: J/2 and the diagonal's multiples of Jz/4
        lossless = bool(torch.equal(torch.as_tensor(values).to(torch.bfloat16).double(),
                                    torch.as_tensor(values)))
        res, seconds, counts = drive("heisenberg_l24", main24, lambda: eigsh(acc24, **L24_SOLVE))
        if args.profile:
            emit("profile_l24", solve="heisenberg_l24",
                 **profile_solve(lambda: eigsh(acc24, **L24_SOLVE)))
        t0 = time.time()
        lam, resid = rayleigh_refine(coo_from_numpy(r, c, v, (dim, dim), device="cpu"),
                                     res.eigenvectors)
        refine_s = time.time() - t0
        e0, rel_resid = float(lam[0]), float(resid[0] / abs(lam[0]))
        solve = dict(converged=res.converged, termination=res.termination, matvecs=res.iterations,
                     e0_f32=float(res.eigenvalues[0]), seconds=seconds,
                     ms_per_matvec=seconds * 1e3 / max(res.iterations, 1))
        del res
        x24 = acc24.embed(np.random.default_rng(SEED + L24).standard_normal(dim))
        per, chain = benchtime.chain_slope(lambda p, x: p.matvec(x), main24, x24, **L24_CHAIN)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30  # before the block pack beside it
        nbytes, flops = (csr_work if kernel24 == "csr_spmv" else sym_work)(main24)
        bound_ms, bound_by = bound(nbytes, flops, peaks, OPS_UNIT[kernel24, "bfloat16"])
        torch.cuda.empty_cache()
        replay_equal = graph_replay_equal(acc24.as_linear_operator(), x24)
        # the half-storage block pack of the same triplets, made on first need: sym_bsr_spmv
        # timed beside the main path, and the operand of the mesh phases below
        t0 = time.time()
        sym24 = acc24.block_matrix()
        torch.cuda.synchronize()
        block_pack_s = time.time() - t0
        block_bytes = (sym24.diag_data.numel() + sym24.upper_data.numel()) * 2
        block_case = check_kernel(
            "sym_bsr_spmv", f"L={L24} S_z=0 sector pack {sym24.n_block_rows} block rows "
            f"reach={sym24.band_reach} ku={sym24.upper_cols.shape[1]} bf16 (far-reach regime"
            + (", main path)" if kernel24 == "sym_bsr_spmv" else ", beside the main path)"),
            sym24, x24, peaks, plain_samples=(5, 4))
        kernel_cases.append(block_case)
        case = block_case
        if kernel24 == "csr_spmv":
            case = check_kernel("csr_spmv", f"L={L24} S_z=0 sector row-compressed nnz={main24.nnz} "
                                f"bf16 (main path)", main24, x24, peaks, plain_samples=(5, 4))
            kernel_cases.append(case)
        acc24b = dataclasses.replace(acc24, matrix=sym24,
                                     stats={**st, "storage": "block", "bytes": block_bytes})
        emit("heisenberg_l24", L=L24, sector_dim=dim, nnz=len(v), host_seconds=host,
             pack_seconds=st["pack_seconds"], pack_stages=st["pack_stages"], native_calls=calls,
             dtype=st["dtype"], bf16_lossless=lossless, storage=st["storage"],
             storage_bytes=st.get("storage_bytes"), real_blocks=st.get("blocks"),
             ku=sym24.upper_cols.shape[1], band_reach=sym24.band_reach,
             bandwidth_before=st["bandwidth_before"],
             bandwidth_after=st["bandwidth_after"], pack_bytes=st["bytes"],
             pack_gib=st["bytes"] / 2 ** 30, block_pack_gib=block_bytes / 2 ** 30,
             block_pack_seconds_on_first_need=block_pack_s, n_block_rows=sym24.n_block_rows,
             options=L24_SOLVE, **solve, launches=counts, refine_seconds=refine_s, e0_f64=e0,
             e0_published=L24_E0, e0_abs_err=abs(e0 - L24_E0), e0_limit=L24_E0_LIMIT,
             residual_f64=float(resid[0]), rel_residual_f64=rel_resid, resid_limit=L24_RESID_LIMIT,
             spmv_kernel=kernel24, spmv_ms_chain_slope=None if per is None else per * 1e3,
             chain_slope=chain, spmv_bytes=nbytes, spmv_bound_ms=bound_ms, spmv_bound_by=bound_by,
             spmv_kernel_ms_by_events=case["kernel_ms"], spmv_plain_ms=case["plain_ms"],
             spmv_library_ms=case["library_ms"], spmv_library=case["library"],
             block_spmv_ms_by_events=block_case["kernel_ms"],
             graph_replay_bit_equal=replay_equal, peak_device_gib=peak_gib,
             peak_host_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)
        if wanted("chunk_graphs"):
            graph_cases.append(chunk_graphs_case(
                "heisenberg_l24", lambda: eigsh(acc24, **L24_SOLVE), lambda r: r.iterations,
                lambda r: only_kernel(kernel24, r.iterations), replaying=False))
        # -- 27. heisenberg_l24_mesh: the block pack over a 4-shard mesh of the card ----------
        l24_mesh = None
        if wanted("heisenberg_l24_mesh"):
            l24_mesh = heisenberg_l24_mesh_phase(acc24b, (r, c, v, dim), e0, solve, drive, dev,
                                                 peaks, kernel_cases)
        # -- 32. heisenberg_l24_multiprocess: the same pack on 2 processes x 2 shards -------
        # (the workers load the pack from the disk: this process frees its copy first)
        l24_work = tempfile.TemporaryDirectory(dir=MP_WORK)
        l24_pack = None
        if wanted("heisenberg_l24_multiprocess"):
            l24_pack = l24_pack_for_workers(acc24b, Path(l24_work.name))
        del acc24, acc24b, sym24, main24, x24
        torch.cuda.empty_cache()
        if l24_pack is not None:
            heisenberg_l24_multiprocess_phase(l24_pack, (r, c, v, dim), e0, solve, l24_mesh,
                                              record, dev, Path(l24_work.name))
        l24_work.cleanup()
        del r, c, v
        native_total("heisenberg_l24", calls)
        if dim != L24_DIM or st["dtype"] != "bfloat16" or not lossless:
            fail(f"heisenberg_l24: dim {dim}, pack dtype {st['dtype']} (lossless {lossless}): "
                 f"expected {L24_DIM} rows in lossless bf16")
        if not solve["converged"]:
            fail(f"heisenberg_l24: not converged ({solve['termination']})")
        if counts != only_kernel(kernel24, solve["matvecs"]):
            fail(f"heisenberg_l24: launches {counts} for {solve['matvecs']} matvecs")
        if not replay_equal:
            fail(f"heisenberg_l24: a CUDA graph replay of {kernel24} differs from the eager product")
        if not abs(e0 - L24_E0) <= L24_E0_LIMIT:
            fail(f"heisenberg_l24: E0 {e0!r} against the published {L24_E0}: "
                 f"{abs(e0 - L24_E0):.3e} exceeds {L24_E0_LIMIT}")
        if not rel_resid <= L24_RESID_LIMIT:
            fail(f"heisenberg_l24: residual {rel_resid:.3e} exceeds {L24_RESID_LIMIT}")

    # -- 33. samples: the 13 samples on the card, each held to its CPU run ------------------
    if wanted("samples"):
        samples_phase(dev)

    if only:
        # every timed case of the run, those the mesh phases added included
        emit("partial", phases=sorted(only), seconds=time.time() - t_start,
             timed=[{k: c.get(k) for k in ("kernel", "case", "kernel_ms", "bound_ms", "plain_ms",
                                           "library_ms", "max_rel_err")} for c in kernel_cases])
        return

    # -- result ----------------------------------------------------------------
    kernels = []
    for name, src in cuda_spmv.KERNEL_SOURCES.items():
        if main_launches[name] <= 0:
            fail(f"{name}: not launched on the main path")
        entries = MAIN_CASES[name]
        claimed = set().union(*(e.get("phases", {}) for e in entries))
        rest = [e for e in entries if "phases" not in e]
        for e in entries:
            # the case measured at a shape and storage the main path gives the kernel
            c = next(c for c in kernel_cases
                     if c["kernel"] == name and all(k in c["case"] for k in e["match"]))
            # an entry with its own phases carries its share of their launches; of the
            # others, a kernel's only one carries all the rest, and one entry per
            # storage carries the launches of the phases on that storage
            if "phases" in e:
                by_phase = {}
                for p, share in e["phases"].items():
                    part = per_phase[p][name] * share
                    if Fraction(part).denominator != 1:
                        fail(f"{name}: {per_phase[p][name]} launches of phase {p} do not split "
                             f"into shares of {share}")
                    by_phase[p] = int(part)
            else:
                by_phase = {p: v[name] for p, v in per_phase.items() if p not in claimed
                            and (len(rest) == 1 or phase_storage[p] == c["storage"])}
            launches = sum(by_phase.values())
            if launches <= 0:
                fail(f"{name} [{c['case'].strip()}]: not launched on the main path")
            mixed = sorted(p for p, k in by_phase.items() if k and phase_storage[p] != c["storage"])
            if mixed:
                fail(f"{name} [{c['case'].strip()}]: launches of phases {mixed} on another "
                     f"block storage than the case's {c['storage']}")
            worst = [k for k in kernel_cases if k["kernel"] == name]
            entry = dict(
                name=name, route="cuda", source=f"eigenex_tpu_torch/csrc/{src}",
                replaces=REPLACES[name], also_replaces=ALSO_REPLACES[name],
                launches=launches, launches_by_phase=by_phase, storage=c["storage"],
                max_abs_err=c["max_abs_err"], ms=c["kernel_ms"], plain_ms=c["plain_ms"],
                bound_ms=c["bound_ms"], bound_by=c["bound_by"], ops_unit=c["ops_unit"],
                library_ms=c["library_ms"], measured_at=c["case"].strip(),
                worst_rel_err_all_cases=max(k["max_rel_err"] for k in worst),
            )
            if "max_col_rel_err" in c:
                entry["worst_col_rel_err_all_cases"] = max(k["max_col_rel_err"] for k in worst)
            kernels.append(entry)
    emit("total", seconds=time.time() - t_start,
         chunk_graphs_seconds=sum(c["seconds"] for c in graph_cases))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
