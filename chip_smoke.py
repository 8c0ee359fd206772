#!/usr/bin/env python3
"""Start-up proof of the PyTorch/CUDA port on one NVIDIA GPU.

Run it from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels of ``eigenex_tpu_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card, and drives
the port's main path -- symmetric ``eigsh`` end to end through those
kernels -- at full size:

1. ``device``            card, power limit, versions; TF32 must be off.
2. ``build``             seconds to build the kernels.
3. ``kernels``           each kernel against its plain version, every regime,
                         f32 and bf16 storage, with times and bounds.
4. ``eigsh_banded``      n = 262,144 banded symmetric operator (f32 half
                         storage), ``eigsh(k=4, which="LA")``.
5. ``eigsh_accelerated`` n = 262,144 scalar-sparse operator -> ``accelerate``
                         (RCM + bf16 blocks) -> ``eigsh`` -> eigenvectors restored.
6. ``eigsh_bsr``         ``eigsh`` on the same operator in full BSR storage (a few restarts).

Each phase prints one JSON line.  Any failure ends the run with a non-zero
exit code: no phase's exception is caught and passed over, nothing carries on
on the CPU, and no kernel gives way to its plain version.  Without a CUDA
device the script exits non-zero and prints no result.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path, error, times and bound.

Options (none is needed): ``--phases a,b,c`` runs a subset (the result line
is then not printed), ``--profile`` repeats the ``eigsh_banded`` solve under ``torch.profiler`` and
prints the device's busy share and the kernels by time (phase ``profile``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from eigenex_tpu_torch import accelerate, eigsh, sym_bsr_from_bsr
from eigenex_tpu_torch.convert import bsr_from_numpy
from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.sparse.bsr import BSRMatrix
from eigenex_tpu_torch.sparse.sym_bsr import SymBSRMatrix

# ---------------------------------------------------------------------------
# stated tolerances and sizes
# ---------------------------------------------------------------------------
KERNEL_REL_TOL = 1e-5      # ||kernel - plain|| / ||plain||, plain on the same blocks lifted to f32
BANDED_TOL = 1e-5          # eigsh tol, phase eigsh_banded
BANDED_RESID_LIMIT = 1e-4  # ||A x - lambda x|| / |lambda| of every returned pair
ACCEL_TOL = 1e-5           # eigsh tol, phase eigsh_accelerated
ACCEL_RESID_LIMIT = 1e-4   # same residual, in f64 on the host against the original triplets
BSR_RESID_LIMIT = 5e-2     # same residual of the unconverged pairs of phase eigsh_bsr (3 restarts)
BSR_TOP_RITZ_GAP = 1e-3    # ... whose top Ritz value lies within this relative distance of lambda_max
TIMED_LAUNCHES = 20        # timed samples per kernel and per plain version, after warm-up

BLOCK = 128
NBR = 2048                 # 2048 block rows of 128 -> n = 262,144
SEED = 0

#: peak rates by card, NVIDIA's data sheets: device memory bytes/s, f32 FMA flop/s
#: outside the tensor cores.  The first key found in the card's name is used.
PEAKS = (
    ("H200", 4.8e12, 67e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
)

REPLACES = {
    "bsr_spmv": "eigenex_tpu/ops/pallas_spmv.py:91",
    "sym_bsr_spmv": "eigenex_tpu/ops/pallas_spmv.py:210",
}
ALSO_REPLACES = {
    "bsr_spmv": ["eigenex_tpu/ops/pallas_spmv.py:39 (_dot_mode/_sdot precision rule)"],
    "sym_bsr_spmv": [
        "eigenex_tpu/ops/pallas_spmv.py:600 (_sym_spmv_kernel)",
        "eigenex_tpu/ops/pallas_spmv.py:355 (_sym_spmv_ring_kernel)",
        "eigenex_tpu/ops/pallas_spmv.py:39 (_dot_mode/_sdot precision rule)",
    ],
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str):
    for key, bw, flops in PEAKS:
        if key in name:
            return key, bw, flops
    return "H100 (assumed: card not in table)", 3.35e12, 67e12


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


# ---------------------------------------------------------------------------
# measuring
# ---------------------------------------------------------------------------
def time_ms(fn, count: int = TIMED_LAUNCHES, batch: int = 8, warm: int = 3) -> float:
    """Time of one call: median over ``count`` samples, each the CUDA-event
    time of ``batch`` back-to-back calls divided by ``batch``, warm.  Queuing a
    batch keeps the device fed, so a sample is the device's time per call and
    not the host's time to issue one.  The operators are far larger than the
    L2 cache, so every call streams its blocks from device memory."""
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


def bound(nbytes: int, flops: int, peaks) -> tuple[float, str]:
    _, bw, rate = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / rate * 1e3
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


def library_bsr_ms(bsr, x):
    """Time of ``torch.sparse_bsr_tensor(...) @ x`` on the same operator: the
    one PyTorch call that computes the general product.  Used nowhere in the
    port.  Returns (ms or None, note)."""
    nbr, kmax, bm, bn = bsr.data.shape
    try:
        crow = torch.arange(0, (nbr + 1) * kmax, kmax, dtype=torch.int64, device=bsr.device)
        cols, order = torch.sort(bsr.block_cols.long(), dim=1, stable=True)
        values = torch.gather(bsr.data, 1, order[:, :, None, None].expand(-1, -1, bm, bn))
        lib = torch.sparse_bsr_tensor(crow, cols.reshape(-1), values.reshape(-1, bm, bn),
                                      size=bsr.shape)
        xcol = x.to(bsr.dtype)[:, None]
        y = (lib @ xcol)[:, 0].float()
        ref = cuda_spmv.bsr_spmv_plain(bsr.astype(torch.float32), x)
        rel = float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref))
        if not rel < (1e-2 if bsr.dtype == torch.bfloat16 else 1e-4):
            return None, f"library product disagrees (rel {rel:.2e})"
        return time_ms(lambda: lib @ xcol), "torch.sparse_bsr_tensor @ x"
    except (RuntimeError, NotImplementedError) as e:  # the yardstick only, never the port
        return None, f"not supported here: {str(e).splitlines()[0][:120]}"


def check_kernel(name: str, case: str, op, x, peaks) -> dict:
    """One kernel on one operator: against its plain version, timed, bounded."""
    is_sym = name == "sym_bsr_spmv"
    wrapper = cuda_spmv.sym_bsr_spmv if is_sym else cuda_spmv.bsr_spmv
    plain = cuda_spmv.sym_bsr_spmv_plain if is_sym else cuda_spmv.bsr_spmv_plain
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
    if is_sym:
        y2 = wrapper(op, x)
        torch.cuda.synchronize()
        if not torch.equal(y, y2):
            fail(f"{name}[{case}]: two runs on the same input are not bit-equal")
        out["bit_equal_rerun"] = True
    out["kernel_ms"] = time_ms(lambda: wrapper(op, x))
    out["plain_ms"] = time_ms(lambda: plain(op, x))
    nbytes, flops = sym_work(op) if is_sym else bsr_work(op)
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, peaks)
    out["bytes"] = nbytes
    out["share_of_bound_rate"] = out["bound_ms"] / out["kernel_ms"]
    if is_sym:
        out["library_ms"], out["library"] = None, "no single PyTorch call takes half storage"
    else:
        out["library_ms"], out["library"] = library_bsr_ms(op, x)
    out["launches"] = cuda_spmv.launch_counts()[name] - before  # this check's own launches
    return out


def profile_solve(fn) -> dict:
    """One solve under ``torch.profiler``: wall time, the time the device was
    busy (sum of the self device time of every event; one stream, so nothing
    overlaps) and the events that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device-side events only: an operator's own row repeats its kernels' time
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    out = dict(solve="eigsh_banded", matvecs=res.iterations, wall_ms_under_profiler=wall_ms,
               device_busy_ms=busy_ms,
               top_device_events=[dict(name=e.key[:80], calls=e.count, ms=device_us(e) / 1e3)
                                  for e in events[:10] if device_us(e) > 0])
    if busy_ms > 0:
        out["device_busy_share"] = busy_ms / wall_ms
        out["device_idle_share"] = 1 - busy_ms / wall_ms
    else:
        out["note"] = "the profiler recorded no device time on this machine"
    return out


def residuals(matvec, lam, X) -> list[float]:
    """||A x - lambda x|| / |lambda| per column, A applied by ``matvec``."""
    out = []
    for j, l in enumerate(lam):
        x = X[:, j].contiguous()
        r = matvec(x) - float(l) * x
        out.append(float(torch.linalg.vector_norm(r)) / abs(float(l)))
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="", help="comma-separated subset of phases to run")
    ap.add_argument("--profile", action="store_true",
                    help="repeat the eigsh_banded solve under torch.profiler")
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
         peak_f32_flops=peaks[2])

    # -- 2. build -----------------------------------------------------------
    t0 = time.time()
    libs = cuda_spmv.build_kernels()
    build_s = time.time() - t0
    ptxas = {}
    for name, path in libs.items():
        log = path.with_suffix(".so.log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, libraries={k: p.name for k, p in libs.items()},
         flags=" ".join(cuda_spmv.NVCC_FLAGS), ptxas=ptxas)

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

    kernel_cases: list[dict] = []
    # -- 3. kernels ----------------------------------------------------------
    if wanted("kernels"):
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            kernel_cases.append(check_kernel(
                "bsr_spmv", f"banded {nbr}x3x{BLOCK}^2 {tag}", bsr32.astype(dt), x, peaks))
            kernel_cases.append(check_kernel(
                "sym_bsr_spmv", f"banded reach=1 ku=1 {tag} (stream regime)",
                sym32.astype(dt), x, peaks))
        scattered = random_sym_blocks(nbr, BLOCK, scattered_cols(nbr, 3, SEED + 1), -1, gen)
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            kernel_cases.append(check_kernel(
                "sym_bsr_spmv", f"scattered reach=-1 ku=3 {tag} (resident regime)",
                scattered.astype(dt), x, peaks))
        del scattered
        far_d = (1, 2, 100, 485)
        far = random_sym_blocks(nbr, BLOCK, far_reach_cols(nbr, far_d), max(far_d), gen)
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            kernel_cases.append(check_kernel(
                "sym_bsr_spmv", f"far reach={max(far_d)} ku=4 {tag} (ring regime)",
                far.astype(dt), x, peaks))
        del far
        # other block shapes the kernels take, at a modest size: several 128-column
        # chunks per row, more than one pass of 128 rows, and short blocks
        wide = random_sym_blocks(256, 256, far_reach_cols(256, (1, 37)), 37, gen)
        xw = torch.randn(wide.shape[1], generator=gen, device=dev)
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            kernel_cases.append(check_kernel(
                "sym_bsr_spmv", f"256x256 blocks reach=37 ku=2 {tag}", wide.astype(dt), xw, peaks))
        del wide
        for bm, bn in ((8, 128), (320, 256)):
            nbr_g, nbc_g, kmax_g = 512, 96, 4
            gdata = torch.randn((nbr_g, kmax_g, bm, bn), generator=gen, device=dev)
            gcols = torch.randint(0, nbc_g, (nbr_g, kmax_g), generator=gen, device=dev,
                                  dtype=torch.int32)
            general = BSRMatrix(gdata, gcols, (nbr_g * bm, nbc_g * bn))
            xg = torch.randn(nbc_g * bn, generator=gen, device=dev)
            for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                kernel_cases.append(check_kernel(
                    "bsr_spmv", f"rectangular {bm}x{bn} blocks kmax=4 {tag}",
                    general.astype(dt), xg, peaks))
            del general, gdata
        torch.cuda.empty_cache()
        emit("kernels", rel_tol=KERNEL_REL_TOL, timed_samples=TIMED_LAUNCHES, calls_per_sample=8,
             cases=kernel_cases)

    main_launches = {name: 0 for name in cuda_spmv.KERNEL_SOURCES}
    per_phase: dict[str, dict] = {}

    def drive(phase: str, fn):
        """Run one main-path phase with the launch counts set to 0 just
        before it and read just after."""
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

    # -- 4. eigsh_banded: the main path at full width --------------------------
    lam_max = None
    if wanted("eigsh_banded"):
        res, seconds, counts = drive(
            "eigsh_banded",
            lambda: eigsh(sym32, k=4, which="LA", v0=v0_banded, tol=BANDED_TOL,
                          max_restarts=400))
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
        if counts["sym_bsr_spmv"] != res.iterations or counts["bsr_spmv"] != 0:
            fail(f"eigsh_banded: launches {counts} for {res.iterations} matvecs")
        lam_max = float(res.eigenvalues[-1])
        if args.profile:
            emit("profile", **profile_solve(
                lambda: eigsh(sym32, k=4, which="LA", v0=v0_banded, tol=BANDED_TOL,
                              max_restarts=400)))

    # -- 5. eigsh_accelerated --------------------------------------------------
    if wanted("eigsh_accelerated"):
        import scipy.sparse as sp

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
        acc = accelerate(trip, symmetric=True)
        if acc.matrix.dtype != torch.bfloat16:
            fail(f"eigsh_accelerated: dyadic values packed as {acc.matrix.dtype}, expected bfloat16")
        res, seconds, counts = drive(
            "eigsh_accelerated",
            lambda: eigsh(acc, k=2, which="LA", tol=ACCEL_TOL, seed=3, max_restarts=400))
        A64 = sp.coo_matrix((trip[2], (trip[0], trip[1])), shape=trip[3]).tocsr()
        X = np.asarray(res.eigenvectors, np.float64)
        lam = np.asarray(res.eigenvalues, np.float64)
        rr = (np.linalg.norm(A64 @ X - X * lam[None, :], axis=0) / np.abs(lam)).tolist()
        stats = {k: v for k, v in acc.stats.items()}
        emit("eigsh_accelerated", n=n_a, nnz=int(A64.nnz), pack=stats, k=2, which="LA",
             tol=ACCEL_TOL, resid_limit=ACCEL_RESID_LIMIT, converged=res.converged,
             termination=res.termination, eigenvalues=lam.tolist(), rel_residuals_f64_host=rr,
             matvecs=res.iterations, launches=counts, seconds=seconds,
             ms_per_matvec=seconds * 1e3 / max(res.iterations, 1))
        if not res.converged:
            fail(f"eigsh_accelerated: not converged ({res.termination})")
        if X.shape != (n_a, 2) or not np.isfinite(X).all():
            fail("eigsh_accelerated: restored eigenvectors are not finite (n, 2)")
        if not max(rr) <= ACCEL_RESID_LIMIT:
            fail(f"eigsh_accelerated: residual {max(rr):.3e} exceeds {ACCEL_RESID_LIMIT}")
        if counts["sym_bsr_spmv"] != res.iterations or counts["bsr_spmv"] != 0:
            fail(f"eigsh_accelerated: launches {counts} for {res.iterations} matvecs")
        del acc

    # -- 6. eigsh_bsr: kernel A on a path ---------------------------------------
    if wanted("eigsh_bsr"):
        res, seconds, counts = drive(
            "eigsh_bsr",
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
        if counts["bsr_spmv"] != res.iterations or counts["sym_bsr_spmv"] != 0 or res.iterations < 24:
            fail(f"eigsh_bsr: launches {counts} for {res.iterations} matvecs")
        if not max(rr) <= BSR_RESID_LIMIT:
            fail(f"eigsh_bsr: residual {max(rr):.3e} exceeds {BSR_RESID_LIMIT}")
        # a Ritz value of a symmetric operator never exceeds its largest
        # eigenvalue, and after 66 matvecs the top one has all but reached it
        if lam_max is not None and not (
                lam_max * (1 - BSR_TOP_RITZ_GAP) <= lam[-1] <= lam_max * (1 + 1e-4)):
            fail(f"eigsh_bsr: top Ritz value {lam[-1]} against lambda_max {lam_max}")

    if only:
        emit("partial", phases=sorted(only), seconds=time.time() - t_start)
        return

    # -- result ----------------------------------------------------------------
    def main_case(name: str) -> dict:
        """The case measured at the shape and storage the main path gives the kernel."""
        key = ("banded", "f32")
        return next(c for c in kernel_cases if c["kernel"] == name and all(k in c["case"] for k in key))

    kernels = []
    for name, src in cuda_spmv.KERNEL_SOURCES.items():
        c = main_case(name)
        if main_launches[name] <= 0:
            fail(f"{name}: not launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source=f"eigenex_tpu_torch/csrc/{src}",
            replaces=REPLACES[name], also_replaces=ALSO_REPLACES[name],
            launches=main_launches[name], launches_by_phase={p: v[name] for p, v in per_phase.items()},
            max_abs_err=c["max_abs_err"], ms=c["kernel_ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=c["library_ms"],
            measured_at=c["case"],
            worst_rel_err_all_cases=max(k["max_rel_err"] for k in kernel_cases if k["kernel"] == name),
        ))
    emit("total", seconds=time.time() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
