"""Run a scenario on a mesh across processes: the spawner and the worker.

:func:`spawn` starts ``nproc`` worker processes of this module on one
machine, joined by :func:`~eigenex_tpu_torch.parallel.mesh.initialize_multihost`
through a free localhost port; each builds the global mesh from its own
``devices`` (``["cpu"] * 2``, ``["cuda:0"] * 2``), runs one scenario of
:data:`SCENARIOS` and prints its result as one JSON line, which
:func:`spawn` returns, one dict a process in rank order.  A worker that
fails, or a run that outlasts ``timeout``, ends every worker and raises
:class:`WorkerFailure` with each process's exit code and the end of its
errors: nothing is retried and nothing hangs.  A program with scenarios of
its own hands :func:`spawn` a worker file that calls :func:`main` with them.

The scenarios take their operator from a spec that every process builds
the same way (:func:`build_operator`): the reference's multi-process test
operators (a 1-D Laplacian; a banded symmetric operator whose off-diagonals
reach past one block), or arrays a caller wrote with :func:`save_operator`
(a ``.npz`` of a BSR or half-stored pack), or an
:meth:`AcceleratedOperator.save` file.  Each result carries the kernels'
launch counts of the scenario's solve (:func:`~eigenex_tpu_torch.ops.cuda_spmv.launch_counts`)
and its seconds; :func:`scenario_eigsh` keeps the operator in host memory,
so that each process places only its own shards on its card.

Run a worker by hand (normally :func:`spawn` does)::

    python -m eigenex_tpu_torch.parallel.multiproc <host:port> <nproc> <rank> <scenario> '<params json>'
"""

from __future__ import annotations

import json
import os
import resource
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..utils.exceptions import EigenexError

__all__ = ["spawn", "free_port", "WorkerFailure", "SCENARIOS", "build_operator", "save_operator",
           "psum_us"]

#: the prefix of the line that carries a worker's result
RESULT_MARK = "EIGENEX_WORKER_RESULT "
_ROOT = Path(__file__).resolve().parents[2]


class WorkerFailure(EigenexError):
    """A worker process failed or the run outlasted its timeout."""

    def __init__(self, message: str, returncodes: list, seconds: float):
        super().__init__(message)
        self.returncodes = returncodes
        self.seconds = seconds


def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario: str, nproc: int, devices: list, params: dict | None = None, *,
          timeout: float = 300.0, collective_timeout: float | None = None,
          threads: int | None = None, worker: str | Path | None = None) -> list[dict]:
    """Run ``scenario`` on ``nproc`` processes of this machine, each with
    the local ``devices`` of the global mesh; their results in rank order.

    ``timeout``: seconds for the whole run, after which every worker is
    killed; ``collective_timeout``: the process group's timeout (default
    the mesh's 600 s); ``threads``: each worker's intra-op threads;
    ``worker``: a Python file to run in place of this module, one that
    calls :func:`main` with scenarios of its own.  Each worker writes its
    output to files of its own (so that none blocks on a full pipe), read
    once all have ended."""
    coordinator = f"127.0.0.1:{free_port()}"
    payload = dict(params or {}, devices=[str(d) for d in devices])
    if collective_timeout is not None:
        payload["collective_timeout"] = float(collective_timeout)
    if threads is not None:
        payload["threads"] = int(threads)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    command = ([sys.executable, str(worker)] if worker is not None
               else [sys.executable, "-m", "eigenex_tpu_torch.parallel.multiproc"])
    procs: list = []
    with tempfile.TemporaryDirectory(prefix="eigenex_workers_") as tmp:
        files = [(open(f"{tmp}/{rank}.out", "w+"), open(f"{tmp}/{rank}.err", "w+"))
                 for rank in range(nproc)]
        try:
            for rank, (out, err) in enumerate(files):
                procs.append(subprocess.Popen(
                    command + [coordinator, str(nproc), str(rank), scenario, json.dumps(payload)],
                    stdout=out, stderr=err, text=True, env=env, cwd=str(_ROOT)))
            t0 = time.monotonic()
            # a failing worker makes the others raise at their next collective
            while any(p.poll() is None for p in procs) and time.monotonic() - t0 < timeout:
                time.sleep(0.05)
            late = [p.poll() is None for p in procs]
            seconds = time.monotonic() - t0
        finally:  # no worker outlives the call
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
            out.close()
            err.close()
    codes = [p.returncode for p in procs]
    if any(late) and not any(c for c, was_late in zip(codes, late) if not was_late):
        raise WorkerFailure(f"{scenario}: the workers did not finish within {timeout:g} s",
                            codes, seconds)
    if any(codes):
        tails = "\n".join(f"--- rank {r} exit {c}:\n{e[-2500:]}"
                          for r, (c, (_, e)) in enumerate(zip(codes, outs)) if c)
        raise WorkerFailure(f"{scenario}: worker exit codes {codes}\n{tails}", codes, seconds)
    results = []
    for rank, (so, _) in enumerate(outs):
        lines = [ln for ln in so.splitlines() if ln.startswith(RESULT_MARK)]
        if len(lines) != 1:
            raise WorkerFailure(f"{scenario}: rank {rank} printed no result", codes, seconds)
        results.append(json.loads(lines[0][len(RESULT_MARK):]))
    return results


# ---------------------------------------------------------------------------
# operators every process builds the same way
# ---------------------------------------------------------------------------
def _laplacian_triplets(n: int):
    r = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    c = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    v = np.concatenate([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    return r, c, v


def banded_sym_triplets(n: int, bw: int, seed: int = 7):
    """The symmetric banded operator of the reference's multi-process test:
    off-diagonals reach past one block, so sym_halo boundary blocks cross
    the process boundary."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 3)
    c = r + rng.integers(1, bw, size=len(r))
    keep = c < n
    r, c = r[keep], c[keep]
    v = np.round(rng.standard_normal(len(r)) * 8) / 8
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 4.0)])
    return rows, cols, vals


def save_operator(path, op) -> None:
    """Write a BSR or half-stored (SymBSR) pack for :func:`build_operator`'s
    ``{"kind": "npz", "path": ...}``."""
    from ..sparse.sym_bsr import SymBSRMatrix

    def host(t):
        return t.detach().cpu().numpy()

    if isinstance(op, SymBSRMatrix):
        np.savez(path, diag=host(op.diag_data), upper=host(op.upper_data),
                 ucols=host(op.upper_cols), shape=np.asarray(op.shape),
                 band_reach=np.asarray(op.band_reach))
    else:
        np.savez(path, data=host(op.data), cols=host(op.block_cols), shape=np.asarray(op.shape))


def build_operator(spec: dict, device):
    """The operator of ``spec`` on ``device``:

    - ``{"kind": "laplacian", "n", "block"}``: the 1-D Laplacian in f64 BSR;
    - ``{"kind": "banded_sym", "n", "bw", "block"}``: :func:`banded_sym_triplets` in f64 BSR;
    - ``{"kind": "npz", "path"}``: a :func:`save_operator` file;
    - ``{"kind": "accelerated", "path"}``: an ``AcceleratedOperator.save`` file."""
    from ..sparse.accelerate import AcceleratedOperator
    from ..sparse.bsr import BSRMatrix, bsr_from_coo_arrays
    from ..sparse.sym_bsr import SymBSRMatrix

    kind = spec["kind"]
    if kind in ("laplacian", "banded_sym"):
        n, b = int(spec["n"]), int(spec.get("block", 4))
        r, c, v = (_laplacian_triplets(n) if kind == "laplacian"
                   else banded_sym_triplets(n, int(spec["bw"]), int(spec.get("seed", 7))))
        return bsr_from_coo_arrays(r, c, v, (n, n), (b, b), device=device)
    if kind == "npz":
        with np.load(spec["path"]) as z:
            shape = tuple(int(s) for s in z["shape"])
            if "diag" in z.files:
                return SymBSRMatrix(torch.as_tensor(z["diag"]).to(device),
                                    torch.as_tensor(z["upper"]).to(device),
                                    torch.as_tensor(z["ucols"]).to(device), shape,
                                    int(z["band_reach"]))
            return BSRMatrix(torch.as_tensor(z["data"]).to(device),
                             torch.as_tensor(z["cols"]).to(device), shape)
    if kind == "accelerated":
        return AcceleratedOperator.load(spec["path"], device=device)
    raise EigenexError(f"unknown operator kind {kind!r}")


# ---------------------------------------------------------------------------
# the scenarios: (mesh, **params) -> a JSON-able dict of replicated results
# ---------------------------------------------------------------------------
def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _counted(mesh, fn):
    """(result, seconds, launches) of ``fn()``, the counts from 0."""
    from ..ops import cuda_spmv

    dev = mesh.first_device
    _sync(dev)
    cuda_spmv.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    seconds = time.perf_counter() - t0
    return out, seconds, dict(cuda_spmv.launch_counts())


def scenario_steps(mesh, operator, steps=12, max_subspace=20, seed=2, matvec_mode="allgather"):
    """``distributed_lanczos_steps`` from a numpy-seeded start: the
    replicated recurrence (alpha, beta, k)."""
    from ..parallel.distributed import distributed_lanczos_steps, pad_bsr_for_mesh
    from ..solvers.lanczos import init_lanczos_state

    nd = mesh.shape[mesh.axis_names[0]]
    bsr = pad_bsr_for_mesh(build_operator(operator, mesh.first_device), nd)
    op = bsr.as_linear_operator()
    v0 = np.random.default_rng(seed).standard_normal(bsr.shape[1])
    s0 = init_lanczos_state(op, max_subspace, v0=torch.as_tensor(v0, dtype=op.dtype))
    s, seconds, launches = _counted(mesh, lambda: distributed_lanczos_steps(
        bsr, s0, steps, mesh, matvec_mode=matvec_mode))
    return dict(k=int(s.k), alpha=s.alpha.cpu().tolist(), beta=s.beta.cpu().tolist(),
                seconds=seconds, launches=launches)


def scenario_trlm(mesh, operator, k=4, tolerance=1e-10, max_subspace=24, max_restarts=60,
                  seed=0, matvec_mode="sym_halo"):
    """``DistributedThickRestartLanczosEigenSolver`` on half storage, as the
    reference's ``sym_halo_trlm`` worker runs it: eigenvalues and flags."""
    from ..parallel.distributed import (DistributedThickRestartLanczosEigenSolver,
                                        pad_bsr_for_mesh)
    from ..solvers.restart import ThickRestartOptions
    from ..sparse.sym_bsr import sym_bsr_from_bsr

    nd = mesh.shape[mesh.axis_names[0]]
    sym = sym_bsr_from_bsr(pad_bsr_for_mesh(build_operator(operator, mesh.first_device), nd))
    solver = DistributedThickRestartLanczosEigenSolver(
        sym, mesh,
        ThickRestartOptions(max_eigenvalues=k, eigenvalue_indices=tuple(range(k)),
                            tolerance=tolerance, max_subspace=max_subspace,
                            max_restarts=max_restarts, seed=seed),
        axis_name=mesh.axis_names[0], matvec_mode=matvec_mode)
    res, seconds, launches = _counted(mesh, solver.compute)
    return dict(k=int(res.iterations), eigenvalues=np.asarray(res.eigenvalues).tolist(),
                converged=bool(res.converged), seconds=seconds, launches=launches)


def psum_us(mesh, count: int = 200) -> float:
    """Wall µs of one psum of 4 KB a shard on ``mesh`` (``count`` in a row)."""
    from .shard_map import P, shard_map

    def psums(c, v):
        for _ in range(count):
            v = c.psum(v, mesh.axis_names[0])
        return v

    run = shard_map(psums, mesh, (P(mesh.axis_names[0]),), P(mesh.axis_names[0]))
    x = torch.ones(mesh.size * 1024, device=mesh.first_device)
    run(x)
    _sync(mesh.first_device)
    t0 = time.perf_counter()
    run(x)
    _sync(mesh.first_device)
    return (time.perf_counter() - t0) / count * 1e6


def scenario_eigsh(mesh, operator, solve, vectors_to=None):
    """``eigsh(op, mesh=mesh, **solve)`` with the operator in host memory,
    so that each process places only its own shards: eigenvalues, matvecs,
    the solve's seconds and launches, the device memory it took at its
    peak and kept after it, the wall µs of a psum on this mesh, and
    (``vectors_to``) the eigenvectors written by rank 0 as ``.npy``."""
    from ..solvers.api import eigsh

    dev = mesh.first_device
    op = build_operator(operator, "cpu")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    res, seconds, launches = _counted(mesh, lambda: eigsh(op, mesh=mesh, **solve))
    out = dict(eigenvalues=np.asarray(res.eigenvalues).tolist(), matvecs=int(res.iterations),
               converged=bool(res.converged), termination=str(res.termination),
               seconds=seconds, launches=launches)
    if cuda:
        out.update(kept_gib=(torch.cuda.memory_allocated(dev) - before) / 2 ** 30,
                   peak_gib=(torch.cuda.max_memory_allocated(dev) - before) / 2 ** 30)
    if vectors_to is not None and mesh.process_index == 0:
        X = res.eigenvectors
        np.save(vectors_to, X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X))
    out["psum_us"] = psum_us(mesh)
    return out


def scenario_reverse(mesh, operator, modes=("allgather",), seed=3, calls=1):
    """Each mode's reverse product (``rmatvec`` of :func:`mesh_operator`)
    of one numpy-seeded vector: the SHA-256 of the result's bytes (equal
    digests: bit-equal results), its norm, and the seconds and launches of
    ``calls`` calls after a first one (which builds the reverse pieces)."""
    import hashlib

    from .distributed import mesh_operator, pad_bsr_for_mesh

    nd = mesh.shape[mesh.axis_names[0]]
    bsr = pad_bsr_for_mesh(build_operator(operator, mesh.first_device), nd)
    out = {}
    for mode in modes:
        op = mesh_operator(bsr, mesh, axis_name=mesh.axis_names[0], matvec_mode=mode)
        y = torch.as_tensor(np.random.default_rng(seed).standard_normal(op.shape[0]))
        y = y.to(op.dtype).to(op.device)
        x = op.rmatvec(y)

        def again():
            for _ in range(calls):
                op.rmatvec(y)

        _, seconds, launches = _counted(mesh, again)
        host = x.cpu().contiguous()
        out[mode] = dict(digest=hashlib.sha256(host.numpy().tobytes()).hexdigest(),
                         norm=float(torch.linalg.vector_norm(host.double())),
                         seconds=seconds, calls=calls, launches=launches)
    return out


def scenario_psum(mesh, count=200):
    """The wall µs of one psum on the mesh (:func:`psum_us`)."""
    return dict(psum_us=psum_us(mesh, count))


SCENARIOS = {
    "steps": scenario_steps,
    "trlm": scenario_trlm,
    "eigsh": scenario_eigsh,
    "psum": scenario_psum,
    "reverse": scenario_reverse,
}


def main(argv=None, scenarios: dict | None = None) -> None:
    """One worker: join the mesh, run the scenario, print its result
    (``scenarios``: more scenarios by name, from a worker file of
    :func:`spawn`)."""
    coordinator, nproc, rank, scenario, params = (sys.argv[1:] if argv is None else argv)
    params = json.loads(params)
    from .mesh import COLLECTIVE_TIMEOUT, initialize_multihost

    if "threads" in params:
        torch.set_num_threads(params.pop("threads"))
    try:
        mesh = initialize_multihost(
            coordinator, int(nproc), int(rank), make_global_mesh=True,
            devices=params.pop("devices"),
            timeout=params.pop("collective_timeout", COLLECTIVE_TIMEOUT))
        out = {**SCENARIOS, **(scenarios or {})}[scenario](mesh, **params)
        out.update(process_index=mesh.process_index, process_count=mesh.process_count,
                   n_global_shards=mesh.size, n_local_shards=len(mesh.local_shards),
                   backend=mesh.backend,
                   host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)
        print(RESULT_MARK + json.dumps(out), flush=True)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)  # at once: the others see the connection close and raise
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
