"""One run of one cell: set-up, the measured window, the traced extras and
the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix or metric is
found by name from ``BENCHMARK.json``:

- ``configs/<config>.py`` (the configuration's ``file``): ``PARAMS``,
  ``STORAGE``, ``SYMMETRIC``, ``REFERENCE``, ``operand(params)`` (the
  operator on the host, through the measured package's public path),
  ``triplets(operand)`` (its rows and columns, for ``work.py``) and
  ``pack(operand, device)`` (the packed operator the solves run on);
- ``traffic/<traffic>.json``: the front-end call and its arguments;
- ``limits/<workload>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: ``read(ctx)``, the metric's value or None;
- ``reference/<REFERENCE>.py``: ``judge(params, request, answers, device, seed)``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "eigenex_tpu")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, prefix: str):
    name = f"eigbench_{prefix}_" + "".join(ch if ch.isalnum() else "_" for ch in path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files loaded."""

    name: str
    config: object      # the configuration's module
    traffic: dict       # the request the window repeats
    limits: dict        # number compared -> limit
    end_to_end: list    # metric entries this cell reports with --trace 0
    per_layer: list     # ... and with --trace 1
    chips: int

    @property
    def reference(self):
        return importlib.import_module(f"eigbench.reference.{self.config.REFERENCE}")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=workload,
        config=load_module(root / config["file"], "config"),
        traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
        chips=w["chips"],
    )


@dataclasses.dataclass
class Solve:
    index: int
    wall_s: float
    eigenvalues: np.ndarray | None = None
    eigenvectors: np.ndarray | None = None
    iterations: int | None = None
    converged: bool = False
    error: str | None = None
    allocated: int | None = None  # device bytes allocated once the solve returned


@dataclasses.dataclass
class Context:
    """What a metric reader may read."""

    cuda: bool
    device_name: str
    setup_s: float
    window_s: float
    solves: list
    memory_peak_bytes: int | None
    pack_s: float
    operator_bytes: int | None
    work: tuple          # (bytes, flops) of one product, eigbench/work.py
    storage: str
    spmv_ms: float | None = None
    profile: dict | None = None


def start_vector(n: int, seed: int, index: int, device) -> torch.Tensor:
    """The start vector of solve ``index``, drawn on ``device`` from (seed, index)."""
    state = np.random.SeedSequence([seed & (2**64 - 1), index]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return torch.randn(n, generator=gen, device=device, dtype=torch.float32)


def solve_once(call, acc, traffic: dict, n: int, seed: int, index: int, device) -> Solve:
    """One request, timed by the host clock.  The accelerated front ends
    return host arrays, so the time covers the whole solve."""
    v0 = start_vector(n, seed, index, device)
    t0 = time.perf_counter()
    try:
        res = call(acc, v0=v0, **traffic["kwargs"])
    except Exception:  # a solve that raises is a failed answer; the run goes on
        wall = time.perf_counter() - t0
        sys.stderr.write(f"solve {index} raised:\n{traceback.format_exc()}")
        return Solve(index, wall, error=traceback.format_exc(limit=1))
    wall = time.perf_counter() - t0
    return Solve(index, wall, np.asarray(res.eigenvalues),
                 None if res.eigenvectors is None else np.asarray(res.eigenvectors),
                 None if res.iterations is None else int(res.iterations), bool(res.converged))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             params: dict | None = None) -> dict:
    """One run of ``cell``: returns the result line as a dict.  ``params``
    replaces the configuration's sizes (the CPU tests run tiny ones); a run
    on a device other than CUDA reports no timing and no device metric."""
    import eigenex_tpu_torch as program

    from . import devtrace, work

    device = torch.device(device)
    cuda = device.type == "cuda"
    config = cell.config
    params = dict(config.PARAMS if params is None else params)
    call = getattr(program, cell.traffic["call"])

    # -- set-up: the operator, its pack, one warm-up solve of the cell's request
    operand = config.operand(params)
    rows, cols, shape = config.triplets(operand)
    nbytes, flops = work.spmv_work(rows, cols, shape[0], shape[1], config.STORAGE, config.SYMMETRIC)
    del rows, cols
    sync(device)
    before = torch.cuda.memory_allocated(device) if cuda else None
    t0 = time.perf_counter()
    acc = config.pack(operand, device)
    sync(device)
    pack_s = time.perf_counter() - t0
    operator_bytes = torch.cuda.memory_allocated(device) - before if cuda else None
    del operand
    stored = str(acc.matrix.dtype).replace("torch.", "")
    if stored != config.STORAGE:
        raise RuntimeError(f"the pack stores {stored}, the configuration states {config.STORAGE}")
    n = acc.orig_shape[0]
    warm = solve_once(call, acc, cell.traffic, n, seed, 0, device)
    if warm.error is not None:
        raise RuntimeError(f"the warm-up solve raised: {warm.error}")
    sync(device)

    # -- the measured window: whole solves until `seconds` have passed
    solves = []
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    while True:
        solves.append(solve_once(call, acc, cell.traffic, n, seed, len(solves) + 1, device))
        if cuda:
            solves[-1].allocated = torch.cuda.memory_allocated(device)
        if time.perf_counter() - t_window >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t_window
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else None

    ctx = Context(cuda=cuda, device_name=torch.cuda.get_device_name(device) if cuda else "cpu",
                  setup_s=setup_s, window_s=window_s, solves=solves,
                  memory_peak_bytes=memory_peak, pack_s=pack_s, operator_bytes=operator_bytes,
                  work=(nbytes, flops), storage=config.STORAGE)
    metrics = cell.per_layer if trace else cell.end_to_end
    result = {}
    if trace and cuda:
        x = acc.embed(start_vector(n, seed, len(solves) + 2, device))
        ctx.spmv_ms = devtrace.chain_ms(lambda: acc.as_linear_operator().matvec(x))
        del x
        ctx.profile = devtrace.profile(
            lambda: solve_once(call, acc, cell.traffic, n, seed, len(solves) + 1, device))
    values = {}
    for m in metrics:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py", "metric").read(ctx)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": ctx.device_name, "count": 1, "memory_peak_bytes": memory_peak}
    if ctx.profile is not None:
        device_info["busy_s"] = ctx.profile["busy_s"]
        device_info["window_s"] = ctx.profile["window_s"]
        result["breakdown"] = ctx.profile["breakdown"]

    # -- the comparison, once the program's state is freed
    del acc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed, notes = judge(cell, params, solves, device, seed)
    return {"correct": failed == 0 and bool(solves), "attempted": len(solves), "failed": failed,
            "metrics": values, "device": device_info, **result, "notes": notes, "checks": checks}


def judge(cell: Cell, params: dict, solves: list, device, seed: int):
    """(checks, failed answers, notes): every answer of the window held to
    the reference; an answer fails when it raised, did not converge, or any
    number of it exceeds its limit."""
    answers = [(s.eigenvalues, s.eigenvectors) for s in solves]
    numbers, notes = cell.reference.judge(params, cell.traffic["kwargs"], answers, device, seed)
    bad = [s.error is not None or not s.converged for s in solves]
    checks = {}
    for name, values in numbers.items():
        limit = cell.limits[name]
        for i, v in enumerate(values):
            if not v <= limit:
                bad[i] = True
        checks[name] = {"value": max(values) if values else None, "limit": limit}
    checks["failed_answers"] = {"value": sum(bad), "limit": 0}
    notes["solve_wall_s"] = [round(s.wall_s, 4) for s in solves]
    notes["allocated_gib_after_solve"] = [None if s.allocated is None else round(s.allocated / 2**30, 3)
                                          for s in solves]
    notes["unconverged"] = sum(1 for s in solves if s.error is None and not s.converged)
    notes["raised"] = sum(1 for s in solves if s.error is not None)
    return checks, sum(bad), notes


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def finite(obj):
    """``obj`` with every float that is not finite (a missing answer's
    reading) replaced by None, as JSON has no such numbers."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj
