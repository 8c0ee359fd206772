"""One cell's set-up and solves with the program's spans kept: the readings
that need spans recorded inside a run, beside the counters' readings.

    python3 eigbench/spans.py --workload <name> --seed <n> [--pairs 6]

Set-up (build, pack, one warm-up solve) runs with spans kept.  Then
``--pairs`` pairs of solves, one with spans off and one with spans kept,
in turns, with the program's counters reset before them; then one solve
under ``torch.profiler``.  Prints one JSON line:

- ``build_s``: the ``eigenex.build`` span of set-up; ``setup_spans``: the
  seconds of it, of ``eigenex.accelerate`` (the pack) and of their stages;
- ``restart_host_ms``: self ms of ``eigenex.restart`` a restart, in the
  solves with spans kept (None where no restart ran);
- ``restore_ms``: self ms of ``eigenex.restore`` plus ``eigenex.embed`` a
  solve, in the same solves;
- ``cgs2_ms``: in the profiled solve, the device ms of the kernels launched
  under ``eigenex.cgs2`` over the spans that launched any (a CUDA graph's
  capture launches none, and its replays run no span); ``idle_by_phase``:
  the seconds of that solve in which the device ran nothing, by the
  outermost span inside ``eigenex.solve`` running in them (a capture's
  inner spans count as the capture); ``malloc_by_span``: its ``cudaMalloc``
  seconds by the innermost ``eigenex.*`` span (``None``: under none);
- ``restarts_per_solve``, ``replay_share``, ``capture_ms``,
  ``launches_per_matvec``: the readers of ``metrics/`` over the paired
  solves (in the benchmark they read the whole run), and
  ``matvecs_per_solve`` from the same counters;
- ``span_overhead_pct``: the median wall of the solves with spans kept over
  the median of those without, less one (pairs in turns: off-on, on-off);
  ``span_overhead_paired_ms``: the median over the pairs of the kept
  solve's wall less the other's;
  ``span_cost_ns``: one span entered and left, off and kept, timed on this
  host; ``spans_per_solve``: the spans a kept solve opened;
- ``accounting``: for each solve with spans kept, its wall on the host
  clock, the ``eigenex.solve`` span's duration and that span's self time
  (its duration less its children's, which never overlap);
  ``per_solve_ms``: each such solve's ms by the root's child spans;
- ``spans``: count, ms and self ms by span name over those solves.

Needs a CUDA card, and exits non-zero without one, unless ``--device cpu``
(with ``--params``, a JSON object of smaller sizes): a rehearsal, whose
times are the CPU's and whose ``cgs2_ms`` is None.
"""

import time

T0 = time.perf_counter()

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))


#: the benchmark's readers of the program's counters
COUNTER_METRICS = ("restarts_per_solve", "replay_share", "capture_ms", "launches_per_matvec")


def _profiled(fn) -> dict:
    """One solve under ``torch.profiler``: ``cgs2_ms``, the device's idle
    seconds by the outermost span inside the root, and the host's
    ``cudaMalloc`` seconds by the innermost ``eigenex.*`` span running in
    them (None: under no program span)."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from eigbench import devtrace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.ROOT_SPAN):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    root = next(e for e in events if e.name == devtrace.ROOT_SPAN
                and e.device_type == DeviceType.CPU)
    cgs2 = [e.device_time_total for e in events
            if e.name == "eigenex.cgs2" and e.device_type == DeviceType.CPU]
    cgs2 = [us for us in cgs2 if us > 0]
    device = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == DeviceType.CUDA and e.name != devtrace.ROOT_SPAN
                     and not getattr(e, "is_user_annotation", False)), key=lambda t: t[0])
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CPU and e.thread == root.thread
                    and e.name.startswith("eigenex.")), key=lambda t: t[0])
    _, gaps = devtrace._union_and_gaps(device, root.time_range.start, root.time_range.end)
    phase = defaultdict(float)
    for (s, e), top in zip(gaps, _below_root(spans, [(s + e) / 2 for s, e in gaps])):
        phase[top] += (e - s) * 1e-6
    mallocs = sorted(((e.time_range.start, e.time_range.end) for e in events
                      if e.name == "cudaMalloc" and e.thread == root.thread), key=lambda t: t[0])
    malloc = defaultdict(float)
    for (s, e), name in zip(mallocs, devtrace._innermost(spans, [(s + e) / 2 for s, e in mallocs])):
        malloc[name] += (e - s) * 1e-6
    order = lambda d: {str(k): round(v, 5) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
    return dict(cgs2_ms=sum(cgs2) / len(cgs2) * 1e-3 if cgs2 else None,
                idle_by_phase=order(phase),
                malloc_by_span=order(malloc))


def _below_root(spans, points):
    """For each point, the outermost span inside ``eigenex.solve`` that holds
    it (``eigenex.solve``: in the root's own time; None: outside it)."""
    roots = [sp for sp in spans if sp[2] == "eigenex.solve"]
    tops = [sp for sp in spans if sp[2] != "eigenex.solve"
            and any(r[0] <= sp[0] and sp[1] <= r[1] for r in roots)]
    tops = [sp for sp in tops if not any(o is not sp and o[0] <= sp[0] and sp[1] <= o[1]
                                         for o in tops)]
    out = []
    for p in points:
        hit = next((sp[2] for sp in tops if sp[0] <= p <= sp[1]), None)
        if hit is None and any(r[0] <= p <= r[1] for r in roots):
            hit = "eigenex.solve"
        out.append(hit)
    return out


def _span_cost_ns(recording: bool, calls: int = 100_000) -> float:
    """Host ns of one span entered and left, on this machine."""
    from eigenex_tpu_torch.utils import profiling

    with profiling.record_spans() if recording else contextlib.nullcontext():
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            with profiling.annotate("eigenex.cost"):
                pass
        took = time.perf_counter_ns() - t0
    profiling.spans()
    return took / calls


def _accounting(records: list, walls: list) -> tuple[list, list]:
    """[wall s, root span s, root span's self s] of each solve, and the ms of
    each solve by the root's child spans' names (``eigenex.solve``: its self)."""
    children, phases = {}, {}
    for r in records:
        took = r["end_ns"] - r["start_ns"]
        children[r["parent"]] = children.get(r["parent"], 0) + took
        by_name = phases.setdefault(r["parent"], {})
        by_name[r["name"]] = by_name.get(r["name"], 0.0) + took * 1e-6
    roots = [r for r in records if r["name"] == "eigenex.solve" and r["parent"] is None]
    rows, split = [], []
    for wall, root in zip(walls, roots):
        took = root["end_ns"] - root["start_ns"]
        self_ns = took - children.get(root["index"], 0)
        rows.append([wall, took * 1e-9, self_ns * 1e-9])
        split.append(dict(phases.get(root["index"], {}), **{"eigenex.solve": self_ns * 1e-6}))
    return rows, split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--params", default=None)
    args = ap.parse_args(argv)

    import torch

    from eigbench import core
    from eigbench.counters import per_solve

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.stderr.write("eigbench spans: needs a CUDA card\n")
        return 2
    import eigenex_tpu_torch as program
    from eigenex_tpu_torch.utils import profiling

    cell = core.load_cell(core.load_spec(), args.workload)
    config = cell.config
    call = getattr(program, cell.traffic["call"])
    params = dict(config.PARAMS, **json.loads(args.params or "{}"))

    with profiling.record_spans():
        operand = config.operand(params)
        acc = config.pack(operand, device)
        del operand
        n = acc.orig_shape[0]
        core.solve_once(call, acc, cell.traffic, n, args.seed, 0, device)
        core.sync(device)
    setup = profiling.spans()
    summary = profiling.span_summary(setup)
    setup_spans = {name: round(s["ms"] * 1e-3, 4) for name, s in summary.items()
                   if name.startswith(("eigenex.build", "eigenex.accelerate"))}
    build = summary.get("eigenex.build")

    profiling.reset_counters()
    walls_off, walls_on, kept = [], [], []
    index = 1
    for pair in range(args.pairs):
        for recording in ((False, True) if pair % 2 == 0 else (True, False)):
            if recording:
                with profiling.record_spans():
                    walls_on.append(core.solve_once(call, acc, cell.traffic, n, args.seed, index,
                                                    device).wall_s)
                kept += profiling.spans()
            else:
                walls_off.append(core.solve_once(call, acc, cell.traffic, n, args.seed, index,
                                                 device).wall_s)
            index += 1
    # the benchmark's own readers, over the paired solves (the store was reset before them)
    reading = core.Context(cuda=True, device_name="", setup_s=0.0, window_s=0.0, solves=[],
                           memory_peak_bytes=None, pack_s=0.0, operator_bytes=None, work=(0, 0),
                           storage=config.STORAGE)
    counted = {name: core.load_module(core.BENCH / "metrics" / f"{name}.py", "metric").read(reading)
               for name in COUNTER_METRICS}
    profiled = _profiled(
        lambda: core.solve_once(call, acc, cell.traffic, n, args.seed, index, device)
    ) if cuda else dict(cgs2_ms=None)

    spans = profiling.span_summary(kept)
    accounting, phases = _accounting(kept, walls_on)
    solves = len(walls_on)
    restarts = spans.get("eigenex.restart", {}).get("count", 0)
    restore = sum(spans.get(name, {}).get("self_ms", 0.0)
                  for name in ("eigenex.restore", "eigenex.embed"))
    line = dict(
        workload=args.workload, seed=args.seed,
        device=torch.cuda.get_device_name(device) if cuda else "cpu",
        build_s=None if build is None else build["ms"] * 1e-3,
        setup_spans=setup_spans,
        restart_host_ms=spans["eigenex.restart"]["self_ms"] / restarts if restarts else None,
        restore_ms=restore / solves,
        **profiled,
        **counted,
        matvecs_per_solve=per_solve("solver.iterations"),
        span_overhead_pct=100.0 * (statistics.median(walls_on) / statistics.median(walls_off)
                                   - 1.0),
        span_overhead_paired_ms=1e3 * statistics.median(
            on - off for on, off in zip(walls_on, walls_off)),
        span_cost_ns=dict(off=_span_cost_ns(False), on=_span_cost_ns(True)),
        spans_per_solve=sum(x["count"] for x in spans.values()) / solves,
        walls_off_s=[round(w, 4) for w in walls_off],
        walls_on_s=[round(w, 4) for w in walls_on],
        accounting=[[round(x, 6) for x in row] for row in accounting],
        per_solve_ms=[{k: round(v, 2) for k, v in sorted(row.items())} for row in phases],
        spans={name: dict(count=s["count"], ms=round(s["ms"], 3), self_ms=round(s["self_ms"], 3))
               for name, s in sorted(spans.items(), key=lambda kv: -kv[1]["self_ms"])},
        t_total_s=round(time.perf_counter() - T0, 1),
    )
    sys.stdout.write(json.dumps(core.finite(line)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
