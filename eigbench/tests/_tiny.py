"""Tiny sizes of the benchmark's configurations, for the CPU tests, and the
cell that waits outside ``BENCHMARK.json`` (PERF.md, Open questions), so
that its files stay tested."""

import json
import time

from eigbench import core

TINY = {"heisenberg_l24": {"L": 12, "n_up": 6, "J": 1.0, "Jz": 1.0, "pbc": False},
        "convdiff_316": {"nx": 20, "conv": 0.4}}
SEED = 2**31 + 977  # larger than 32 signed bits hold, as the driver's are
#: the waiting cell; its limits here are the tests' own (tiny sizes), not a
#: cell's limits set from readings on the card
WAITING = "convdiff_316.dominant"
WAITING_LIMITS = {"resid": 2e-05, "shortfall": 0.02}


def cell(workload: str) -> core.Cell:
    if workload != WAITING:
        return core.load_cell(core.load_spec(), workload)
    spec = core.load_spec()
    return core.Cell(
        name=WAITING,
        config=core.load_module(core.BENCH / "configs" / "convdiff_316.py", "config"),
        traffic=json.loads((core.BENCH / "traffic" / "dominant.json").read_text()),
        limits=WAITING_LIMITS,
        end_to_end=spec["end_to_end"],
        per_layer=[],
        chips=1,
    )


CELLS = [w["name"] for w in core.load_spec()["workloads"]] + [WAITING]


def run(workload: str, trace: bool = False, seconds: float = 0.3, substitute: str | None = None):
    """One run of ``workload`` on the CPU at its tiny size: the result line."""
    from eigbench import control

    c = cell(workload)
    params = TINY[c.config.__name__.split("config_")[-1]]
    t = time.perf_counter()
    if substitute is None:
        return core.run_cell(c, SEED, seconds, trace, "cpu", t, params=params)
    with control.substitute(c, substitute, params, "cpu"):
        return core.run_cell(c, SEED, seconds, trace, "cpu", t, params=params)
