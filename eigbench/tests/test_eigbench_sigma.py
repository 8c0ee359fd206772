"""The cell ``convdiff_128.sigma`` at a tiny size on the CPU: the four
readers of its shift-invert counters against the program's counter store.

The tests parametrised over every cell of ``BENCHMARK.json`` (a tiny run
correct, traced or not; the control and the planted faults, ``altered`` and
``half`` among them, not correct; every number the judge reads limited) run
this cell too.  They take its tiny size from ``_tiny.TINY``, which this
module fills in when it is imported: every test module of the directory is
imported at collection, before any test runs.
"""

import types

from eigbench import core
from eigbench.counters import program_counters
from eigbench.tests._tiny import TINY, run

# nx = 24: the two top closed-form eigenvalues lie 0.56 % apart, under the
# cell's shortfall limit of 1 %
TINY.setdefault("convdiff_128", {"nx": 24, "conv": 0.4})

CELL = "convdiff_128.sigma"
#: metric -> (numerator, denominator) of the program's counters
RATIOS = {"si_matvecs_per_solve": ("si.matvecs", "solver.solves"),
          "gmres_cycles_per_apply": ("gmres.cycles", "si.applications"),
          "si_apply_ms": ("si.apply_ms", "si.applications"),
          "gmres_host_ms_per_cycle": ("gmres.host_ms", "gmres.cycles")}


def test_readers_read_the_shift_invert_counters():
    result = run(CELL, trace=True)
    assert result["correct"] and result["failed"] == 0
    counted = program_counters()
    for name, (num, den) in RATIOS.items():
        reader = core.load_module(core.BENCH / "metrics" / f"{name}.py", "metric")
        assert reader.read(types.SimpleNamespace(cuda=False)) is None  # no card, no reading
        assert reader.read(types.SimpleNamespace(cuda=True)) == counted[num] / counted[den] > 0
    # one GMRES(48) cycle an application, above the spectrum
    assert counted["gmres.cycles"] == counted["si.applications"]
