"""Whole runs at tiny sizes on the CPU: the loop, the traced extras, the
comparison; and no device metric from a run without a card."""

import subprocess
import sys

import pytest

from eigbench import core
from eigbench.tests._tiny import CELLS, cell, run


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct_and_reports_no_device_metric(workload, trace):
    result = run(workload, trace=trace)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["device"]["platform"] == "cpu" and result["device"]["memory_peak_bytes"] is None
    assert "busy_s" not in result["device"] and "breakdown" not in result
    # counts only: no clock, no device reading, from a run without a card
    counts = {m["name"] for m in cell(workload).per_layer} & {"matvecs_per_solve"}
    assert set(result["metrics"]) == (counts if trace else set())


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    proc = subprocess.run([sys.executable, str(core.BENCH / "run.py"), "--workload", CELLS[0],
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, cwd=core.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_start_vectors_follow_the_seed():
    a = core.start_vector(50, 2**31 + 5, 3, "cpu")
    assert a.equal(core.start_vector(50, 2**31 + 5, 3, "cpu"))
    assert not a.equal(core.start_vector(50, 2**31 + 5, 4, "cpu"))
    assert not a.equal(core.start_vector(50, 2**31 + 6, 3, "cpu"))
