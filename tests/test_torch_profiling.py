"""The port's profiling hooks (``utils/profiling.py``): ``PhaseTimer``
prints exactly the reference's summary for the same totals, ``annotate``
works as a context manager and as a decorator and shows in a trace, and
``profile_trace`` writes a Chrome trace into its directory."""

import json
import time

import torch

import eigenex_tpu.utils.profiling as jp
import eigenex_tpu_torch.utils.profiling as tp

torch.set_num_threads(1)


def test_phase_timer_summary_is_the_reference_format():
    t, j = tp.PhaseTimer(), jp.PhaseTimer()
    for timer in (t, j):
        for phase, seconds, n in (("matvec", 1.25, 40), ("reorth", 0.5, 40),
                                  ("a_very_long_phase_name_beyond_24", 3.0, 1), ("idle", 0.0, 0)):
            timer.totals[phase] += seconds
            timer.counts[phase] += n
    assert t.summary() == j.summary()
    lines = t.summary().splitlines()
    assert lines[0].startswith("a_very_long_phase_name_beyond_24") and len(lines) == 4
    assert "x40" in lines[1] and "31.250 ms/call" in lines[1]


def test_phase_timer_accumulates():
    t = tp.PhaseTimer()
    for _ in range(3):
        with t("step"):
            time.sleep(0.001)
    try:
        with t("fails"):
            raise ValueError
    except ValueError:
        pass
    assert t.counts == {"step": 3, "fails": 1} and t.totals["step"] >= 0.003


def test_annotate_and_profile_trace(tmp_path):
    @tp.annotate("decorated_region")
    def work(x):
        return x @ x

    x = torch.ones(32, 32)
    with tp.profile_trace(str(tmp_path / "trace")) as prof:
        with tp.annotate("context_region"):
            work(x)
        work(x)
    names = {e.key for e in prof.key_averages()}
    assert {"context_region", "decorated_region"} <= names
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert sum(e.get("name") == "decorated_region" for e in events) == 2
