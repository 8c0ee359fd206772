"""The comparison fails the control and every fault the cells can have:
a run with the timed path broken underneath comes out not correct."""

import pytest

from eigbench.tests._tiny import CELLS, run


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("substitute", ["control", "altered", "half", "unchanged"])
def test_broken_run_is_not_correct(workload, substitute):
    result = run(workload, substitute=substitute)
    assert not result["correct"] and result["failed"] == result["attempted"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_number_that_sound_runs_pass(workload):
    sound = run(workload)["checks"]
    control = run(workload, substitute="control")["checks"]
    over = [name for name, c in control.items()
            if name != "failed_answers" and c["value"] is not None and c["value"] > c["limit"]]
    assert over and all(sound[name]["value"] <= sound[name]["limit"] for name in over)
