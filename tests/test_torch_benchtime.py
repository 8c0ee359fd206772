"""The port's timing protocol (``utils/benchtime.py``) against the JAX
package's: the same plausibility arithmetic at a stated peak, the same
return fields of the chain slope, the H100's own ceiling by default (no
TPU constant), and a CPU synchronisation that waits for nothing."""

import numpy as np
import pytest
import torch

import eigenex_tpu.utils.benchtime as jb
import eigenex_tpu_torch.utils.benchtime as tb

torch.set_num_threads(1)


def test_names_and_ceiling():
    assert set(tb.__all__) == (set(jb.__all__) - {"V5E_PEAK_GBS"}) | {"H100_SXM_PEAK_GBS"}
    assert tb.H100_SXM_PEAK_GBS == 3350.0
    assert not any("V5E" in name for name in vars(tb))
    assert tb.plausibility_floor(3.35e9) == pytest.approx(1e-3, rel=1e-15)


@pytest.mark.parametrize("per", [1e-4, 2e-3])
def test_roofline_clamp_matches_reference(per):
    nbytes, peak = 4_000_000_000, 2000.0
    assert tb.plausibility_floor(nbytes, peak) == jb.plausibility_floor(nbytes, peak)
    assert tb.clamp_to_roofline(per, nbytes, peak) == jb.clamp_to_roofline(per, nbytes, peak)
    clamped, flag = tb.clamp_to_roofline(per, nbytes, peak)
    assert flag == (per < nbytes / (peak * 1e9)) and clamped >= per


def test_timed_median():
    calls = []
    med, samples = tb.timed_median(lambda: calls.append(1), reps=7)
    assert len(calls) == len(samples) == 7 and med == float(np.median(samples))
    jmed, jsamples = jb.timed_median(lambda: None, reps=7)
    assert len(jsamples) == 7 and isinstance(jmed, float)


def test_force_sync_on_the_cpu_waits_for_nothing():
    x = torch.ones(4)
    assert tb.force_sync(x) is None and tb.force_sync((x, x)) is None
    assert tb.force_sync([1.0]) is None


def test_chain_slope_fields_and_applications():
    A = torch.as_tensor(np.random.default_rng(0).standard_normal((64, 64)))
    x = torch.ones(64, dtype=torch.float64)
    applied = []

    def matvec(p, v):
        applied.append(1)
        return p @ v

    per, stats = tb.chain_slope(matvec, A, x, k_lo=2, k_hi=6, reps=3)
    # two warm runs, then reps runs at each point
    assert len(applied) == (2 + 6) + 3 * 2 + 3 * 6
    keys = {"k_lo", "k_hi", "reps", "median_lo_s", "median_hi_s", "spread_lo_s", "spread_hi_s"}
    assert keys <= set(stats) and (stats["k_lo"], stats["k_hi"], stats["reps"]) == (2, 6, 3)
    assert all(stats[k] >= 0 for k in keys - {"k_lo", "k_hi", "reps"})
    if per is None:
        assert stats["unresolvable"] is True
    else:
        assert per == pytest.approx((stats["median_hi_s"] - stats["median_lo_s"]) / 4)
