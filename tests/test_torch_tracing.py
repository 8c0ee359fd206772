"""The port's spans and counters (``eigenex_tpu_torch/utils/profiling.py``)
and the benchmark's readers of them (``eigbench/metrics/``).

Spans nest, carry their parent's index and one solve id per outermost
``eigenex.solve``; off (no profiler, nothing recording) a span keeps nothing
and opens no ``record_function``; a thick-restart or Krylov-Schur solve opens
one ``eigenex.restart`` span and counts one ``solver.restarts`` for each
restart its trace shows; the launch and graph counts read the one counter
store; and each counter reader gives its value from counts set by hand, and
None off CUDA.
"""

import threading

import numpy as np
import pytest
import torch

import eigenex_tpu_torch as ext
from eigbench import core
from eigenex_tpu_torch.block.hamiltonians import heisenberg_sector_coo
from eigenex_tpu_torch.ops import cuda_spmv
from eigenex_tpu_torch.solvers import chunk_graph
from eigenex_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean_store():
    profiling.spans()
    profiling.reset_counters()
    yield
    profiling.spans()
    profiling.reset_counters()


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def test_spans_nest_with_parent_indices_and_one_solve_id_a_root():
    with profiling.record_spans():
        for _ in range(2):
            with profiling.annotate(profiling.ROOT_SPAN):
                with profiling.annotate("outer", step=1):
                    with profiling.annotate("inner"):
                        pass
                    with profiling.annotate(profiling.ROOT_SPAN):  # nested: no new solve
                        pass
        with profiling.annotate("loose"):
            pass
    records = profiling.spans()
    assert profiling.spans() == []  # read once
    assert [r["name"] for r in records] == ["eigenex.solve", "outer", "inner", "eigenex.solve"] * 2 + ["loose"]
    index = {r["index"]: r for r in records}
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            parent = index[r["parent"]]
            assert parent["start_ns"] <= r["start_ns"] and r["end_ns"] <= parent["end_ns"]
            assert parent["solve"] == r["solve"]
    roots = [r for r in records if r["parent"] is None and r["name"] == "eigenex.solve"]
    assert len(roots) == 2 and roots[0]["solve"] != roots[1]["solve"]
    assert {r["solve"] for r in records[:4]} == {roots[0]["solve"]}
    assert records[-1]["solve"] is None and records[-1]["parent"] is None
    assert by_name(records)["outer"][0]["attrs"] == {"step": 1}
    assert index[by_name(records)["inner"][0]["parent"]]["name"] == "outer"


def test_a_span_on_another_thread_joins_the_open_solve():
    seen = []

    def shard():
        with profiling.annotate("shard"):
            seen.append(True)

    with profiling.record_spans(), profiling.annotate(profiling.ROOT_SPAN):
        t = threading.Thread(target=shard)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen
    records = by_name(profiling.spans())
    assert records["shard"][0]["solve"] == records["eigenex.solve"][0]["solve"] is not None
    assert records["shard"][0]["parent"] is None  # parents are of one thread


def test_a_span_that_is_off_keeps_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: opened.append(name))

    @profiling.annotate("decorated")
    def work():
        return 1

    with profiling.annotate(profiling.ROOT_SPAN), profiling.annotate("region"):
        assert work() == 1
    profiling.add_span("stage", 0.0, 1.0)
    assert opened == [] and profiling.spans() == []


def test_under_a_profiler_a_span_is_a_record_function_and_is_kept_when_recording():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("profiled_only"):
            torch.ones(4).sum()
        with profiling.record_spans(), profiling.annotate("profiled_and_kept"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"profiled_only", "profiled_and_kept"} <= names
    assert [r["name"] for r in profiling.spans()] == ["profiled_and_kept"]


def test_the_kept_spans_are_bounded_oldest_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_records", profiling.deque(maxlen=5))
    with profiling.record_spans():
        for i in range(8):
            with profiling.annotate(f"s{i}"):
                pass
    assert [r["name"] for r in profiling.spans()] == [f"s{i}" for i in range(3, 8)]


def test_span_summary_self_time_leaves_out_the_children():
    records = [dict(index=0, name="a", start_ns=0, end_ns=100, parent=None, solve=1, attrs={}),
               dict(index=1, name="b", start_ns=10, end_ns=40, parent=0, solve=1, attrs={}),
               dict(index=2, name="b", start_ns=50, end_ns=60, parent=0, solve=1, attrs={}),
               dict(index=3, name="c", start_ns=70, end_ns=None, parent=0, solve=1, attrs={})]
    summary = profiling.span_summary(records)
    assert summary["a"] == dict(count=1, ms=pytest.approx(1e-4), self_ms=pytest.approx(6e-5))
    assert summary["b"] == dict(count=2, ms=pytest.approx(4e-5), self_ms=pytest.approx(4e-5))
    assert "c" not in summary


def spread_matrix(n, seed=0):
    """Eigenvalues near 1, 2, ..., n: separated pairs at both ends, reached
    in a few restarts of a short subspace."""
    B = np.random.default_rng(seed).standard_normal((n, n))
    return torch.as_tensor(np.diag(np.arange(1.0, n + 1)) + 0.01 * (B + B.T))


@pytest.mark.parametrize("front_end", ["eigsh", "eigs"])
def test_restart_spans_equal_the_restart_counter_and_the_trace(front_end):
    A = spread_matrix(200)
    v0 = np.random.default_rng(3).standard_normal(200)
    kwargs = dict(k=3, max_subspace=16, tol=1e-8, v0=v0, device="cpu")
    if front_end == "eigsh":
        kwargs["which"] = "SA"
    with profiling.record_spans():
        res = getattr(ext, front_end)(A, **kwargs)
    records = by_name(profiling.spans())
    restarts = profiling.counters()["solver.restarts"]
    assert res.converged and restarts >= 2
    assert len(records["eigenex.restart"]) == restarts == len(res.trace.iterations) - 1
    assert len(records["eigenex.ritz"]) == len(res.trace.iterations)
    assert len(records["eigenex.solve"]) == 1 and len(records["eigenex.extract"]) == 1
    solve = records["eigenex.solve"][0]
    assert all(r["solve"] == solve["solve"] for rs in records.values() for r in rs)
    assert len(records["eigenex.cgs2"]) == res.iterations
    assert profiling.counters("solver.") == {"solver.restarts": restarts, "solver.solves": 1,
                                             "solver.launches": 0,
                                             "solver.iterations": res.iterations}


def test_krylov_schur_counts_and_project_spans_agree_with_the_solve():
    """``ks.steps`` sums the chunks' steps (the result's iterations),
    ``ks.kept`` the kept dimension of each restart (the subspace less the
    next chunk's steps), one ``eigenex.ks.project`` a projected problem,
    inside ``eigenex.ritz``; ``ks.host_ms`` lies inside those spans, and is
    counted with no span recorded too."""
    A = spread_matrix(200)
    v0 = np.random.default_rng(3).standard_normal(200)
    kwargs = dict(k=3, max_subspace=16, tol=1e-8, v0=v0, device="cpu")
    with profiling.record_spans():
        res = ext.eigs(A, **kwargs)
    records = by_name(profiling.spans())
    counted = profiling.counters()
    kept = 16 - np.diff(res.trace.iterations)
    assert res.converged and counted["solver.restarts"] == len(kept) >= 2
    assert counted["ks.steps"] == res.iterations
    assert counted["ks.kept"] == kept.sum()
    project = records["eigenex.ks.project"]
    assert len(project) == len(res.trace.iterations)
    index = {r["index"]: r for rs in records.values() for r in rs}
    assert {index[r["parent"]]["name"] for r in project} == {"eigenex.ritz"}
    span_ms = sum(r["end_ns"] - r["start_ns"] for r in project) * 1e-6
    assert 0 < counted["ks.host_ms"] <= span_ms
    ext.eigs(A, **kwargs)
    assert profiling.spans() == [] and profiling.counters()["ks.host_ms"] > counted["ks.host_ms"]
    assert profiling.counters()["ks.steps"] == 2 * res.iterations


def test_an_accelerated_solve_spans_build_pack_embed_and_restore():
    with profiling.record_spans():
        coo = heisenberg_sector_coo(10, 5, device="cpu")
        acc = ext.accelerate(coo, symmetric=True, device="cpu")
        v0 = np.random.default_rng(5).standard_normal(coo.shape[0])
        res = ext.eigsh(acc, k=2, which="SA", max_subspace=20, v0=v0)
    records = by_name(profiling.spans())
    index = {r["index"]: r for rs in records.values() for r in rs}
    build = records["eigenex.build"][0]
    assert {index[r["parent"]]["name"] for r in records["eigenex.build.enumerate"]} == {"eigenex.build"}
    assert build["start_ns"] <= records["eigenex.build.lexsort"][0]["start_ns"]
    stages = {name.rsplit(".", 1)[1]: rs[0] for name, rs in records.items()
              if name.startswith("eigenex.accelerate.")}
    assert set(stages) == set(acc.stats["pack_stages"])
    for name, r in stages.items():
        assert index[r["parent"]]["name"] == "eigenex.accelerate"
        assert (r["end_ns"] - r["start_ns"]) * 1e-9 == pytest.approx(
            acc.stats["pack_stages"][name], abs=1e-4)
    solve = records["eigenex.solve"][0]
    for name in ("eigenex.embed", "eigenex.restore", "eigenex.graphs.close"):
        assert [index[r["parent"]]["name"] for r in records[name]] == ["eigenex.solve"], name
    assert res.converged and len(records["eigenex.solve"]) == 1  # the inner eigsh is not a request
    assert all(r["solve"] == solve["solve"] for r in records["eigenex.cgs2"])


def test_an_accelerated_solve_counts_its_boundary_host_time_and_no_copy_off_the_cpu():
    """``accelerate.host_ms`` grows with each accelerated solve, with no span
    recorded; nothing crosses a device boundary for an operator on the CPU,
    so ``accelerate.d2h_bytes`` stays 0."""
    coo = heisenberg_sector_coo(10, 5, device="cpu")
    acc = ext.accelerate(coo, symmetric=True, device="cpu")
    v0 = np.random.default_rng(5).standard_normal(coo.shape[0])
    ext.eigsh(acc, k=2, which="SA", max_subspace=20, v0=v0)
    first = profiling.counters("accelerate.")
    assert first["accelerate.host_ms"] > 0
    ext.eigsh(acc, k=2, which="SA", max_subspace=20, v0=torch.as_tensor(v0))
    counted = profiling.counters("accelerate.")
    assert counted["accelerate.host_ms"] > first["accelerate.host_ms"]
    assert counted.get("accelerate.d2h_bytes", 0) == 0 and profiling.spans() == []


def test_graph_and_launch_counts_are_views_of_the_one_store():
    profiling.count("graph.replays", 3)
    profiling.count("graph.capture_ms", 2.5)
    assert chunk_graph.graph_counts() == dict(solves=0, keys=0, eager=0, warmups=0, captures=0,
                                              replays=3, capture_ms=2.5, pool_bytes=0)
    cuda_spmv._count_launch("sym_bsr_spmv")
    with cuda_spmv.launch_tally() as tally:  # a capture: counted at its replays instead
        cuda_spmv._count_launch("sym_bsr_spmv")
    assert tally["sym_bsr_spmv"] == 1
    cuda_spmv.count_replayed_launches(tally)
    cuda_spmv.count_replayed_launches(tally)
    assert cuda_spmv.launch_counts() == dict(bsr_spmv=0, sym_bsr_spmv=3, bsr_spmm=0, sym_bsr_spmm=0,
                                             csr_spmv=0)
    assert profiling.counters("launch.") == {"launch.sym_bsr_spmv": 3}
    cuda_spmv.reset_launch_counts()
    assert not any(cuda_spmv.launch_counts().values()) and chunk_graph.graph_counts()["replays"] == 3
    chunk_graph.reset_graph_counts()
    assert not any(chunk_graph.graph_counts().values())


def test_the_graph_set_of_a_cpu_solve_counts_its_eager_chunks():
    A = spread_matrix(120)
    res = ext.eigsh(A, k=2, which="SA", max_subspace=12, device="cpu",
                    v0=np.random.default_rng(1).standard_normal(120))
    counts = chunk_graph.graph_counts()
    assert counts["solves"] == 1 and counts["eager"] == len(res.trace.iterations)
    assert profiling.counters()["graph.eager"] == counts["eager"]


def context(cuda: bool) -> core.Context:
    return core.Context(cuda=cuda, device_name="test", setup_s=1.0, window_s=1.0, solves=[],
                        memory_peak_bytes=None, pack_s=1.0, operator_bytes=None, work=(1, 1),
                        storage="bfloat16")


COUNTS = {"solver.solves": 4, "solver.restarts": 54, "solver.iterations": 512,
          "solver.launches": 512, "graph.replays": 50, "graph.warmups": 8, "graph.eager": 0,
          "graph.capture_ms": 100.0, "launch.sym_bsr_spmv": 600, "ks.steps": 2000, "ks.kept": 648,
          "ks.host_ms": 27.0, "cgs2.rows": 12880, "cgs2.steps": 160, "accelerate.host_ms": 10.0}
KS_METRICS = ["ks_matvecs_per_solve", "ks_kept_per_restart", "ks_host_ms_per_restart"]


@pytest.mark.parametrize("metric, expected", [
    ("restarts_per_solve", 13.5),
    ("replay_share", 100.0 * 50 / 58),
    ("capture_ms", 25.0),
    ("launches_per_matvec", 1.0),
    ("ks_matvecs_per_solve", 500.0),
    ("ks_kept_per_restart", 12.0),
    ("ks_host_ms_per_restart", 0.5),
    ("cgs2_rows_per_step", 80.5),
    ("embed_restore_ms", 2.5),
])
def test_each_counter_reader_from_counts_set_by_hand(metric, expected):
    for name, n in COUNTS.items():
        profiling.count(name, n)
    reader = core.load_module(core.BENCH / "metrics" / f"{metric}.py", "metric")
    assert reader.read(context(True)) == pytest.approx(expected)
    assert reader.read(context(False)) is None


@pytest.mark.parametrize("metric", ["restarts_per_solve", "replay_share", "capture_ms",
                                    "launches_per_matvec", "cgs2_rows_per_step",
                                    "embed_restore_ms"] + KS_METRICS)
def test_each_counter_reader_gives_none_without_counts(metric):
    reader = core.load_module(core.BENCH / "metrics" / f"{metric}.py", "metric")
    assert reader.read(context(True)) is None


@pytest.mark.parametrize("metric", KS_METRICS)
def test_ks_readers_give_none_for_a_program_without_ks_counts(metric):
    """A program that counts solves and restarts but keeps no ``ks.*``
    count (the port before these counters) gives no reading, not a zero."""
    for name, n in COUNTS.items():
        if not name.startswith("ks."):
            profiling.count(name, n)
    reader = core.load_module(core.BENCH / "metrics" / f"{metric}.py", "metric")
    assert reader.read(context(True)) is None


def test_cgs2_reader_gives_none_for_a_program_without_cgs2_counts():
    """A program whose passes read the whole basis under a mask keeps no
    ``cgs2.*`` count: no reading, not a zero."""
    for name, n in COUNTS.items():
        if not name.startswith("cgs2."):
            profiling.count(name, n)
    reader = core.load_module(core.BENCH / "metrics" / "cgs2_rows_per_step.py", "metric")
    assert reader.read(context(True)) is None


def test_embed_restore_reader_gives_none_for_a_program_without_accelerate_counts():
    """A program that counts solves but keeps no ``accelerate.host_ms``
    (the port before that counter) gives no reading, not a zero."""
    for name, n in COUNTS.items():
        if not name.startswith("accelerate."):
            profiling.count(name, n)
    reader = core.load_module(core.BENCH / "metrics" / "embed_restore_ms.py", "metric")
    assert reader.read(context(True)) is None
