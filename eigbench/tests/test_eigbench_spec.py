"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re

import pytest

from eigbench import core
from eigbench.tests._tiny import CELLS, cell, run

SPEC = core.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "eigbench/run.py"]
    assert SPEC["paths"] == ["eigbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(0 < len(c[k]) <= 200 and "\n" not in c[k] for k in ("source", "why"))
        assert c["file"].startswith("eigbench/") and (core.ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert 0 < len(m["layer"]) <= 200
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in SPEC[group]}) == len(SPEC[group])


def test_every_cell_reports_what_the_contract_asks():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for name in cells:
        cell = core.load_cell(SPEC, name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("workload", CELLS)
def test_files_found_by_name(workload):
    c = cell(workload)
    for attr in ("PARAMS", "STORAGE", "SYMMETRIC", "REFERENCE", "SOURCE", "REDUCED", "ASSUMED",
                 "operand", "triplets", "pack"):
        assert hasattr(c.config, attr), attr
    entry = [e for e in SPEC["configs"] if e["name"] == c.config.__name__.split("config_")[-1]]
    assert not entry or (entry[0]["source"] == c.config.SOURCE
                         and entry[0]["reduced"] == c.config.REDUCED)
    assert callable(c.reference.judge) and callable(c.reference.control_solver)
    assert c.traffic["call"] in ("eigsh", "eigs") and "k" in c.traffic["kwargs"]
    assert all(v > 0 or name == "shortfall" for name, v in c.limits.items())
    for m in c.end_to_end + c.per_layer:
        module = core.load_module(core.BENCH / "metrics" / f"{m['name']}.py", "metric")
        assert callable(module.read)


def test_limits_cover_every_number_the_judge_reads():
    for name in CELLS:
        result = run(name, seconds=0.05)
        assert set(result["checks"]) == set(cell(name).limits) | {"failed_answers"}
        assert list(result)[-1] == "checks"
        json.dumps(core.finite(result), allow_nan=False)
