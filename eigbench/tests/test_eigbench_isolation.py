"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the measured package."""

import ast
import subprocess
import sys

from eigbench import core

RUN_ALL = r"""
import importlib, sys
from pathlib import Path
sys.path.insert(0, {root!r})
from eigbench import core
for path in sorted(Path({bench!r}).rglob("*.py")):
    rel = path.relative_to(core.ROOT).with_suffix("")
    if "tests" in rel.parts:
        continue
    if rel.parts[1] in ("configs", "metrics"):
        core.load_module(path, rel.parts[1])
    else:
        importlib.import_module(".".join(rel.parts))
from eigbench.tests._tiny import run
assert run("heisenberg_l24.ground")["correct"]
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE_ONLY = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from eigbench.reference import heisenberg_chain as hc, convection_diffusion as cd
p = {{"L": 8, "n_up": 4, "J": 1.0, "Jz": 1.0, "pbc": False}}
lam, X = hc.control_solver(p, {{"k": 1, "tol": 1e-8}}, "cpu")(np.ones(70))
hc.judge(p, {{"k": 1}}, [(lam, X)], "cpu", 0)
q = {{"nx": 8, "conv": 0.4}}
lam, X = cd.control_solver(q, {{"k": 2, "tol": 1e-6}}, "cpu")(np.ones(64))
cd.judge(q, {{"k": 2}}, [(lam, X)], "cpu", 0)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def top_level_modules(script: str) -> set:
    proc = subprocess.run([sys.executable, "-c", script.format(root=str(core.ROOT),
                                                               bench=str(core.BENCH))],
                          capture_output=True, text=True, timeout=300, cwd=core.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    loaded = top_level_modules(RUN_ALL)
    assert "eigenex_tpu_torch" in loaded
    assert not loaded & set(core.BANNED)


def test_the_reference_loads_nothing_of_the_measured_package():
    loaded = top_level_modules(REFERENCE_ONLY)
    assert "eigenex_tpu_torch" not in loaded and not loaded & set(core.BANNED)


def test_the_reference_imports_nothing_of_the_measured_package():
    for path in (core.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not any(n.split(".")[0] in ("eigenex_tpu_torch",) + core.BANNED for n in names), path
