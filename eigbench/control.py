"""The readings the comparison's limits are set from, beside the cell's own
runs: the plain reference put in the measured solver's place one
precision lower (the control), and faults planted in the measured
program.  A run under one of them must come out not correct.

    python3 eigbench/control.py --workload <name> --seed <n> --seconds <s> --substitute <what>

<what>:
  control    the reference's control solver answers each request
  altered    an answer altered where it is produced: every returned
             eigenvalue 10 % low
  half       half of the pairs left out of each answer
  unchanged  a step that returns its state unchanged: the operator's
             product gives back its input

Prints the run's result line; its ``checks`` are the readings.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

SUBSTITUTES = ("control", "altered", "half", "unchanged")


@contextlib.contextmanager
def substitute(cell, what: str, params: dict, device):
    """Run the cell's requests under ``what`` inside the block."""
    import eigenex_tpu_torch as program

    name = cell.traffic["call"]
    original = getattr(program, name)
    if what == "control":
        solve = cell.reference.control_solver(params, cell.traffic["kwargs"], device)

        def call(acc, v0, **kwargs):
            lam, X = solve(v0.cpu().numpy())
            return types.SimpleNamespace(eigenvalues=lam, eigenvectors=X, iterations=None,
                                         converged=True)
    elif what == "altered":
        def call(acc, v0, **kwargs):
            res = original(acc, v0=v0, **kwargs)
            res.eigenvalues = np.asarray(res.eigenvalues) * 0.9
            return res
    elif what == "half":
        def call(acc, v0, **kwargs):
            res = original(acc, v0=v0, **kwargs)
            keep = max(len(res.eigenvalues) // 2, 1) if len(res.eigenvalues) > 1 else 0
            res.eigenvalues = np.asarray(res.eigenvalues)[:keep]
            res.eigenvectors = np.asarray(res.eigenvectors)[:, :keep]
            return res
    elif what == "unchanged":
        from eigenex_tpu_torch.sparse.bsr import BSRMatrix
        from eigenex_tpu_torch.sparse.sym_bsr import SymBSRMatrix

        saved = [(cls, attr, getattr(cls, attr))
                 for cls in (BSRMatrix, SymBSRMatrix) for attr in ("matvec", "matmat")]
        for cls, attr, _ in saved:
            setattr(cls, attr, lambda self, x: x.clone())
        try:
            yield
        finally:
            for cls, attr, fn in saved:
                setattr(cls, attr, fn)
        return
    else:
        raise ValueError(f"substitute must be one of {SUBSTITUTES}, got {what!r}")
    setattr(program, name, call)
    try:
        yield
    finally:
        setattr(program, name, original)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--substitute", choices=SUBSTITUTES, required=True)
    args = ap.parse_args(argv)

    import torch

    from eigbench import core

    cell = core.load_cell(core.load_spec(), args.workload)
    if not torch.cuda.is_available():
        sys.stderr.write("eigbench control: no CUDA card\n")
        return 2
    with substitute(cell, args.substitute, dict(cell.config.PARAMS), "cuda:0"):
        result = core.run_cell(cell, args.seed, args.seconds, False, "cuda:0", T_START)
    result["substitute"] = args.substitute
    sys.stdout.write(json.dumps(core.finite(result), allow_nan=False) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
