"""Run one cell of the benchmark once and print its result as the last line.

    python3 eigbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds and packs the cell's operator and runs one warm-up solve;
the window then runs whole solves of the cell's request until ``--seconds``
have passed; with ``--trace 1`` the per-layer metrics are read after it.
Every answer of the window is then held to the plain reference.  Exits
non-zero, printing no result, without a CUDA card, or when a module of
JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
# every compile cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_extensions")
sys.path.insert(0, str(BENCH.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from eigbench import core

    cell = core.load_cell(core.load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"eigbench: {args.workload} needs {cell.chips} CUDA card(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        return 2
    torch.cuda.reset_peak_memory_stats()
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    banned = core.banned_modules()
    if banned:
        sys.stderr.write(f"eigbench: the run loaded {', '.join(banned)}\n")
        return 3
    for name, check in result["checks"].items():
        sys.stderr.write(f"check {name} {check['value']!r} limit {check['limit']!r}\n")
    sys.stdout.write(json.dumps(core.finite(result), allow_nan=False) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
