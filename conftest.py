"""Load the JAX package's native library before any test module is collected.

``tests/test_native.py`` decides its module-level ``skipif`` on
``eigenex_tpu.native.native_available()`` while it is collected.  Under
pytest-xdist every worker collects every file, so a worker that lost the
library's unlocked build race (see ``tests/_reference_native.py``) would skip
that file before any port test module had run the guard.  Pytest loads this
file, and runs the hook below, in the main process and in every worker before
collection starts, after ``tests/conftest.py`` has configured JAX.
"""

import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent / "tests"


def pytest_sessionstart(session):
    if str(TESTS) not in sys.path:
        sys.path.insert(0, str(TESTS))
    from _reference_native import ensure_reference_native

    ensure_reference_native()
