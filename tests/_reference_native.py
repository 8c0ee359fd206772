"""Make sure the JAX package's native library is loaded in this test process.

``eigenex_tpu/native/__init__.py`` builds ``libeigenex_native.so`` when it is
first imported, with no lock.  When several pytest-xdist workers import it
at once on a tree without the library, one worker's ``g++`` may still be
writing the file when another worker looks: that worker sees a fresh file,
skips the build, fails to ``dlopen`` the partial file and keeps
``NATIVE = None`` for its whole life.  Its tests then compare the port's
native route with the reference's numpy route (another RCM permutation) or
read "the native library is unavailable on this host".

:func:`ensure_reference_native` repairs that from the test side, without
touching the JAX package: when ``NATIVE`` is None while the library file
exists, it calls the package's own loader again -- under a file lock, after
the file has stopped changing, with a short sleep between tries, for at most
about a minute -- and rebinds ``eigenex_tpu.native.NATIVE`` to what it
returns.  Every call site of the JAX package reads ``native.NATIVE`` (or
``native_available()``) when it is called, so the rebinding reaches them.
The port's test modules that compare against the reference's native route
call it at import, which in every xdist worker is collection time, before
any test runs.
"""

from __future__ import annotations

import fcntl
import os
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the lock lives in the port's git-ignored build directory
LOCK = ROOT / "eigenex_tpu_torch" / "build" / "reference_native.lock"
#: seconds a library file must have kept its size and mtime before it is loaded
SETTLED = 1.0
#: what a test that needs the reference's native route says when it is missing
NOT_LOADED = ("the JAX package's native library is not loaded in this process "
              "(see tests/_reference_native.py)")


def _settled(path: Path) -> bool:
    try:
        st = path.stat()
    except FileNotFoundError:
        return False
    if time.time() - st.st_mtime < SETTLED:
        return False
    time.sleep(0.05)
    try:
        again = path.stat()
    except FileNotFoundError:
        return False
    return (again.st_size, again.st_mtime_ns) == (st.st_size, st.st_mtime_ns)


def ensure_reference_native(budget: float = 60.0, pause: float = 0.5, module=None) -> bool:
    """Reload the JAX package's native library if this process lost the
    build race; True when ``NATIVE`` is loaded on return.

    Does nothing when the library is loaded already, or when its file does
    not exist (no toolchain, or ``EIGENEX_TPU_NO_NATIVE`` set: the package's
    own choice)."""
    if module is None:
        import eigenex_tpu.native as module
    if os.environ.get("EIGENEX_TPU_NO_NATIVE"):
        return False
    lib = Path(module._LIB)
    if module.NATIVE is not None or not lib.exists():
        return module.NATIVE is not None
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    deadline = time.monotonic() + budget
    with open(LOCK, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            while module.NATIVE is None and time.monotonic() < deadline:
                if _settled(lib):
                    module.NATIVE = module._load()
                if module.NATIVE is None:
                    time.sleep(pause)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return module.NATIVE is not None
