"""CPU tests of the benchmark harness, at tiny sizes:

    python -m pytest eigbench/tests -q --noconftest

(``--noconftest`` leaves out the repository's root conftest, which loads the
JAX package's native library for the tests under ``tests/``.)
"""
