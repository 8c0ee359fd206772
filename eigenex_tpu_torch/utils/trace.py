"""Convergence tracing and event logging.

Copy of ``eigenex_tpu/utils/trace.py`` (pure host code).  The reference keeps a
severity-tagged string event log ``log_`` with ``ERROR/WARN/INFO/DEBUG``
headers and ``hasERROR()/hasWARN()`` queries (lanczos.hpp:486-489,636,
903-922) and the per-eigenvalue Ritz history ``convergenceLog_``
(lanczos.hpp:638,853-864; arnoldi.hpp:659,954-964).

Here both live on the host as a plain mutable record appended between
solver chunks; the solver returns it alongside the results so
user code can print/plot convergence exactly like the reference samples
do (sample_lanczos2.cpp:76-86).
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["ConvergenceTrace", "Severity"]


class Severity:
    ERROR = "ERROR"
    WARN = "WARN"
    INFO = "INFO"
    DEBUG = "DEBUG"


@dataclasses.dataclass
class ConvergenceTrace:
    """Per-check convergence history + event log of one solver run."""

    #: iteration count at each convergence check
    iterations: list = dataclasses.field(default_factory=list)
    #: tracked Ritz values at each check (np.ndarray per entry)
    ritz_values: list = dataclasses.field(default_factory=list)
    #: residual-norm proxy at each check (beta_k for Lanczos, residue for Arnoldi)
    residuals: list = dataclasses.field(default_factory=list)
    #: wall-clock seconds at each check (host time; 0-based from solve start)
    timings: list = dataclasses.field(default_factory=list)
    #: severity-tagged event messages (cf. log_ lanczos.hpp:636)
    events: list = dataclasses.field(default_factory=list)

    def record(self, iteration: int, ritz, residual: float, t: float = 0.0):
        self.iterations.append(int(iteration))
        self.ritz_values.append(np.asarray(ritz))
        self.residuals.append(float(residual))
        self.timings.append(float(t))

    def log(self, severity: str, message: str):
        self.events.append(f"{severity}: {message}")

    def has_error(self) -> bool:
        """cf. hasERROR lanczos.hpp:903-911"""
        return any(e.startswith(Severity.ERROR) for e in self.events)

    def has_warn(self) -> bool:
        """cf. hasWARN lanczos.hpp:914-922"""
        return any(e.startswith(Severity.WARN) for e in self.events)

    def ritz_history(self, tracked_position: int) -> np.ndarray:
        """Full history of one tracked Ritz value across checks
        (cf. convergenceLog_ per-index history lanczos.hpp:853-864)."""
        return np.array(
            [rv[tracked_position] for rv in self.ritz_values if len(rv) > tracked_position]
        )

    def __str__(self):
        lines = [f"ConvergenceTrace({len(self.iterations)} checks)"]
        for it, rv, res in zip(self.iterations, self.ritz_values, self.residuals):
            lines.append(f"  iter {it:5d}  residual {res:.3e}  ritz {np.array2string(rv, precision=8)}")
        lines.extend("  " + e for e in self.events)
        return "\n".join(lines)
