"""Per-solve metrics and profiler ranges.

Counterpart of ``qiskit_dynamics_tpu/utils/metrics.py``:

- :func:`solve_span` wraps each solve in a ``torch.profiler.record_function``
  range named after the method (visible in ``torch.profiler`` traces, where
  it groups the solve's kernels) and records its host wall time;
- :func:`enable_metrics` / :func:`solve_metrics` expose a process-local
  registry of recent solve statistics (method, wall time, integrator stats
  such as ``nfev`` when the caller passes them).

The wall time is the host's: a device method returns before the card has
finished unless its result is read back, so it measures the enqueue.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

__all__ = ["SolveMetrics", "enable_metrics", "disable_metrics", "solve_metrics", "solve_span"]


@dataclass
class SolveMetrics:
    """Statistics for one solve call."""

    method: str
    wall_time_s: float
    extra: Dict[str, Any] = field(default_factory=dict)


_ENABLED = False
_RECORDS: List[SolveMetrics] = []
_MAX_RECORDS = 1000


def enable_metrics():
    """Start recording per-solve metrics."""
    global _ENABLED
    _ENABLED = True


def disable_metrics(clear: bool = False):
    """Stop recording; optionally clear the registry."""
    global _ENABLED
    _ENABLED = False
    if clear:
        _RECORDS.clear()


def solve_metrics() -> List[SolveMetrics]:
    """Recorded metrics, oldest first."""
    return list(_RECORDS)


@contextmanager
def solve_span(name: str, method: str = "", result_stats: Optional[dict] = None):
    """Named profiler range + optional metrics record around a solve phase."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if _ENABLED:
        _RECORDS.append(
            SolveMetrics(
                method=method or name,
                wall_time_s=time.perf_counter() - t0,
                extra=dict(result_stats or {}),
            )
        )
        del _RECORDS[:-_MAX_RECORDS]
