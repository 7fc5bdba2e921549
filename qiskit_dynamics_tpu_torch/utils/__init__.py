"""Utilities: the port's spans and counters, and per-solve metrics."""
from .metrics import (
    SolveMetrics,
    SpanRecord,
    counters,
    disable_metrics,
    enable_metrics,
    reset_spans,
    solve_metrics,
    solve_span,
    span,
    span_records,
    span_totals,
)

__all__ = [
    "SolveMetrics", "SpanRecord", "enable_metrics", "disable_metrics", "solve_metrics",
    "solve_span", "span", "span_records", "span_totals", "counters", "reset_spans",
]
