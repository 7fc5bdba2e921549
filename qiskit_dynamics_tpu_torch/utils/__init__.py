"""Utilities: per-solve metrics and profiler ranges."""
from .metrics import SolveMetrics, disable_metrics, enable_metrics, solve_metrics, solve_span

__all__ = ["SolveMetrics", "enable_metrics", "disable_metrics", "solve_metrics", "solve_span"]
