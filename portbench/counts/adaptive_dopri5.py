"""The lockstep-adaptive dopri5 sweep (kernel B1's algorithm).

Copied from ``chip_smoke.py`` (``b1_work``). Its work depends on the steps
each tile accepted: ``portbench/metrics/adaptive_roofline_pct.py`` reads
them from the port's counter ``b1.steps_accepted`` and B1's ``sweep.engine``
spans in a traced run.
"""
from __future__ import annotations


def flops(n: int, k: int, tile_b: int, accepted) -> float:
    """Float32 operations for the accepted steps of each tile (6 new stages
    per step, FSAL): per stage and member the generator entries (4k) and the
    complex multiply-add (8) for n^2 entries, the stage combination and the
    error norm (~20 n)."""
    stages = 6 * float(sum(accepted))
    return stages * tile_b * (n * n * (4 * k + 8) + 20 * n)


def nbytes(n: int, k: int, lanes: int) -> float:
    """The amplitude table and the initial and final states, float32."""
    return 4 * (2 * k * lanes + 4 * n * lanes)
