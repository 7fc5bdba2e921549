r"""The Magnus step rules of the fixed-step sweeps: their Gauss nodes and step
constants, shared by every engine (kernels B2, B3 and B8, the eager and
polynomial engines, the fused solvers).

Per step of size ``dt`` the generator is sampled at the Gauss-Legendre nodes
``t + c dt`` and combined by

- order 2 (two nodes, 4th order): ``M = dt/2 (G_1 + G_2) + p2 dt^2 [G_2, G_1]``
  with ``p2 = sqrt(3) / 12``;
- order 3 (three nodes, 6th order, Blanes et al. 2009): ``a1 = dt G_2``,
  ``a2 = c0 dt (G_3 - G_1)``, ``a3 = c1 dt (G_3 - 2 G_2 + G_1)`` with
  ``c0 = sqrt(15) / 3`` and ``c1 = 10 / 3``, then the brackets.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MAGNUS_NODES", "TWO_PI", "step_constants", "validate_eval_slots"]

#: Gauss-Legendre nodes in (0, 1) of the Magnus rule of each order
MAGNUS_NODES = {
    2: np.array([0.5 - np.sqrt(3) / 6, 0.5 + np.sqrt(3) / 6]),
    3: np.array([0.5 - np.sqrt(15) / 10, 0.5, 0.5 + np.sqrt(15) / 10]),
}
P2 = np.sqrt(3) / 12
M3_C0 = np.sqrt(15) / 3
M3_C1 = 10.0 / 3
TWO_PI = 2.0 * np.pi


def step_constants(magnus_order: int, dt):
    """The rule's dt-dependent scalars in float64, of a step size or an array
    of them: ``(dt / 2, p2 dt^2)`` at order 2, ``(dt, c0 dt, c1 dt)`` at order
    3 (each is rounded once to the working dtype where it is used)."""
    if magnus_order == 2:
        return 0.5 * dt, P2 * dt * dt
    return dt, M3_C0 * dt, M3_C1 * dt


def validate_eval_slots(eval_slots, T: int) -> int:
    """Validate a trajectory slot table; returns ``n_eval``.

    The non-negative entries must be exactly a permutation of
    ``range(n_eval)``: a duplicate or gapped slot would leave trajectory
    slots unwritten.
    """
    if len(eval_slots) != T:
        raise ValueError(f"eval_slots must have length T={T}")
    marked = sorted(int(s) for s in eval_slots if int(s) >= 0)
    if not marked:
        raise ValueError("eval_slots must mark at least one step")
    if marked != list(range(len(marked))):
        raise ValueError(
            "the non-negative eval_slots values must be exactly a "
            f"permutation of range(n_eval); got {marked}."
        )
    return len(marked)
