"""Cumulative propagator products over time.

Counterpart of the single-device ``propagator_scan`` of
``qiskit_dynamics_tpu/parallel/scan.py``. Composition order: the cumulative
product at step k is ``U_k = P_k @ P_{k-1} @ ... @ P_0``.
"""
from __future__ import annotations

import torch

__all__ = ["propagator_scan"]


def propagator_scan(step_propagators: torch.Tensor) -> torch.Tensor:
    """Cumulative products of a ``(T, ..., n, n)`` propagator stack in
    ``ceil(log2 T)`` batched ``torch.matmul`` passes (a Hillis-Steele scan):
    ``out[k] = step_propagators[k] @ ... @ step_propagators[0]``.
    Differentiable."""
    out = step_propagators
    shift = 1
    while shift < out.shape[0]:
        out = torch.cat([out[:shift], torch.matmul(out[shift:], out[:-shift])], dim=0)
        shift *= 2
    return out
