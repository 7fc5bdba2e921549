"""Propagator composition (the single-device part of
``qiskit_dynamics_tpu/parallel``; the multi-device part is still to be
ported, see ``ROADMAP.md``)."""
from .scan import propagator_scan

__all__ = ["propagator_scan"]
