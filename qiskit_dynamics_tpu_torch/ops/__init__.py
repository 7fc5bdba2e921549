"""Compute kernels of the port: the lockstep-adaptive dopri5 sweep (CUDA kernel
and eager twin) and the tableau constants it uses."""
from .adaptive_sweep import sweep_dopri5_lockstep, sweep_dopri5_lockstep_plain

__all__ = ["sweep_dopri5_lockstep", "sweep_dopri5_lockstep_plain"]
