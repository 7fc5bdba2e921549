"""Compute kernels of the port and their plain versions: the lockstep-adaptive
dopri5 sweep (B1), the fixed-step Magnus-2 sweep (B2), the eager engine and
the differentiable wrapper of the fixed-step sweep."""
from .adaptive_sweep import sweep_dopri5_lockstep, sweep_dopri5_lockstep_plain
from .sweep_solver import sweep_expm_magnus2, sweep_expm_magnus2_plain
from .xla_sweep import sweep_expm_magnus2_xla
from .sweep_ad import sweep_expm_magnus2_ad

__all__ = [
    "sweep_dopri5_lockstep",
    "sweep_dopri5_lockstep_plain",
    "sweep_expm_magnus2",
    "sweep_expm_magnus2_plain",
    "sweep_expm_magnus2_xla",
    "sweep_expm_magnus2_ad",
]
