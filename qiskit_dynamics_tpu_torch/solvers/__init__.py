"""Solvers: ``solve_ode``/``solve_lmde`` (scipy host solves and the device
fixed-step, Lanczos, parallel and adaptive methods), the fused sweeps, the
Chebyshev-interpolated sweeps, the Solver class and the perturbative
(Dyson/Magnus) solvers."""
from .results import OdeResult
from .solver_functions import solve_ode, solve_lmde, ODE_METHODS, LMDE_METHODS
from .scipy_solve_ivp import scipy_solve_ivp
from .solver_classes import Solver
from .fused_sweep import fused_adaptive_sweep_solve, fused_sweep_solve
from .sweep_interpolation import (
    interpolated_sweep_solve,
    interpolated_sweep_solve_2d,
    SweepInterpolationInfo,
    SweepInterpolation2DInfo,
)
from .perturbative_solvers import DysonSolver, MagnusSolver, ExpansionModel
