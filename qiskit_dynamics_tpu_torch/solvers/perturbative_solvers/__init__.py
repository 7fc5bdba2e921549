"""Dyson/Magnus perturbative solvers."""
from .expansion_model import ExpansionModel
from .perturbative_solver import DysonSolver, MagnusSolver

__all__ = ["ExpansionModel", "DysonSolver", "MagnusSolver"]
