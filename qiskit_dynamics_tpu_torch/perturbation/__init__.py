"""Time-dependent perturbation theory (Dyson, Magnus, Dyson-like).

Counterpart of ``qiskit_dynamics_tpu/perturbation``.
"""
from .multiset_utils import (
    Multiset,
    to_multiset,
    clean_multisets,
    get_all_submultisets,
    submultisets_and_complements,
)
from .custom_dot import CustomMatmul, CustomMul, compile_rule, CompiledRule
from .array_polynomial import ArrayPolynomial
from .perturbation_data import PowerSeriesData, DysonLikeData
from .solve_lmde_perturbation import solve_lmde_perturbation
from .dyson_magnus import magnus_from_dyson

__all__ = [
    "solve_lmde_perturbation",
    "ArrayPolynomial",
    "PowerSeriesData",
    "DysonLikeData",
    "Multiset",
    "to_multiset",
    "CustomMatmul",
    "CustomMul",
    "magnus_from_dyson",
]
