"""Compute kernels of the port and their plain versions: the lockstep-adaptive
dopri5 sweep (B1), the fixed-step Magnus-2 sweep (B2), the member-major
Magnus-2/3 sweep (B3), the Horner expm action (B4), the streamed propagator
chain (B5), the batch-minor Taylor expm, its backward and the batched product
(B6, B7, B10), the native-FP64 Magnus sweep (B8), the fused expm chain (B9)
and the fixed-order Taylor expm it shares with the fixed-step solvers, the
perturbative step's monomials and their contraction (B11), the
eager and polynomial engines and the differentiable wrappers of the
fixed-step sweeps."""
from .adaptive_sweep import sweep_dopri5_lockstep, sweep_dopri5_lockstep_plain
from .sweep_solver import sweep_expm_magnus2, sweep_expm_magnus2_plain
from .xla_sweep import sweep_expm_magnus2_xla
from .member_sweep import sweep_expm_magnus2_member, sweep_expm_magnus2_member_plain
from .horner_pallas import horner_apply_bm, horner_apply_bm_ad, horner_twin_bm
from .polynomial_sweep import expand_magnus_polynomial, sweep_expm_magnus_poly
from .sweep_ad import sweep_expm_magnus2_ad, sweep_expm_magnus2_member_ad
from .df_sweep import sweep_expm_magnus_df, sweep_expm_magnus_df_plain
from .chain_apply import chain_apply_bol, chain_apply_bol_ad, chain_apply_bol_plain
from .expm import expm_taylor
from .expm_chain_pallas import expm_chain_fused, expm_chain_fused_plain
from .monomial_contract import contract_monomials, contract_monomials_plain
from .batched_linalg import (
    matmul_bol,
    expm_taylor_bol,
    expm_taylor_bol_ad,
    expm_taylor_bol_bwd,
    to_bol,
    from_bol,
)

__all__ = [
    "sweep_dopri5_lockstep",
    "sweep_dopri5_lockstep_plain",
    "sweep_expm_magnus2",
    "sweep_expm_magnus2_plain",
    "sweep_expm_magnus2_xla",
    "sweep_expm_magnus2_member",
    "sweep_expm_magnus2_member_plain",
    "horner_apply_bm",
    "horner_apply_bm_ad",
    "horner_twin_bm",
    "expand_magnus_polynomial",
    "sweep_expm_magnus_poly",
    "sweep_expm_magnus2_ad",
    "sweep_expm_magnus2_member_ad",
    "sweep_expm_magnus_df",
    "sweep_expm_magnus_df_plain",
    "chain_apply_bol",
    "chain_apply_bol_ad",
    "chain_apply_bol_plain",
    "matmul_bol",
    "expm_taylor_bol",
    "expm_taylor_bol_ad",
    "expm_taylor_bol_bwd",
    "to_bol",
    "from_bol",
    "expm_taylor",
    "expm_chain_fused",
    "expm_chain_fused_plain",
    "contract_monomials",
    "contract_monomials_plain",
]
