"""Dormand-Prince 5(4) Butcher tableau (DOPRI5), as plain constants.

Counterpart of the DOPRI5 part of ``qiskit_dynamics_tpu/ops/rk_tableaus.py``
(same published values: Dormand & Prince, J. Comp. Appl. Math. 6 (1980)).
``A[i, j]`` are the stage coefficients, ``B`` the solution weights, ``C``
the stage times, ``E`` the error-estimate weights (including the FSAL
stage). The CUDA kernel ``csrc/adaptive_sweep.cu`` carries a copy of these
numbers; ``tests/test_torch_adaptive_sweep.py`` holds the two equal.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DOPRI5_A", "DOPRI5_B", "DOPRI5_C", "DOPRI5_E", "DOPRI5_N_STAGES"]

DOPRI5_N_STAGES = 6
DOPRI5_A = np.array([
    [0.0, 0.0, 0.0, 0.0, 0.0],
    [0.2, 0.0, 0.0, 0.0, 0.0],
    [0.075, 0.225, 0.0, 0.0, 0.0],
    [0.9777777777777777, -3.7333333333333334, 3.5555555555555554, 0.0, 0.0],
    [2.9525986892242035, -11.595793324188385, 9.822892851699436, -0.2908093278463649, 0.0],
    [2.8462752525252526, -10.757575757575758, 8.906422717743473, 0.2784090909090909, -0.2735313036020583],
])
DOPRI5_B = np.array([0.09114583333333333, 0.0, 0.44923629829290207, 0.6510416666666666, -0.322376179245283, 0.13095238095238096])
DOPRI5_C = np.array([0.0, 0.2, 0.3, 0.8, 0.8888888888888888, 1.0])
DOPRI5_E = np.array([-0.0012326388888888888, 0.0, 0.0042527702905061394, -0.03697916666666667, 0.05086379716981132, -0.0419047619047619, 0.025])
