"""Kernel B2's frame-phase table and launch arithmetic, on the CPU.

The fixed-step Magnus-2 sweep (``ops/sweep_solver.py``) forms the frame
phases of every step once per call (:func:`phase_table`); the kernel and the
plain version both read that table. These tests hold it against the phases
the plain version formed inside its step loop before the table existed, in
float64, and check the padded layout the kernel reads. This file imports
nothing of JAX.
"""
import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.ops import sweep_solver as ssw
from qiskit_dynamics_tpu_torch.ops.magnus_rule import MAGNUS_NODES, TWO_PI


@pytest.mark.parametrize("n", [1, 3, 4, 9, 16])
def test_phase_table_matches_in_loop_phases(n):
    gen = np.random.default_rng(n)
    w = 2 * np.pi * np.sort(gen.uniform(0.0, 5.0, n))
    omega = torch.as_tensor(w[None, :] - w[:, None])
    t0, dt, steps = 331.7, 0.05, 7  # phase arguments near 1e4 rad
    table = ssw.phase_table(omega, t0, dt, steps, torch.float64)
    nc = ssw.columns(n)
    assert table.shape == (steps, 2, nc // 2, n, 4)
    cos_t, sin_t = ssw.phase_matrices(table, n)
    for step in range(steps):
        for g, gauss_c in enumerate(MAGNUS_NODES[2].tolist()):
            # the plain version's former in-loop phases
            tau = t0 + (step + gauss_c) * dt
            ph = torch.fmod(omega * tau, TWO_PI)
            assert torch.equal(cos_t[step, g], torch.cos(ph))
            assert torch.equal(sin_t[step, g], torch.sin(ph))
    # the kernel's layout: row i of columns (2p, 2p + 1) at [s, g, p, i], zero past n
    full = table.transpose(2, 3).reshape(steps, 2, n, nc, 2)
    assert torch.equal(full[:, :, :, n:], torch.zeros_like(full[:, :, :, n:]))
    p, i = (n - 1) // 2, n - 1
    assert torch.equal(table[:, :, p, i, 0], cos_t[:, :, i, 2 * p])
    assert torch.equal(table[:, :, p, i, 1], sin_t[:, :, i, 2 * p])


def test_phase_table_rounds_once_to_float32():
    omega = torch.as_tensor([[0.0, 31.4], [-31.4, 0.0]], dtype=torch.float64)
    f64 = ssw.phase_table(omega, 100.0, 0.02, 5, torch.float64)
    f32 = ssw.phase_table(omega, 100.0, 0.02, 5, torch.float32)
    assert f32.dtype == torch.float32 and torch.equal(f32, f64.float())


@pytest.mark.parametrize("n, nc", [
    (1, 4), (3, 4), (4, 4), (5, 8), (8, 8), (9, 12), (16, 16), (17, 20), (25, 28), (32, 32),
])
def test_columns(n, nc):
    """The kernel's padded state dimension: n rounded up to a multiple of 4
    (its 16-byte loads hold two complex entries), at least 4."""
    assert ssw.columns(n) == nc


def _shape(blocks, blocks_per_sm, warps):
    return ssw.LaunchShape(columns=16, lanes_per_member=16, members_per_warp=2,
                           warps_per_block=warps, blocks=blocks, smem_bytes=0,
                           blocks_per_sm=blocks_per_sm, registers=0, local_bytes=0)


def test_wave_cost():
    """Full waves cost their warps per SM; a last partial wave the warps on
    its fullest SM; neither less than a saturated wave. The CR shape (5,000
    warps on 132 SMs) prefers 5 warps per block (2 waves of 20 warps per SM)
    to 4 (3 waves of 16)."""
    sms, sat = 132, ssw.SATURATING_WARPS
    assert ssw.wave_cost(_shape(1250, 4, 4), sms) == 3 * max(16, sat)
    assert ssw.wave_cost(_shape(1000, 4, 5), sms) == 2 * max(20, sat)
    assert ssw.wave_cost(_shape(1000, 4, 5), sms) < ssw.wave_cost(_shape(1250, 4, 4), sms)
    assert ssw.wave_cost(_shape(10, 8, 4), sms) == sat  # one sparse wave
