"""Parity of the port's native-FP64 Magnus sweep (kernel B8's plain version)
with the JAX package's double-float32 Pallas kernel,
``ops/df_sweep_pallas.py``, run in interpret mode, at the shapes of the JAX
package's own test (``tests/test_df32.py::TestDfSweepPallas``).

Tolerance 1e-12 on unit-norm states: the Pallas kernel's double-float32
arithmetic (unit roundoff ~2^-48) against float64, over 16 to 40 steps. Each
interpret call takes 15-25 s, so the file holds three.
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close

from qiskit_dynamics_tpu.ops.df_sweep import MAGNUS_NODES as JAX_NODES
from qiskit_dynamics_tpu.ops.df_sweep_pallas import sweep_expm_magnus_df_pallas as jax_pallas

from qiskit_dynamics_tpu_torch.ops import df_sweep as dfs


def _engines_problem(magnus_order):
    """``TestDfSweepPallas.test_engines_agree``: n = 4, k = 2, B = 8, T = 40."""
    gen = np.random.default_rng(5)
    n, k, B = 4, 2, 8
    h0 = gen.standard_normal((n, n)) + 1j * gen.standard_normal((n, n))
    static = -1j * (h0 + h0.conj().T) / 2 * 0.3
    ops = np.array([
        -1j * ((a + a.conj().T) / 2) * 0.1
        for a in (gen.standard_normal((n, n)) + 1j * gen.standard_normal((n, n))
                  for _ in range(k))
    ])
    omega = gen.standard_normal((n, n)) * 0.5
    omega = omega - omega.T
    amps = gen.standard_normal((k, B))
    freqs = np.array([1.3, 0.7])
    t0, dt, T = 0.5, 0.05, 40
    tau = t0 + dt * (np.arange(T)[:, None] + JAX_NODES[magnus_order][None, :])
    coefs = amps[None, None] * np.cos(freqs[None, None, :, None] * tau[:, :, None, None])
    y0 = np.zeros((n, B), dtype=complex)
    y0[0] = 1.0
    return (static, ops, omega, coefs, y0), dict(dt=dt, t0=t0, magnus_order=magnus_order)


def _pad_problem(_):
    """``TestDfSweepPallas.test_pad_to_tile``: n = 2, k = 1, B = 5 (not a
    multiple of the JAX tile), T = 16, Magnus-3."""
    gen = np.random.default_rng(6)
    n, B = 2, 5
    static = -1j * np.array([[0.3, 0.0], [0.0, -0.3]], dtype=complex)
    ops = np.array([-1j * np.array([[0, 0.2], [0.2, 0]], dtype=complex)])
    omega = np.zeros((n, n))
    T, dt = 16, 0.1
    tau = dt * (np.arange(T)[:, None] + JAX_NODES[3][None, :])
    coefs = gen.standard_normal((1, B))[None, None] * np.cos(tau)[:, :, None, None]
    y0 = np.zeros((n, B), dtype=complex)
    y0[0] = 1.0
    return (static, ops, omega, coefs, y0), dict(dt=dt, magnus_order=3)


@pytest.mark.parametrize("make, magnus_order", [(_engines_problem, 2), (_engines_problem, 3),
                                                (_pad_problem, 3)])
def test_plain_matches_jax_pallas(make, magnus_order):
    args, kwargs = make(magnus_order)
    expected = np.asarray(jax_pallas(*args, tile_b=8, interpret=True, **kwargs))
    static, ops, omega, coefs, y0 = args
    out = dfs.sweep_expm_magnus_df_pallas(static, ops, omega, coefs, torch.as_tensor(y0),
                                          **kwargs)
    assert out.shape == expected.shape and out.dtype == torch.complex128
    assert_rel_close(out, expected, 1e-12)
    # the XLA entry point on the same inputs is the same computation
    assert torch.equal(dfs.sweep_expm_magnus_df(static, ops, omega, coefs, torch.as_tensor(y0),
                                                **kwargs), out)
