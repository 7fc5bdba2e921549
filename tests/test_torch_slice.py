"""The port's CR amplitude-sweep main path end to end against the JAX package
and against host float64 DOP853.

- ``Solver.solve_sweep`` (eager twin on the CPU) against JAX
  ``fused_adaptive_sweep_solve(interpret=True)`` at n = 4, with 6 members in
  tiles of 4 (two padding lanes): within 2e-5 (both integrate in float32;
  their step grids differ by f32 roundoff in the error estimates).
- The full-width n = 16 ``cr_solver()`` at the main path's settings
  (T = 100, atol = rtol = 1e-6, h0 = 0.1) for 3 members against DOP853
  (atol = rtol = 1e-8): populations within 1e-5, the accuracy bar of the
  workload.
- The port's DOP853 against the JAX DOP853: 1e-8 (both scipy DOP853 on
  float64 right-hand sides that agree to rounding).
- Importing the port does not import ``jax``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import rng

import jax.numpy as jnp

from qiskit_dynamics_tpu import Signal as JaxSignal
from qiskit_dynamics_tpu.benchmarks import cr_solver as jax_cr_solver
from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve as jax_fused_solve

from qiskit_dynamics_tpu_torch import Signal
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver
from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.solvers import fused_adaptive_sweep_solve

T_SMALL = 2.0
AMP_SCALE = 0.02


@pytest.fixture(scope="module")
def small_sweep():
    """6 seeded amplitudes through both packages at n = 4 (tile_b = 4)."""
    amps = np.sort(rng(5).uniform(2.0, 10.0, 6))[::-1].copy()  # unsorted order is bucketed
    rng(6).shuffle(amps)
    y0 = np.zeros(4, dtype=complex)
    y0[0] = 1.0
    t_eval = [0.0, 0.7, T_SMALL]
    kwargs = dict(t_span=(0.0, T_SMALL), y0=y0, atol=1e-6, rtol=1e-6, h0=0.1, tile_b=4)

    jsolver, w1 = jax_cr_solver(dim=2)
    jfn = lambda a: [JaxSignal(lambda t: a * AMP_SCALE, carrier_freq=w1)]
    jax_out = jax_fused_solve(
        jsolver.model, jfn, jnp.asarray(amps), interpret=True,
        rwa_signal_map=jsolver._rwa_signal_map, differentiable=False, t_eval=t_eval, **kwargs,
    )
    tsolver, _ = cr_solver(dim=2, device="cpu")
    tfn = lambda a: [Signal(lambda t: a * AMP_SCALE, carrier_freq=w1)]
    port_out = tsolver.solve_sweep(tfn, torch.as_tensor(amps), t_eval=t_eval, **kwargs)
    return amps, np.asarray(jax_out), port_out


def test_solve_sweep_matches_jax(small_sweep):
    _, jax_out, port_out = small_sweep
    assert port_out.shape == jax_out.shape == (6, 3, 4)
    np.testing.assert_allclose(port_out.numpy(), jax_out, rtol=0, atol=2e-5)


def test_solve_sweep_keeps_member_order_and_t0(small_sweep):
    """Bucketing is undone (member i is amplitude i) and t_eval[0] = t0 is y0."""
    amps, _, port_out = small_sweep
    np.testing.assert_array_equal(port_out[:, 0].numpy(), np.tile([1, 0, 0, 0], (6, 1)))
    solver, w1 = cr_solver(dim=2, device="cpu")
    y0 = np.eye(4, dtype=complex)[0]
    for i in (0, 5):
        ref = solver.solve(
            t_span=[0.0, T_SMALL], y0=y0, method="DOP853", atol=1e-10, rtol=1e-10,
            signals=[Signal(lambda t, a=amps[i]: a * AMP_SCALE, carrier_freq=w1)],
        )
        np.testing.assert_allclose(port_out[i, -1].numpy(), ref.y[-1], rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def full_width():
    """The main path at full width (n = 16) for 3 members, on the twin."""
    solver, w1 = cr_solver(device="cpu")
    y0 = np.zeros(16, dtype=complex)
    y0[0] = 1.0
    amps = np.array([0.25, 0.625, 1.0])
    before = launches("adaptive_sweep_launch")
    out = solver.solve_sweep(
        lambda a: [Signal(lambda t: a * AMP_SCALE, carrier_freq=w1)], torch.as_tensor(amps),
        t_span=(0.0, 100.0), y0=y0, atol=1e-6, rtol=1e-6, h0=0.1,
    )
    assert launches("adaptive_sweep_launch") == before  # CPU tensors: the twin, no launch
    return solver, w1, y0, amps, out


def test_full_width_cr_sweep_within_bar(full_width):
    solver, w1, y0, amps, out = full_width
    assert out.shape == (3, 16)
    pops = out.abs().numpy() ** 2
    for i, a in enumerate(amps):
        ref = solver.solve(
            t_span=[0.0, 100.0], y0=y0, method="DOP853", atol=1e-8, rtol=1e-8,
            signals=[Signal(lambda t, a=a: a * AMP_SCALE, carrier_freq=w1)],
        )
        err = np.max(np.abs(pops[i] - np.abs(ref.y[-1]) ** 2))
        assert err <= 1e-5, (a, err)


def test_dop853_matches_jax():
    jsolver, w1 = jax_cr_solver()
    tsolver, _ = cr_solver(device="cpu")
    y0 = np.zeros(16, dtype=complex)
    y0[0] = 1.0
    kwargs = dict(t_span=[0.0, 20.0], y0=y0, method="DOP853", atol=1e-10, rtol=1e-10,
                  t_eval=[5.0, 20.0])
    jres = jsolver.solve(signals=[JaxSignal(lambda t: 0.7 * AMP_SCALE, carrier_freq=w1)], **kwargs)
    tres = tsolver.solve(signals=[Signal(lambda t: 0.7 * AMP_SCALE, carrier_freq=w1)], **kwargs)
    np.testing.assert_allclose(tres.t, np.asarray(jres.t), rtol=0, atol=0)
    np.testing.assert_allclose(tres.y, np.asarray(jres.y), rtol=0, atol=1e-8)


def test_gradient_request_raises():
    solver, w1 = cr_solver(dim=2, device="cpu")
    amps = torch.tensor([0.3, 0.6], dtype=torch.float64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="gradient"):
        solver.solve_sweep(
            lambda a: [Signal(lambda t: a * AMP_SCALE, carrier_freq=w1)], amps,
            t_span=(0.0, 1.0), y0=np.eye(4, dtype=complex)[0],
        )


def test_mesh_raises():
    solver, w1 = cr_solver(dim=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        fused_adaptive_sweep_solve(
            solver.model, lambda a: [Signal(lambda t: a, carrier_freq=w1)],
            torch.tensor([0.1]), (0.0, 1.0), np.eye(4, dtype=complex)[0], mesh=object(),
        )


def test_import_does_not_load_jax():
    code = (
        "import sys, qiskit_dynamics_tpu_torch, qiskit_dynamics_tpu_torch.interop, "
        "qiskit_dynamics_tpu_torch.benchmarks, qiskit_dynamics_tpu_torch.kernels._build, "
        "qiskit_dynamics_tpu_torch.ops.sweep_solver, qiskit_dynamics_tpu_torch.ops.xla_sweep, "
        "qiskit_dynamics_tpu_torch.ops.sweep_ad, qiskit_dynamics_tpu_torch.ops.member_sweep, "
        "qiskit_dynamics_tpu_torch.ops.horner_pallas, qiskit_dynamics_tpu_torch.ops.polynomial_sweep, "
        "qiskit_dynamics_tpu_torch.solvers.fused_sweep, qiskit_dynamics_tpu_torch.models.lindblad_model, "
        "qiskit_dynamics_tpu_torch.models.model_utils, "
        "qiskit_dynamics_tpu_torch.solvers.fixed_step_solvers, "
        "qiskit_dynamics_tpu_torch.ops.df_sweep, qiskit_dynamics_tpu_torch.solvers.sweep_interpolation, "
        "qiskit_dynamics_tpu_torch.ops.expm, qiskit_dynamics_tpu_torch.ops.expm_chain_pallas, "
        "qiskit_dynamics_tpu_torch.solvers.adaptive, qiskit_dynamics_tpu_torch.solvers.lanczos, "
        "qiskit_dynamics_tpu_torch.solvers.solver_utils, qiskit_dynamics_tpu_torch.utils.metrics; "
        "print('jax' in sys.modules)"
    )
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=root
    )
    assert out.stdout.strip() == "False"
