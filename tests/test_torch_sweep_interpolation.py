"""Parity of the port's Chebyshev-interpolated sweeps with the JAX package's
``solvers/sweep_interpolation.py``, and ``Solver.solve_sweep(method="chebyshev")``.

Node placement, refinement and the certificate are the JAX package's host
logic, so the two packages solve the same nodes and report the same ``Info``
fields. The inner solver is ``fused_sweep_solve(precision="df32")`` over
T = 2 at ``max_dt=0.05`` (40 steps of Magnus-3); the JAX package's
double-float32 engine with its float32 commutators leaves ~3e-11 there
against the port's float64, so the reconstructed states agree within 1e-10
(the interpolant adds no error of its own: both evaluate the same
coefficients), and the certified error estimates, both at that level, within
1e-10.
"""
import numpy as np
import pytest
import torch

from torch_parity import to_np

from qiskit_dynamics_tpu import Signal as JaxSignal
from qiskit_dynamics_tpu.benchmarks import cr_solver as jax_cr_solver
from qiskit_dynamics_tpu.solvers import interpolated_sweep_solve as jax_interp
from qiskit_dynamics_tpu.solvers import interpolated_sweep_solve_2d as jax_interp_2d

from qiskit_dynamics_tpu_torch import Signal
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError
from qiskit_dynamics_tpu_torch.solvers import (
    SweepInterpolation2DInfo,
    SweepInterpolationInfo,
    interpolated_sweep_solve,
    interpolated_sweep_solve_2d,
)

T_SPAN = (0.0, 2.0)
Y0 = np.eye(4, dtype=complex)[0]
AMPS = np.linspace(0.3, 1.0, 40)
DETS = np.linspace(-0.05, 0.05, 7)
KW = dict(t_span=T_SPAN, y0=Y0, tol=1e-9, max_dt=0.05, full_output=True)


@pytest.fixture(scope="module")
def cr_pair():
    return jax_cr_solver(dim=2), cr_solver(dim=2, device="cpu")


def _amp(package_signal, w1):
    return lambda a: [package_signal(lambda t: a * 0.4, carrier_freq=w1)]


def _amp_det(package_signal, w1):
    return lambda pq: [package_signal(lambda t: pq[0] * 0.4, carrier_freq=w1 + pq[1])]


def _same_info(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.n_nodes == want.n_nodes and got.levels == want.levels
    assert got.converged == want.converged
    assert abs(got.est_error - want.est_error) <= 1e-10
    pairs = zip(got.node_params, want.node_params) if isinstance(got.node_params, tuple) else [
        (got.node_params, want.node_params)]
    for g, w in pairs:
        np.testing.assert_array_equal(g, np.asarray(w))


def test_1d_matches_jax(cr_pair):
    (jsolver, w1), (tsolver, _) = cr_pair
    kw = dict(KW, min_level=2, max_level=6)
    want, want_info = jax_interp(jsolver.model, _amp(JaxSignal, w1), AMPS,
                                 rwa_signal_map=jsolver._rwa_signal_map, **kw)
    got, info = tsolver.solve_sweep(_amp(Signal, w1), torch.as_tensor(AMPS), method="chebyshev",
                                    **kw)
    assert isinstance(info, SweepInterpolationInfo) and info.converged
    assert got.dtype == torch.complex128 and got.shape == (AMPS.size, 4)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-10)
    _same_info(info, want_info)


@pytest.mark.parametrize("layout", ["product", "points"])
def test_2d_matches_jax(cr_pair, layout):
    (jsolver, w1), (tsolver, _) = cr_pair
    kw = dict(KW, min_level=2, max_level=5)
    if layout == "product":
        params, shape = (AMPS[:6], DETS), (6, DETS.size, 4)
    else:
        params = np.stack([AMPS[::4], np.linspace(-0.05, 0.05, AMPS[::4].size)], axis=1)
        shape = (params.shape[0], 4)
    want, want_info = jax_interp_2d(jsolver.model, _amp_det(JaxSignal, w1), params,
                                    rwa_signal_map=jsolver._rwa_signal_map, **kw)
    got, info = tsolver.solve_sweep(_amp_det(Signal, w1), params, method="chebyshev", **kw)
    assert isinstance(info, SweepInterpolation2DInfo) and info.converged
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-10)
    _same_info(info, want_info)


def test_solver_dispatch_and_node_solver(cr_pair):
    """``Solver.solve_sweep(method="chebyshev")`` is the 1-d function for 1-d
    params and the 2-d one for a pair tuple; a custom node solver is used as
    given and its states' device is kept."""
    (_, w1), (tsolver, _) = cr_pair
    kw = dict(t_span=T_SPAN, y0=Y0, tol=1e-9, max_dt=0.2, min_level=2, max_level=6)
    direct = interpolated_sweep_solve(tsolver.model, _amp(Signal, w1), AMPS,
                                      rwa_signal_map=tsolver._rwa_signal_map, **kw)
    via = tsolver.solve_sweep(_amp(Signal, w1), AMPS, method="chebyshev", **kw)
    assert torch.equal(via, direct)
    calls = []

    def node_solver(q):
        calls.append(len(q))
        return torch.as_tensor(np.stack([np.cos(q), np.sin(3 * q)], axis=1))

    out = interpolated_sweep_solve(None, None, AMPS, None, None, node_solver=node_solver,
                                   min_level=3, max_level=8)
    np.testing.assert_allclose(to_np(out), np.stack([np.cos(AMPS), np.sin(3 * AMPS)], axis=1),
                               rtol=0, atol=1e-9)
    assert calls == [9] + [8 * 2**i for i in range(len(calls) - 1)]
    out2 = interpolated_sweep_solve_2d(
        None, None, (AMPS[:5], DETS), None, None, min_level=2, max_level=5,
        node_solver=lambda q1, q2: torch.as_tensor(np.cos(q1) * np.exp(q2))[:, None],
    )
    np.testing.assert_allclose(to_np(out2)[..., 0], np.cos(AMPS[:5])[:, None] * np.exp(DETS),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize(
    "call, message",
    [(lambda f: f(np.array([0.5])), "1-d with >= 2 entries"),
     (lambda f: f(np.array([0.5, 0.5])), "nonzero interval"),
     (lambda f: f(AMPS, min_level=4, max_level=4), "min_level < max_level"),
     (lambda f: f(torch.tensor(AMPS, requires_grad=True)), "must not require grad"),
     (lambda f: f(AMPS, min_level=1, max_level=2, tol=1e-15), "did not reach tol"),
     (lambda f: interpolated_sweep_solve_2d(None, None, np.zeros((4, 3)), None, None),
      "tuple \\(product grid\\)"),
     (lambda f: interpolated_sweep_solve_2d(None, None, (AMPS, np.ones(3)), None, None),
      "nonzero intervals")],
)
def test_validation(call, message):
    def f(params, **kwargs):
        return interpolated_sweep_solve(
            None, None, params, None, None,
            node_solver=lambda q: torch.as_tensor(np.exp(np.outer(q, [1.0, 9.0]))), **kwargs,
        )

    with pytest.raises(DynamicsError, match=message):
        call(f)
