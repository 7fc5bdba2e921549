"""Parity of the port's ``fused_sweep_solve(precision="df32")`` with the JAX
package's, and with the port's own DOP853.

The model is ``cr_solver(dim=2)`` (n = 4, RWA, frame diag(H0)) over T = 5 at
``max_dt=0.025`` (200 steps of Magnus-3). Tolerances and their reasons:

- against the JAX package with its defaults, 1e-10: the JAX engine runs its
  Magnus commutators in float32 (``df_fast``) and its outer Horner terms in
  complex64 (``df_horner_tail``), ~1e-11 over these steps; the port runs
  everything in float64 (those keywords are no-ops there);
- against the port's DOP853 at atol = rtol = 1e-12, 1e-8: the bar of the
  chip's df32 rows; the Magnus-3 truncation here is ~1e-11.

Cases: a uniform and an adaptive grid, off-grid ``t_eval``, a Gaussian
envelope, a (n, m) state, and a vectorized Lindblad model.
"""
import numpy as np
import pytest
import torch

from torch_parity import to_np

from qiskit_dynamics_tpu import Signal as JaxSignal
from qiskit_dynamics_tpu import Solver as JaxSolver
from qiskit_dynamics_tpu.benchmarks import cr_solver as jax_cr_solver
from qiskit_dynamics_tpu.solvers import fused_sweep_solve as jax_fused_sweep_solve

import qiskit_dynamics_tpu_torch as port
from qiskit_dynamics_tpu_torch import Signal
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError
from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.solvers import fused_sweep_solve

B8 = ("df_magnus_sweep_launch", "df_magnus_wide_launch")  # kernel B8's two sweeps

T_SPAN = (0.0, 5.0)
MAX_DT = 0.025
AMPS = np.linspace(0.3, 1.0, 5)
SCALE = 0.4

X = np.array([[0, 1], [1, 0]], dtype=complex)
Z = np.array([[1, 0], [0, -1]], dtype=complex)
SM = np.array([[0, 1], [0, 0]], dtype=complex)
H0 = 2 * np.pi * 5.0 * Z / 2
QUBIT = dict(static_hamiltonian=H0, hamiltonian_operators=[2 * np.pi * 0.1 * X / 2],
             static_dissipators=[np.sqrt(0.02) * SM], rotating_frame=np.diag(H0),
             vectorized=True)
RHO0 = np.array([[1.0, 0.0], [0.0, 0.0]], dtype=complex)


@pytest.fixture(scope="module")
def cr_pair():
    return jax_cr_solver(dim=2), cr_solver(dim=2, device="cpu")


def _signals(package_signal, w1, gaussian):
    if gaussian:
        mid = T_SPAN[1] / 2

        def envelope(a, exp):
            return lambda t: a * SCALE * exp(-((t - mid) ** 2))

        exp = np.exp if package_signal is JaxSignal else torch.exp
        return lambda a: [package_signal(envelope(a, exp), carrier_freq=w1)]
    return lambda a: [package_signal(lambda t: a * SCALE, carrier_freq=w1)]


CASES = {
    "uniform": {},
    "adaptive": {"df_grid": "adaptive", "df_grid_tol": 1e-10},
    "t_eval": {"t_eval": [0.0, 1.2345, 3.0, 5.0]},
    "gaussian": {},
    "unitary": {},
}


@pytest.mark.parametrize("case", list(CASES))
def test_df32_matches_jax(cr_pair, case):
    (jsolver, w1), (tsolver, _) = cr_pair
    y0 = np.eye(4, dtype=complex) if case == "unitary" else np.eye(4, dtype=complex)[0]
    kw = dict(t_span=T_SPAN, max_dt=MAX_DT, y0=y0, precision="df32", **CASES[case])
    gaussian = case == "gaussian"
    expected = np.asarray(jax_fused_sweep_solve(
        jsolver.model, _signals(JaxSignal, w1, gaussian), AMPS,
        rwa_signal_map=jsolver._rwa_signal_map, **kw,
    ))
    before = launches(*B8)
    out = tsolver.solve_sweep(_signals(Signal, w1, gaussian), torch.as_tensor(AMPS),
                              method="fused_magnus2", **kw)
    assert launches(*B8) == before  # CPU model: the plain version
    assert out.dtype == torch.complex128 and out.shape == expected.shape
    np.testing.assert_allclose(to_np(out), expected, rtol=0, atol=1e-10)


def test_df32_lindblad_matches_jax():
    kw = dict(t_span=T_SPAN, max_dt=MAX_DT, y0=RHO0, precision="df32", t_eval=[0.0, 2.5, 5.0])
    jsolver = JaxSolver(**QUBIT)
    expected = np.asarray(jax_fused_sweep_solve(
        jsolver.model, lambda a: ([JaxSignal(lambda t: a, carrier_freq=5.0)], None), AMPS, **kw,
    ))
    tsolver = port.Solver(**QUBIT, device="cpu")
    fn = lambda a: ([Signal(lambda t: a, carrier_freq=5.0)], None)  # noqa: E731
    out = tsolver.solve_sweep(fn, torch.as_tensor(AMPS), method="fused_magnus2", **kw)
    assert out.shape == (len(AMPS), 3, 2, 2) and out.dtype == torch.complex128
    np.testing.assert_allclose(to_np(out), expected, rtol=0, atol=1e-10)
    final = tsolver.solve_sweep(fn, torch.as_tensor(AMPS), method="fused_magnus2",
                                **{**kw, "t_eval": None})
    np.testing.assert_allclose(to_np(final), to_np(out[:, -1]), rtol=0, atol=1e-13)


@pytest.mark.parametrize("gaussian", [False, True])
def test_df32_matches_dop853(cr_pair, gaussian):
    (_, w1), (tsolver, _) = cr_pair
    y0 = np.eye(4, dtype=complex)[0]
    fn = _signals(Signal, w1, gaussian)
    out = tsolver.solve_sweep(fn, torch.as_tensor(AMPS[[0, -1]]), t_span=T_SPAN, max_dt=MAX_DT,
                              y0=y0, method="fused_magnus2", precision="df32")
    for i, a in enumerate(AMPS[[0, -1]]):
        ref = tsolver.solve(t_span=list(T_SPAN), y0=y0, signals=fn(torch.tensor(a)),
                            method="DOP853", atol=1e-12, rtol=1e-12)
        assert float(np.max(np.abs(to_np(out[i]) - np.asarray(ref.y[-1])))) <= 1e-8


def test_df_engines_are_one_kernel(cr_pair):
    """``df_engine`` picks one of the JAX package's two engines; here all of
    them run kernel B8 (the plain version on the CPU), to the same bits."""
    (_, w1), (tsolver, _) = cr_pair
    kw = dict(t_span=(0.0, 1.0), max_dt=0.1, y0=np.eye(4, dtype=complex)[0],
              method="fused_magnus2", precision="df32")
    fn, amps = _signals(Signal, w1, False), torch.as_tensor(AMPS)
    base = tsolver.solve_sweep(fn, amps, **kw)
    for engine in ("xla", "pallas"):
        assert torch.equal(tsolver.solve_sweep(fn, amps, df_engine=engine, **kw), base)


@pytest.mark.parametrize(
    "kwargs, error, message",
    [({"df_devices": ["cuda:0"]}, NotImplementedError, "A13"),
     ({"df_grid": "bogus"}, DynamicsError, "unknown df_grid"),
     ({"df_engine": "bogus"}, DynamicsError, "unknown df_engine"),
     ({"df_magnus_order": 4}, DynamicsError, "df_magnus_order"),
     ({"t_eval": [0.5, 3.0]}, DynamicsError, "within t_span"),
     ({"grad": True}, DynamicsError, "no gradient")],
)
def test_df32_validation(cr_pair, kwargs, error, message):
    (_, w1), (tsolver, _) = cr_pair
    kwargs = dict(kwargs)
    amps = torch.tensor([0.1, 0.2], requires_grad=kwargs.pop("grad", False))
    with pytest.raises(error, match=message):
        fused_sweep_solve(
            tsolver.model, lambda a: [Signal(lambda t: a, carrier_freq=w1)], amps, (0.0, 1.0),
            0.5, np.eye(4, dtype=complex)[0], rwa_signal_map=tsolver._rwa_signal_map,
            precision="df32", **kwargs,
        )
