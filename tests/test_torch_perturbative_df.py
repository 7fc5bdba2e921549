"""Parity of ``DysonSolver``/``MagnusSolver.solve_sweep(precision="df32")``
with the JAX package's double-float32 Dysolve (``ops/df_chain.py``).

The driven two-level system of ``test_torch_perturbative_solvers.py``; the
JAX expansion is carried into the port by ``interop``, so only the stepping
differs. The JAX side samples its coefficients on the host in float64 (the
envelope is written with numpy) and runs every term in double-float32
(``df_order`` above the expansion order); the port runs the same expansion
in float64/complex128 (the plain versions of the chain and the Taylor expm
on the CPU). Tolerance 1e-10: double-float32 against float64 over six steps
is ~1e-14; the Magnus path differs further in its per-step exponential (the
JAX package applies a Taylor-12 action to the state, the port forms the
Taylor-12 propagator with one squaring), ~1e-13.
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close

from qiskit_dynamics_tpu import DysonSolver as JaxDysonSolver
from qiskit_dynamics_tpu import MagnusSolver as JaxMagnusSolver
from qiskit_dynamics_tpu import Signal as JaxSignal

from qiskit_dynamics_tpu_torch import Signal, interop
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError
from qiskit_dynamics_tpu_torch.kernels import launches

X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
NU = 5.0
G0 = -1j * 2 * np.pi * NU * Z / 2
G1 = -1j * 2 * np.pi * X / 2
DT, N_STEPS, T0 = 0.025, 6, 0.05
AMPS = np.array([0.2, 0.3, 0.4, 0.5, 0.6])
Y0 = np.array([1.0, 0.0], dtype=complex)
CONFIG = dict(
    operators=[G1], rotating_frame=G0, dt=DT, carrier_freqs=[NU], chebyshev_orders=[1],
    atol=1e-13, rtol=1e-13,
)
ORDERS = {"dyson": 3, "magnus": 2}


def jax_signals(amp):
    return [JaxSignal(lambda t: amp * np.exp(-((t - 0.125) ** 2) / 0.02), carrier_freq=NU)]


def port_signals(amp):
    return [Signal(lambda t: amp * torch.exp(-((t - 0.125) ** 2) / 0.02), carrier_freq=NU)]


@pytest.fixture(scope="module", params=["dyson", "magnus"])
def solvers(request):
    """The JAX solver and the port's solver around the same expansion."""
    method = request.param
    cls = JaxDysonSolver if method == "dyson" else JaxMagnusSolver
    jax_solver = cls(expansion_order=ORDERS[method], **CONFIG)
    model = jax_solver.model
    poly = model.expansion_polynomial
    solver = interop.perturbative_solver_from_arrays(
        operators=np.asarray(model.operators),
        frame_operator=np.asarray(model.rotating_frame.frame_operator),
        dt=model.dt, carrier_freqs=np.asarray(CONFIG["carrier_freqs"]),
        chebyshev_orders=CONFIG["chebyshev_orders"], include_imag=[True],
        Udt=np.asarray(model.Udt), expansion_method=method,
        poly_constant=None if poly.constant_term is None else np.asarray(poly.constant_term),
        poly_coefficients=np.asarray(poly.array_coefficients),
        poly_labels=poly.monomial_labels, device="cpu",
    )
    return jax_solver, solver


def test_df32_matches_jax(solvers):
    jax_solver, solver = solvers
    want = np.asarray(jax_solver.solve_sweep(T0, N_STEPS, Y0, jax_signals, AMPS,
                                             precision="df32", df_order=8))
    before = (launches("chain_apply_launch"), launches("expm_bol_launch"))
    got = solver.solve_sweep(T0, N_STEPS, Y0, port_signals, torch.as_tensor(AMPS),
                             precision="df32", df_chunk_b=2)
    assert (launches("chain_apply_launch"), launches("expm_bol_launch")) == before  # CPU: plain
    assert got.shape == (len(AMPS), 2) and got.dtype == torch.complex128
    assert_rel_close(got, want, 1e-10)


def test_df32_chunks_and_keywords(solvers):
    """Chunking the members changes nothing but the pass count; ``df_order``
    is a no-op; the f32 path of a complex128 model on the CPU runs the same
    arithmetic."""
    _, solver = solvers
    amps = torch.as_tensor(AMPS)
    base = solver.solve_sweep(T0, N_STEPS, Y0, port_signals, amps, precision="df32")
    for kwargs in ({"df_chunk_b": 1}, {"df_chunk_b": 3}, {"df_order": 0}):
        out = solver.solve_sweep(T0, N_STEPS, Y0, port_signals, amps, precision="df32", **kwargs)
        assert_rel_close(out, base, 1e-14)
    assert_rel_close(solver.solve_sweep(T0, N_STEPS, Y0, port_signals, amps), base, 1e-14)


@pytest.mark.parametrize(
    "kwargs, error, message",
    [({"df_devices": ["cuda:0"]}, NotImplementedError, "A13"),
     ({"df_chunk_b": 0}, DynamicsError, "df_chunk_b"),
     ({"grad": True}, DynamicsError, "no gradient")],
)
def test_df32_raises(solvers, kwargs, error, message):
    _, solver = solvers
    kwargs = dict(kwargs)
    amps = torch.tensor(AMPS, requires_grad=kwargs.pop("grad", False))
    with pytest.raises(error, match=message):
        solver.solve_sweep(T0, N_STEPS, Y0, port_signals, amps, precision="df32", **kwargs)
