"""Parity of the port's perturbative solvers with the JAX package: the slice
as a whole.

``ExpansionModel``, ``DysonSolver`` and ``MagnusSolver`` (``solve`` by both
routes, ``solve_sweep`` and its gradient) on a driven two-level system. The
JAX side runs on the CPU with x64 and its Pallas kernels in interpret mode;
the port runs its plain versions on the CPU.

Two kinds of comparison:

- the two precomputes against each other (both DOP853 at 1e-13): polynomial
  coefficients within 1e-9;
- the stepping, with the SAME precomputed expansion carried across by
  ``interop`` (or by the ``.npz`` checkpoint), so that only the stepping
  differs: complex128 within 1e-10, complex64 within 1e-5 (float32 roundoff
  over a few steps), the gradient of ``sum(|y[:, 1]|^2)`` with respect to the
  amplitudes within 1e-6 relative of ``jax.grad``.

The JAX reference states are passed as arguments, never closed over.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, to_np

from qiskit_dynamics_tpu import DysonSolver as JaxDysonSolver
from qiskit_dynamics_tpu import MagnusSolver as JaxMagnusSolver
from qiskit_dynamics_tpu import Signal as JaxSignal
from qiskit_dynamics_tpu.solvers import ExpansionModel as JaxExpansionModel

import qiskit_dynamics_tpu_torch as port
from qiskit_dynamics_tpu_torch import DysonSolver, ExpansionModel, MagnusSolver, Signal, interop
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError

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
    return [JaxSignal(lambda t: amp * jnp.exp(-((t - 0.125) ** 2) / 0.02), carrier_freq=NU)]


def port_signals(amp):
    return [Signal(lambda t: amp * torch.exp(-((t - 0.125) ** 2) / 0.02), carrier_freq=NU)]


@pytest.fixture(scope="module", params=["dyson", "magnus"])
def solvers(request):
    """The JAX solver and the port's solvers around the same expansion, in
    complex128 and complex64."""
    method = request.param
    cls = JaxDysonSolver if method == "dyson" else JaxMagnusSolver
    jax_solver = cls(expansion_order=ORDERS[method], **CONFIG)
    model = jax_solver.model
    poly = model.expansion_polynomial
    arrays = dict(
        operators=np.asarray(model.operators),
        frame_operator=np.asarray(model.rotating_frame.frame_operator),
        dt=model.dt, carrier_freqs=np.asarray(CONFIG["carrier_freqs"]),
        chebyshev_orders=CONFIG["chebyshev_orders"], include_imag=[True],
        Udt=np.asarray(model.Udt), expansion_method=method,
        poly_constant=None if poly.constant_term is None else np.asarray(poly.constant_term),
        poly_coefficients=np.asarray(poly.array_coefficients),
        poly_labels=poly.monomial_labels,
    )
    carried = {
        dtype: interop.perturbative_solver_from_arrays(**arrays, device="cpu", dtype=dtype)
        for dtype in (torch.complex128, torch.complex64)
    }
    return method, jax_solver, carried


# --------------------------------------------------------------------------
# the expansion model
# --------------------------------------------------------------------------
def test_precompute_matches_jax(solvers):
    method, jax_solver, carried = solvers
    cls = DysonSolver if method == "dyson" else MagnusSolver
    ours = cls(expansion_order=ORDERS[method], device="cpu", **CONFIG)
    assert isinstance(ours, type(carried[torch.complex128]))
    want = jax_solver.model.expansion_polynomial
    got = ours.model.expansion_polynomial
    assert got.monomial_labels == want.monomial_labels
    assert_rel_close(got.array_coefficients, to_np(want.array_coefficients), 1e-9)
    assert (got.constant_term is None) == (want.constant_term is None)
    if got.constant_term is not None:
        assert_rel_close(got.constant_term, to_np(want.constant_term), 1e-12)
    assert_rel_close(ours.model.Udt, to_np(jax_solver.model.Udt), 1e-12)
    assert ours.model.expansion_method == method and ours.model.dt == DT
    assert ours.model.device.type == "cpu"


def test_approximate_signals_and_evaluate_match_jax(solvers):
    _, jax_solver, carried = solvers
    model = carried[torch.complex128].model
    for t0, n_steps in ((0.0, 4), (T0, N_STEPS), (87.3, 3)):
        want = to_np(jax_solver.model.approximate_signals(jax_signals(0.35), t0, n_steps))
        got = model.approximate_signals(port_signals(0.35), t0, n_steps)
        assert got.dtype == torch.float64 and got.shape == want.shape
        assert_rel_close(got, want, 1e-10)
    coeffs = want[:, 0]
    value = to_np(jax_solver.model.evaluate(coeffs))
    assert isinstance(model.evaluate(coeffs), np.ndarray)
    assert_rel_close(model.evaluate(coeffs), value, 1e-10)
    assert_rel_close(model.evaluate(torch.as_tensor(coeffs)), value, 1e-10)
    assert_rel_close(model.evaluate(torch.as_tensor(want))[..., 0], value, 1e-10)


def test_constant_signal_coefficients_match_jax(solvers):
    _, jax_solver, carried = solvers
    want = to_np(jax_solver.model.approximate_signals([JaxSignal(0.7, NU, phase=0.3)], T0, 3))
    got = carried[torch.complex128].model.approximate_signals(
        [Signal(0.7, NU, phase=0.3)], T0, 3)
    assert_rel_close(got, want, 1e-10)


def test_checkpoint_round_trip_both_ways(solvers, tmp_path):
    _, jax_solver, carried = solvers
    coeffs = np.array([0.3, -0.2, 0.1, 0.05])
    value = to_np(jax_solver.model.evaluate(coeffs))
    jax_solver.model.save(str(tmp_path / "from_jax"))
    loaded = ExpansionModel.load(str(tmp_path / "from_jax"), device="cpu")
    assert loaded.expansion_method == jax_solver.model.expansion_method
    assert_rel_close(loaded.evaluate(coeffs), value, 1e-14)
    assert_rel_close(loaded.Udt, to_np(jax_solver.model.Udt), 0.0)
    carried[torch.complex128].model.save(str(tmp_path / "from_port.npz"))
    back = JaxExpansionModel.load(str(tmp_path / "from_port.npz"))
    assert_rel_close(to_np(back.evaluate(coeffs)), value, 1e-14)
    assert back.expansion_polynomial.monomial_labels == loaded.expansion_polynomial.monomial_labels


# --------------------------------------------------------------------------
# solve: the host loop and the batched route
# --------------------------------------------------------------------------
def test_solve_both_routes_match_jax(solvers):
    _, jax_solver, carried = solvers
    y0 = np.eye(2, dtype=complex)
    want = to_np(jax_solver.solve(T0, N_STEPS, y0, jax_signals(0.4), jax_control_flow=False).y[-1])
    want_jax = to_np(jax_solver.solve(T0, N_STEPS, jnp.asarray(y0), jax_signals(0.4)).y[-1])
    solver = carried[torch.complex128]
    host = solver.solve(T0, N_STEPS, y0, port_signals(0.4))
    assert isinstance(host.y[-1], np.ndarray)
    assert host.t == [T0, T0 + N_STEPS * DT]
    assert_rel_close(host.y[-1], want, 1e-10)
    batched = solver.solve(T0, N_STEPS, torch.as_tensor(y0), port_signals(0.4))
    assert isinstance(batched.y[-1], torch.Tensor) and batched.y[-1].dtype == torch.complex128
    assert_rel_close(batched.y[-1], want_jax, 1e-10)
    forced = solver.solve(T0, N_STEPS, y0, port_signals(0.4), jax_control_flow=True)
    assert_rel_close(forced.y[-1], want_jax, 1e-10)
    single = carried[torch.complex64].solve(
        T0, N_STEPS, y0, port_signals(0.4), jax_control_flow=True)
    assert single.y[-1].dtype == torch.complex64
    assert_rel_close(single.y[-1], want_jax, 1e-5)


def test_solve_list_broadcasting_and_validation(solvers):
    _, jax_solver, carried = solvers
    solver = carried[torch.complex128]
    y0 = np.eye(2, dtype=complex)
    results = solver.solve(
        [0.0, T0], 4, y0, [port_signals(0.3), port_signals(0.5)])
    assert isinstance(results, list) and len(results) == 2
    want = jax_solver.solve([0.0, T0], 4, y0, [jax_signals(0.3), jax_signals(0.5)],
                            jax_control_flow=False)
    for got, ref in zip(results, want):
        assert_rel_close(got.y[-1], to_np(ref.y[-1]), 1e-10)
    with pytest.raises(DynamicsError, match="same length as the operators"):
        solver.solve(0.0, 4, y0, [Signal(1.0, NU), Signal(1.0, NU)])
    with pytest.raises(DynamicsError, match="incompatible"):
        solver.solve([0.0, 0.1, 0.2], [4, 4], y0, port_signals(0.3))
    with pytest.raises(DynamicsError, match="0d or 1d"):
        solver.solve(np.zeros((2, 2)), 4, y0, port_signals(0.3))


# --------------------------------------------------------------------------
# solve_sweep and its gradient
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_sweep(solvers):
    """The JAX sweep (Pallas kernels in interpret mode) and the gradient of
    ``sum(|y[:, 1]|^2)`` with respect to the amplitudes."""
    _, jax_solver, _ = solvers

    def loss(amps, y0):
        out = jax_solver.solve_sweep(T0, N_STEPS, y0, jax_signals, amps, tile_b=8,
                                     interpret=True)
        return jnp.sum(jnp.abs(out[:, 1]) ** 2), out

    (_, out), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(AMPS), jnp.asarray(Y0))
    return to_np(out), to_np(grad)


@pytest.mark.parametrize("dtype, tol", [(torch.complex128, 1e-10), (torch.complex64, 1e-5)])
def test_solve_sweep_matches_jax(solvers, jax_sweep, dtype, tol):
    _, _, carried = solvers
    out = carried[dtype].solve_sweep(T0, N_STEPS, Y0, port_signals, AMPS)
    assert out.shape == (len(AMPS), 2) and out.dtype == dtype
    assert_rel_close(out, jax_sweep[0], tol)
    # a sweep member is the host-loop solve of that member
    member = carried[torch.complex128].solve(T0, N_STEPS, Y0, port_signals(AMPS[2])).y[-1]
    assert_rel_close(out[2], member, max(tol, 1e-9))


def test_solve_sweep_gradient_matches_jax(solvers, jax_sweep):
    _, _, carried = solvers
    amps = torch.as_tensor(AMPS).requires_grad_(True)
    out = carried[torch.complex128].solve_sweep(T0, N_STEPS, Y0, port_signals, amps)
    (grad,) = torch.autograd.grad((out[:, 1].abs() ** 2).sum(), amps)
    assert_rel_close(grad, jax_sweep[1], 1e-6 * float(np.max(np.abs(jax_sweep[1]))))
    # and in float32, looser: the bar of the card run
    amps32 = torch.as_tensor(AMPS).requires_grad_(True)
    out32 = carried[torch.complex64].solve_sweep(T0, N_STEPS, Y0, port_signals, amps32)
    (grad32,) = torch.autograd.grad((out32[:, 1].abs() ** 2).sum(), amps32)
    assert float((grad32 - grad).abs().max() / grad.abs().max()) <= 1e-4


def test_solve_sweep_tree_params(solvers):
    """Parameters may be a tree of batched leaves; tensors on the device and
    numpy arrays both work."""
    _, _, carried = solvers
    solver = carried[torch.complex128]

    def signals_fn(p):
        return [Signal(lambda t: p["amp"] * torch.exp(-((t - p["mid"]) ** 2) / 0.02),
                       carrier_freq=NU)]

    params = {"amp": AMPS, "mid": torch.full((len(AMPS),), 0.125, dtype=torch.float64)}
    out = solver.solve_sweep(T0, N_STEPS, Y0, signals_fn, params)
    assert_rel_close(out, solver.solve_sweep(T0, N_STEPS, Y0, port_signals, AMPS), 1e-14)


def test_solve_sweep_raises_for_what_waits(solvers):
    _, _, carried = solvers
    solver = carried[torch.complex128]
    args = (T0, N_STEPS, Y0, port_signals, AMPS)
    with pytest.raises(NotImplementedError, match="A13"):
        solver.solve_sweep(*args, precision="df32", df_devices=["cuda:0"])
    with pytest.raises(NotImplementedError, match="A13"):
        solver.solve_sweep(*args, mesh=object())
    with pytest.raises(DynamicsError, match="Unknown precision"):
        solver.solve_sweep(*args, precision="f16")
    with pytest.raises(ValueError, match="at least one propagator"):
        solver.solve_sweep(T0, 0, Y0, port_signals, AMPS)


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------
def test_expansion_model_validation():
    base = dict(CONFIG, expansion_order=1, device="cpu")
    with pytest.raises(DynamicsError, match="'dyson' or 'magnus'"):
        ExpansionModel(expansion_method="taylor", **base)
    with pytest.raises(DynamicsError, match="carrier_freqs"):
        ExpansionModel(**dict(base, carrier_freqs=[NU, NU]))
    with pytest.raises(DynamicsError, match="chebyshev_orders"):
        ExpansionModel(**dict(base, chebyshev_orders=[1, 1]))
    with pytest.raises(DynamicsError, match="A12"):
        DysonSolver(integration_method="jax_odeint", **base)
    with pytest.raises(TypeError, match="numpy array"):
        interop.expansion_model_from_arrays(
            [G1], G0, DT, np.array([NU]), [1], [True], torch.eye(2), "dyson", None,
            np.zeros((1, 2, 2)), [(0,)], device="cpu")


def test_include_imag_and_two_operators_match_jax():
    """Two operators, one with a real envelope only (``include_imag=False``),
    a 0-carrier channel, and a diagonal frame given as a 1-d array."""
    config = dict(
        operators=[G1, -1j * 2 * np.pi * 0.1 * Z / 2], rotating_frame=np.diag(G0), dt=DT,
        carrier_freqs=[NU, 0.0], chebyshev_orders=[1, 0], include_imag=[True, False],
        expansion_order=2, atol=1e-13, rtol=1e-13,
    )
    jax_solver = JaxDysonSolver(**config)
    ours = DysonSolver(device="cpu", **config)
    want = jax_solver.model.expansion_polynomial
    got = ours.model.expansion_polynomial
    assert got.monomial_labels == want.monomial_labels
    assert_rel_close(got.array_coefficients, to_np(want.array_coefficients), 1e-9)
    sigs = lambda S, exp: [S(lambda t: 0.4 * exp(-((t - 0.1) ** 2) / 0.02), carrier_freq=NU),
                           S(0.8, 0.0)]
    ref = jax_solver.solve(0.0, 5, np.eye(2, dtype=complex), sigs(JaxSignal, jnp.exp),
                           jax_control_flow=False)
    out = ours.solve(0.0, 5, np.eye(2, dtype=complex), sigs(Signal, torch.exp))
    assert_rel_close(out.y[-1], to_np(ref.y[-1]), 1e-9)


def test_exports():
    for name in ("DysonSolver", "MagnusSolver", "ExpansionModel", "solve_lmde_perturbation",
                 "ArrayPolynomial"):
        assert hasattr(port, name)
    assert port.solvers.DysonSolver is DysonSolver
    assert port.solvers.ExpansionModel is ExpansionModel
