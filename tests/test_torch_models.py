"""Parity of the port's signals, frame, operator collection, models, RWA and
interop with the JAX package.

Inputs are seeded numpy; both sides run in float64/complex128 and agree to
1e-12 relative (the same arithmetic up to summation order). Frame-basis
quantities depend on the eigenvector phases each eigensolver picks, so
full-frame checks compare results returned in the standard basis.
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, random_hermitian, rng, to_np

import qiskit_dynamics_tpu.models as jmodels
import qiskit_dynamics_tpu.signals as jsignals
from qiskit_dynamics_tpu.benchmarks import _transmon_ops, cr_solver as jax_cr_solver

import qiskit_dynamics_tpu_torch.models as tmodels
import qiskit_dynamics_tpu_torch.signals as tsignals
from qiskit_dynamics_tpu_torch import interop
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver as torch_cr_solver
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError

RTOL = 1e-12
TIMES = np.linspace(0.0, 3.0, 7)


# --- signals ---------------------------------------------------------------
def _signal_pair(case: str):
    """The same signal built in both packages (envelopes written per package)."""
    gen = rng(11)
    amp = complex(gen.normal(), gen.normal())
    freq, phase = float(gen.uniform(1.0, 5.0)), float(gen.uniform(-np.pi, np.pi))
    if case == "constant":
        return jsignals.Signal(amp, freq, phase), tsignals.Signal(amp, freq, phase)
    if case == "gaussian":
        return (
            jsignals.Signal(lambda t: amp * np.exp(-((t - 1.5) ** 2)), freq, phase),
            tsignals.Signal(lambda t: amp * torch.exp(-((t - 1.5) ** 2)), freq, phase),
        )
    if case == "real_only":
        return jsignals.Signal(0.7), tsignals.Signal(0.7)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["constant", "gaussian", "real_only"])
@pytest.mark.parametrize("method", ["complex_value", "__call__", "envelope"])
def test_signal_evaluation(case, method):
    jsig, tsig = _signal_pair(case)
    expected = getattr(jsig, method)(TIMES)
    assert_rel_close(getattr(tsig, method)(torch.as_tensor(TIMES)), np.broadcast_to(expected, TIMES.shape), RTOL)


def _sum_pair():
    gen = rng(12)
    amps = gen.normal(size=3) + 1j * gen.normal(size=3)
    freqs, phases = gen.uniform(1.0, 5.0, 3), gen.uniform(-np.pi, np.pi, 3)
    jterms = [jsignals.Signal(amps[0], freqs[0], phases[0]),
              jsignals.Signal(lambda t: amps[1] * np.cos(t), freqs[1], phases[1]),
              jsignals.Signal(amps[2], freqs[2], phases[2])]
    tterms = [tsignals.Signal(amps[0], freqs[0], phases[0]),
              tsignals.Signal(lambda t: amps[1] * torch.cos(t), freqs[1], phases[1]),
              tsignals.Signal(amps[2], freqs[2], phases[2])]
    return jsignals.SignalSum(*jterms), tsignals.SignalSum(*tterms)


@pytest.mark.parametrize("method", ["complex_value", "__call__", "envelope"])
def test_signal_sum_evaluation(method):
    jsum, tsum = _sum_pair()
    assert_rel_close(getattr(tsum, method)(torch.as_tensor(TIMES)), getattr(jsum, method)(TIMES), RTOL)
    assert_rel_close(tsum.carrier_freq, jsum.carrier_freq, RTOL)
    assert_rel_close(tsum.phase, jsum.phase, RTOL)


def test_signal_sum_flatten():
    jsum, tsum = _sum_pair()
    jflat, tflat = jsum.flatten(), tsum.flatten()
    assert_rel_close(tflat.carrier_freq, jflat.carrier_freq, RTOL)
    assert_rel_close(tflat.complex_value(torch.as_tensor(TIMES)), jflat.complex_value(TIMES), RTOL)


@pytest.mark.parametrize("method", ["__call__", "complex_value"])
def test_signal_list(method):
    jsum, tsum = _sum_pair()
    jsig, tsig = _signal_pair("gaussian")
    jlist, tlist = jsignals.SignalList([jsig, jsum]), tsignals.SignalList([tsig, tsum])
    assert len(tlist) == 2
    assert_rel_close(getattr(tlist, method)(torch.as_tensor(TIMES)), getattr(jlist, method)(TIMES), RTOL)
    assert_rel_close(tlist.flatten()(torch.as_tensor(TIMES)), jlist.flatten()(TIMES), RTOL)


def test_signals_vmap_over_parameters():
    """A signal built from a batched parameter evaluates batched under vmap."""
    amps = np.linspace(0.1, 1.0, 5)
    batched = torch.func.vmap(
        lambda a: tsignals.Signal(lambda t: a * torch.exp(-t), 2.0, 0.3).complex_value(
            torch.tensor(0.4, dtype=torch.float64)
        )
    )(torch.as_tensor(amps))
    expected = [jsignals.Signal(lambda t, a=a: a * np.exp(-t), 2.0, 0.3).complex_value(0.4)
                for a in amps]
    assert_rel_close(batched, np.asarray(expected), RTOL)


# --- rotating frame ----------------------------------------------------------
def _frame_pair(kind: str, n: int = 4):
    gen = rng(21)
    if kind == "hermitian":
        op = random_hermitian(gen, n)
    elif kind == "anti_hermitian":
        op = -1j * random_hermitian(gen, n)
    else:  # diagonal
        op = gen.normal(size=n)
    return jmodels.RotatingFrame(op), tmodels.RotatingFrame(op, device="cpu")


@pytest.mark.parametrize("kind", ["hermitian", "anti_hermitian", "diagonal"])
def test_frame_eigenvalues(kind):
    jframe, tframe = _frame_pair(kind)
    jdiag, tdiag = np.asarray(jframe.frame_diag), to_np(tframe.frame_diag)
    assert_rel_close(np.sort(tdiag.imag), np.sort(jdiag.imag), RTOL)


@pytest.mark.parametrize("kind", ["hermitian", "diagonal"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_frame_state_maps(kind, ndim):
    jframe, tframe = _frame_pair(kind)
    gen = rng(22)
    y = gen.normal(size=(4,) * ndim) + 1j * gen.normal(size=(4,) * ndim)
    for t in (0.0, 0.7, -1.3):
        assert_rel_close(tframe.state_into_frame(t, y), jframe.state_into_frame(t, y), RTOL)
        assert_rel_close(tframe.state_out_of_frame(t, y), jframe.state_out_of_frame(t, y), RTOL)


@pytest.mark.parametrize("kind", ["hermitian", "diagonal"])
@pytest.mark.parametrize("method", ["operator_into_frame", "generator_into_frame"])
def test_frame_operator_maps(kind, method):
    jframe, tframe = _frame_pair(kind)
    gen = rng(23)
    ops = gen.normal(size=(2, 4, 4)) + 1j * gen.normal(size=(2, 4, 4))
    for t in (0.0, 0.7):
        assert_rel_close(getattr(tframe, method)(t, ops), getattr(jframe, method)(t, ops), RTOL)


def test_frame_basis_roundtrip():
    _, tframe = _frame_pair("hermitian")
    y = rng(24).normal(size=(4, 3)) + 0j
    back = tframe.state_out_of_frame_basis(tframe.state_into_frame_basis(y))
    assert_rel_close(back, y, RTOL)
    op = rng(25).normal(size=(4, 4)) + 0j
    back = tframe.operator_out_of_frame_basis(tframe.operator_into_frame_basis(op))
    assert_rel_close(back, op, RTOL)


def test_frame_rejects_non_hermitian():
    with pytest.raises(DynamicsError, match="Hermitian"):
        tmodels.RotatingFrame(
            rng(26).normal(size=(3, 3)) + 1j * np.triu(np.ones((3, 3))), device="cpu"
        )


# --- operator collection -----------------------------------------------------
@pytest.mark.parametrize("ydim", [1, 2])
def test_operator_collection(ydim):
    gen = rng(31)
    static = gen.normal(size=(4, 4)) + 1j * gen.normal(size=(4, 4))
    ops = gen.normal(size=(3, 4, 4)) + 1j * gen.normal(size=(3, 4, 4))
    coeffs = gen.normal(size=3)
    y = gen.normal(size=(4,) * ydim) + 1j * gen.normal(size=(4,) * ydim)
    jcoll = jmodels.OperatorCollection(static, ops)
    tcoll = tmodels.OperatorCollection(torch.as_tensor(static), torch.as_tensor(ops))
    assert_rel_close(tcoll(coeffs), jcoll(coeffs), RTOL)
    assert_rel_close(tcoll(coeffs, torch.as_tensor(y)), jcoll(coeffs, y), RTOL)


# --- models ------------------------------------------------------------------
def _model_pair(frame_kind: str, in_frame_basis: bool):
    gen = rng(41)
    h0 = random_hermitian(gen, 4)
    ops = np.stack([random_hermitian(gen, 4) for _ in range(2)])
    frame = {"none": None, "diagonal": np.diag(h0).real, "full": h0}[frame_kind]
    jsig = [jsignals.Signal(0.3, 1.1, 0.2),
            jsignals.Signal(lambda t: 0.5 * np.cos(t), 0.6)]
    tsig = [tsignals.Signal(0.3, 1.1, 0.2),
            tsignals.Signal(lambda t: 0.5 * torch.cos(t), 0.6)]
    jmodel = jmodels.HamiltonianModel(h0, ops, signals=jsig, rotating_frame=frame,
                                      in_frame_basis=in_frame_basis)
    tmodel = tmodels.HamiltonianModel(h0, ops, signals=tsig, rotating_frame=frame,
                                      in_frame_basis=in_frame_basis, device="cpu")
    return jmodel, tmodel


@pytest.mark.parametrize("frame_kind", ["none", "diagonal", "full"])
def test_hamiltonian_model_evaluate(frame_kind):
    jmodel, tmodel = _model_pair(frame_kind, in_frame_basis=False)
    y = rng(42).normal(size=4) + 1j * rng(43).normal(size=4)
    for t in (0.0, 0.9, 2.4):
        assert_rel_close(tmodel(t), jmodel(t), RTOL)
        assert_rel_close(tmodel(t, y), jmodel(t, y), RTOL)
    assert_rel_close(tmodel.static_operator, jmodel.static_operator, RTOL)
    assert_rel_close(tmodel.operators, jmodel.operators, RTOL)


@pytest.mark.parametrize("frame_kind", ["none", "diagonal"])
def test_hamiltonian_model_in_frame_basis(frame_kind):
    jmodel, tmodel = _model_pair(frame_kind, in_frame_basis=True)
    y = rng(44).normal(size=(4, 2)) + 0j
    for t in (0.0, 1.7):
        assert_rel_close(tmodel(t), jmodel(t), RTOL)
        assert_rel_close(tmodel(t, y), jmodel(t, y), RTOL)


def test_hamiltonian_model_validates():
    with pytest.raises(DynamicsError, match="Hermitian"):
        tmodels.HamiltonianModel(static_operator=np.triu(np.ones((3, 3))), device="cpu")
    with pytest.raises(DynamicsError, match="same length"):
        tmodels.HamiltonianModel(np.eye(2), np.stack([np.eye(2)]),
                                 signals=[tsignals.Signal(1.0), tsignals.Signal(2.0)], device="cpu")


# --- RWA -----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cr_pair():
    return jax_cr_solver(dim=2), torch_cr_solver(dim=2, device="cpu")


@pytest.mark.parametrize("in_frame_basis", [False, True])
def test_rwa_operators(cr_pair, in_frame_basis):
    (jsolver, _), (tsolver, _) = cr_pair
    jmodel, tmodel = jsolver.model, tsolver.model
    assert tmodel.operators.shape == (2, 4, 4)
    jmodel.in_frame_basis = tmodel.in_frame_basis = in_frame_basis
    try:
        assert_rel_close(tmodel.operators, jmodel.operators, RTOL)
        assert_rel_close(tmodel.static_operator, jmodel.static_operator, RTOL)
    finally:
        jmodel.in_frame_basis = tmodel.in_frame_basis = False


def test_rwa_signal_map_and_generator(cr_pair):
    (jsolver, w1), (tsolver, _) = cr_pair
    jmapped = jsolver._rwa_signal_map([jsignals.Signal(lambda t: 0.02 * np.exp(-t), w1, 0.4)])
    tmapped = tsolver._rwa_signal_map([tsignals.Signal(lambda t: 0.02 * torch.exp(-t), w1, 0.4)])
    assert len(tmapped) == len(jmapped) == 2
    assert_rel_close(tmapped.complex_value(torch.as_tensor(TIMES)), jmapped.complex_value(TIMES), RTOL)
    jsolver.model.signals, tsolver.model.signals = jmapped, tmapped
    try:
        y = np.eye(4, dtype=complex)[:, 0]
        for t in (0.0, 1.3):
            assert_rel_close(tsolver.model(t), jsolver.model(t), RTOL)
            assert_rel_close(tsolver.model(t, y), jsolver.model(t, y), RTOL)
    finally:
        jsolver.model.signals = tsolver.model.signals = None


def test_rwa_generic_model_matches():
    """RWA of a generic Hamiltonian with a full (non-diagonal) frame."""
    gen = rng(51)
    h0 = np.diag(np.array([0.0, 5.0, 10.3, 15.1]) * 2 * np.pi) + 0.05 * random_hermitian(gen, 4)
    op = random_hermitian(gen, 4)
    jm = jmodels.HamiltonianModel(h0, [op], signals=[jsignals.Signal(1.0, 5.0)], rotating_frame=h0)
    tm = tmodels.HamiltonianModel(h0, [op], signals=[tsignals.Signal(1.0, 5.0)], rotating_frame=h0,
                                device="cpu")
    jr = jmodels.rotating_wave_approximation(jm, 2.0)
    tr = tmodels.rotating_wave_approximation(tm, 2.0)
    assert_rel_close(tr.operators, jr.operators, RTOL)
    assert_rel_close(tr.static_operator, jr.static_operator, RTOL)


# --- interop -------------------------------------------------------------------
def test_interop_model_from_jax_arrays(cr_pair):
    (jsolver, w1), _ = cr_pair
    jmodel = jsolver.model
    tmodel = interop.hamiltonian_model_from_arrays(
        np.asarray(jmodel.static_operator), np.asarray(jmodel.operators),
        rotating_frame=np.asarray(jmodel.rotating_frame.frame_operator),
        in_frame_basis=jmodel.in_frame_basis, device="cpu",
    )
    jmodel.signals = jsolver._rwa_signal_map([jsignals.Signal(0.02, w1)])
    tmodel.signals = [tsignals.Signal(0.02, w1), tsignals.Signal(0.02, w1, -np.pi / 2)]
    try:
        for t in (0.0, 0.8):
            assert_rel_close(tmodel(t), jmodel(t), RTOL)
    finally:
        jmodel.signals = None


def test_interop_solver_from_jax_inputs(cr_pair):
    """The arrays cr_solver builds its JAX Solver from give the same RWA model."""
    (jsolver, w1), _ = cr_pair
    a, adag, N = _transmon_ops(2)
    ident = np.eye(2)
    h0 = (2 * np.pi * 5.0 * np.kron(N, ident) + np.pi * -0.33 * np.kron(N @ (N - ident), ident)
          + 2 * np.pi * w1 * np.kron(ident, N) + np.pi * -0.33 * np.kron(ident, N @ (N - ident))
          + 2 * np.pi * 0.002 * (np.kron(adag, a) + np.kron(a, adag)))
    drive = 2 * np.pi * np.kron(a + adag, ident)
    tsolver = interop.solver_from_arrays(
        h0, [drive], rotating_frame=np.diag(h0), rwa_cutoff_freq=(5.0 + w1) / 2,
        rwa_carrier_freqs=[w1], device="cpu",
    )
    assert_rel_close(tsolver.model.operators, jsolver.model.operators, RTOL)
    assert_rel_close(tsolver.model.static_operator, jsolver.model.static_operator, RTOL)


def test_interop_takes_numpy_only():
    with pytest.raises(TypeError, match="numpy"):
        interop.hamiltonian_model_from_arrays(torch.eye(2), None, device="cpu")
