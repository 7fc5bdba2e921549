"""Parity of the port's vectorized Lindblad stack with the JAX package.

- ``vec_commutator``/``vec_dissipator``, ``VectorizedLindbladCollection``,
  the vectorized frame maps and ``LindbladModel``: 1e-12 relative (the same
  float64 arithmetic up to summation order). Full-frame quantities depend on
  the eigenvector phases each eigensolver picks, so they are compared where
  results come back in the standard basis.
- The fused Lindblad sweep (float32, as the kernel) against the JAX XLA
  engine in float64: 5e-6 (measured 1e-6 at T = 20, 1,000 steps).
- The Lindblad DOP853 solve against the JAX DOP853: 1e-8 (both scipy DOP853
  on float64 right-hand sides that agree to rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, random_hermitian, rng, to_np

import qiskit_dynamics_tpu as jpkg
import qiskit_dynamics_tpu.models as jmodels
from qiskit_dynamics_tpu.models.model_utils import vec_commutator as jax_vec_commutator
from qiskit_dynamics_tpu.models.model_utils import vec_dissipator as jax_vec_dissipator
from qiskit_dynamics_tpu.solvers import fused_sweep_solve as jax_fused_sweep_solve

import qiskit_dynamics_tpu_torch as port
import qiskit_dynamics_tpu_torch.models as tmodels
from qiskit_dynamics_tpu_torch import interop
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError
from qiskit_dynamics_tpu_torch.models.model_utils import vec_commutator, vec_dissipator

RTOL = 1e-12
N = 3
X = np.array([[0, 1], [1, 0]], dtype=complex)
Z = np.array([[1, 0], [0, -1]], dtype=complex)
SM = np.array([[0, 1], [0, 0]], dtype=complex)
H0 = 2 * np.pi * 5.0 * Z / 2
HD = 2 * np.pi * 0.1 * X / 2
QUBIT = dict(static_hamiltonian=H0, hamiltonian_operators=[HD],
             static_dissipators=[np.sqrt(0.02) * SM], rotating_frame=np.diag(H0))
RHO0 = np.array([[1.0, 0.0], [0.0, 0.0]], dtype=complex)


def _ops(seed, k=2, n=N):
    gen = rng(seed)
    return gen.normal(size=(k, n, n)) + 1j * gen.normal(size=(k, n, n))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", ["vec_commutator", "vec_dissipator"])
def test_vectorization_maps(name, batched):
    ops = _ops(1)
    ops = ops if batched else ops[0]
    jax_fn = {"vec_commutator": jax_vec_commutator, "vec_dissipator": jax_vec_dissipator}[name]
    port_fn = {"vec_commutator": vec_commutator, "vec_dissipator": vec_dissipator}[name]
    assert_rel_close(port_fn(torch.as_tensor(ops)), np.asarray(jax_fn(ops)), RTOL)


def test_vectorized_collection():
    gen = rng(2)
    groups = dict(static_hamiltonian=random_hermitian(gen, N),
                  hamiltonian_operators=np.stack([random_hermitian(gen, N) for _ in range(2)]),
                  static_dissipators=_ops(3, k=1), dissipator_operators=_ops(4, k=2))
    jcoll = jmodels.VectorizedLindbladCollection(**groups)
    tcoll = tmodels.VectorizedLindbladCollection(
        **{key: torch.as_tensor(val) for key, val in groups.items()}
    )
    ham, dis = gen.normal(size=2), gen.normal(size=2)
    y = gen.normal(size=N * N) + 1j * gen.normal(size=N * N)
    assert_rel_close(tcoll.evaluate(ham, dis), np.asarray(jcoll.evaluate(ham, dis)), RTOL)
    assert_rel_close(tcoll.evaluate_rhs(ham, dis, torch.as_tensor(y)),
                     np.asarray(jcoll.evaluate_rhs(ham, dis, y)), RTOL)
    assert_rel_close(tcoll.evaluate_hamiltonian(ham), np.asarray(jcoll.evaluate_hamiltonian(ham)),
                     RTOL)


def _frame_pair(kind):
    gen = rng(5)
    op = random_hermitian(gen, N) if kind == "full" else gen.normal(size=N)
    return jmodels.RotatingFrame(op), tmodels.RotatingFrame(op, device="cpu")


@pytest.mark.parametrize("kind", ["diagonal", "full"])
def test_vectorized_frame_maps(kind):
    jframe, tframe = _frame_pair(kind)
    gen = rng(6)
    sup = gen.normal(size=(N * N, N * N)) + 1j * gen.normal(size=(N * N, N * N))
    vecs = gen.normal(size=(N * N, 2)) + 1j * gen.normal(size=(N * N, 2))
    for t in (0.0, 0.7):
        assert_rel_close(tframe.vectorized_map_into_frame(t, sup),
                         np.asarray(jframe.vectorized_map_into_frame(t, sup)), RTOL)
        for method in ("operator_into_frame", "operator_out_of_frame"):
            for y in (vecs, vecs[:, 0]):
                assert_rel_close(
                    getattr(tframe, method)(t, y, vectorized_operators=True),
                    np.asarray(getattr(jframe, method)(t, y, vectorized_operators=True)), RTOL,
                )
    # the vectorized basis change round-trips
    if kind == "full":
        vecs = torch.as_tensor(vecs)
        back = tframe.vectorized_frame_basis @ (tframe.vectorized_frame_basis_adjoint @ vecs)
        assert_rel_close(back, vecs, RTOL)


def _model_pair(frame_kind, in_frame_basis):
    gen = rng(7)
    h0 = random_hermitian(gen, N)
    groups = dict(static_hamiltonian=h0,
                  hamiltonian_operators=np.stack([random_hermitian(gen, N) for _ in range(2)]),
                  static_dissipators=_ops(8, k=1), dissipator_operators=_ops(9, k=1),
                  rotating_frame={"none": None, "diagonal": np.diag(h0).real, "full": h0}[frame_kind],
                  in_frame_basis=in_frame_basis, vectorized=True)
    jsig = ([jpkg.Signal(0.3, 1.1), jpkg.Signal(lambda t: 0.5 * np.cos(t), 0.6)],
            [jpkg.Signal(0.2)])
    tsig = ([port.Signal(0.3, 1.1), port.Signal(lambda t: 0.5 * torch.cos(t), 0.6)],
            [port.Signal(0.2)])
    jmodel, jmodel_dense = (
        jmodels.LindbladModel(**{**groups, "vectorized": vectorized},
                              hamiltonian_signals=jsig[0], dissipator_signals=jsig[1])
        for vectorized in (True, False)
    )
    tmodel = tmodels.LindbladModel(**groups, hamiltonian_signals=tsig[0],
                                   dissipator_signals=tsig[1], device="cpu")
    return jmodel, jmodel_dense, tmodel


@pytest.mark.parametrize(
    "frame_kind, in_frame_basis",
    [("none", False), ("diagonal", False), ("diagonal", True), ("full", False)],
)
def test_lindblad_model(frame_kind, in_frame_basis):
    jmodel, jmodel_dense, tmodel = _model_pair(frame_kind, in_frame_basis)
    assert tmodel.dim == jmodel.dim == N
    gen = rng(10)
    y = gen.normal(size=N * N) + 1j * gen.normal(size=N * N)
    for t in (0.0, 0.9):
        assert_rel_close(tmodel.evaluate(t), np.asarray(jmodel.evaluate(t)), RTOL)
        assert_rel_close(tmodel.evaluate_rhs(t, y), np.asarray(jmodel.evaluate_rhs(t, y)), RTOL)
        # the JAX vectorized model's evaluate_hamiltonian raises with a frame
        # (it maps the (n, n) Hamiltonian as a vectorized operator); its
        # non-vectorized model gives the reference
        assert_rel_close(tmodel.evaluate_hamiltonian(t),
                         np.asarray(jmodel_dense.evaluate_hamiltonian(t)), RTOL)
    for name in ("static_hamiltonian", "hamiltonian_operators", "static_dissipators",
                 "dissipator_operators"):
        if frame_kind != "full" or not in_frame_basis:
            assert_rel_close(getattr(tmodel, name), np.asarray(getattr(jmodel, name)), RTOL)


def test_lindblad_model_errors():
    with pytest.raises(NotImplementedError, match="A12"):
        tmodels.LindbladModel(static_hamiltonian=H0, static_dissipators=[SM], device="cpu")
    with pytest.raises(DynamicsError, match="at least one operator group"):
        tmodels.LindbladModel(vectorized=True, device="cpu")
    with pytest.raises(DynamicsError, match="Hermitian"):
        tmodels.LindbladModel(static_hamiltonian=SM, vectorized=True, device="cpu")
    model = tmodels.LindbladModel(static_hamiltonian=H0, hamiltonian_operators=[HD],
                                  vectorized=True, device="cpu")
    with pytest.raises(DynamicsError, match="same length"):
        model.signals = ([port.Signal(1.0), port.Signal(2.0)], None)
    with pytest.raises(DynamicsError, match="without hamiltonian signals"):
        model.evaluate(0.0)


def test_interop_lindblad_model():
    jmodel = jmodels.LindbladModel(**QUBIT, vectorized=True)
    tmodel = interop.lindblad_model_from_arrays(
        np.asarray(jmodel.static_hamiltonian), np.asarray(jmodel.hamiltonian_operators),
        static_dissipators=np.asarray(jmodel.static_dissipators),
        rotating_frame=np.asarray(jmodel.rotating_frame.frame_operator), device="cpu",
    )
    jmodel.signals = ([jpkg.Signal(0.4, 5.0)], None)
    tmodel.signals = ([port.Signal(0.4, 5.0)], None)
    for t in (0.0, 0.3):
        assert_rel_close(tmodel.evaluate(t), np.asarray(jmodel.evaluate(t)), RTOL)
    tsolver = interop.solver_from_arrays(
        H0, [HD], rotating_frame=np.diag(H0), static_dissipators=[np.sqrt(0.02) * SM],
        vectorized=True, device="cpu",
    )
    assert isinstance(tsolver.model, tmodels.LindbladModel)
    assert_rel_close(tsolver.model.static_dissipators, np.sqrt(0.02) * SM[None], RTOL)


# --- the Lindblad sweep --------------------------------------------------------
T_SWEEP, MAX_DT = 2.0, 0.02
AMPS = np.array([0.2, 0.6, 1.0])


@pytest.fixture(scope="module")
def jax_sweep():
    model = jmodels.LindbladModel(**QUBIT, vectorized=True)
    return jax_fused_sweep_solve(
        model, lambda a: ([jpkg.Signal(lambda t: a, carrier_freq=5.0)], None), jnp.asarray(AMPS),
        t_span=(0.0, T_SWEEP), max_dt=MAX_DT, y0=RHO0, sweep_engine="xla", t_eval=[0.0, 1.0, 2.0],
    )


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_lindblad_sweep_matches_jax(jax_sweep, engine):
    solver = port.Solver(**QUBIT, vectorized=True, device="cpu")
    kw = dict(t_span=(0.0, T_SWEEP), max_dt=MAX_DT, y0=RHO0, method="fused_magnus2",
              sweep_engine=engine)
    fn = lambda a: ([port.Signal(lambda t: a, carrier_freq=5.0)], None)  # noqa: E731
    traj = solver.solve_sweep(fn, torch.as_tensor(AMPS), t_eval=[0.0, 1.0, 2.0], **kw)
    final = solver.solve_sweep(fn, torch.as_tensor(AMPS), **kw)
    assert traj.shape == (3, 3, 2, 2) and final.shape == (3, 2, 2)
    np.testing.assert_allclose(to_np(traj), np.asarray(jax_sweep), rtol=0, atol=5e-6)
    np.testing.assert_array_equal(to_np(traj[:, 0]), np.broadcast_to(RHO0, (3, 2, 2)))
    np.testing.assert_allclose(to_np(final), to_np(traj[:, -1]), rtol=0, atol=1e-12)


def test_lindblad_dop853_matches_jax():
    jsolver = jpkg.Solver(**QUBIT, vectorized=True)
    tsolver = port.Solver(**QUBIT, vectorized=True, device="cpu")
    kw = dict(t_span=[0.0, 1.0], method="DOP853", atol=1e-10, rtol=1e-10, t_eval=[0.5, 1.0])
    jres = jsolver.solve(y0=RHO0.ravel(order="F"), signals=[jpkg.Signal(0.7, 5.0)], **kw)
    tres = tsolver.solve(y0=RHO0, signals=[port.Signal(0.7, 5.0)], **kw)
    expected = np.swapaxes(np.asarray(jres.y).reshape(-1, 2, 2), 1, 2)  # column-stacked
    assert tres.y.shape == (2, 2, 2)
    np.testing.assert_allclose(tres.y, expected, rtol=0, atol=1e-8)
    vec = tsolver.solve(y0=RHO0.ravel(order="F"), signals=[port.Signal(0.7, 5.0)], **kw)
    np.testing.assert_allclose(vec.y, np.asarray(jres.y), rtol=0, atol=1e-8)


def test_solver_lindblad_rwa_raises():
    with pytest.raises(NotImplementedError, match="A7"):
        port.Solver(**QUBIT, vectorized=True, rwa_cutoff_freq=1.0, device="cpu")
