"""Parity of the port's ``solve_ode``/``solve_lmde`` method table with the JAX
package: the fixed-step, Lanczos, parallel and adaptive methods, through
``Solver.solve`` and through the functional interface, on the CPU in
complex128.

Models: the Rabi model (BASELINE config 1, dim 2), the cross-resonance model
at 2 levels per transmon (dim 4, frame diag(H0), RWA), a function-based dim-4
Hamiltonian and a vectorized Lindblad qubit.

Tolerances and their reasons:

- Fixed-step methods, the Lanczos methods, the parallel methods and both
  expm methods: 1e-10. The same step rules in float64 on both sides; only
  the order of sums differs. ``expm_method="pade"`` is the port's
  :func:`~qiskit_dynamics_tpu_torch.ops.expm.expm_pade`, the algorithm of
  the JAX package's ``jax.scipy.linalg.expm`` (the same degree and
  squarings for every matrix), so it is held like the others.
- ``tpu_dopri5``/``tpu_dop853``: the same number of right-hand-side
  evaluations (the same accepted and rejected steps) and states within 1e-10.
- The perturbative precompute through a device method against the JAX
  package's precompute through the same method: 1e-10.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, random_hermitian, rng, to_np

from qiskit_dynamics_tpu import Signal as JaxSignal
from qiskit_dynamics_tpu import Solver as JaxSolver
from qiskit_dynamics_tpu import solve_lmde as jax_solve_lmde
from qiskit_dynamics_tpu import solve_ode as jax_solve_ode
from qiskit_dynamics_tpu.benchmarks import cr_solver as jax_cr_solver
from qiskit_dynamics_tpu.benchmarks import rabi_solver as jax_rabi_solver
from qiskit_dynamics_tpu.perturbation import solve_lmde_perturbation as jax_solve_perturbation
from qiskit_dynamics_tpu.solvers.lanczos import jax_lanczos_expm as jax_jax_lanczos_expm
from qiskit_dynamics_tpu.solvers.solver_utils import merge_t_args_jax as jax_merge_t_args_jax

from qiskit_dynamics_tpu_torch import Signal, Solver, solve_lmde, solve_ode
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver, rabi_solver
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError
from qiskit_dynamics_tpu_torch.perturbation import solve_lmde_perturbation
from qiskit_dynamics_tpu_torch.solvers.lanczos import jax_lanczos_expm, lanczos_expm
from qiskit_dynamics_tpu_torch.solvers.solver_utils import (
    is_lindblad_model_not_vectorized,
    is_lindblad_model_vectorized,
    merge_t_args_jax,
)
from qiskit_dynamics_tpu_torch.utils import disable_metrics, enable_metrics, solve_metrics

TOL = 1e-10
PADE_TOL = 1e-10
T_EVAL = np.linspace(0.0, 1.0, 5)

# (method, keywords, tolerance): every method of the table, on both models
METHODS = [
    ("jax_expm", dict(max_dt=0.01, magnus_order=1), PADE_TOL),
    ("jax_expm", dict(max_dt=0.01, magnus_order=2, expm_method="taylor"), TOL),
    ("jax_expm", dict(max_dt=0.01, magnus_order=3, expm_method="taylor"), TOL),
    ("jax_expm", dict(max_dt=0.01, magnus_order=3), PADE_TOL),
    ("jax_RK4", dict(max_dt=0.01), TOL),
    ("RK4", dict(max_dt=0.01), TOL),
    ("scipy_expm", dict(max_dt=0.01, magnus_order=2), TOL),
    ("lanczos_diag", dict(max_dt=0.01, k_dim=2), TOL),
    ("jax_lanczos_diag", dict(max_dt=0.01, k_dim=2), TOL),
    ("jax_expm_parallel", dict(max_dt=0.01, magnus_order=2, expm_method="taylor"), TOL),
    ("jax_expm_parallel", dict(max_dt=0.01, magnus_order=1), PADE_TOL),
    ("jax_RK4_parallel", dict(max_dt=0.01), TOL),
    ("tpu_dopri5", dict(atol=1e-10, rtol=1e-10), TOL),
    ("tpu_dop853", dict(atol=1e-10, rtol=1e-10), TOL),
]
DEVICE_METHODS = {"jax_expm", "jax_RK4", "jax_lanczos_diag", "jax_expm_parallel",
                  "jax_RK4_parallel", "tpu_dopri5", "tpu_dop853"}


@pytest.fixture(scope="module")
def models():
    jrabi, nu = jax_rabi_solver()
    prabi, _ = rabi_solver(device="cpu")
    jcr, w1 = jax_cr_solver(dim=2)
    pcr, _ = cr_solver(dim=2, device="cpu")
    return {
        "rabi": (jrabi, prabi, nu, np.array([1.0, 0.0], dtype=complex)),
        "cr": (jcr, pcr, w1, np.eye(4, dtype=complex)),
    }


def _solve_both(models, model, method, kwargs):
    jsolver, psolver, freq, y0 = models[model]
    amp = 1.0 if model == "rabi" else 0.3
    kw = dict(t_span=[0.0, 1.0], y0=y0, method=method, t_eval=T_EVAL, **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the lanczos sparse-mode and parallel-on-CPU notes
        want = jsolver.solve(signals=[JaxSignal(amp, freq)], **kw)
        got = psolver.solve(signals=[Signal(amp, freq)], **kw)
    return want, got


@pytest.mark.parametrize("model", ["rabi", "cr"])
@pytest.mark.parametrize("method, kwargs, tol", METHODS,
                         ids=[f"{m}-{i}" for i, (m, _, _) in enumerate(METHODS)])
def test_solver_methods_match_jax(models, model, method, kwargs, tol):
    want, got = _solve_both(models, model, method, kwargs)
    np.testing.assert_allclose(got.t, np.asarray(want.t), rtol=0, atol=1e-15)
    if method in DEVICE_METHODS:
        assert isinstance(got.y, torch.Tensor) and got.y.device.type == "cpu"
    else:
        assert isinstance(got.y, np.ndarray)
    assert_rel_close(got.y, to_np(want.y), tol)
    if method.startswith("tpu_"):
        assert int(got.nfev) == int(want.nfev)
        assert bool(got.success)


def test_functional_interface_matches_jax():
    """``solve_lmde`` with a function-based generator and ``solve_ode`` with a
    function-based right-hand side (dim 4, no frame), backwards in time."""
    gen = rng(41)
    H0, H1 = random_hermitian(gen, 4), random_hermitian(gen, 4)

    def functions(cos, H0, H1):
        """The generator and the right-hand side on the arrays of one package."""
        def generator(t):
            return -1j * (H0 + cos(3.0 * t) * H1)

        return {"lmde": generator, "ode": lambda t, y: generator(t) @ y}

    jax_fns = functions(jnp.cos, H0, H1)
    fns = functions(np.cos, torch.as_tensor(H0), torch.as_tensor(H1))
    y0 = gen.normal(size=4) + 1j * gen.normal(size=4)
    y0 = y0 / np.linalg.norm(y0)
    t_span, t_eval = [1.0, -0.5], [0.8, 0.0]
    cases = [
        ("lmde", "jax_expm", dict(max_dt=0.02, magnus_order=2, expm_method="taylor")),
        ("lmde", "jax_RK4_parallel", dict(max_dt=0.02)),
        ("ode", "tpu_dop853", dict(atol=1e-11, rtol=1e-11)),
        ("ode", "jax_RK4", dict(max_dt=0.02)),
    ]
    solvers = {"lmde": (solve_lmde, jax_solve_lmde), "ode": (solve_ode, jax_solve_ode)}
    for kind, method, kwargs in cases:
        solve, jax_solve = solvers[kind]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jax_solve(jax_fns[kind], t_span, y0, method=method, t_eval=t_eval, **kwargs)
        got = solve(fns[kind], t_span, torch.as_tensor(y0), method=method, t_eval=t_eval,
                    **kwargs)
        assert got.y.shape == (2, 4)
        assert_rel_close(got.y, to_np(want.y), TOL)


def test_rk4_parallel_takes_rectangular_states(models):
    """An (n, m) state with m != n: the JAX package's identity takes the last
    axis and fails (ROADMAP.md section C); the port's columns equal the
    columns of the square solve."""
    _, psolver, w1, eye = models["cr"]
    kw = dict(t_span=[0.0, 1.0], signals=[Signal(0.3, w1)], method="jax_RK4_parallel",
              max_dt=0.01)
    square = psolver.solve(y0=eye, **kw).y
    assert_rel_close(psolver.solve(y0=eye[:, :2], **kw).y, square[..., :2], TOL)


def test_lindblad_vectorized_jax_expm_matches_jax():
    X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    Z = np.diag([1.0, -1.0]).astype(complex)
    kw = dict(
        static_hamiltonian=2 * np.pi * Z / 2, hamiltonian_operators=[2 * np.pi * 0.3 * X / 2],
        static_dissipators=[np.sqrt(0.1) * np.array([[0.0, 1.0], [0.0, 0.0]])],
        rotating_frame=2 * np.pi * Z / 2, vectorized=True,
    )
    jsolver, psolver = JaxSolver(**kw), Solver(**kw, device="cpu")
    rho0 = np.diag([0.0, 1.0]).astype(complex)
    solve_kw = dict(t_span=[0.0, 1.0], y0=rho0, method="jax_expm", max_dt=0.01, magnus_order=2,
                    expm_method="taylor", t_eval=T_EVAL)
    got = psolver.solve(signals=[Signal(1.0, 1.0)], **solve_kw)
    # the JAX Solver takes the column-stacked state
    solve_kw["y0"] = rho0.flatten(order="F")
    want = to_np(jsolver.solve(signals=[JaxSignal(1.0, 1.0)], **solve_kw).y)
    assert got.y.shape == (5, 2, 2) and isinstance(got.y, torch.Tensor)
    assert_rel_close(got.y, np.swapaxes(want.reshape(5, 2, 2), 1, 2), TOL)
    assert is_lindblad_model_vectorized(psolver.model)
    assert not is_lindblad_model_not_vectorized(psolver.model)


def test_precompute_with_device_method_matches_jax():
    gen = rng(43)
    mats = gen.normal(size=(2, 3, 3)) + 1j * gen.normal(size=(2, 3, 3))
    perturbations = [lambda t, k=k: np.cos((k + 1) * t) * mats[k] for k in range(2)]
    jax_perturbations = [lambda t, k=k: jnp.cos((k + 1) * t) * mats[k] for k in range(2)]
    kw = dict(t_span=[0.0, 0.5], expansion_method="dyson", expansion_order=2,
              integration_method="jax_RK4", max_dt=0.01)
    want = jax_solve_perturbation(jax_perturbations, **kw)
    got = solve_lmde_perturbation(perturbations, device="cpu", **kw)
    assert isinstance(got.y, np.ndarray)
    assert_rel_close(got.perturbation_data.data, to_np(want.perturbation_data.data), TOL)
    adaptive = dict(t_span=[0.0, 0.5], expansion_method="magnus", expansion_order=2,
                    atol=1e-12, rtol=1e-12)
    magnus = solve_lmde_perturbation(
        perturbations, device="cpu", integration_method="tpu_dop853", **adaptive)
    host = solve_lmde_perturbation(perturbations, integration_method="DOP853", **adaptive)
    # the scipy solve reports its internal steps, the device solve only the end points
    assert_rel_close(magnus.perturbation_data.data[:, -1], host.perturbation_data.data[:, -1], 1e-9)


def test_lanczos_expm_matches_jax_and_breaks_down():
    gen = rng(47)
    A = -1j * random_hermitian(gen, 6)
    y = gen.normal(size=(6, 2)) + 1j * gen.normal(size=(6, 2))
    for k_dim in (3, 6):
        want = np.asarray(jax_jax_lanczos_expm(A, y, k_dim, 0.1))
        assert_rel_close(jax_lanczos_expm(torch.as_tensor(A), torch.as_tensor(y), k_dim, 0.1),
                         want, TOL)
        assert_rel_close(lanczos_expm(A, y, k_dim, 0.1), want, 1e-8 if k_dim == 3 else TOL)
    # an invariant subspace of dimension 2: the Krylov iteration breaks down
    # after two vectors, and the masked iterations leave the result exact
    A2 = np.zeros((4, 4), dtype=complex)
    A2[:2, :2] = -1j * random_hermitian(gen, 2)
    y2 = np.array([1.0, 0.5, 0.0, 0.0], dtype=complex)
    want = np.asarray(jax_jax_lanczos_expm(A2, y2, 4, 0.3))
    got = jax_lanczos_expm(torch.as_tensor(A2), torch.as_tensor(y2), 4, 0.3)
    assert bool(torch.isfinite(got).all())
    assert_rel_close(got, want, TOL)


def test_merge_and_trim_t_args_match_jax(models):
    for t_span, t_eval in (([0.0, 1.0], [0.0, 0.5, 1.0]), ([2.0, 0.0], [1.5, 0.0])):
        np.testing.assert_array_equal(merge_t_args_jax(t_span, t_eval),
                                      np.asarray(jax_merge_t_args_jax(t_span, t_eval)))
    with pytest.raises(ValueError, match="t_span"):
        merge_t_args_jax([0.0, 1.0], [0.5, 2.0])
    # endpoints in t_eval: the adaptive solver reports them exactly
    want, got = _solve_both(models, "rabi", "tpu_dopri5", dict(atol=1e-10, rtol=1e-10))
    assert_rel_close(got.y[0], models["rabi"][3], 0.0)
    assert_rel_close(got.y, to_np(want.y), TOL)


@pytest.mark.parametrize("alias, method", [("jax_dopri5", "tpu_dopri5"),
                                           ("jax_dop853", "tpu_dop853")])
def test_adaptive_aliases(models, alias, method):
    _, psolver, nu, y0 = models["rabi"]
    kw = dict(t_span=[0.0, 0.5], y0=y0, signals=[Signal(1.0, nu)], atol=1e-8, rtol=1e-8)
    want = psolver.solve(method=method, **kw)
    got = psolver.solve(method=alias, **kw)
    assert int(got.nfev) == int(want.nfev) and torch.equal(got.y, want.y)


def test_budget_exhaustion_poisons(models):
    _, psolver, nu, y0 = models["rabi"]
    res = psolver.solve(t_span=[0.0, 1.0], y0=y0, signals=[Signal(1.0, nu)],
                        method="tpu_dopri5", max_steps=3)
    assert not res.success
    assert bool(torch.isnan(res.y[-1]).all()) and bool(torch.isfinite(res.y[0]).all())


def test_unported_methods_and_metrics(models):
    _, psolver, nu, y0 = models["rabi"]
    with pytest.raises(DynamicsError, match="A13"):
        psolver.solve(t_span=[0.0, 1.0], y0=y0, signals=[Signal(1.0, nu)], method="tensor_expm")
    with pytest.raises(DynamicsError, match="not ported"):
        solve_ode(lambda t, y: y, [0.0, 1.0], torch.ones(2), method="jax_odeint")
    with pytest.raises(DynamicsError, match="not supported"):
        solve_lmde(lambda t: torch.eye(2), [0.0, 1.0], torch.ones(2), method="expm")
    with pytest.raises(DynamicsError, match="k_dim"):
        psolver.solve(t_span=[0.0, 1.0], y0=y0, signals=[Signal(1.0, nu)],
                      method="jax_lanczos_diag", max_dt=0.1, k_dim=3)
    enable_metrics()
    try:
        psolver.solve(t_span=[0.0, 0.1], y0=y0, signals=[Signal(1.0, nu)], method="jax_expm",
                      max_dt=0.05)
        record = solve_metrics()[-1]
    finally:
        disable_metrics(clear=True)
    assert record.method == "jax_expm" and record.wall_time_s > 0
    assert solve_metrics() == []
