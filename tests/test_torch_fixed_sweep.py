"""Parity of the port's fixed-step sweep (kernel B2's plain version, the eager
engine, the autograd wrapper and ``fused_sweep_solve``) with the JAX package.

Tolerances and their reasons:

- Plain B2 in float64 against the JAX Pallas kernel (interpret mode, x64):
  1e-12. Both run the same Magnus-2 and Horner arithmetic in float64; they
  differ only in the frame phase (the port reduces ``omega tau`` mod 2 pi
  before cos/sin), ~1e-15 at these phases.
- The eager engine against the JAX XLA engine (x64): 1e-12, same reason.
- The autograd wrapper's float64 gradient against ``jax.vjp`` of the JAX XLA
  engine: 1e-10 (reverse-mode sums in a different order); central
  differences: 1e-6 relative (step 1e-6, truncation ~1e-8).
- ``fused_sweep_solve`` against JAX ``fused_sweep_solve(sweep_engine="xla")``
  (x64): the port's default path runs in float32 as the kernel does, so
  states agree to 5e-6 (measured 5e-7) and gradients to 1e-5 of max |g|
  (measured 9e-7).

The JAX Pallas kernel is run in interpret mode four times (one call per
mode and one trajectory call; ~10-20 s each); everything else goes through
the JAX XLA paths.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, random_hermitian, rng, to_np

from qiskit_dynamics_tpu import Signal as JaxSignal
from qiskit_dynamics_tpu.benchmarks import cr_solver as jax_cr_solver
from qiskit_dynamics_tpu.ops.sweep_solver import sweep_expm_magnus2 as jax_sweep
from qiskit_dynamics_tpu.ops.xla_sweep import sweep_expm_magnus2_xla as jax_xla
from qiskit_dynamics_tpu.solvers import fused_sweep_solve as jax_fused_sweep_solve
from qiskit_dynamics_tpu.solvers.fused_sweep import (
    _all_anti_hermitian as jax_all_anti_hermitian,
)
from qiskit_dynamics_tpu.solvers.fixed_step_solvers import (
    get_fixed_step_sizes as jax_get_fixed_step_sizes,
)

import qiskit_dynamics_tpu_torch as port
from qiskit_dynamics_tpu_torch import Signal, interop
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError
from qiskit_dynamics_tpu_torch.kernels import _build
from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import sweep_solver as ssw
from qiskit_dynamics_tpu_torch.ops.sweep_ad import sweep_expm_magnus2_ad
from qiskit_dynamics_tpu_torch.ops.xla_sweep import sweep_expm_magnus2_xla
from qiskit_dynamics_tpu_torch.solvers import fused_sweep_solve
from qiskit_dynamics_tpu_torch.solvers.fixed_step_solvers import get_fixed_step_sizes

N, K, T, B = 4, 2, 6, 8
DT, T0 = 0.1, 0.3
SLOTS = (-1, 0, -1, 1, -1, 2)


@pytest.fixture(scope="module")
def problem():
    """Seeded anti-Hermitian frame-basis operators, a frame, Gauss-point
    coefficients and normalized initial states."""
    gen = rng(101)
    static = -1j * random_hermitian(gen, N)
    ops = np.stack([-1j * random_hermitian(gen, N) for _ in range(K)])
    w = gen.uniform(0.0, 5.0, N)
    y0 = gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B))
    return dict(
        static=static, ops=ops, omega=w[None, :] - w[:, None],
        coef=gen.normal(size=(T, 2, K, B)), coef3=gen.normal(size=(T, 3, K, B)),
        y0=y0 / np.linalg.norm(y0, axis=0),
    )


def _args(p, coef="coef"):
    return p["static"], p["ops"], p["omega"], p[coef], p["y0"]


@pytest.mark.parametrize(
    "mode, eval_slots",
    [("matrix", None), ("matrix_herm", None), ("matvec", None), ("matrix_herm", SLOTS)],
)
def test_plain_matches_jax_pallas(problem, mode, eval_slots):
    kwargs = dict(dt=DT, t0=T0, tile_b=B, hermitian=True, mode=mode, eval_slots=eval_slots)
    expected = jax_sweep(*_args(problem), interpret=True, **kwargs)
    static, ops, omega, coef, y0 = _args(problem)
    out = ssw.sweep_expm_magnus2(static, ops, omega, coef, torch.as_tensor(y0), **kwargs)
    if eval_slots is None:
        out, expected = (out,), (expected,)
    for got, want in zip(out, expected):
        assert got.dtype == torch.complex128
        assert_rel_close(got, np.asarray(want), 1e-12)


@pytest.mark.parametrize("magnus_order", [2, 3])
@pytest.mark.parametrize("layout", ["lanes", "batch_major"])
def test_eager_engine_matches_jax_xla(problem, magnus_order, layout):
    static, ops, omega, coef, y0 = _args(problem, "coef" if magnus_order == 2 else "coef3")
    if layout == "batch_major":  # (B, n, m): m state columns per member
        y0 = np.stack([np.eye(N, 3, k=-1, dtype=complex)] * B)
    kwargs = dict(dt=DT, t0=T0, hermitian=True, eval_slots=SLOTS, magnus_order=magnus_order)
    expected = jax_xla(static, ops, omega, coef, y0, **kwargs)
    out = sweep_expm_magnus2_xla(static, ops, omega, coef, torch.as_tensor(y0), **kwargs)
    for got, want in zip(out, expected):
        assert_rel_close(got, np.asarray(want), 1e-12)


def test_eager_engine_matches_plain_kernel_arithmetic(problem):
    """The eager engine and the plain B2 compute the same polynomial."""
    static, ops, omega, coef, y0 = _args(problem)
    y0 = torch.as_tensor(y0)
    kw = dict(dt=DT, t0=T0, hermitian=False)
    engine = sweep_expm_magnus2_xla(static, ops, omega, coef, y0, **kw)
    plain = ssw.sweep_expm_magnus2(static, ops, omega, coef, y0, tile_b=B, mode="matrix", **kw)
    assert_rel_close(plain, engine, 1e-12)


def _loss_weights(shape_final, shape_traj):
    gen = rng(102)
    return [gen.normal(size=s) + 1j * gen.normal(size=s) for s in (shape_final, shape_traj)]


def test_ad_gradient_matches_jax_vjp(problem):
    static, ops, omega, coef, y0 = _args(problem)
    w_final, w_traj = _loss_weights((N, B), (3, N, B))
    kw = dict(dt=DT, t0=T0, hermitian=True, eval_slots=SLOTS)

    def jax_loss(s, o, c, y):
        final, traj = jax_xla(s, o, omega, c, y, **kw)
        return jnp.sum(jnp.real(jnp.conj(w_final) * final)) + jnp.sum(
            jnp.real(jnp.conj(w_traj) * traj)
        )

    expected = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(static, ops, coef, y0)
    leaves = [torch.tensor(x, requires_grad=True) for x in (static, ops, coef, y0)]
    final, traj = sweep_expm_magnus2_ad(
        leaves[0], leaves[1], torch.as_tensor(omega), leaves[2], leaves[3], order=8,
        mode="matrix_herm", tile_b=B, **kw,
    )
    loss = torch.sum(torch.real(torch.as_tensor(w_final).conj() * final)) + torch.sum(
        torch.real(torch.as_tensor(w_traj).conj() * traj)
    )
    loss.backward()
    for leaf, want in zip(leaves, expected):
        # torch's gradient of a real loss in a complex input is the
        # conjugate of JAX's
        want = np.asarray(want)
        assert_rel_close(leaf.grad, np.conj(want) if np.iscomplexobj(want) else want, 1e-10)


def test_ad_gradient_central_difference(problem):
    static, ops, omega, coef, y0 = _args(problem)
    w_final, _ = _loss_weights((N, B), (3, N, B))

    def loss(c):
        out = sweep_expm_magnus2_ad(
            torch.as_tensor(static), torch.as_tensor(ops), torch.as_tensor(omega), c,
            torch.as_tensor(y0), dt=DT, t0=T0, order=8, hermitian=True, mode="matrix_herm",
            tile_b=B,
        )
        return torch.sum(torch.real(torch.as_tensor(w_final).conj() * out))

    c = torch.tensor(coef, requires_grad=True)
    loss(c).backward()
    h = 1e-6
    for idx in [(0, 0, 0, 0), (3, 1, 1, 5), (5, 0, 1, 7)]:
        up, down = coef.copy(), coef.copy()
        up[idx] += h
        down[idx] -= h
        fd = (loss(torch.as_tensor(up)) - loss(torch.as_tensor(down))).item() / (2 * h)
        assert abs(c.grad[idx].item() - fd) <= 1e-6 * max(1.0, abs(fd)), (idx, c.grad[idx], fd)


def test_get_fixed_step_sizes_matches_jax():
    for t_span, t_eval, max_dt in [((0.0, 100.0), None, 0.5), ((0.0, 1.0), [0.3, 0.7], 0.11),
                                   ((2.0, 0.0), [1.5], 0.4)]:
        got = get_fixed_step_sizes(t_span, t_eval, max_dt)
        want = jax_get_fixed_step_sizes(t_span, t_eval, max_dt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert int(get_fixed_step_sizes((0.0, 100.0), None, 0.5)[2][0]) == 200


# --- fused_sweep_solve on cr_solver(dim=2) against JAX -----------------------
T_SWEEP = 10.0
AMPS = np.linspace(0.3, 1.0, 5)


@pytest.fixture(scope="module")
def cr_pair():
    return jax_cr_solver(dim=2), cr_solver(dim=2, device="cpu")


def _signals(package_signal, amp_scale):
    return lambda a, w1: [package_signal(lambda t: a * amp_scale, carrier_freq=w1)]


@pytest.mark.parametrize("case", ["final", "t_eval", "unitary", "xla_engine"])
def test_fused_sweep_solve_matches_jax(cr_pair, case):
    (jsolver, w1), (tsolver, _) = cr_pair
    y0 = np.eye(4, dtype=complex) if case == "unitary" else np.eye(4, dtype=complex)[0]
    kw = dict(t_span=(0.0, T_SWEEP), max_dt=0.5, y0=y0)
    if case == "t_eval":
        kw["t_eval"] = [0.0, 5.0, T_SWEEP]
    jfn = _signals(JaxSignal, 0.4)
    tfn = _signals(Signal, 0.4)
    expected = jax_fused_sweep_solve(
        jsolver.model, lambda a: jfn(a, w1), jnp.asarray(AMPS),
        rwa_signal_map=jsolver._rwa_signal_map, sweep_engine="xla", **kw,
    )
    engine = {"sweep_engine": "xla"} if case == "xla_engine" else {"tile_b": 8}
    before = launches("sweep_magnus2_launch")
    out = tsolver.solve_sweep(
        lambda a: tfn(a, w1), torch.as_tensor(AMPS), method="fused_magnus2", **engine, **kw
    )
    assert launches("sweep_magnus2_launch") == before  # CPU tensors: the plain version
    assert out.shape == np.asarray(expected).shape
    np.testing.assert_allclose(to_np(out), np.asarray(expected), rtol=0, atol=5e-6)


def test_fused_sweep_gradient_matches_jax(cr_pair):
    (jsolver, w1), (tsolver, _) = cr_pair
    y0 = np.eye(4, dtype=complex)[0]
    kw = dict(t_span=(0.0, T_SWEEP), max_dt=0.5, y0=y0)
    jfn = _signals(JaxSignal, 0.4)

    def jax_loss(a):
        yf = jax_fused_sweep_solve(
            jsolver.model, lambda x: jfn(x, w1), a, rwa_signal_map=jsolver._rwa_signal_map,
            sweep_engine="xla", **kw,
        )
        return jnp.mean(jnp.abs(yf[:, 1]) ** 2)

    expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(AMPS)))
    amps = torch.tensor(AMPS, requires_grad=True)
    tfn = _signals(Signal, 0.4)
    yf = tsolver.solve_sweep(lambda a: tfn(a, w1), amps, method="fused_magnus2", tile_b=8, **kw)
    torch.mean(yf[:, 1].abs() ** 2).backward()
    assert_rel_close(amps.grad, expected, 1e-5 * np.max(np.abs(expected)))


def test_kernel_route_pads_no_lanes(cr_pair, monkeypatch):
    """With the default ``tile_b`` every lane the kernel engine runs is a
    sweep member: no padding copies."""
    (_, w1), (tsolver, _) = cr_pair
    batches = []
    plain = ssw.sweep_expm_magnus2_plain

    def recording_plain(inputs):
        batches.append(inputs.batch)
        return plain(inputs)

    monkeypatch.setattr(ssw, "sweep_expm_magnus2_plain", recording_plain)
    tsolver.solve_sweep(
        lambda a: [Signal(lambda t: a, carrier_freq=w1)], torch.tensor([0.1, 0.2, 0.3]),
        t_span=(0.0, 1.0), max_dt=0.5, y0=np.eye(4, dtype=complex)[0], method="fused_magnus2",
    )
    assert batches == [3]


@pytest.mark.parametrize(
    "t_eval, message",
    [([0.25, 1.0], "fixed step grid"), ([0.5, 0.5 + 1e-8], "same fixed step"),
     ([1.0, 0.5], "strictly increasing"), ([0.5, 3.0], "within t_span")],
)
def test_t_eval_validation(cr_pair, t_eval, message):
    (_, w1), (tsolver, _) = cr_pair
    with pytest.raises(DynamicsError, match=message):
        tsolver.solve_sweep(
            lambda a: [Signal(lambda t: a, carrier_freq=w1)], torch.tensor([0.1]),
            t_span=(0.0, 2.0), max_dt=0.5, y0=np.eye(4, dtype=complex)[0],
            method="fused_magnus2", t_eval=t_eval,
        )


@pytest.mark.parametrize(
    "kwargs, error, message",
    [({"precision": "df32", "df_devices": ["cuda:0"]}, NotImplementedError, "A13"),
     ({"mesh": object()}, NotImplementedError, "A13"),
     ({"precision": "f16"}, DynamicsError, "unknown precision"),
     ({"sweep_engine": "member", "t_eval": [0.5, 1.0]}, DynamicsError, "vector initial states"),
     ({"magnus_order": 4}, DynamicsError, "magnus_order must be 2 or 3"),
     ({"sweep_engine": "pallas", "magnus_order": 3}, DynamicsError, "magnus_order=3"),
     ({"sweep_engine": "bogus"}, DynamicsError, "unknown sweep_engine")],
)
def test_unported_options_raise(cr_pair, kwargs, error, message):
    """Options still to be ported raise with their ROADMAP item; the member
    and polynomial engines are ported and raise only for what the JAX package
    rejects too."""
    (_, w1), (tsolver, _) = cr_pair
    with pytest.raises(error, match=message):
        fused_sweep_solve(
            tsolver.model, lambda a: [Signal(lambda t: a, carrier_freq=w1)], torch.tensor([0.1]),
            (0.0, 1.0), 0.5, np.eye(4, dtype=complex)[0], rwa_signal_map=tsolver._rwa_signal_map,
            **kwargs,
        )


def test_auto_engine_above_32_raises():
    """Above solve_dim 32 ``sweep_engine="auto"`` no longer raises: it runs the
    member engine (agreeing with the eager engine). What still raises there is
    what the JAX package rejects: Magnus-3 on the member engine above 64."""
    gen = rng(103)
    model = port.models.HamiltonianModel(
        random_hermitian(gen, 33), [random_hermitian(gen, 33)], device="cpu"
    )
    args = (model, lambda a: [Signal(a)], torch.tensor([0.1]), (0.0, 1.0), 0.5,
            np.eye(33, dtype=complex)[0])
    out = fused_sweep_solve(*args)
    np.testing.assert_allclose(to_np(out), to_np(fused_sweep_solve(*args, sweep_engine="xla")),
                               rtol=0, atol=2e-5)
    big = port.models.HamiltonianModel(
        random_hermitian(gen, 65), [random_hermitian(gen, 65)], device="cpu"
    )
    with pytest.raises(DynamicsError, match="solve_dim <= 64"):
        fused_sweep_solve(big, lambda a: [Signal(a)], torch.tensor([0.1]), (0.0, 1.0), 0.5,
                          np.eye(65, dtype=complex)[0], sweep_engine="member", magnus_order=3)


@pytest.mark.parametrize(
    "change, error, message",
    [({"tile_b": 3}, ValueError, "multiple of tile_b"),
     ({"mode": "matrix_herm", "hermitian": False}, ValueError, "requires hermitian"),
     ({"mode": "bogus"}, ValueError, "unknown mode"),
     ({"eval_slots": (0, 0, -1, -1, -1, -1)}, ValueError, "permutation"),
     ({"eval_slots": (-1,) * T}, ValueError, "at least one step")],
)
def test_wrapper_validation(problem, change, error, message):
    static, ops, omega, coef, y0 = _args(problem)
    kwargs = {"dt": DT, "tile_b": B, "hermitian": True, **change}
    with pytest.raises(error, match=message):
        ssw.sweep_expm_magnus2(static, ops, omega, coef, torch.as_tensor(y0), **kwargs)


_X = np.array([[0, 1], [1, 0]], dtype=complex)


@pytest.mark.parametrize(
    "static, op",
    [(-1j * _X, -1j * _X), (_X, -1j * _X), (-1j * _X, _X), (None, -1j * _X)],
)
def test_anti_hermitian_check_matches_jax(static, op):
    """The collection's anti-Hermitian check agrees with the JAX package's
    and is computed once per collection."""
    coll = port.models.OperatorCollection(
        None if static is None else torch.as_tensor(static), torch.as_tensor(op[None])
    )
    expected = jax_all_anti_hermitian(np.zeros((2, 2)) if static is None else static, op[None])
    assert coll.anti_hermitian == bool(expected)
    assert "anti_hermitian" in vars(coll)  # kept for the next solve


def test_auto_mode_cost_model():
    assert ssw.select_mode("auto", 16, 8, True) == "matrix_herm"
    assert ssw.select_mode("auto", 25, 8, True) == "matvec"
    assert ssw.select_mode("auto", 4, 8, False) == "matrix"
    assert ssw.select_mode("auto", 13, 8, False) == "matvec"


def test_kernel_source_constants():
    """The kernel's caps are the wrapper's: the state dimension and the warps
    per block. (The Gauss nodes live in the wrapper alone since the frame
    phases come from its table.)"""
    source = (_build.SOURCE_DIR / "sweep_magnus2.cu").read_text()
    for name, value in (("kMaxN", ssw.MAX_N), ("kMaxWarps", ssw.MAX_WARPS_PER_BLOCK)):
        literal = re.search(rf"{name} = ([0-9]+);", source).group(1)
        assert int(literal) == value


def _perturbative_entry_points(eye):
    """The perturbative entry points, each returning its model (a tiny
    first-order expansion where one is computed at all)."""
    from qiskit_dynamics_tpu_torch.benchmarks import (
        dyson_transmon_solver,
        magnus_transmon_solver,
    )

    config = dict(operators=[-1j * eye], rotating_frame=np.array([1.0, 2.0]), dt=0.1,
                  carrier_freqs=[1.0], chebyshev_orders=[0], expansion_order=1)

    def load():
        import tempfile

        with tempfile.TemporaryDirectory() as folder:
            np.savez(
                folder + "/model.npz", expansion_method="dyson", dt=0.1, Udt=eye, operators=[eye],
                carrier_freqs=[1.0], chebyshev_orders=[0], include_imag=[True],
                frame_operator=-1j * eye, poly_constant=eye, poly_has_constant=True,
                poly_coefficients=[eye], poly_labels=["0"],
            )
            return port.ExpansionModel.load(folder + "/model.npz")

    return {
        "ExpansionModel": lambda: port.ExpansionModel(**config),
        "DysonSolver": lambda: port.DysonSolver(**config).model,
        "MagnusSolver": lambda: port.MagnusSolver(**config).model,
        "dyson_transmon_solver": lambda: dyson_transmon_solver(dim=2, expansion_order=1)[0].model,
        "magnus_transmon_solver": lambda: magnus_transmon_solver(dim=2, expansion_order=1)[0].model,
        "ExpansionModel.load": load,
        "perturbative_solver_from_arrays": lambda: interop.perturbative_solver_from_arrays(
            np.stack([eye]), -1j * eye, 0.1, np.array([1.0]), [0], [True], eye, "dyson", eye,
            np.stack([eye]), [(0,)]
        ).model,
    }


def _high_precision_entry_points(eye, problem):
    """The native-FP64 entry points, each returning its result (or inputs)."""
    from qiskit_dynamics_tpu_torch.ops.df_sweep import prepare_df_inputs
    from qiskit_dynamics_tpu_torch.solvers import (
        interpolated_sweep_solve,
        interpolated_sweep_solve_2d,
    )

    static, ops, omega, _, y0 = _args(problem)
    amps = np.array([0.1, 0.2])
    kw = dict(t_span=(0.0, 0.2), y0=np.eye(4, dtype=complex)[0], max_dt=0.1)

    def cr_model():
        solver, w1 = cr_solver(dim=2)
        return solver, lambda a: [Signal(lambda t: a, carrier_freq=w1)]

    def fused():
        solver, fn = cr_model()
        return solver.solve_sweep(fn, amps, method="fused_magnus2", precision="df32", **kw)

    def interp(two_d):
        solver, fn = cr_model()
        if two_d:
            return interpolated_sweep_solve_2d(
                solver.model, lambda pq: fn(pq[0] + pq[1]), (amps, amps), min_level=1,
                max_level=2, tol=1.0, rwa_signal_map=solver._rwa_signal_map, **kw)
        return interpolated_sweep_solve(solver.model, fn, amps, min_level=1, max_level=2,
                                        tol=1.0, rwa_signal_map=solver._rwa_signal_map, **kw)

    config = dict(operators=[-1j * eye], rotating_frame=np.array([1.0, 2.0]), dt=0.1,
                  carrier_freqs=[1.0], chebyshev_orders=[0], expansion_order=1)
    return {
        # a non-tensor y0 goes to the CUDA device
        "sweep_expm_magnus_df": lambda: prepare_df_inputs(
            static, ops, omega, problem["coef3"], y0, dt=DT).y0,
        "fused_sweep_solve_df32": fused,
        "interpolated_sweep_solve": lambda: interp(False),
        "interpolated_sweep_solve_2d": lambda: interp(True),
        "DysonSolver.solve_sweep_df32": lambda: port.DysonSolver(**config).solve_sweep(
            0.0, 2, np.array([1.0, 0.0]), lambda a: [Signal(a, 1.0)], amps, precision="df32"),
    }


def _device_method_entry_points(eye):
    """The device methods of ``solve_ode``/``solve_lmde`` with host inputs,
    each returning its result's states (or terms)."""
    from qiskit_dynamics_tpu_torch.benchmarks import rabi_solver
    from qiskit_dynamics_tpu_torch.perturbation import solve_lmde_perturbation

    def precompute():
        # the stacked state of a device method lives on the CUDA device
        import qiskit_dynamics_tpu_torch.perturbation.dyson_magnus as dm

        seen = {}
        solve = dm.solve_ode

        def spy(**kwargs):
            seen["y0"] = kwargs["y0"]
            return solve(**kwargs)

        dm.solve_ode = spy
        try:
            solve_lmde_perturbation([lambda t: eye], [0.0, 0.1], "dyson", expansion_order=1,
                                    integration_method="jax_RK4", max_dt=0.1)
        finally:
            dm.solve_ode = solve
        return seen["y0"]

    return {
        "rabi_solver": lambda: rabi_solver()[0].model,
        # a host y0 and a function-based right-hand side go to the CUDA device
        "solve_ode_jax_RK4": lambda: port.solve_ode(
            lambda t, y: y, [0.0, 0.1], np.ones(2), method="jax_RK4", max_dt=0.1).y,
        "solve_lmde_jax_expm": lambda: port.solve_lmde(
            lambda t: -1j * eye, [0.0, 0.1], np.ones(2), method="jax_expm", max_dt=0.1).y,
        "solve_lmde_perturbation_device": precompute,
    }


@pytest.mark.parametrize(
    "entry",
    ["cr_solver", "RotatingFrame", "HamiltonianModel", "LindbladModel", "Solver",
     "solver_from_arrays", "lindblad_model_from_arrays", "sweep_expm_magnus2",
     "sweep_expm_magnus2_xla", "ExpansionModel", "DysonSolver", "MagnusSolver",
     "dyson_transmon_solver", "magnus_transmon_solver", "ExpansionModel.load",
     "perturbative_solver_from_arrays", "sweep_expm_magnus_df", "fused_sweep_solve_df32",
     "interpolated_sweep_solve", "interpolated_sweep_solve_2d", "DysonSolver.solve_sweep_df32",
     "rabi_solver", "solve_ode_jax_RK4", "solve_lmde_jax_expm", "solve_lmde_perturbation_device"],
)
def test_device_none_means_cuda(entry, problem):
    """``device=None`` is the CUDA device: without one the entry points raise
    and never fall back to the CPU."""
    eye = np.eye(2, dtype=complex)
    static, ops, omega, coef, y0 = _args(problem)
    calls = {
        "cr_solver": lambda: cr_solver(dim=2)[0].model,
        "RotatingFrame": lambda: port.models.RotatingFrame(np.array([1.0, 2.0])),
        "HamiltonianModel": lambda: port.models.HamiltonianModel(eye, [eye]),
        "LindbladModel": lambda: port.models.LindbladModel(
            eye, static_dissipators=[eye], vectorized=True
        ),
        "Solver": lambda: port.Solver(eye, [eye]).model,
        "solver_from_arrays": lambda: interop.solver_from_arrays(eye, [eye]).model,
        "lindblad_model_from_arrays": lambda: interop.lindblad_model_from_arrays(
            eye, None, static_dissipators=[eye]
        ),
        # a non-tensor y0 goes to the CUDA device
        "sweep_expm_magnus2": lambda: ssw.prepare_inputs(
            static, ops, omega, coef, y0, dt=DT, tile_b=B
        ).y0r,
        # neither y0 nor the coefficients are tensors
        "sweep_expm_magnus2_xla": lambda: sweep_expm_magnus2_xla(
            static, ops, omega, coef, y0, dt=DT
        ),
        **_perturbative_entry_points(eye),
        **_high_precision_entry_points(eye, problem),
        **_device_method_entry_points(eye),
    }
    if torch.cuda.is_available():
        assert calls[entry]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            calls[entry]()
