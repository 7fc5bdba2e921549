"""Parity of the port's member-major sweep (kernel B3's plain version, its
autograd wrapper and the ``sweep_engine="member"`` / ``"auto"`` routes of
``fused_sweep_solve``) with the JAX package.

Tolerances and their reasons:

- Plain B3 in float64 against the JAX Pallas kernel (interpret mode, x64):
  1e-10. Both run the same Magnus-2/3 rule and Horner polynomial in float64;
  the JAX kernel works in transposed space on the real (2n, 2n)
  representation, so sums run in another order (~1e-15 per step). Plain B3
  in float32 against the same result: 2e-5 (float32 roundoff over 6 steps,
  measured ~2e-7).
- The autograd wrapper's float64 gradient against ``jax.grad`` of the JAX XLA
  engine: 1e-10; against central differences: 1e-6 relative.
- ``fused_sweep_solve`` on the dim-4 Lindblad model (solve_dim 16) against the
  JAX package's XLA engine (x64): 2e-5, the port runs float32 as its kernel
  does; against DOP853(1e-13): 5e-6, the bar of the JAX package's own test.
  Gradients: 1e-5 of max |g| against the JAX gradient, 1e-4 relative against
  central differences of the JAX float64 solve.

The JAX Pallas kernel is run in interpret mode five times (one per static
configuration, each result shared by the float64 and the float32 case).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, random_hermitian, rng, to_np

from qiskit_dynamics_tpu import Signal as JaxSignal, Solver as JaxSolver
from qiskit_dynamics_tpu.ops.member_sweep import sweep_expm_magnus2_member as jax_member
from qiskit_dynamics_tpu.ops.xla_sweep import sweep_expm_magnus2_xla as jax_xla
from qiskit_dynamics_tpu.solvers import fused_sweep_solve as jax_fused_sweep_solve

from qiskit_dynamics_tpu_torch import Signal, Solver
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError
from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import member_sweep as msw
from qiskit_dynamics_tpu_torch.ops import sweep_solver as ssw
from qiskit_dynamics_tpu_torch.ops import xla_sweep
from qiskit_dynamics_tpu_torch.ops.sweep_ad import sweep_expm_magnus2_member_ad
from qiskit_dynamics_tpu_torch.solvers import fused_sweep_solve
from qiskit_dynamics_tpu_torch.solvers.fused_sweep import _select_engine

N, K, T, B = 6, 2, 6, 5
DT, T0 = 0.1, 0.3


@functools.lru_cache(maxsize=None)
def problem(hermitian: bool):
    """Seeded frame-basis operators (anti-Hermitian or general), a frame,
    Gauss-point coefficients for both rules and normalized initial states."""
    gen = rng(301 + hermitian)

    def matrix():
        if hermitian:
            return -1j * random_hermitian(gen, N)
        return (gen.normal(size=(N, N)) + 1j * gen.normal(size=(N, N))) / 2

    static = matrix()
    ops = np.stack([matrix() for _ in range(K)])
    w = gen.uniform(0.0, 5.0, N)
    y0 = gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B))
    return dict(
        static=static, ops=ops, omega=w[None, :] - w[:, None],
        coef={2: gen.normal(size=(T, 2, K, B)), 3: gen.normal(size=(T, 3, K, B))},
        y0=y0 / np.linalg.norm(y0, axis=0),
    )


@functools.lru_cache(maxsize=None)
def jax_member_result(magnus: int, hermitian: bool, resident: bool):
    p = problem(hermitian)
    return np.asarray(jax_member(
        p["static"], p["ops"], p["omega"], p["coef"][magnus], p["y0"], dt=DT, t0=T0,
        block_m=4, interpret=True, hermitian=hermitian, resident=resident, magnus=magnus,
    ))


CONFIGS = [(2, False, True), (2, True, True), (3, False, True), (3, True, True),
           (2, False, False)]


@pytest.mark.parametrize("real, tol", [(np.float64, 1e-10), (np.float32, 2e-5)])
@pytest.mark.parametrize("magnus, hermitian, resident", CONFIGS)
def test_plain_matches_jax_pallas(magnus, hermitian, resident, real, tol):
    expected = jax_member_result(magnus, hermitian, resident)
    p = problem(hermitian)
    before = launches("member_sweep_launch")
    out = msw.sweep_expm_magnus2_member(
        p["static"], p["ops"], p["omega"], p["coef"][magnus].astype(real),
        torch.as_tensor(p["y0"]), dt=DT, t0=T0, hermitian=hermitian, magnus=magnus,
    )
    assert launches("member_sweep_launch") == before  # CPU tensors: the plain version
    assert out.dtype == (torch.complex128 if real == np.float64 else torch.complex64)
    assert_rel_close(out, expected, tol)


@pytest.mark.parametrize("magnus", [2, 3])
def test_plain_matches_eager_engine(magnus):
    """The plain version and the eager engine compute the same polynomial."""
    p = problem(False)
    args = (p["static"], p["ops"], p["omega"], p["coef"][magnus], torch.as_tensor(p["y0"]))
    plain = msw.sweep_expm_magnus2_member(*args, dt=DT, t0=T0, magnus=magnus)
    engine = xla_sweep.sweep_expm_magnus2_xla(*args, dt=DT, t0=T0, magnus_order=magnus)
    assert_rel_close(plain, engine, 1e-12)


@pytest.mark.parametrize(
    "change, error, message",
    [({"magnus": 4}, ValueError, "magnus must be 2 or 3"),
     ({"magnus": 3}, ValueError, "Gauss-point"),
     ({"coef": np.zeros((T, 2, K))}, ValueError, r"\(T, magnus, k, B\)"),
     ({"y0": np.zeros((N + 1, B), dtype=complex)}, ValueError, "shape mismatch")],
)
def test_wrapper_validation(change, error, message):
    p = problem(False)
    coef = change.pop("coef", p["coef"][2])
    y0 = torch.as_tensor(change.pop("y0", p["y0"]))
    with pytest.raises(error, match=message):
        msw.sweep_expm_magnus2_member(p["static"], p["ops"], p["omega"], coef, y0, dt=DT, **change)


def _weights():
    gen = rng(302)
    return gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B))


@pytest.mark.parametrize("magnus", [2, 3])
def test_member_ad_gradient_matches_jax_vjp(magnus):
    p = problem(True)
    weights = _weights()

    def jax_loss(s, o, c, y):
        final = jax_xla(s, o, p["omega"], c, y, dt=DT, t0=T0, hermitian=True,
                        magnus_order=magnus)
        return jnp.sum(jnp.real(jnp.conj(weights) * final))

    expected = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        p["static"], p["ops"], p["coef"][magnus], p["y0"]
    )
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (p["static"], p["ops"], p["coef"][magnus], p["y0"])]
    final = sweep_expm_magnus2_member_ad(
        leaves[0], leaves[1], torch.as_tensor(p["omega"]), leaves[2], leaves[3], DT, T0, 8,
        True, magnus,
    )
    torch.sum(torch.real(torch.as_tensor(weights).conj() * final)).backward()
    for leaf, want in zip(leaves, expected):
        # torch's gradient of a real loss in a complex input is the conjugate of JAX's
        want = np.asarray(want)
        assert_rel_close(leaf.grad, np.conj(want) if np.iscomplexobj(want) else want, 1e-10)


def test_member_ad_gradient_central_difference():
    p = problem(False)
    weights = torch.as_tensor(_weights())
    coef = p["coef"][3]

    def loss(c):
        out = sweep_expm_magnus2_member_ad(
            torch.as_tensor(p["static"]), torch.as_tensor(p["ops"]), torch.as_tensor(p["omega"]),
            c, torch.as_tensor(p["y0"]), DT, T0, 8, False, 3,
        )
        return torch.sum(torch.real(weights.conj() * out))

    c = torch.tensor(coef, requires_grad=True)
    loss(c).backward()
    h = 1e-6
    for idx in [(0, 0, 0, 0), (3, 2, 1, 4), (5, 1, 1, 2)]:
        up, down = coef.copy(), coef.copy()
        up[idx] += h
        down[idx] -= h
        fd = (loss(torch.as_tensor(up)) - loss(torch.as_tensor(down))).item() / (2 * h)
        assert abs(c.grad[idx].item() - fd) <= 1e-6 * max(1.0, abs(fd)), (idx, c.grad[idx], fd)


# --- fused_sweep_solve on the dim-4 Lindblad model (solve_dim 16) ------------
def _lindblad_arrays(dim=4):
    a_op = np.diag(np.sqrt(np.arange(1, dim)), 1)
    N_op = np.diag(np.arange(dim, dtype=float))
    H0 = 2 * np.pi * (5.0 * N_op - 0.33 / 2 * (N_op @ N_op - N_op))
    Hd = 2 * np.pi * 0.02 * (a_op + a_op.conj().T)
    rho0 = np.zeros((dim, dim), dtype=complex)
    rho0[1, 1] = 1.0
    return dict(static_hamiltonian=H0, hamiltonian_operators=[Hd],
                static_dissipators=[np.sqrt(0.01) * a_op], rotating_frame=np.diag(H0)), rho0


@pytest.fixture(scope="module")
def lindblad_pair():
    arrays, rho0 = _lindblad_arrays()
    jsolver = JaxSolver(vectorized=True, **arrays)
    tsolver = Solver(vectorized=True, device="cpu", **arrays)
    return jsolver, tsolver, rho0


def _jsig(amp):
    return ([JaxSignal(lambda t: amp, carrier_freq=5.0)], None)


def _tsig(amp):
    return ([Signal(lambda t: amp, carrier_freq=5.0)], None)


AMPS = np.linspace(0.2, 1.0, 3)


@pytest.mark.parametrize("magnus_order", [2, 3])
def test_member_engine_matches_jax_and_dop853(lindblad_pair, magnus_order):
    jsolver, tsolver, rho0 = lindblad_pair
    kw = dict(t_span=(0.0, 5.0), max_dt=0.05, y0=rho0, magnus_order=magnus_order)
    expected = np.asarray(jax_fused_sweep_solve(
        jsolver.model, _jsig, jnp.asarray(AMPS), sweep_engine="xla", **kw
    ))
    out = fused_sweep_solve(tsolver.model, _tsig, torch.as_tensor(AMPS), sweep_engine="member",
                            **kw)
    assert out.shape == expected.shape == (3, 4, 4)
    np.testing.assert_allclose(to_np(out), expected, rtol=0, atol=2e-5)
    if magnus_order == 3:
        for i, a in enumerate(AMPS):
            ref = tsolver.solve(t_span=[0.0, 5.0], y0=rho0, method="DOP853", atol=1e-13,
                                rtol=1e-13, signals=[Signal(float(a), carrier_freq=5.0)])
            assert np.max(np.abs(to_np(out[i]) - ref.y[-1])) < 5e-6


def test_member_engine_gradient(lindblad_pair):
    jsolver, tsolver, rho0 = lindblad_pair
    kw = dict(t_span=(0.0, 2.0), max_dt=0.05, y0=rho0, magnus_order=3)

    def jax_loss(a):
        yf = jax_fused_sweep_solve(jsolver.model, _jsig, a, sweep_engine="xla", **kw)
        return jnp.mean(jnp.abs(yf[:, 1, 1]) ** 2)

    expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(AMPS)))

    def loss(a):
        yf = fused_sweep_solve(tsolver.model, _tsig, a, sweep_engine="member", **kw)
        return torch.mean(yf[:, 1, 1].abs() ** 2)

    amps = torch.tensor(AMPS, requires_grad=True)
    loss(amps).backward()
    assert_rel_close(amps.grad, expected, 1e-5 * np.max(np.abs(expected)))
    # central differences of the JAX float64 solve (the float32 forward is too
    # coarse to difference)
    eps = 1e-6
    fd = (float(jax_loss(jnp.asarray(AMPS) + eps)) - float(jax_loss(jnp.asarray(AMPS) - eps)))
    np.testing.assert_allclose(float(amps.grad.sum()), fd / (2 * eps), rtol=1e-4)


@pytest.mark.parametrize(
    "magnus_order, solve_dim, member_ok, expected",
    [(2, 16, True, "pallas"), (2, 32, False, "pallas"), (2, 33, True, "member"),
     (2, 64, False, "xla"), (2, 128, True, "member"), (2, 129, True, "poly"),
     (3, 16, True, "member"), (3, 64, True, "member"), (3, 64, False, "xla"),
     (3, 65, True, "xla"), (3, 128, True, "xla"), (3, 256, False, "poly")],
)
def test_auto_dispatch_table(magnus_order, solve_dim, member_ok, expected):
    """``sweep_engine="auto"`` follows the JAX package's table (its condition
    "backend is TPU or interpret" read as always true)."""
    assert _select_engine("auto", magnus_order, solve_dim, member_ok) == expected


def test_auto_dispatch_runs_the_chosen_engine(lindblad_pair, monkeypatch):
    """On the solve_dim-16 model: Magnus-2 auto runs B2's plain version,
    Magnus-3 auto the member plain version, and with ``t_eval`` the eager
    engine; the polynomial engine above 128 is covered by its own file."""
    _, tsolver, rho0 = lindblad_pair
    calls = []
    for name, module, attr in [("pallas", ssw, "sweep_expm_magnus2_plain"),
                               ("member", msw, "sweep_expm_magnus2_member_plain"),
                               ("xla", xla_sweep, "sweep_expm_magnus2_xla")]:
        def spy(*args, _name=name, _fn=getattr(module, attr), **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, attr, spy)
    kw = dict(t_span=(0.0, 0.5), max_dt=0.05, y0=rho0)
    amps = torch.as_tensor(AMPS)
    fused_sweep_solve(tsolver.model, _tsig, amps, magnus_order=2, **kw)
    fused_sweep_solve(tsolver.model, _tsig, amps, magnus_order=3, **kw)
    fused_sweep_solve(tsolver.model, _tsig, amps, magnus_order=3, t_eval=[0.25, 0.5], **kw)
    assert calls == ["pallas", "member", "xla"]
    assert launches("horner_apply_launch") == launches("member_sweep_launch") == 0


@pytest.mark.parametrize(
    "kwargs, message",
    [({"sweep_engine": "pallas", "magnus_order": 3}, "lanes"),
     ({"magnus_order": 4}, "magnus_order"),
     ({"sweep_engine": "member", "t_eval": [0.5, 1.0]}, "vector initial states without t_eval"),
     ({"sweep_engine": "bogus"}, "unknown sweep_engine")],
)
def test_engine_errors(lindblad_pair, kwargs, message):
    _, tsolver, rho0 = lindblad_pair
    with pytest.raises(DynamicsError, match=message):
        fused_sweep_solve(tsolver.model, _tsig, torch.ones(2, dtype=torch.float64),
                          t_span=(0.0, 1.0), max_dt=0.05, y0=rho0, **kwargs)


def test_member_engine_rejects_matrix_state_and_large_magnus3():
    gen = rng(303)
    model = Solver(random_hermitian(gen, 4), [random_hermitian(gen, 4)], device="cpu").model
    sig = lambda a: [Signal(a)]  # noqa: E731
    with pytest.raises(DynamicsError, match="vector initial states"):
        fused_sweep_solve(model, sig, torch.tensor([0.1]), (0.0, 1.0), 0.5,
                          np.eye(4, dtype=complex), sweep_engine="member")
    assert _select_engine("member", 2, 128, True) == "member"
    with pytest.raises(DynamicsError, match="solve_dim <= 64"):
        _select_engine("member", 3, 65, True)


def test_ignored_kernel_options_warn(lindblad_pair):
    _, tsolver, rho0 = lindblad_pair
    with pytest.warns(UserWarning, match="magnus_mode and tile_b"):
        fused_sweep_solve(tsolver.model, _tsig, torch.as_tensor(AMPS), t_span=(0.0, 0.2),
                          max_dt=0.05, y0=rho0, sweep_engine="member", tile_b=8)
