"""Parity of the port's polynomial engine (the Magnus expansion, kernel B4's
plain version with its autograd wrapper, ``sweep_expm_magnus_poly`` and the
``sweep_engine="poly"`` route of ``fused_sweep_solve``) with the JAX package.

Tolerances and their reasons:

- Plain B4 in float64 against the JAX Pallas kernel (interpret mode, x64):
  1e-10 (the same polynomial; the JAX kernel multiplies row vectors into the
  planes separately, so sums run in another order). Against scipy's
  ``expm(M) v`` at ``|M| ~ 0.3``: 1e-9, the order-12 Taylor remainder.
- ``expand_magnus_polynomial``: the same monomial index table (exact) and the
  same matrices within 1e-12 (the port keeps its own copy of the host code).
- ``sweep_expm_magnus_poly`` in float64 against the JAX one (x64): 1e-10;
  they differ in the frame phase only (the port reduces it mod 2 pi).
  Against the port's eager engine at n = 12: 1e-10 (the expansion reorders
  the commutator sums).
- ``fused_sweep_solve(sweep_engine="poly")`` on the dim-4 Lindblad model
  against the JAX package (x64): 2e-5, the port runs float32; against
  DOP853(1e-13): 5e-6. Gradients: 1e-5 of max |g| against the JAX gradient.

The JAX Pallas Horner kernel is run in interpret mode twice: once alone, once
inside the JAX polynomial sweep.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from torch_parity import assert_rel_close, rng, to_np

from qiskit_dynamics_tpu import Signal as JaxSignal, Solver as JaxSolver
from qiskit_dynamics_tpu.ops.horner_pallas import horner_apply_bm as jax_horner
from qiskit_dynamics_tpu.ops.polynomial_sweep import (
    expand_magnus_polynomial as jax_expand,
    sweep_expm_magnus_poly as jax_poly,
)
from qiskit_dynamics_tpu.solvers import fused_sweep_solve as jax_fused_sweep_solve

from qiskit_dynamics_tpu_torch import Signal, Solver
from qiskit_dynamics_tpu_torch.ops import horner_pallas as hp
from qiskit_dynamics_tpu_torch.ops import polynomial_sweep as psw
from qiskit_dynamics_tpu_torch.ops.xla_sweep import sweep_expm_magnus2_xla
from qiskit_dynamics_tpu_torch.solvers import fused_sweep_solve
from qiskit_dynamics_tpu_torch.solvers.fused_sweep import _select_engine

N, T, B = 6, 6, 5
DT, T0 = 0.1, 0.3
SLOTS = (-1, 0, -1, 1, -1, 2)


# --- kernel B4's plain version ----------------------------------------------
@pytest.fixture(scope="module")
def horner_inputs():
    gen = rng(401)
    planes = 0.3 / np.sqrt(N) * gen.normal(size=(2, B, N, N))
    v = gen.normal(size=(2, B, N))
    return planes[0], planes[1], v[0], v[1]


def test_horner_plain_matches_jax_pallas(horner_inputs):
    expected = jax_horner(*[jnp.asarray(x) for x in horner_inputs], order=8, interpret=True)
    before = hp.horner_apply_bm.launches
    out = hp.horner_apply_bm(*[torch.as_tensor(x) for x in horner_inputs], order=8)
    assert hp.horner_apply_bm.launches == before  # CPU tensors: the plain version
    for got, want in zip(out, expected):
        assert got.dtype == torch.float64
        assert_rel_close(got, np.asarray(want), 1e-10)


@pytest.mark.parametrize("real, tol", [(np.float64, 1e-9), (np.float32, 2e-6)])
def test_horner_plain_matches_expm(horner_inputs, real, tol):
    MTr, MTi, vr, vi = horner_inputs
    ur, ui = hp.horner_apply_bm(*[torch.as_tensor(x.astype(real)) for x in horner_inputs],
                                order=12)
    M = np.swapaxes(MTr + 1j * MTi, 1, 2)
    expected = np.stack([scipy.linalg.expm(M[b]) @ (vr[b] + 1j * vi[b]) for b in range(B)])
    assert_rel_close(torch.complex(ur, ui), expected, tol)


def test_horner_ad_gradient_is_the_plain_versions(horner_inputs):
    leaves = [torch.tensor(x, requires_grad=True) for x in horner_inputs]
    twins = [torch.tensor(x, requires_grad=True) for x in horner_inputs]
    ur, ui = hp.horner_apply_bm_ad(*leaves, order=8)
    plain_r, plain_i = hp.horner_twin_bm(*twins, order=8)
    (ur.sum() + 2.0 * ui.sum()).backward()
    (plain_r.sum() + 2.0 * plain_i.sum()).backward()
    for got, want in zip(leaves, twins):
        assert_rel_close(got.grad, want.grad, 1e-14)


@pytest.mark.parametrize(
    "change, error, message",
    [({"order": 0}, ValueError, "order must be >= 1"),
     ({"vi": np.zeros((B, N + 1))}, ValueError, "shape mismatch"),
     ({"vi": np.zeros((B, N), dtype=np.float32)}, TypeError, "one real floating dtype")],
)
def test_horner_validation(horner_inputs, change, error, message):
    MTr, MTi, vr, vi = [torch.as_tensor(x) for x in horner_inputs]
    order = change.pop("order", 8)
    vi = torch.as_tensor(change.get("vi", vi))
    with pytest.raises(error, match=message):
        hp.horner_apply_bm(MTr, MTi, vr, vi, order=order)


# --- the host expansion --------------------------------------------------------
def _operators(n, k, seed):
    gen = rng(seed)
    mats = (gen.normal(size=(k + 1, n, n)) + 1j * gen.normal(size=(k + 1, n, n))) / 2
    d = 1j * gen.uniform(0.0, 5.0, n)
    return mats[0], mats[1:], d


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("magnus_order", [2, 3])
def test_expansion_matches_jax(magnus_order, k):
    static, ops, d = _operators(4, k, 402 + k)
    mon_index, X = psw.expand_magnus_polynomial(static, ops, d, DT, magnus_order)
    want_index, want_X = jax_expand(static, ops, d, DT, magnus_order)
    assert mon_index.dtype == want_index.dtype == np.int32
    np.testing.assert_array_equal(mon_index, want_index)
    assert_rel_close(X, want_X, 1e-12)
    with pytest.raises(ValueError, match="magnus_order"):
        psw.expand_magnus_polynomial(static, ops, d, DT, 4)


# --- sweep_expm_magnus_poly ---------------------------------------------------
@pytest.fixture(scope="module")
def sweep_inputs():
    static, ops, d = _operators(N, 2, 410)
    gen = rng(411)
    y0 = gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B))
    return dict(static=static, ops=ops, d=d,
                coef={2: gen.normal(size=(T, 2, 2, B)), 3: gen.normal(size=(T, 3, 2, B))},
                y0=y0 / np.linalg.norm(y0, axis=0),
                y0_bm=np.stack([np.eye(N, 3, k=-1, dtype=complex)] * B))


@pytest.mark.parametrize(
    "magnus_order, layout, horner",
    [(2, "lanes", "einsum"), (3, "lanes", "einsum"), (3, "batch_major", "einsum"),
     (3, "lanes", "pallas")],
)
def test_poly_sweep_matches_jax(sweep_inputs, magnus_order, layout, horner):
    p = sweep_inputs
    y0 = p["y0"] if layout == "lanes" else p["y0_bm"]
    kw = dict(dt=DT, t0=T0, eval_slots=SLOTS, magnus_order=magnus_order, horner=horner)
    expected = jax_poly(p["static"], p["ops"], p["d"], p["coef"][magnus_order], y0,
                        interpret=horner == "pallas", **kw)
    out = psw.sweep_expm_magnus_poly(p["static"], p["ops"], p["d"], p["coef"][magnus_order],
                                     torch.as_tensor(y0), **kw)
    for got, want in zip(out, expected):
        assert got.dtype == torch.complex128
        assert_rel_close(got, np.asarray(want), 1e-10)


@pytest.mark.parametrize("magnus_order", [2, 3])
@pytest.mark.parametrize("horner", ["einsum", "pallas"])
def test_poly_sweep_matches_eager_engine_unaligned(magnus_order, horner):
    """n = 12: a dimension no kernel tiling divides."""
    n = 12
    static, ops, d = _operators(n, 1, 420)
    gen = rng(421)
    coef = gen.normal(size=(T, magnus_order, 1, B))
    y0 = gen.normal(size=(n, B)) + 1j * gen.normal(size=(n, B))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0))
    w = -np.imag(d)  # omega[a, c] = w_c - w_a carries the frame diagonal d = -i w
    omega = w[None, :] - w[:, None]
    out = psw.sweep_expm_magnus_poly(static, ops, d, coef, y0, dt=DT, t0=T0,
                                     magnus_order=magnus_order, horner=horner)
    engine = sweep_expm_magnus2_xla(static, ops, omega, coef, y0, dt=DT, t0=T0,
                                    magnus_order=magnus_order)
    assert_rel_close(out, engine, 1e-10)


def test_poly_sweep_no_frame_and_float32(sweep_inputs):
    p = sweep_inputs
    coef = p["coef"][2]
    y0 = torch.as_tensor(p["y0"])
    out64 = psw.sweep_expm_magnus_poly(p["static"], p["ops"], None, coef, y0, dt=DT)
    engine = sweep_expm_magnus2_xla(p["static"], p["ops"], np.zeros((N, N)), coef, y0, dt=DT)
    assert_rel_close(out64, engine, 1e-10)
    out32 = psw.sweep_expm_magnus_poly(p["static"], p["ops"], None, coef.astype(np.float32), y0,
                                       dt=DT)
    assert out32.dtype == torch.complex64
    assert_rel_close(out32, engine, 2e-5)


def test_poly_horner_auto_and_validation(sweep_inputs, monkeypatch):
    """``horner="auto"`` takes the kernel route for single-column float32
    states at n >= 64 only; ``"pallas"`` refuses matrix states."""
    p = sweep_inputs
    calls = []
    real_ad = psw.horner_apply_bm_ad
    monkeypatch.setattr(psw, "horner_apply_bm_ad",
                        lambda *a, **k: calls.append(1) or real_ad(*a, **k))
    args = (p["static"], p["ops"], p["d"])
    coef32 = p["coef"][2][:2].astype(np.float32)
    psw.sweep_expm_magnus_poly(*args, coef32, torch.as_tensor(p["y0"]), dt=DT)
    assert not calls  # n = 6 < 64
    monkeypatch.setattr(psw, "KERNEL_MIN_N", N)
    psw.sweep_expm_magnus_poly(*args, coef32, torch.as_tensor(p["y0"]), dt=DT)
    assert len(calls) == 2  # one call per step
    psw.sweep_expm_magnus_poly(*args, p["coef"][2][:2], torch.as_tensor(p["y0"]), dt=DT)
    psw.sweep_expm_magnus_poly(*args, coef32, torch.as_tensor(p["y0_bm"]), dt=DT)
    assert len(calls) == 2  # float64, and matrix states, take einsum
    with pytest.raises(ValueError, match="single-column"):
        psw.sweep_expm_magnus_poly(*args, coef32, torch.as_tensor(p["y0_bm"]), dt=DT,
                                   horner="pallas")
    with pytest.raises(ValueError, match="horner must be"):
        psw.sweep_expm_magnus_poly(*args, coef32, torch.as_tensor(p["y0"]), dt=DT, horner="vpu")


@pytest.mark.parametrize("horner", ["einsum", "pallas"])
def test_poly_sweep_gradient_central_difference(sweep_inputs, horner):
    p = sweep_inputs
    gen = rng(430)
    weights = torch.as_tensor(gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B)))
    coef = p["coef"][3]

    def loss(c):
        out = psw.sweep_expm_magnus_poly(p["static"], p["ops"], p["d"], c,
                                         torch.as_tensor(p["y0"]), dt=DT, t0=T0, magnus_order=3,
                                         horner=horner)
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


# --- fused_sweep_solve(sweep_engine="poly") on the dim-4 Lindblad model ------
@pytest.fixture(scope="module")
def lindblad_pair():
    dim = 4
    a_op = np.diag(np.sqrt(np.arange(1, dim)), 1)
    N_op = np.diag(np.arange(dim, dtype=float))
    H0 = 2 * np.pi * (5.0 * N_op - 0.33 / 2 * (N_op @ N_op - N_op))
    arrays = dict(static_hamiltonian=H0,
                  hamiltonian_operators=[2 * np.pi * 0.02 * (a_op + a_op.conj().T)],
                  static_dissipators=[np.sqrt(0.01) * a_op], rotating_frame=np.diag(H0))
    rho0 = np.zeros((dim, dim), dtype=complex)
    rho0[1, 1] = 1.0
    return (JaxSolver(vectorized=True, **arrays), Solver(vectorized=True, device="cpu", **arrays),
            rho0)


def _jsig(amp):
    return ([JaxSignal(lambda t: amp, carrier_freq=5.0)], None)


def _tsig(amp):
    return ([Signal(lambda t: amp, carrier_freq=5.0)], None)


AMPS = np.linspace(0.2, 1.0, 3)


@pytest.mark.parametrize("case", ["magnus2", "magnus3", "magnus3_kernel_route", "t_eval"])
def test_poly_engine_matches_jax_and_dop853(lindblad_pair, case):
    jsolver, tsolver, rho0 = lindblad_pair
    kw = dict(t_span=(0.0, 5.0), max_dt=0.05, y0=rho0, magnus_order=2 if case == "magnus2" else 3)
    if case == "t_eval":
        kw["t_eval"] = [0.0, 2.5, 5.0]
    expected = np.asarray(jax_fused_sweep_solve(
        jsolver.model, _jsig, jnp.asarray(AMPS), sweep_engine="poly", **kw
    ))
    extra = {"poly_horner": "pallas"} if case == "magnus3_kernel_route" else {}
    out = fused_sweep_solve(tsolver.model, _tsig, torch.as_tensor(AMPS), sweep_engine="poly",
                            **extra, **kw)
    assert out.shape == expected.shape
    np.testing.assert_allclose(to_np(out), expected, rtol=0, atol=2e-5)
    if case.startswith("magnus3"):
        for i, a in enumerate(AMPS):
            ref = tsolver.solve(t_span=[0.0, 5.0], y0=rho0, method="DOP853", atol=1e-13,
                                rtol=1e-13, signals=[Signal(float(a), carrier_freq=5.0)])
            assert np.max(np.abs(to_np(out[i]) - ref.y[-1])) < 5e-6


@pytest.mark.parametrize("poly_horner", ["einsum", "pallas"])
def test_poly_engine_gradient(lindblad_pair, poly_horner):
    jsolver, tsolver, rho0 = lindblad_pair
    kw = dict(t_span=(0.0, 1.0), max_dt=0.05, y0=rho0, magnus_order=3, sweep_engine="poly")

    def jax_loss(a):
        return jnp.mean(jnp.abs(jax_fused_sweep_solve(jsolver.model, _jsig, a, **kw)[:, 1, 1]))

    expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(AMPS)))
    amps = torch.tensor(AMPS, requires_grad=True)
    out = fused_sweep_solve(tsolver.model, _tsig, amps, poly_horner=poly_horner, **kw)
    torch.mean(out[:, 1, 1].abs()).backward()
    assert_rel_close(amps.grad, expected, 1e-5 * np.max(np.abs(expected)))
    eps = 1e-6
    fd = (float(jax_loss(jnp.asarray(AMPS) + eps)) - float(jax_loss(jnp.asarray(AMPS) - eps)))
    np.testing.assert_allclose(float(amps.grad.sum()), fd / (2 * eps), rtol=1e-4)


def test_auto_dispatch_picks_poly_above_128(monkeypatch):
    """A solve_dim-144 Lindblad model on ``sweep_engine="auto"`` goes to the
    polynomial engine, whose ``horner="auto"`` takes the kernel route."""
    dim = 12
    a_op = np.diag(np.sqrt(np.arange(1, dim)), 1)
    H0 = 2 * np.pi * 5.0 * np.diag(np.arange(dim, dtype=float))
    solver = Solver(static_hamiltonian=H0,
                    hamiltonian_operators=[2 * np.pi * 0.02 * (a_op + a_op.conj().T)],
                    static_dissipators=[np.sqrt(0.01) * a_op], rotating_frame=np.diag(H0),
                    vectorized=True, device="cpu")
    rho0 = np.zeros((dim, dim), dtype=complex)
    rho0[1, 1] = 1.0
    assert _select_engine("auto", 2, dim * dim, True) == "poly"
    calls = []
    real_ad = psw.horner_apply_bm_ad
    monkeypatch.setattr(psw, "horner_apply_bm_ad",
                        lambda *a, **k: calls.append(1) or real_ad(*a, **k))
    out = fused_sweep_solve(solver.model, _tsig, torch.tensor([0.5], dtype=torch.float64),
                            t_span=(0.0, 0.1), max_dt=0.05, y0=rho0)
    assert len(calls) == 2  # two steps, one Horner call each
    assert out.shape == (1, dim, dim)
    assert abs(float(torch.diagonal(out[0]).sum().real) - 1.0) < 1e-5
