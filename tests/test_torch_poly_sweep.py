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

The prepared-expansion cache (no JAX): a repeated call is a hit, bit for bit
the uncached output, and reads back only the frame diagonal; an in-place or
new operand, another frame or ``dt``, misses; routes and dtypes keep separate
entries; the cache holds at most its cap and frees what it evicts.

The JAX Pallas Horner kernel is run in interpret mode twice: once alone, once
inside the JAX polynomial sweep.
"""
import weakref

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
from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import horner_pallas as hp
from qiskit_dynamics_tpu_torch.ops import polynomial_sweep as psw
from qiskit_dynamics_tpu_torch.ops.xla_sweep import sweep_expm_magnus2_xla
from qiskit_dynamics_tpu_torch.solvers import fused_sweep_solve
from qiskit_dynamics_tpu_torch.solvers.fused_sweep import _select_engine
from qiskit_dynamics_tpu_torch.utils import lru, metrics

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
    before = launches("horner_apply_launch")
    out = hp.horner_apply_bm(*[torch.as_tensor(x) for x in horner_inputs], order=8)
    assert launches("horner_apply_launch") == before  # CPU tensors: the plain version
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


# --- the prepared-expansion cache --------------------------------------------
@pytest.fixture
def cache_inputs():
    """Operands as the fused sweep passes them (tensors), with the cache and
    the counters empty before and after."""
    psw._PREPARED_CACHE.clear()
    psw._EXPANSION_CACHE.clear()
    metrics.disable_metrics(clear=True)
    metrics.enable_metrics()
    static, ops, d = _operators(N, 2, 440)
    gen = rng(441)
    y0 = gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B))
    yield dict(static=torch.as_tensor(static), ops=torch.as_tensor(ops), d=torch.as_tensor(d),
               coef=torch.as_tensor(gen.normal(size=(T, 3, 2, B))),
               y0=torch.as_tensor(y0 / np.linalg.norm(y0, axis=0)))
    metrics.disable_metrics(clear=True)
    psw._PREPARED_CACHE.clear()
    psw._EXPANSION_CACHE.clear()


def _cached_solve(p, horner="einsum", real=torch.float64, **change):
    q = {**p, **change}
    return psw.sweep_expm_magnus_poly(q["static"], q["ops"], q["d"], q["coef"].to(real), q["y0"],
                                      dt=q.get("dt", DT), t0=T0, magnus_order=3, horner=horner)


def _uncached_solve(p, **kw):
    psw._PREPARED_CACHE.clear()
    psw._EXPANSION_CACHE.clear()
    return _cached_solve(p, **kw)


def _lookups():
    got = metrics.counters()
    return got.get("poly.expansion_misses", 0), got.get("poly.expansion_hits", 0)


ROUTES = [("einsum", torch.float64), ("einsum", torch.float32), ("pallas", torch.float64),
          ("pallas", torch.float32)]


@pytest.mark.parametrize("horner, real", ROUTES)
def test_prepared_cache_hit_is_bit_identical(cache_inputs, horner, real):
    first = _cached_solve(cache_inputs, horner, real)
    second = _cached_solve(cache_inputs, horner, real)
    assert _lookups() == (1, 1)
    assert torch.equal(first, second)
    assert torch.equal(second, _uncached_solve(cache_inputs, horner=horner, real=real))
    for entry in psw._PREPARED_CACHE.values():
        assert not any(x.requires_grad for x in entry[:4])


def test_prepared_cache_keys_inference_tensors_by_value(cache_inputs):
    """Tensors made under ``torch.inference_mode`` keep no version counter:
    they are keyed by value, so an equal copy hits and another value misses."""
    p = cache_inputs
    with torch.inference_mode():
        frozen = {name: p[name].clone() for name in ("static", "ops")}
        first = _cached_solve(p, **frozen)
        again = _cached_solve(p, ops=frozen["ops"].clone(), static=frozen["static"])
        other = _cached_solve(p, ops=2 * frozen["ops"], static=frozen["static"])
    assert _lookups() == (2, 1)
    assert torch.equal(first, again) and not torch.equal(first, other)


def test_prepared_cache_routes_and_dtypes_are_separate_entries(cache_inputs):
    outs = [_cached_solve(cache_inputs, horner, real) for horner, real in ROUTES]
    assert _lookups() == (len(ROUTES), 0)
    assert len(psw._PREPARED_CACHE) == len(ROUTES)
    assert len(psw._EXPANSION_CACHE) == 1  # one float64 expansion serves all four
    again = [_cached_solve(cache_inputs, horner, real) for horner, real in ROUTES]
    assert _lookups() == (len(ROUTES), len(ROUTES))
    for (horner, real), out, hit in zip(ROUTES, outs, again):
        assert out.dtype == (torch.complex128 if real == torch.float64 else torch.complex64)
        assert torch.equal(out, hit)
        assert torch.equal(out, _uncached_solve(cache_inputs, horner=horner, real=real))


def test_prepared_cache_hit_reads_back_only_the_frame_diagonal(cache_inputs, monkeypatch):
    """On a hit nothing of the operators' size comes back to the host,
    through the module's ``to_numpy`` or a tensor's ``.cpu()``/``.numpy()``."""
    shapes = []
    real_to_numpy = psw.to_numpy
    monkeypatch.setattr(psw, "to_numpy", lambda x: shapes.append(tuple(x.shape)) or
                        real_to_numpy(x))

    class Readbacks(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.Tensor.cpu, torch.Tensor.numpy):
                shapes.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    _cached_solve(cache_inputs, "pallas", torch.float32)
    assert (N, N) in shapes and (2, N, N) in shapes  # the miss reads the operators
    shapes.clear()
    with Readbacks():
        _cached_solve(cache_inputs, "pallas", torch.float32)
    assert _lookups() == (1, 1)
    assert shapes and set(shapes) == {(N,)}


def _bump_static(p):
    p["static"].add_(0.1 * p["static"].conj().T)


@pytest.mark.parametrize("case", ["ops_in_place", "static_in_place", "new_tensor", "numpy",
                                  "frame", "dt"])
def test_prepared_cache_misses_on_any_change(cache_inputs, case):
    p = cache_inputs
    if case == "numpy":
        p["static"], p["ops"] = p["static"].numpy().copy(), p["ops"].numpy().copy()
    before = _cached_solve(p)
    change = {}
    if case == "ops_in_place":
        p["ops"].mul_(2)
    elif case == "static_in_place":
        _bump_static(p)
    elif case == "new_tensor":
        change["ops"] = 2 * p["ops"]
    elif case == "numpy":
        p["static"][0, 1] += 0.25  # the same array object, another value
    elif case == "frame":
        change["d"] = p["d"] * 1.5
    else:
        change["dt"] = 0.5 * DT
    after = _cached_solve(p, **change)
    assert _lookups() == (2, 0)
    assert not torch.equal(before, after)
    assert torch.equal(after, _uncached_solve(p, **change))


def test_prepared_cache_is_bounded(cache_inputs):
    p = cache_inputs
    cap = lru.ENTRIES
    _cached_solve(p)
    evicted = weakref.ref(next(iter(psw._PREPARED_CACHE.values()))[1])
    outs = [_cached_solve(p, ops=p["ops"] * (1 + 0.1 * i)) for i in range(cap + 2)]
    assert _lookups() == (cap + 3, 0)
    assert len(psw._PREPARED_CACHE) == cap and len(psw._EXPANSION_CACHE) == cap
    assert evicted() is None  # an evicted entry's planes are freed
    # the earliest entries went first, and come back equal to what they gave
    again = _cached_solve(p, ops=p["ops"] * 1.0)
    assert _lookups() == (cap + 4, 0)
    assert torch.equal(again, outs[0])


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
