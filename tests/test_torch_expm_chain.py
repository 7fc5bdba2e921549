"""Parity of the port's expm chain slice with the JAX package: ``expm_taylor``,
kernel B9's plain version, ``benchmarks.expm_chain``, ``rabi_solver``, and the
``frame_omega`` gradient of the fixed-step sweep.

Tolerances and their reasons:

- ``expm_taylor`` against the JAX function (x64), complex128: 1e-12. The
  same coefficients and evaluation order; the products are summed in
  another order.
- B9's plain version against the JAX Pallas kernel in interpret mode (x64):
  1e-12. The JAX kernel forms its complex products as one real product of
  stacked real and imaginary parts; the sums differ in order only.
- The two ``expm_chain`` engines on the CPU: bit for bit (the CPU path of
  the kernel's wrapper is the plain version, which is the engine's loop).
- The ``frame_omega`` gradient of ``sweep_expm_magnus2_ad`` (float64, n = 4,
  k = 2, 20 steps) against ``jax.grad`` of the JAX XLA engine, which is the
  JAX package's backward of ``sweep_expm_magnus2_ad``: 1e-10 relative to
  max |g| (reverse-mode sums in another order). Under x64 the JAX engine
  forms its phases in float64 (its float32 hi/lo split is inactive), so its
  gradient is the exact derivative of the same polynomial.

The JAX Pallas kernel runs in interpret mode three times (n <= 8, T <= 4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, random_hermitian, rng, to_np

from qiskit_dynamics_tpu import Signal as JaxSignal
from qiskit_dynamics_tpu.benchmarks import rabi_solver as jax_rabi_solver
from qiskit_dynamics_tpu.ops.expm import expm_taylor as jax_expm_taylor
from qiskit_dynamics_tpu.ops.expm_chain_pallas import expm_chain_fused as jax_expm_chain_fused
from qiskit_dynamics_tpu.ops.xla_sweep import sweep_expm_magnus2_xla as jax_xla

from qiskit_dynamics_tpu_torch import Signal
from qiskit_dynamics_tpu_torch.benchmarks import expm_chain, rabi_solver
from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops.expm import expm_taylor
from qiskit_dynamics_tpu_torch.ops.expm_chain_pallas import (
    expm_chain_fused,
    expm_chain_fused_plain,
)
from qiskit_dynamics_tpu_torch.ops.sweep_ad import (
    sweep_expm_magnus2_ad,
    sweep_expm_magnus2_member_ad,
)

TOL = 1e-12


def random_chain(T, b, n, m, seed, herm=False):
    """(T, b, n, n) generators of Frobenius norm 2 and (b, n, m) states, as
    the JAX package's B9 tests make them."""
    gen = np.random.default_rng(seed)
    G = gen.normal(size=(T, b, n, n)) + 1j * gen.normal(size=(T, b, n, n))
    if herm:
        G = -0.5j * (G + np.conj(np.swapaxes(G, -1, -2)))
    G = G / np.linalg.norm(G, axis=(-2, -1), keepdims=True) * 2.0
    y0 = gen.normal(size=(b, n, m)) + 1j * gen.normal(size=(b, n, m))
    return G, y0


@pytest.mark.parametrize("squarings", [0, 1, 2])
@pytest.mark.parametrize("order", [4, 6, 12])
def test_expm_taylor_matches_jax(order, squarings):
    gen = rng(order + 10 * squarings)
    A = 0.8 * (gen.normal(size=(3, 2, 5, 5)) + 1j * gen.normal(size=(3, 2, 5, 5)))
    out = expm_taylor(torch.as_tensor(A), order=order, squarings=squarings)
    assert out.shape == A.shape and out.dtype == torch.complex128
    assert_rel_close(out, np.asarray(jax_expm_taylor(A, order=order, squarings=squarings)), TOL)


@pytest.mark.parametrize(
    "order, squarings, unbatched", [(12, 1, False), (6, 0, False), (12, 2, True)]
)
def test_expm_chain_plain_matches_jax_pallas(order, squarings, unbatched):
    G, y0 = random_chain(T=4, b=2, n=8, m=5, seed=order + squarings)
    if unbatched:
        G, y0 = G[:, 0], y0[0]
    want = jax_expm_chain_fused(G, 0.9, y0, order=order, squarings=squarings, interpret=True)
    got = expm_chain_fused_plain(torch.as_tensor(G), 0.9, torch.as_tensor(y0), order, squarings)
    assert got.shape == y0.shape
    assert_rel_close(got, np.asarray(want), TOL)
    # on CPU tensors the wrapper is the plain version
    wrapped = expm_chain_fused(torch.as_tensor(G), 0.9, torch.as_tensor(y0), order, squarings)
    assert torch.equal(wrapped, got)


def test_expm_chain_engines_agree_on_cpu():
    G, y0 = random_chain(T=5, b=3, n=6, m=2, seed=7, herm=True)
    G, y0 = torch.as_tensor(G), torch.as_tensor(y0)
    before = launches("expm_chain_launch")
    xla = expm_chain(G, 0.7, y0, squarings=1, engine="xla")
    fused = expm_chain(G, 0.7, y0, squarings=1, engine="pallas")
    assert torch.equal(xla, fused)
    assert launches("expm_chain_launch") == before  # the CPU path launches no kernel
    # a batched (T, ..., n, n) chain beyond B9's shapes, on the xla engine
    G4 = G.reshape(5, 3, 1, 6, 6).expand(5, 3, 2, 6, 6)
    y4 = y0[:, None].expand(3, 2, 6, 2)
    assert_rel_close(expm_chain(G4, 0.7, y4, squarings=1)[:, 0], xla, TOL)
    with pytest.raises(ValueError, match="engine"):
        expm_chain(G, 0.7, y0, engine="mosaic")


def test_expm_chain_validation():
    G, y0 = random_chain(T=2, b=2, n=4, m=4, seed=3)
    G, y0 = torch.as_tensor(G), torch.as_tensor(y0)
    for fn in (expm_chain_fused, expm_chain_fused_plain):
        with pytest.raises(ValueError, match="order >= 6"):
            fn(G, 1.0, y0, order=5)
        with pytest.raises(ValueError, match="generators"):
            fn(G[0], 1.0, y0)
        with pytest.raises(ValueError, match="T >= 1"):
            fn(G[:0], 1.0, y0)
    with pytest.raises(TypeError, match="tensors"):
        expm_chain_fused(G.numpy(), 1.0, y0)


def test_rabi_solver_matches_jax():
    jsolver, nu = jax_rabi_solver()
    solver, nu2 = rabi_solver(device="cpu")
    assert nu == nu2
    y0 = np.array([1.0, 0.0], dtype=complex)
    kw = dict(t_span=[0.0, 0.5], y0=y0, method="DOP853", atol=1e-12, rtol=1e-12)
    want = jsolver.solve(signals=[JaxSignal(1.0, nu)], **kw).y
    got = solver.solve(signals=[Signal(1.0, nu)], **kw).y
    assert_rel_close(got, to_np(want), 1e-10)


N, K, T_STEPS, B = 4, 2, 20, 3
DT, T0 = 0.05, 0.2


@pytest.fixture(scope="module")
def sweep_problem():
    gen = rng(131)
    w = gen.uniform(0.0, 5.0, N)
    y0 = gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B))
    return dict(
        static=-1j * random_hermitian(gen, N),
        ops=np.stack([-1j * random_hermitian(gen, N) for _ in range(K)]),
        omega=w[None, :] - w[:, None],
        coef=gen.normal(size=(T_STEPS, 2, K, B)),
        y0=y0 / np.linalg.norm(y0, axis=0),
        weights=gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B)),
    )


def test_frame_omega_gradient_matches_jax(sweep_problem):
    p = sweep_problem
    kw = dict(dt=DT, t0=T0, order=8, hermitian=True)

    def jax_loss(omega):
        out = jax_xla(p["static"], p["ops"], omega, p["coef"], p["y0"], **kw)
        return jnp.sum(jnp.real(jnp.conj(p["weights"]) * out))

    want = np.asarray(jax.grad(jax_loss)(p["omega"]))
    assert np.all(np.isfinite(want)) and np.max(np.abs(want)) > 1e-3

    weights = torch.as_tensor(p["weights"])
    args = [torch.as_tensor(p[key]) for key in ("static", "ops", "omega", "coef", "y0")]
    for route in ("lanes", "member"):
        omega = args[2].clone().requires_grad_(True)
        if route == "lanes":
            out = sweep_expm_magnus2_ad(
                args[0], args[1], omega, args[3], args[4], mode="matrix_herm", tile_b=B, **kw)
        else:
            out = sweep_expm_magnus2_member_ad(args[0], args[1], omega, args[3], args[4], **kw)
        loss = torch.sum(torch.real(weights.conj() * out))
        (grad,) = torch.autograd.grad(loss, omega)
        assert grad is not None
        assert_rel_close(grad, want, 1e-10)
