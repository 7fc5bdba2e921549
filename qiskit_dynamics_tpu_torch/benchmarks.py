"""Benchmark models (counterpart of ``qiskit_dynamics_tpu/benchmarks.py``).

``cr_solver`` is the headline model: a two-transmon cross-resonance
``Solver`` (dim 16 at the default 4 levels per transmon) with a rotating
frame equal to diag(H0) and the RWA at the mean transmon frequency, the
model of the 10,000-point amplitude sweep. ``lindblad_qudit_solver`` and
``lindblad_two_transmon_solver`` are the two large-dimension vectorized
Lindblad models the JAX package benchmarks inline (``bench.py``, the dim-8 and
dim-256 rows). ``dyson_transmon_solver`` and ``magnus_transmon_solver`` are the
single-transmon perturbative solvers of BASELINE config 4. ``rabi_solver`` is
BASELINE config 1, and ``expm_chain`` the sustained expm-propagator chain
(kernel B9 and its cuBLAS yardstick). The JAX package's other benchmark models
are still to be ported (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .solvers import Solver

__all__ = [
    "cr_solver",
    "rabi_solver",
    "expm_chain",
    "lindblad_qudit_solver",
    "lindblad_two_transmon_solver",
    "dyson_transmon_solver",
    "magnus_transmon_solver",
]


def _transmon_ops(dim: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    a = np.diag(np.sqrt(np.arange(1, dim)), 1)
    adag = a.conj().T
    N = np.diag(np.arange(dim))
    return a, adag, N


def cr_solver(
    dim: int = 4,
    w0: float = 5.0,
    w1: float = 5.1,
    alpha0: float = -0.33,
    alpha1: float = -0.33,
    J: float = 0.002,
    rwa_cutoff_freq: Optional[float] = None,
    device=None,
    dtype: torch.dtype = torch.complex128,
):
    """Two-transmon cross-resonance Solver (drive on qubit 0 at qubit 1's freq).

    ``dim`` levels per transmon (total Hilbert dim ``dim**2``; dim=4 -> 16).
    Rotating frame = diagonal of the static Hamiltonian; the RWA cutoff
    defaults to the mean transmon frequency. ``device``/``dtype`` place the
    model's operators.

    Returns:
        (solver, drive_freq): the configured ``Solver`` and the CR drive
        carrier frequency (= target-qubit frequency).
    """
    a, adag, N = _transmon_ops(dim)
    ident = np.eye(dim)

    def two(op, which):
        return np.kron(op, ident) if which == 0 else np.kron(ident, op)

    H0 = (
        2 * np.pi * w0 * two(N, 0)
        + np.pi * alpha0 * two(N @ (N - ident), 0)
        + 2 * np.pi * w1 * two(N, 1)
        + np.pi * alpha1 * two(N @ (N - ident), 1)
        + 2 * np.pi * J * (np.kron(adag, a) + np.kron(a, adag))
    )
    drive0 = 2 * np.pi * two(a + adag, 0)

    if rwa_cutoff_freq is None:
        # mean transmon frequency: keeps the ~|w0-w1| rotating terms, drops the
        # ~(w0+w1) counter-rotating ones with a wide margin on both sides
        rwa_cutoff_freq = (w0 + w1) / 2

    solver = Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[drive0],
        rotating_frame=np.diag(H0),
        rwa_cutoff_freq=rwa_cutoff_freq,
        rwa_carrier_freqs=[w1],
        device=device,
        dtype=dtype,
    )
    return solver, w1


def rabi_solver(nu: float = 5.0, device=None, dtype: torch.dtype = torch.complex128):
    """Single-qubit Rabi Solver (BASELINE config 1)."""
    X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    solver = Solver(
        static_hamiltonian=2 * np.pi * nu * Z / 2,
        hamiltonian_operators=[2 * np.pi * X / 2],
        rotating_frame=2 * np.pi * nu * Z / 2,
        device=device,
        dtype=dtype,
    )
    return solver, nu


def expm_chain(
    generators, dt: float, y0, order: int = 12, squarings: int = 2, engine: str = "xla",
):
    """Sustained expm-propagator chain: ``y <- expm(G_t dt) @ y`` over steps.

    Args:
        generators: (T, ..., n, n) per-step (optionally batched) generators, a
            tensor.
        dt: step size.
        y0: (..., n, m) states/propagators to which the chain is applied, a
            tensor on the generators' device.
        engine: ``"xla"`` (the name kept from the JAX package: an eager loop
            of :func:`~qiskit_dynamics_tpu_torch.ops.expm.expm_taylor`, whose
            batched products are cuBLAS calls on the card) or ``"pallas"``
            (kernel B9,
            :func:`~qiskit_dynamics_tpu_torch.ops.expm_chain_pallas.expm_chain_fused`;
            the same polynomial, (T, b, n, n)/(T, n, n) shapes).

    Returns:
        (..., n, m) final states.
    """
    if engine == "pallas":
        from .ops.expm_chain_pallas import expm_chain_fused

        return expm_chain_fused(generators, dt, y0, order=order, squarings=squarings)
    if engine != "xla":
        raise ValueError(f"engine must be 'xla' or 'pallas', got {engine!r}")
    from .ops.expm import expm_taylor

    y = y0
    for g in generators:
        y = expm_taylor(g * dt, order=order, squarings=squarings) @ y
    return y


def lindblad_qudit_solver(dim: int = 8, device=None, dtype: torch.dtype = torch.complex128):
    """A driven ``dim``-level transmon with amplitude damping, vectorized
    (``solve_dim = dim**2``; 64 at the default): ``H0 = 2 pi (5 N - 0.165
    (N^2 - N))``, drive ``2 pi 0.02 (a + a^dag)``, static dissipator
    ``sqrt(0.01) a``, rotating frame ``diag(H0)``.

    Returns:
        (solver, rho0, carrier): the ``Solver``, the initial density matrix
        ``|1><1|`` and the drive carrier frequency (5.0).
    """
    a, adag, N = _transmon_ops(dim)
    H0 = 2 * np.pi * (5.0 * N - 0.33 / 2 * (N @ N - N))
    solver = Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[2 * np.pi * 0.02 * (a + adag)],
        static_dissipators=[np.sqrt(0.01) * a],
        rotating_frame=np.diag(H0),
        vectorized=True,
        device=device,
        dtype=dtype,
    )
    rho0 = np.zeros((dim, dim), dtype=complex)
    rho0[1, 1] = 1.0
    return solver, rho0, 5.0


def lindblad_two_transmon_solver(device=None, dtype: torch.dtype = torch.complex128):
    """Two coupled 4-level transmons (5.0 and 5.1 GHz, anharmonicity -0.33,
    coupling 0.002) with amplitude damping on both, vectorized (``solve_dim``
    256): drive ``2 pi 0.02 (a + a^dag) x I``, static dissipators
    ``sqrt(0.005) a x I`` and ``sqrt(0.005) I x a``, rotating frame
    ``diag(H0)``.

    Returns:
        (solver, rho0, carrier): the ``Solver``, the initial density matrix
        ``|1><1|`` and the drive carrier frequency (5.1).
    """
    a, adag, N = _transmon_ops(4)
    ident = np.eye(4)
    H0 = (
        2 * np.pi * 5.0 * np.kron(N, ident)
        + np.pi * (-0.33) * np.kron(N @ (N - ident), ident)
        + 2 * np.pi * 5.1 * np.kron(ident, N)
        + np.pi * (-0.33) * np.kron(ident, N @ (N - ident))
        + 2 * np.pi * 0.002 * (np.kron(adag, a) + np.kron(a, adag))
    )
    solver = Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[2 * np.pi * 0.02 * np.kron(a + adag, ident)],
        static_dissipators=[np.sqrt(0.005) * np.kron(a, ident), np.sqrt(0.005) * np.kron(ident, a)],
        rotating_frame=np.diag(H0),
        vectorized=True,
        device=device,
        dtype=dtype,
    )
    rho0 = np.zeros((16, 16), dtype=complex)
    rho0[1, 1] = 1.0
    return solver, rho0, 5.1


def dyson_transmon_solver(
    dim: int = 10,
    nu: float = 5.0,
    alpha: float = -0.33,
    r: float = 0.02,
    dt: float = 0.1,
    chebyshev_order: int = 1,
    expansion_order: int = 6,
    device=None,
    dtype: torch.dtype = torch.complex128,
):
    """BASELINE config 4: single-transmon ``DysonSolver`` (Dysolve stepping).

    dim-10 transmon in its own rotating frame, one drive at the transmon
    frequency, coarse dt = 0.1 (the perturbative solvers' whole point is
    stepping far beyond the carrier period at fixed precompute).

    Returns:
        (dyson_solver, nu): the solver and the drive carrier frequency.
    """
    return _perturbative_transmon_solver(
        "dyson", dim, nu, alpha, r, dt, chebyshev_order, expansion_order, device, dtype
    )


def magnus_transmon_solver(
    dim: int = 10,
    nu: float = 5.0,
    alpha: float = -0.33,
    r: float = 0.02,
    dt: float = 0.1,
    chebyshev_order: int = 1,
    expansion_order: int = 3,
    device=None,
    dtype: torch.dtype = torch.complex128,
):
    """BASELINE config 4, Magnus variant: the same transmon as
    :func:`dyson_transmon_solver` stepped with ``MagnusSolver`` (per-step
    ``expm`` of the Magnus polynomial; unitary per step, so coarser expansion
    orders hold).

    Returns:
        (magnus_solver, nu): the solver and the drive carrier frequency.
    """
    return _perturbative_transmon_solver(
        "magnus", dim, nu, alpha, r, dt, chebyshev_order, expansion_order, device, dtype
    )


def _perturbative_transmon_solver(
    kind, dim, nu, alpha, r, dt, chebyshev_order, expansion_order, device, dtype
):
    from .solvers import DysonSolver, MagnusSolver

    a, adag, N = _transmon_ops(dim)
    H0 = 2 * np.pi * nu * N + np.pi * alpha * N @ (N - np.eye(dim))
    G0 = -1j * H0
    G1 = -1j * 2 * np.pi * r * (a + adag)
    cls = DysonSolver if kind == "dyson" else MagnusSolver
    solver = cls(
        operators=[G1],
        rotating_frame=G0,
        dt=dt,
        carrier_freqs=[nu],
        chebyshev_orders=[chebyshev_order],
        expansion_order=expansion_order,
        device=device,
        dtype=dtype,
        atol=1e-12,
        rtol=1e-12,
    )
    return solver, nu
