"""The plain reference of a sweep, and the control that computes it in TF32.

Independent of the program: it imports NumPy and PyTorch only (and the
benchmark's envelopes), and works out from a :class:`~portbench.model.Model`'s
matrices the rotating frame, the rotating-wave approximation and, for a
density matrix, the column-stacked Lindbladian. In the frame ``diag(lam)``
entry ``(p, q)`` of every generator turns with ``exp(i (lam_p - lam_q) t)``,
and the drive ``Re[f(t) exp(i nu t)] D`` splits into ``f(t)/2 exp(i nu t) D +
conj(f(t))/2 exp(-i nu t) D``, ``f`` evaluated in float64 at the rule's node
times; the approximation keeps each part of an entry only where its
frequency ``|(+-nu + lam_p - lam_q) / 2 pi|`` lies below the cutoff (the
static part with ``nu = 0``).

The solve is a fixed-step Magnus rule, 2-point Gauss (4th order) or 3-point
Gauss (6th order, Blanes, Casas and Ros 2009), with the exact step
propagator: a Taylor series of 18 terms after scaling the step matrix to a
1-norm of at most 1/2 (truncation below 1e-22). On the program's grid this is
the rule the cell asks for; on a fine grid it is the exact solution to the
limit of the rule's error.

``Arith("float64")`` is the reference: complex128 throughout.
``Arith("tf32")`` is the control: complex64 storage and element-wise
arithmetic, and every matrix product on operands rounded to TF32 (10
mantissa bits, to nearest) with the sums in float32, as the tensor cores
form them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .model import envelope

TAYLOR_TERMS = 18
TAYLOR_NORM = 0.5

GAUSS2 = (0.5 - math.sqrt(3) / 6, 0.5 + math.sqrt(3) / 6)
GAUSS3 = (0.5 - math.sqrt(15) / 10, 0.5, 0.5 + math.sqrt(15) / 10)


def fixed_steps(span: float, max_dt: float) -> int:
    """The fewest equal steps no longer than ``max_dt``."""
    return max(1, math.ceil(span / max_dt * (1 - 1e-12)))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32: the nearest value with 10 mantissa bits, ties
    away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()  # the gradient passes straight through


class Arith:
    """The precision of a solve: ``"float64"`` or ``"tf32"``."""

    def __init__(self, kind: str):
        if kind not in ("float64", "tf32"):
            raise ValueError(f"unknown arithmetic {kind!r}")
        self.kind = kind
        self.cdtype = torch.complex128 if kind == "float64" else torch.complex64

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "float64":
            return a @ b
        ar, ai = _tf32(a.real), _tf32(a.imag)
        br, bi = _tf32(b.real), _tf32(b.imag)
        return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


class Problem:
    """A model's generator in its rotating frame on ``device``:
    ``G(t, amp) = X(t) + amp * Y(t)``."""

    def __init__(self, model, device):
        h0 = np.asarray(model.static_hamiltonian, dtype=complex)
        lam = np.asarray(model.frame, dtype=float)
        d = h0.shape[0]
        ident = np.eye(d)
        h_rest = h0 - np.diag(lam)  # the static part less the frame
        if model.vectorized:
            # column-stacking vec: vec(A rho B) = (B^T kron A) vec(rho)
            static = -1j * (np.kron(ident, h_rest) - np.kron(h_rest.T, ident))
            for L in model.dissipators:
                LdL = L.conj().T @ L
                static = static + np.kron(L.conj(), L) - 0.5 * (
                    np.kron(ident, LdL) + np.kron(LdL.T, ident))
            drives = [-1j * (np.kron(ident, dr.operator) - np.kron(dr.operator.T, ident))
                      for dr in model.drives]
            lam = (lam[:, None] - lam[None, :]).T.reshape(-1)  # index i + d j: lam_i - lam_j
        else:
            static = -1j * h_rest
            drives = [-1j * dr.operator for dr in model.drives]
        delta = lam[:, None] - lam[None, :]
        self.n = static.shape[0]
        self.vectorized = model.vectorized
        self.state_dim = d

        def keep(freq):
            if model.rwa_cutoff_ghz is None:
                return np.ones_like(freq)
            return (np.abs(freq) < 2 * np.pi * model.rwa_cutoff_ghz).astype(float)

        as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)  # noqa: E731
        self.delta = as_t(delta)
        self.static = as_t(static * keep(delta))
        nus = [2 * np.pi * dr.carrier_ghz for dr in model.drives]
        self.nus = nus
        self.scales = [dr.envelope_scale for dr in model.drives]
        self.envelopes = [None if dr.envelope is None else envelope(dr.envelope)
                          for dr in model.drives]
        self.plus = [as_t(D * keep(nu + delta)) for D, nu in zip(drives, nus)]
        self.minus = [as_t(D * keep(-nu + delta)) for D, nu in zip(drives, nus)]
        y0 = np.asarray(model.y0, dtype=complex)
        self.y0 = as_t(y0.T.reshape(-1) if model.vectorized else y0)

    def pieces(self, t: torch.Tensor):
        """``X(t), Y(t)``: (..., n, n) complex128 for float64 times ``t``."""
        phase = torch.exp(1j * self.delta * t[..., None, None])
        x = self.static * phase
        y = torch.zeros_like(x)
        for nu, scale, env, plus, minus in zip(self.nus, self.scales, self.envelopes, self.plus,
                                               self.minus):
            carrier = torch.exp(1j * nu * t)[..., None, None]
            if env is not None:  # the +nu part turns with env(t), the -nu part with its conjugate
                carrier = carrier * env(t).to(torch.complex128)[..., None, None]
            y = y + (0.5 * scale) * (carrier * plus + carrier.conj() * minus)
        return x, y * phase

    def states(self, y: torch.Tensor) -> torch.Tensor:
        """(B, n) solve vectors -> (B, n) states or (B, d, d) density matrices."""
        if not self.vectorized:
            return y
        d = self.state_dim
        return y.reshape(-1, d, d).transpose(1, 2)


def _comm(arith, a, b):
    return arith.mm(a, b) - arith.mm(b, a)


def magnus_matrices(problem, arith, amps, t0, dt, steps, order):
    """(S, B, n, n) step matrices of ``steps`` (S,) step indices."""
    nodes = GAUSS2 if order == 2 else GAUSS3
    times = t0 + dt * (steps.to(torch.float64)[:, None] + torch.tensor(
        nodes, dtype=torch.float64, device=steps.device))  # (S, nodes)
    x, y = problem.pieces(times)  # (S, nodes, n, n)
    amp = amps.to(arith.cdtype)[None, :, None, None]
    gens = [x[:, i, None].to(arith.cdtype) + amp * y[:, i, None].to(arith.cdtype)
            for i in range(len(nodes))]
    if order == 2:
        g1, g2 = gens
        return (0.5 * dt) * (g1 + g2) + (math.sqrt(3) / 12 * dt * dt) * _comm(arith, g2, g1)
    g1, g2, g3 = gens
    a1 = dt * g2
    a2 = (math.sqrt(15) / 3 * dt) * (g3 - g1)
    a3 = (10.0 / 3 * dt) * (g3 - 2.0 * g2 + g1)
    c1 = _comm(arith, a1, a2)
    c2 = -_comm(arith, a1, 2.0 * a3 + c1) / 60.0
    return a1 + a3 / 12.0 + _comm(arith, -20.0 * a1 - a3 + c1, a2 + c2) / 240.0


def expm(arith, omega: torch.Tensor) -> torch.Tensor:
    """exp of a batch of matrices: Taylor series after scaling and squaring."""
    with torch.no_grad():
        norm = float(omega.abs().sum(-2).amax()) if omega.numel() else 0.0
    squarings = max(0, math.ceil(math.log2(norm / TAYLOR_NORM))) if norm > TAYLOR_NORM else 0
    x = omega / 2.0**squarings
    eye = torch.eye(omega.shape[-1], dtype=omega.dtype, device=omega.device)
    out = eye + x / TAYLOR_TERMS
    for k in range(TAYLOR_TERMS - 1, 0, -1):
        out = eye + arith.mm(x, out) / k
    for _ in range(squarings):
        out = arith.mm(out, out)
    return out


def solve(problem, amps, t0, t_final, n_steps, order, arith, chunk_elems=1 << 21):
    """Final frame states of the members ``amps`` (B,), float64 on the
    problem's device: (B, n), or (B, d, d) for a density matrix. Each member
    is independent of the others, so any split of ``amps`` gives the same
    rows. Differentiable in ``amps``."""
    dt = (t_final - t0) / n_steps
    B, n = amps.shape[0], problem.n
    y = problem.y0.to(arith.cdtype)[None, :, None].expand(B, n, 1)
    per_step = max(1, B * n * n)
    chunk = max(1, min(n_steps, chunk_elems // per_step))
    device = amps.device
    for start in range(0, n_steps, chunk):
        steps = torch.arange(start, min(start + chunk, n_steps), device=device)
        props = expm(arith, magnus_matrices(problem, arith, amps, t0, dt, steps, order))
        for s in range(props.shape[0]):
            y = arith.mm(props[s], y)
    return problem.states(y[..., 0])
