r"""Precomputed perturbative expansion model (the "Dysolve" compile step).

Counterpart of
``qiskit_dynamics_tpu/solvers/perturbative_solvers/expansion_model.py``
(algorithm: Puzzuoli et al. arXiv:2210.11595; Shillito et al. "Dysolve").

At construction, for a generator :math:`G(t) = G_0 + \sum_j Re[f_j(t)
e^{i2\pi\nu_j t}] G_j`, the model computes a truncated Dyson/Magnus expansion
of the propagator over one step :math:`[0, \Delta t]` in the rotating frame of
:math:`G_0`, with perturbation variables being the Chebyshev coefficients of
the frequency-shifted envelopes. The result is packaged into an
:class:`ArrayPolynomial`: stepping then costs one monomial evaluation and one
tensordot (and one ``expm`` for Magnus) per step.

The precompute is one joint ODE solve on the host in complex128 (numpy
perturbation callables, scipy integrator). The polynomial's coefficients are
uploaded to the model's device once, at construction. Signal sampling
(:meth:`ExpansionModel.approximate_signals`) runs on the device in
float64/complex128 whatever the working type of the stepping: the envelope is
multiplied by a carrier phase at absolute times, which float32 cannot hold;
the per-step frequency shift itself is applied at the step-local Chebyshev
nodes, where its argument is at most ``2 pi nu dt``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from numpy.polynomial.chebyshev import chebpts1, chebvander

from ...exceptions import DynamicsError
from ...models import RotatingFrame
from ...perturbation import solve_lmde_perturbation, ArrayPolynomial
from ...unified import is_tensor, to_numpy

__all__ = ["ExpansionModel"]


def _cheb_basis(t, deg: int, dt: float):
    """T_deg on domain [0, dt], by the three-term recurrence."""
    x = (2.0 * t - dt) / dt
    if deg == 0:
        return np.ones_like(x) if hasattr(x, "shape") else 1.0
    t_prev, t_cur = 1.0, x
    for _ in range(deg - 1):
        t_prev, t_cur = t_cur, 2.0 * x * t_cur - t_prev
    return t_cur


def _construct_DCT(degree: int, domain: Optional[List] = None) -> Tuple[np.ndarray, np.ndarray]:
    """DCT matrix + sample points for interval ``domain``: coefficients of the
    Chebyshev interpolant of ``f`` are ``M @ f(x)``."""
    domain = domain or [-1, 1]
    order = degree + 1
    xcheb = chebpts1(order)
    xcheb_shifted = 0.5 * ((domain[1] - domain[0]) * xcheb + (domain[1] + domain[0]))
    dct_mat = chebvander(xcheb, degree).T.copy()
    dct_mat[0] /= order
    dct_mat[1:] /= 0.5 * order
    return dct_mat, xcheb_shifted


def _signal_envelope_DCT(
    signal, reference_freq: float, degree: int, t0: float, dt: float, n_intervals: int, device
) -> torch.Tensor:
    """Multi-interval DCT of a signal's envelope shifted to ``reference_freq``:
    a complex128 ``(degree + 1, n_intervals)`` tensor on ``device``.

    In every interval the signal is sampled at the Chebyshev nodes
    ``t_k + x`` (absolute float64 times) and multiplied by
    ``exp(-i 2 pi nu x)``: the shift ``exp(-i 2 pi nu (t_k + x))`` of the
    sample times and the per-interval phase ``exp(+i 2 pi nu t_k)`` combined,
    so the exponent is the step-local node, never the absolute time."""
    dct_mat, xcheb = _construct_DCT(degree, domain=[0, dt])
    interval_starts = t0 + np.arange(n_intervals) * dt
    x_vals = torch.as_tensor(np.add.outer(xcheb, interval_starts), device=device)
    local_shift = torch.as_tensor(
        np.exp(-1j * 2 * np.pi * float(reference_freq) * xcheb), device=device
    )
    samples = signal.complex_value(x_vals).to(torch.complex128) * local_shift[:, None]
    return torch.as_tensor(dct_mat, dtype=torch.complex128, device=device) @ samples


def _signal_list_envelope_DCT(
    signal_list,
    reference_freqs,
    degrees: List[int],
    t0: float,
    dt: float,
    n_intervals: int,
    device,
    include_imag: Optional[List[bool]] = None,
) -> torch.Tensor:
    """Stacked real/imag Chebyshev coefficients of every signal's shifted
    envelope, a float64 tensor of shape (n_vars, n_intervals)."""
    if include_imag is None:
        include_imag = [True] * len(signal_list)

    blocks = []
    for sig, freq, deg, inc_imag in zip(signal_list, reference_freqs, degrees, include_imag):
        coeffs = _signal_envelope_DCT(sig, freq, deg, t0, dt, n_intervals, device)
        blocks.append(torch.real(coeffs))
        if inc_imag:
            blocks.append(torch.imag(coeffs))
    return torch.cat(blocks, dim=0)


def _construct_cheb_perturbations(
    operators,
    chebyshev_orders: List[int],
    carrier_freqs,
    dt: float,
    rotating_frame: RotatingFrame,
    include_imag: Optional[List[bool]] = None,
) -> List[Callable]:
    r"""Perturbation callables ``cos(2πν t) T_m(t) G̃_j(t)`` and
    ``sin(-2πν t) T_m(t) G̃_j(t)`` with ``G̃_j(t)`` the operator in the
    rotating frame; ordered by (j, m), cosine block before sine block per j.
    They run on the host in complex128 numpy (they are the right-hand side of
    the precompute's scipy solve), on the frame's eigendecomposition."""
    if include_imag is None:
        include_imag = [True] * len(operators)

    frame_diag = rotating_frame.frame_diag
    basis = rotating_frame.frame_basis
    frame_diag = None if frame_diag is None else to_numpy(frame_diag).astype(complex)
    basis = None if basis is None else to_numpy(basis).astype(complex)

    def make(deg, freq, op, trig):
        rad = 2 * np.pi * freq
        op = np.asarray(op, dtype=complex)
        op_fb = op if basis is None else basis.conj().T @ op @ basis

        def func(t):
            if frame_diag is None:
                op_in_frame = op
            else:
                phases = np.exp(t * frame_diag)
                op_in_frame = op_fb * (phases.conj()[:, None] * phases[None, :])
                if basis is not None:
                    op_in_frame = basis @ op_in_frame @ basis.conj().T
            carrier = np.cos(rad * t) if trig == "cos" else np.sin(-rad * t)
            return _cheb_basis(t, deg, dt) * carrier * op_in_frame

        return func

    perturbations = []
    for deg, op, freq, inc_imag in zip(chebyshev_orders, operators, carrier_freqs, include_imag):
        for k in range(deg + 1):
            perturbations.append(make(k, freq, op, "cos"))
        if inc_imag:
            for k in range(deg + 1):
                perturbations.append(make(k, freq, op, "sin"))
    return perturbations


class ExpansionModel:
    """Precomputed perturbative expansion of an LMDE over one fixed step.

    ``device=None`` is the CUDA device (raises without one); ``dtype`` is the
    complex type of the batched stepping on that device."""

    def __init__(
        self,
        operators,
        rotating_frame,
        dt: float,
        carrier_freqs,
        chebyshev_orders: List[int],
        expansion_method: str = "dyson",
        expansion_order: Optional[int] = None,
        expansion_labels: Optional[List] = None,
        integration_method: Optional[str] = None,
        include_imag: Optional[List[bool]] = None,
        device=None,
        dtype: torch.dtype = torch.complex128,
        **kwargs,
    ):
        if expansion_method not in ["dyson", "magnus"]:
            raise DynamicsError(
                "ExpansionModel only accepts expansion_method 'dyson' or 'magnus'."
            )
        operators = np.asarray([to_numpy(op) for op in operators])
        carrier_freqs = np.asarray(to_numpy(carrier_freqs))
        if len(operators) != len(carrier_freqs):
            raise DynamicsError("carrier_freqs must have the same length as operators.")
        if len(operators) != len(chebyshev_orders):
            raise DynamicsError("chebyshev_orders must have the same length as operators.")

        if isinstance(rotating_frame, RotatingFrame) and device is None:
            frame = rotating_frame
        else:
            frame = RotatingFrame(rotating_frame, device=device)
        if include_imag is None:
            include_imag = [True] * len(carrier_freqs)
        dim = operators[0].shape[0]
        Udt = to_numpy(frame.state_out_of_frame(dt, np.eye(dim, dtype=complex)))

        if integration_method is None:
            integration_method = "DOP853"

        perturbations = _construct_cheb_perturbations(
            operators, chebyshev_orders, carrier_freqs, dt, frame, include_imag
        )
        results = solve_lmde_perturbation(
            perturbations=perturbations,
            t_span=[0, dt],
            expansion_method=expansion_method,
            expansion_order=expansion_order,
            expansion_labels=expansion_labels,
            integration_method=integration_method,
            device=frame.device,
            **kwargs,
        )

        data = np.asarray(results.perturbation_data.data)
        if expansion_method == "dyson":
            # premultiply by the single-step frame change: stepping then maps
            # frame-basis state directly
            data = Udt @ data
            polynomial = ArrayPolynomial(
                constant_term=Udt,
                array_coefficients=data[:, -1],
                monomial_labels=results.perturbation_data.labels,
            )
        else:
            polynomial = ArrayPolynomial(
                array_coefficients=data[:, -1],
                monomial_labels=results.perturbation_data.labels,
            )
        self._set_parts(
            expansion_method, dt, Udt, operators, carrier_freqs, chebyshev_orders,
            include_imag, frame, polynomial, dtype,
        )

    def _set_parts(
        self, expansion_method, dt, Udt, operators, carrier_freqs, chebyshev_orders,
        include_imag, frame: RotatingFrame, polynomial: ArrayPolynomial, dtype,
    ):
        self._expansion_method = str(expansion_method)
        self._dt = float(dt)
        self._Udt = np.asarray(Udt)
        self._operators = np.asarray(operators)
        self._carrier_freqs = np.asarray(carrier_freqs)
        self._chebyshev_orders = [int(d) for d in chebyshev_orders]
        self._include_imag = [bool(b) for b in include_imag]
        self._rotating_frame = frame
        self._expansion_polynomial = polynomial
        self._dtype = dtype
        # the one upload of the coefficients: the model's own type, and the
        # kernels' complex64 where the stepping will run on the card
        polynomial.tensors(frame.device, dtype)
        if frame.device.type == "cuda":
            polynomial.tensors(frame.device, torch.complex64)

    @classmethod
    def from_parts(
        cls, expansion_method, dt, Udt, operators, carrier_freqs, chebyshev_orders,
        include_imag, frame_operator, polynomial: ArrayPolynomial, device=None,
        dtype: torch.dtype = torch.complex128,
    ) -> "ExpansionModel":
        """An ExpansionModel around an already computed expansion (a
        checkpoint, or arrays carried across from the JAX package)."""
        if expansion_method not in ["dyson", "magnus"]:
            raise DynamicsError(
                "ExpansionModel only accepts expansion_method 'dyson' or 'magnus'."
            )
        obj = object.__new__(cls)
        frame = RotatingFrame(frame_operator, device=device)
        obj._set_parts(
            expansion_method, dt, Udt, operators, carrier_freqs, chebyshev_orders,
            include_imag, frame, polynomial, dtype,
        )
        return obj

    @property
    def expansion_method(self) -> str:
        """Perturbation method used in solver."""
        return self._expansion_method

    @property
    def dt(self) -> float:
        """Step size of solver."""
        return self._dt

    @property
    def Udt(self) -> np.ndarray:
        """Single-step frame transformation (host, complex128)."""
        return self._Udt

    @property
    def operators(self) -> np.ndarray:
        """Original operators in the generator."""
        return self._operators

    @property
    def rotating_frame(self) -> RotatingFrame:
        """Rotating frame."""
        return self._rotating_frame

    @property
    def device(self) -> torch.device:
        """Device of the batched stepping."""
        return self._rotating_frame.device

    @property
    def dtype(self) -> torch.dtype:
        """Complex dtype of the batched stepping."""
        return self._dtype

    @property
    def expansion_polynomial(self) -> ArrayPolynomial:
        """ArrayPolynomial evaluating the perturbation series."""
        return self._expansion_polynomial

    def approximate_signals(self, signals, t0: float, n_steps: int) -> torch.Tensor:
        """Chebyshev coefficients of the signals over ``n_steps`` intervals: a
        float64 tensor of shape (n_vars, n_steps) on the model's device,
        differentiable (and ``torch.func.vmap``-able) in the signal
        parameters."""
        return _signal_list_envelope_DCT(
            signals,
            reference_freqs=self._carrier_freqs,
            degrees=self._chebyshev_orders,
            t0=t0,
            dt=self._dt,
            n_intervals=n_steps,
            device=self.device,
            include_imag=self._include_imag,
        )

    def evaluate(self, coeffs):
        """Evaluate the expansion polynomial at Chebyshev coefficients (numpy
        in, numpy out on the host; a tensor in, a tensor out on its device)."""
        if is_tensor(coeffs) and coeffs.dtype not in (torch.float32, torch.float64):
            coeffs = coeffs.to(torch.float64)
        return self._expansion_polynomial(coeffs)

    # ------------------------------------------------------------------ #
    # checkpointing: the precompute is expensive, so it can be saved and
    # loaded. The .npz keys are the JAX package's, so a checkpoint written by
    # either package loads in the other.
    # ------------------------------------------------------------------ #

    def save(self, path: str):
        """Serialize the precomputed expansion to an ``.npz`` checkpoint."""
        poly = self._expansion_polynomial
        frame_operator = self._rotating_frame.frame_operator
        np.savez(
            path,
            expansion_method=self._expansion_method,
            dt=self._dt,
            Udt=self._Udt,
            operators=self._operators,
            carrier_freqs=self._carrier_freqs,
            chebyshev_orders=np.asarray(self._chebyshev_orders),
            include_imag=np.asarray(self._include_imag),
            frame_operator=(
                to_numpy(frame_operator)
                if frame_operator is not None
                else np.zeros(self._Udt.shape, dtype=complex)
            ),
            poly_constant=(
                to_numpy(poly.constant_term)
                if poly.constant_term is not None
                else np.zeros(self._Udt.shape, dtype=complex)
            ),
            poly_has_constant=poly.constant_term is not None,
            poly_coefficients=to_numpy(poly.array_coefficients),
            poly_labels=np.asarray(
                [",".join(map(str, label)) for label in poly.monomial_labels]
            ),
        )

    @classmethod
    def load(cls, path: str, device=None, dtype: torch.dtype = torch.complex128) -> "ExpansionModel":
        """Reconstruct an ExpansionModel from a checkpoint without recompute."""
        data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        labels = [
            tuple(int(i) for i in s.split(",")) if s else ()
            for s in data["poly_labels"]
        ]
        polynomial = ArrayPolynomial(
            constant_term=data["poly_constant"] if bool(data["poly_has_constant"]) else None,
            array_coefficients=data["poly_coefficients"],
            monomial_labels=labels,
        )
        return cls.from_parts(
            str(data["expansion_method"]), float(data["dt"]), data["Udt"], data["operators"],
            data["carrier_freqs"], list(data["chebyshev_orders"]), list(data["include_imag"]),
            data["frame_operator"], polynomial, device=device, dtype=dtype,
        )
