r"""Polynomial-expanded Magnus sweep engine: the large-dimension fixed-step path.

Counterpart of ``qiskit_dynamics_tpu/ops/polynomial_sweep.py``. At large
``n`` the eager engine (:mod:`~qiskit_dynamics_tpu_torch.ops.xla_sweep`)
spends its time in per-member batched commutator matmuls: Magnus order 3 with
non-anti-Hermitian generators costs six ``(B, n, n) @ (B, n, n)`` products per
step. This engine removes them algebraically. The frame phase mask is a
diagonal conjugation, ``P(t) o A = D(t) A D(t)^{-1}`` with
``D = diag(exp(d t))``, so every Gauss-point generator is

.. math:: G_i = D_r\,\tilde A_i\,D_r^{-1},\qquad
          \tilde A_i = E_i\Big(S + \sum_k c_{ik} O_k\Big)E_i^{-1},

with ``D_r = D(t_ref)`` shared by the Gauss points of the step and
``E_i = D(tau_i - t_ref)`` a constant diagonal. Conjugation by ``D_r`` is a
ring homomorphism, so the whole Magnus bracket polynomial is evaluated on the
``tilde A_i`` and the ``D_r`` sandwich moves into the state transform:
``expm(D M D^{-1}) y = D expm(M) D^{-1} y``. The bracket polynomial is
multilinear in the per-member Gauss coefficients, so it expands (on the host,
in float64, where all commutator cancellations happen) into

.. math:: \tilde M_b = \sum_q \mathrm{mono}_q(c_b)\, X_q

with ``Q`` member-independent matrices ``X_q`` (``Q <= 56`` for one drive
operator at Magnus order 3). Two small LRU caches keep this work out of
repeated calls. The host one keeps the float64 expansion by the operands'
values. The device one keeps what a call consumes: the ``X_q`` as real and
imaginary ``(Q, n^2)`` planes in the call's dtype (transposed for the kernel
route), the monomial index and the frame diagonal, keyed by device, route and
dtype and by the operands, a tensor by its identity and in-place version, so
a repeated call with the same operator tensors reads back none of them and
uploads nothing. Per step the device then does one monomial gather-product
``(Q, B)``, one ``(B, Q) @ (Q, n^2)`` contraction per plane
(``torch.matmul``: the JAX package leaves it to XLA outside any kernel), two
diagonal phase multiplies on the state, and the Horner ``expm`` action, which
goes to kernel B4 (:mod:`~qiskit_dynamics_tpu_torch.ops.horner_pallas`) or to
an eager loop. Same step rule and polynomial as the other engines.

Frame phases are formed in float64 and reduced with ``fmod`` before cos/sin,
as everywhere in the port (the JAX package splits them into float32 (hi, lo)
pairs). Not carried: the JAX package's compile-time warning for large
dimensions and ``interpret``.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..unified import default_device, to_numpy, to_tensor
from ..utils import lru
from ..utils.metrics import count, span
from .horner_pallas import horner_apply_bm_ad
from .magnus_rule import MAGNUS_NODES, TWO_PI, step_constants, validate_eval_slots

__all__ = ["sweep_expm_magnus_poly", "expand_magnus_polynomial"]

_T_REF = 0.5  # the step's reference time, in units of dt from its start
KERNEL_MIN_N = 64  # horner="auto" takes the kernel route from this dimension


# ---------------------------------------------------------------------------
# host-side symbolic expansion: dict{monomial tuple -> (n, n) complex128}


def _padd(p, q, scale=1.0):
    out = dict(p)
    for m, X in q.items():
        out[m] = out.get(m, 0.0) + scale * X
    return out


def _pscale(p, scale):
    return {m: scale * X for m, X in p.items()}


def _pprod(p, q):
    out = {}
    for m1, X1 in p.items():
        for m2, X2 in q.items():
            m = tuple(sorted(m1 + m2))
            prod = X1 @ X2
            out[m] = out[m] + prod if m in out else prod
    return out


def _pcomm(p, q):
    return _padd(_pprod(p, q), _pprod(q, p), scale=-1.0)


def expand_magnus_polynomial(static_op, operators, frame_diag, dt: float, magnus_order: int):
    """Expand the Magnus step matrix as a monomial polynomial of the Gauss
    coefficients (host numpy, float64).

    Variables are flat indices ``i * k + j`` for Gauss point ``i`` and
    operator ``j``. Returns ``(mon_index, X)``: a ``(Q, deg_max)`` int32
    gather matrix (sentinel = n_vars, gathers an appended ones-row) and the
    stacked ``(Q, n, n)`` complex128 coefficient matrices of
    ``M_tilde = sum_q prod(c[mon_index[q]]) X_q`` (reference time = step
    midpoint).
    """
    if magnus_order not in (2, 3):
        raise ValueError(f"magnus_order must be 2 or 3, got {magnus_order!r}")
    S = np.asarray(static_op, dtype=np.complex128)
    ops = np.asarray(operators, dtype=np.complex128)
    d = np.asarray(frame_diag, dtype=np.complex128)
    k = ops.shape[0]
    nodes = MAGNUS_NODES[magnus_order].tolist()

    # tilde A_i = E_i (S + sum_k c_ik O_k) E_i^{-1}, E_i = diag(exp(d (c_i - t_ref) dt))
    a_tilde = []
    for i, c in enumerate(nodes):
        E = np.exp(d * ((c - _T_REF) * dt))
        Einv = np.exp(-d * ((c - _T_REF) * dt))
        poly = {(): (E[:, None] * S) * Einv[None, :]}
        for j in range(k):
            poly[(i * k + j,)] = (E[:, None] * ops[j]) * Einv[None, :]
        a_tilde.append(poly)

    if magnus_order == 2:
        A1, A2 = a_tilde
        c1, c2 = step_constants(2, dt)
        M = _padd(_pscale(_padd(A1, A2), c1), _pcomm(A2, A1), scale=c2)
    else:
        A1, A2, A3 = a_tilde
        dtf, c0dt, c1dt = step_constants(3, dt)
        a1 = _pscale(A2, dtf)
        a2 = _pscale(_padd(A3, A1, scale=-1.0), c0dt)
        a3 = _pscale(_padd(_padd(A3, A2, scale=-2.0), A1), c1dt)
        C1 = _pcomm(a1, a2)
        C2 = _pscale(_pcomm(_padd(_pscale(a3, 2.0), C1), a1), 1.0 / 60.0)
        M = _padd(
            _padd(a1, _pscale(a3, 1.0 / 12.0)),
            _pcomm(_padd(_padd(_pscale(a1, -20.0), a3, scale=-1.0), C1), _padd(a2, C2)),
            scale=1.0 / 240.0,
        )

    monos = sorted(M.keys(), key=lambda m: (len(m), m))
    n_vars = len(nodes) * k
    deg_max = max(1, max(len(m) for m in monos))
    mon_index = np.full((len(monos), deg_max), n_vars, dtype=np.int32)
    for q, m in enumerate(monos):
        mon_index[q, : len(m)] = m
    return mon_index, np.stack([M[m] for m in monos], axis=0)


# least-recently-used caches of :data:`~qiskit_dynamics_tpu_torch.utils.lru.ENTRIES` entries
_EXPANSION_CACHE: OrderedDict = OrderedDict()  # operand values -> host (mon_index, X)
_PREPARED_CACHE: OrderedDict = OrderedDict()  # operand identities + route -> device planes


def _host_complex(x):
    return to_numpy(x).astype(np.complex128)


def _host_expansion(S, ops, d, dt, magnus_order):
    key = (S.shape, S.tobytes(), ops.shape, ops.tobytes(), d.tobytes(), dt, magnus_order)
    hit = lru.get(_EXPANSION_CACHE, key)
    if hit is None:
        hit = expand_magnus_polynomial(S, ops, d, dt, magnus_order)
        lru.put(_EXPANSION_CACHE, key, hit)
    return hit


def _prepared_expansion(static_op, operators, frame_diag, dt, magnus_order, device, route, real):
    """``(gather, Xr, Xi, d_im)`` on ``device``: the int64 monomial index,
    the expansion's real and imaginary planes as ``(Q, n^2)`` in ``real``
    (of ``M^T`` for the kernel route), and the frame diagonal's float64
    imaginary part. A hit reads back only the (n,) frame diagonal, and
    uploads nothing; a miss takes the float64 expansion from the host cache
    (or expands) and uploads it."""
    d = None if frame_diag is None else _host_complex(frame_diag)
    key = (
        device, route, real, lru.operand_key(static_op), lru.operand_key(operators),
        None if d is None else d.tobytes(), dt, magnus_order,
    )
    entry = lru.get(_PREPARED_CACHE, key)
    count("poly.expansion_misses" if entry is None else "poly.expansion_hits")
    if entry is None:
        S, ops = _host_complex(static_op), _host_complex(operators)
        if d is None:
            d = np.zeros(S.shape[0], dtype=np.complex128)
        mon_index, X = _host_expansion(S, ops, d, dt, magnus_order)
        # the kernel route consumes M^T planes: transpose on the host, so no
        # transpose exists on the device
        Xf = (np.swapaxes(X, 1, 2) if route == "pallas" else X).reshape(X.shape[0], -1)
        entry = (
            torch.as_tensor(mon_index.astype(np.int64), device=device),
            torch.as_tensor(Xf.real.copy(), device=device).to(real),
            torch.as_tensor(Xf.imag.copy(), device=device).to(real),
            torch.as_tensor(d.imag.copy(), device=device),
            (static_op, operators),  # held: their ids stay theirs while the entry lives
        )
        lru.put(_PREPARED_CACHE, key, entry)
    return entry[:4]


# ---------------------------------------------------------------------------
# device engine


def sweep_expm_magnus_poly(
    static_op, operators, frame_diag, coefficients, y0, dt, t0=0.0, order=8, eval_slots=None,
    magnus_order=2, horner="auto",
):
    """Fixed-step Magnus sweep solve through the polynomial-expanded engine.

    Drop-in alternative to
    :func:`~qiskit_dynamics_tpu_torch.ops.xla_sweep.sweep_expm_magnus2_xla`
    (same step rule, same Horner polynomial, same coefficient-table contract)
    that replaces the per-member batched commutator matmuls with one
    ``(B, Q) @ (Q, n^2)`` contraction against expansion matrices formed on
    the host and kept on the device between calls (see the module
    docstring).

    Args:
        static_op: (n, n) static generator in the frame eigenbasis, frame
            diagonal already subtracted. Concrete values: the expansion runs
            on the host (no gradient reaches it or ``operators``). A tensor
            is cached by identity and in-place version (a cache entry holds
            it); change it in place, or pass another, and the next call
            expands anew.
        operators: (k, n, n) drive operators in the frame eigenbasis, cached
            as ``static_op``.
        frame_diag: (n,) frame eigenvalues ``d`` (purely imaginary), or
            ``None`` for no frame.
        coefficients: (T, n_gauss, k, B) real Gauss-point signal samples. Its
            dtype sets the arithmetic: float64 gives complex128, anything
            else complex64.
        y0: (n, B) complex column states or (B, n, m) batch-major. Everything
            is computed on its device, else that of ``coefficients``, else
            (neither is a tensor) on the CUDA device.
        dt, t0: uniform step size and initial time.
        order: Horner Taylor order of the ``expm`` action.
        eval_slots: optional per-step trajectory store slots (as the eager
            engine).
        magnus_order: 2 or 3.
        horner: the ``expm``-action route. ``"pallas"`` (the name is kept):
            kernel B4 through
            :func:`~qiskit_dynamics_tpu_torch.ops.horner_pallas.horner_apply_bm_ad`
            (CUDA on the card, its plain version on the CPU; single-column
            states only), ``"einsum"``: an eager loop of batched matmuls, or
            ``"auto"``: the kernel route for single-column float32 states at
            ``n >= 64``, else einsum.

    Returns:
        as the eager engine. Gradients flow to ``coefficients`` and ``y0``;
        under autograd each step is checkpointed, so only the per-step states
        are stored.
    """
    if horner not in ("auto", "pallas", "einsum"):
        raise ValueError(f"horner must be 'auto', 'pallas' or 'einsum', got {horner!r}")
    with span("sweep.prepare"):
        if isinstance(y0, torch.Tensor):
            device = y0.device
        elif isinstance(coefficients, torch.Tensor):
            device = coefficients.device
        else:
            device = default_device()
        coef = to_tensor(coefficients, device=device)
        real = torch.float64 if coef.dtype == torch.float64 else torch.float32
        cplx = torch.complex128 if real == torch.float64 else torch.complex64
        coef = coef.to(real)
        T, n_gauss, k, B = coef.shape
        y = to_tensor(y0, device=device).to(cplx)
        batch_major = y.ndim == 3
        if not batch_major:
            y = y.transpose(0, 1)[..., None]  # (B, n, 1)
        n, m_cols = y.shape[1], y.shape[-1]
        if horner == "pallas" and m_cols != 1:
            raise ValueError(
                f"horner='pallas' supports single-column states only (got m={m_cols}); use "
                "horner='einsum' for matrix states."
            )
        if horner == "auto":
            kernel_ok = m_cols == 1 and real == torch.float32 and n >= KERNEL_MIN_N
            horner = "pallas" if kernel_ok else "einsum"

        gather, Xr, Xi, d_im = _prepared_expansion(
            static_op, operators, frame_diag, float(dt), int(magnus_order), device, horner, real
        )
        ones = torch.ones((1, B), dtype=real, device=device)

        n_eval, slots = 0, None
        if eval_slots is not None:
            n_eval = validate_eval_slots(eval_slots, T)
            slots = [int(s) for s in eval_slots]

    def step_fn(y, coef_step, step):
        c_ext = torch.cat([coef_step.reshape(n_gauss * k, B), ones], dim=0)
        mono_t = torch.prod(c_ext[gather], dim=1).transpose(0, 1)  # (B, Q)
        Mr = (mono_t @ Xr).reshape(B, n, n)
        Mi = (mono_t @ Xi).reshape(B, n, n)
        # state into the step's reference frame: v = D^{-1} y
        ph = torch.fmod(d_im * (t0 + (step + _T_REF) * dt), TWO_PI)
        Dinv = torch.complex(torch.cos(ph), -torch.sin(ph)).to(cplx)[None, :, None]
        v = Dinv * y
        if horner == "pallas":  # Mr, Mi are the planes of M^T here
            ur, ui = horner_apply_bm_ad(
                Mr, Mi, torch.real(v[..., 0]), torch.imag(v[..., 0]), order
            )
            w = torch.complex(ur, ui)[..., None]
        else:
            M = torch.complex(Mr, Mi)
            w = v
            for kk in range(order, 0, -1):
                w = v + (M @ w) / kk
        return torch.conj(Dinv) * w

    differentiable = torch.is_grad_enabled() and (coef.requires_grad or y.requires_grad)
    with span("sweep.engine"):
        evals = [None] * n_eval
        for step in range(T):
            if differentiable:
                y = checkpoint(step_fn, y, coef[step], step, use_reentrant=False)
            else:
                y = step_fn(y, coef[step], step)
            if slots is not None and slots[step] >= 0:
                evals[slots[step]] = y
    if batch_major:
        return (y, torch.stack(evals)) if n_eval else y
    final = y[..., 0].transpose(0, 1)  # (n, B)
    if n_eval:
        return final, torch.stack(evals)[..., 0].transpose(1, 2)  # (n_eval, n, B)
    return final
