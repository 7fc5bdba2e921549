"""``"model": "transmon_chain"``: coupled transmons in a chain.

``len(freqs_ghz)`` transmons of ``levels`` levels each, in ``np.kron`` order
(transmon 0 is the leftmost factor), exchange coupling between neighbours,
drives on single transmons (each with an optional ``envelope``, see
:mod:`portbench.model`) and optional amplitude damping:

    H0 = sum_q 2 pi f_q N_q + pi alpha_q N_q (N_q - 1)
         + sum_q 2 pi J (a_q^dag a_{q+1} + a_q a_{q+1}^dag)
    D  = 2 pi c (a_p + a_p^dag)   (c: the drive's operator_scale, p its transmon)
    L_q = sqrt(gamma_q) a_q

The frame is diag(H0) (``"frame": "diag_static"``), the initial state the
basis state ``initial_basis_index`` (its projector when ``vectorized``).
"""
from __future__ import annotations

import numpy as np

from ..model import Drive, Model


def _embed(op: np.ndarray, which: int, count: int) -> np.ndarray:
    out = np.eye(1)
    for q in range(count):
        out = np.kron(out, op if q == which else np.eye(op.shape[0]))
    return out


def build(cfg: dict) -> Model:
    levels = int(cfg["levels"])
    freqs = [float(f) for f in cfg["freqs_ghz"]]
    alphas = [float(a) for a in cfg["anharmonicities_ghz"]]
    count = len(freqs)
    a = np.diag(np.sqrt(np.arange(1, levels, dtype=float)), 1)
    adag = a.T
    num = np.diag(np.arange(levels, dtype=float))
    ident = np.eye(levels)

    h0 = sum(
        2 * np.pi * f * _embed(num, q, count) + np.pi * al * _embed(num @ (num - ident), q, count)
        for q, (f, al) in enumerate(zip(freqs, alphas))
    )
    coupling = float(cfg.get("coupling_ghz", 0.0))
    for q in range(count - 1):
        h0 = h0 + 2 * np.pi * coupling * (
            _embed(adag, q, count) @ _embed(a, q + 1, count)
            + _embed(a, q, count) @ _embed(adag, q + 1, count)
        )
    h0 = np.asarray(h0, dtype=complex)

    drives = [
        Drive(
            operator=np.asarray(
                2 * np.pi * float(d["operator_scale"]) * _embed(a + adag, int(d["transmon"]), count),
                dtype=complex,
            ),
            carrier_ghz=float(d["carrier_ghz"]),
            envelope_scale=float(d["envelope_scale"]),
            envelope=d.get("envelope"),
        )
        for d in cfg["drives"]
    ]
    dissipators = [
        np.asarray(np.sqrt(float(g)) * _embed(a, q, count), dtype=complex)
        for q, g in enumerate(cfg.get("damping_rates") or [])
        if g
    ]
    vectorized = bool(cfg.get("vectorized", False))
    dim = levels**count
    index = int(cfg["initial_basis_index"])
    if vectorized:
        y0 = np.zeros((dim, dim), dtype=complex)
        y0[index, index] = 1.0
    else:
        y0 = np.zeros(dim, dtype=complex)
        y0[index] = 1.0
    if cfg.get("frame") != "diag_static":
        raise ValueError(f"unknown frame {cfg.get('frame')!r}: transmon_chain takes 'diag_static'")
    cutoff = cfg.get("rwa_cutoff_ghz")
    return Model(
        static_hamiltonian=h0,
        drives=drives,
        dissipators=dissipators,
        frame=np.real(np.diag(h0)).copy(),
        rwa_cutoff_ghz=None if cutoff is None else float(cutoff),
        vectorized=vectorized,
        y0=y0,
        t_final=float(cfg["t_final"]),
    )
