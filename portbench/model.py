"""A configuration's model, written out in NumPy from its JSON file.

Both sides of the benchmark start here: the program builds its public
``Solver`` from these matrices, and the reference works out the frame, the
rotating-wave approximation and the vectorized Lindbladian from the same
matrices on its own. Nothing here imports the program.

A configuration names its model kind under ``"model"``; the kind is the
module ``portbench/models/<kind>.py``, whose ``build(cfg)`` returns a
:class:`Model`. A new kind is a new file.

A drive may carry a time-dependent envelope, ``{"kind": <kind>, ...}``: the
kind is the module ``portbench/envelopes/<kind>.py``, whose ``value(t,
params)`` maps a float64 tensor of times to the envelope with torch
operations only (differentiable and vmappable, since the port evaluates
signals under ``torch.func.vmap``), ``params`` being the drive's envelope
entry. A new envelope is a new file.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional

import numpy as np

from .spec import check_name


@dataclasses.dataclass
class Drive:
    operator: np.ndarray  # (d, d) Hermitian
    carrier_ghz: float
    envelope_scale: float  # the envelope is amp * envelope_scale (times envelope(t))
    envelope: Optional[dict] = None  # {"kind": <kind>, <its parameters>}; None: constant


@dataclasses.dataclass
class Model:
    """``H(t) = static_hamiltonian + sum_j Re[amp e_j(t) exp(2 pi i nu_j t)] D_j``,
    with static Lindblad operators ``dissipators`` when ``vectorized`` (the
    density matrix evolved as its column-stacked vector), solved in the
    rotating frame ``diag(frame)`` from ``y0`` at 0 to ``t_final``."""

    static_hamiltonian: np.ndarray  # (d, d)
    drives: List[Drive]
    dissipators: List[np.ndarray]  # (d, d) each
    frame: np.ndarray  # (d,) real
    rwa_cutoff_ghz: Optional[float]
    vectorized: bool
    y0: np.ndarray  # (d,) state, or (d, d) density matrix when vectorized
    t_final: float

    @property
    def dim(self) -> int:
        return self.static_hamiltonian.shape[0]


def build(cfg: dict) -> Model:
    """The model a configuration file describes."""
    kind = check_name(cfg["model"])
    return importlib.import_module(f"{__package__}.models.{kind}").build(cfg)


def envelope(spec: dict):
    """The envelope ``{"kind": <kind>, ...}`` as a function of a float64
    tensor of times."""
    module = importlib.import_module(f"{__package__}.envelopes.{check_name(spec['kind'])}")
    return lambda t: module.value(t, spec)
