"""Time-dependent model coefficients ("signals").

Counterpart of ``qiskit_dynamics_tpu/signals/signals.py``:

- ``Signal`` represents ``Re[f(t) exp(i(2 pi nu t + phi))]`` with a callable
  or constant envelope ``f``.
- ``SignalSum`` is a sum of signals with array-valued ``carrier_freq`` /
  ``phase`` and a stacked ``envelope(t) -> (..., k)``.
- ``SignalList`` evaluates independent signal components simultaneously.

Envelopes are Python callables on tensors. Every evaluation path is plain
tensor arithmetic with no ``.item()``, numpy conversion or Python branching
on tensor values, so a signal built from a batched tensor inside
``torch.func.vmap`` evaluates batched: the sweep solver builds its
amplitude tables for all sweep members in one vmapped pass.

Carrier frequencies and phases are float64 tensors (times are float64 too:
phase arguments ``2 pi nu t`` need the mantissa at large ``t``).
"""
from __future__ import annotations

import operator
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ..exceptions import DynamicsError
from ..unified import is_tensor, to_tensor

__all__ = ["Signal", "SignalCollection", "SignalSum", "SignalList", "to_SignalSum"]

_TWO_PI = 2 * np.pi


def _time(t) -> torch.Tensor:
    """Times as a float64 tensor (kept on its device if already a tensor)."""
    return torch.as_tensor(t, dtype=torch.float64)


def _like(value, t: torch.Tensor) -> torch.Tensor:
    """An envelope value as a tensor on the device of the times ``t``."""
    return to_tensor(value, device=t.device)


def _stack_last(values) -> torch.Tensor:
    """Stack broadcast-compatible tensors along a new last axis, promoting
    to their common dtype."""
    dtype = values[0].dtype
    for v in values[1:]:
        dtype = torch.promote_types(dtype, v.dtype)
    return torch.stack(torch.broadcast_tensors(*[v.to(dtype) for v in values]), dim=-1)


class Signal:
    r"""A function of the form ``Re[f(t) exp(i(2 pi nu t + phi))]``.

    ``envelope`` may be a vectorized callable ``f(t)`` or a constant value;
    the carrier frequency ``nu`` and phase ``phi`` are real (arrays for
    subclasses representing sums).
    """

    def __init__(
        self,
        envelope: Union[Callable, float, complex, torch.Tensor],
        carrier_freq=0.0,
        phase=0.0,
        name: Optional[str] = None,
    ):
        self._name = name
        self._is_constant = False

        if not callable(envelope):
            if not is_tensor(carrier_freq) and np.all(np.asarray(carrier_freq) == 0.0):
                self._is_constant = True
            envelope = _ConstantEnvelope(envelope)

        self._envelope = envelope
        self.carrier_freq = carrier_freq
        self.phase = phase

    # --- basic properties -------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        """Name of the signal."""
        return self._name

    @property
    def is_constant(self) -> bool:
        """Whether this signal is a constant (constant envelope, zero carrier)."""
        return self._is_constant

    @property
    def carrier_freq(self) -> torch.Tensor:
        """Carrier frequency (array-valued in subclasses)."""
        return self._carrier_freq

    @carrier_freq.setter
    def carrier_freq(self, carrier_freq):
        self._carrier_freq = torch.as_tensor(carrier_freq, dtype=torch.float64)

    @property
    def phase(self) -> torch.Tensor:
        """Carrier phase (array-valued in subclasses)."""
        return self._phase

    @phase.setter
    def phase(self, phase):
        self._phase = torch.as_tensor(phase, dtype=torch.float64)

    # --- evaluation ---------------------------------------------------------
    def envelope(self, t):
        """Vectorized envelope evaluation."""
        return self._envelope(t)

    def carrier_factor(self, t) -> torch.Tensor:
        """Vectorized evaluation of the carrier ``exp(i(2 pi nu t + phi))``."""
        t = _time(t)
        arg = _TWO_PI * self._carrier_freq.to(t.device) * t + self._phase.to(t.device)
        return torch.exp(1j * arg)

    def modulate(self, t, factor: torch.Tensor) -> torch.Tensor:
        """The complex value at ``t`` given the carrier ``factor`` there
        (:meth:`carrier_factor`): ``f(t) * factor``."""
        t = _time(t)
        return _like(self.envelope(t), t) * factor

    def complex_value(self, t) -> torch.Tensor:
        """Vectorized evaluation of ``f(t) exp(i(2 pi nu t + phi))``."""
        return self.modulate(t, self.carrier_factor(t))

    def __call__(self, t) -> torch.Tensor:
        """Vectorized evaluation of the real signal."""
        return torch.real(self.complex_value(t))

    def __str__(self):
        if self.name is not None:
            return str(self.name)
        if self.is_constant:
            return f"Constant({self(0.0)})"
        return f"Signal(carrier_freq={self.carrier_freq}, phase={self.phase})"

    def __repr__(self):
        return self.__str__()


class _ConstantEnvelope:
    """Constant envelope callable: ``value`` broadcast to the shape of ``t``."""

    def __init__(self, value):
        self.value = to_tensor(value)

    def __call__(self, t):
        t = _time(t)
        return self.value.to(t.device) * torch.ones_like(t)


class SignalCollection:
    """Base class for list-like collections of signals."""

    def __init__(self, signal_list: List[Signal]):
        self._components = list(signal_list)

    @property
    def components(self) -> List[Signal]:
        """The component signals."""
        return self._components

    def __len__(self):
        return len(self._components)

    def __getitem__(self, idx):
        sub = operator.itemgetter(idx)(self._components)
        if isinstance(sub, list):
            return self.__class__(sub)
        return sub

    def __iter__(self):
        return iter(self._components)


class SignalSum(SignalCollection, Signal):
    r"""A sum ``s_1(t) + ... + s_k(t)`` of signals.

    ``carrier_freq``/``phase`` are ``(k,)`` tensors; ``envelope(t)`` returns
    the stacked component envelopes with shape ``(..., k)``.
    """

    def __init__(self, *signals, name: Optional[str] = None):
        self._name = name
        components = []
        for sig in signals:
            if isinstance(sig, list):
                sig = SignalSum(*sig)
            if isinstance(sig, SignalSum):
                components += sig.components
            elif isinstance(sig, Signal):
                components.append(sig)
            elif np.ndim(sig) == 0:
                components.append(Signal(sig))
            else:
                raise DynamicsError(
                    "Components of a SignalSum must be Signal instances or scalars."
                )

        SignalCollection.__init__(self, components)
        Signal.__init__(
            self,
            envelope=self._envelope_fn,
            carrier_freq=_stack_freqs([sig.carrier_freq for sig in components]),
            phase=_stack_freqs([sig.phase for sig in components]),
            name=name,
        )

    def _envelope_fn(self, t):
        t = _time(t)
        return _stack_last([_like(sig.envelope(t), t) for sig in self._components])

    def carrier_factor(self, t) -> torch.Tensor:
        """The components' carriers at ``t``, stacked on a last axis."""
        t = _time(t)
        freq = self._carrier_freq.to(t.device)
        arg = _TWO_PI * t.unsqueeze(-1) * freq + self._phase.to(t.device)
        return torch.exp(1j * arg)

    def modulate(self, t, factor: torch.Tensor) -> torch.Tensor:
        t = _time(t)
        return torch.sum(self.envelope(t) * factor, dim=-1)

    def flatten(self) -> Signal:
        """Merge into a single ``Signal`` carried at the average frequency."""
        if len(self) == 0:
            return Signal(0.0)
        if len(self) == 1:
            return self._components[0]
        ave_freq = torch.sum(self._carrier_freq) / len(self)
        shifted = 1j * _TWO_PI * (self._carrier_freq - ave_freq)
        phases = 1j * self._phase
        env = self._envelope

        def merged_env(t):
            t = _time(t)
            arg = t.unsqueeze(-1) * shifted.to(t.device) + phases.to(t.device)
            return torch.sum(env(t) * torch.exp(arg), dim=-1)

        return Signal(envelope=merged_env, carrier_freq=ave_freq, name=str(self))

    def __str__(self):
        if self.name is not None:
            return str(self.name)
        if len(self) == 0:
            return "SignalSum()"
        return " + ".join(str(sig) for sig in self._components)


def _stack_freqs(values) -> torch.Tensor:
    """(k,) float64 tensor from component frequencies/phases (0-d tensors)."""
    if not values:
        return torch.zeros(0, dtype=torch.float64)
    return torch.stack([torch.as_tensor(v, dtype=torch.float64) for v in values])


class SignalList(SignalCollection):
    """A list of signals evaluated simultaneously: ``__call__(t) -> (..., k)``."""

    def __init__(self, signal_list: List[Signal]):
        super().__init__([to_SignalSum(sig) for sig in signal_list])

    def complex_value(self, t) -> torch.Tensor:
        """Stacked complex values, shape ``(..., k)``."""
        return _stack_last([sig.complex_value(t) for sig in self._components])

    def __call__(self, t) -> torch.Tensor:
        return _stack_last([sig(t) for sig in self._components])

    def flatten(self) -> "SignalList":
        """Flatten each component sum into a single signal."""
        return SignalList(
            [sig.flatten() if isinstance(sig, SignalSum) else sig for sig in self._components]
        )


def to_SignalSum(sig) -> SignalSum:
    """Coerce a scalar / Signal / SignalSum into a SignalSum."""
    if isinstance(sig, SignalSum):
        return sig
    if isinstance(sig, Signal):
        return SignalSum(sig)
    if np.ndim(sig) == 0:
        return SignalSum(Signal(sig))
    raise DynamicsError("Input type incompatible with SignalSum.")
