"""Labeled containers for perturbation-theory results.

Counterpart of ``qiskit_dynamics_tpu/perturbation/perturbation_data.py``.
Labels are canonical sorted tuples (Dyson/Magnus) or int lists
(Dyson-like); ``get_item`` accepts any form coercible to those.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

from ..exceptions import DynamicsError
from .multiset_utils import to_multiset

__all__ = ["PowerSeriesData", "DysonLikeData"]


@dataclass
class _LabeledData:
    data: Any
    labels: List[Any]
    metadata: Optional[Any] = None

    def _preprocess_label(self, label):
        return label

    def get_item(self, label):
        """Look up the data entry whose label matches ``label``."""
        label = self._preprocess_label(label)
        if label in self.labels:
            return self.data[self.labels.index(label)]
        raise DynamicsError("label is not present in self.labels.")


class PowerSeriesData(_LabeledData):
    """Power-series (Dyson/Magnus) terms labeled by multisets."""

    def _preprocess_label(self, label):
        return to_multiset(label)


class DysonLikeData(_LabeledData):
    """Dyson-like terms labeled by ordered int lists."""

    def _preprocess_label(self, label):
        return list(label)
