r"""Public API for time-dependent perturbation theory computations.

Counterpart of ``qiskit_dynamics_tpu/perturbation/solve_lmde_perturbation.py``.

Computes multivariable Dyson series terms :math:`\mathcal{D}_I(t)`, Magnus
expansion terms :math:`\mathcal{O}_I(t)` (arXiv:2210.11595), or Dyson-like
ordered-integral terms (Haas et al., 2019) for the generator power series

.. math:: G(t, c) = G_{\emptyset}(t) + \sum_I c_I G_I(t),

in the toggling frame of the unperturbed generator, via a single joint ODE
solve of the stacked terms (see :mod:`.dyson_magnus`). Multiset labels are
canonical sorted int-tuples; list/dict forms are accepted.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..exceptions import DynamicsError
from .dyson_magnus import solve_lmde_dyson, solve_lmde_magnus
from .multiset_utils import clean_multisets, to_multiset
from .perturbation_utils import (
    merge_multiset_expansion_order_labels,
    merge_list_expansion_order_labels,
)

__all__ = ["solve_lmde_perturbation"]


def solve_lmde_perturbation(
    perturbations: List[Callable],
    t_span,
    expansion_method: str,
    expansion_order: Optional[int] = None,
    expansion_labels: Optional[List] = None,
    perturbation_labels: Optional[List] = None,
    generator: Optional[Callable] = None,
    y0=None,
    dyson_in_frame: bool = True,
    integration_method: str = "DOP853",
    t_eval=None,
    **kwargs,
):
    r"""Compute perturbation-theory terms for an LMDE.

    Args:
        perturbations: list of matrix-valued callables :math:`G_I(t)`.
        t_span: integration bounds.
        expansion_method: ``'dyson'``, ``'magnus'``, or ``'dyson_like'``.
        expansion_order: compute all terms up to this order.
        expansion_labels: explicit terms to compute (multisets for
            dyson/magnus; int lists for dyson_like). At least one of
            ``expansion_order``/``expansion_labels`` is required.
        perturbation_labels: multiset labels of ``perturbations`` (dyson/magnus
            only); defaults to ``[(0,), (1,), ...]``.
        generator: unperturbed generator :math:`G_\emptyset` (default 0).
        y0: initial state of the unperturbed LMDE (default identity); requires
            ``dyson_in_frame=False`` and is unsupported for magnus.
        dyson_in_frame: return Dyson terms with the frame factor
            :math:`V(t)` removed.
        integration_method: a method of :func:`solve_ode`: a scipy method
            (host), or a device method such as ``tpu_dop853``, whose stacked
            state lives on ``device`` (a keyword in ``kwargs``; the CUDA
            device when absent).
        t_eval: additional evaluation times.
        kwargs: forwarded to the integrator.

    Returns:
        OdeResult with ``perturbation_data`` attribute
        (:class:`PowerSeriesData` or :class:`DysonLikeData`).
    """
    if y0 is not None:
        if "magnus" in expansion_method:
            raise DynamicsError("Argument y0 cannot be used for expansion_method=='magnus'.")
        if dyson_in_frame:
            raise DynamicsError(
                "If expansion_method in ['dyson', 'dyson_like'] and y0 passed, "
                "dyson_in_frame must be False."
            )
        y0 = np.asarray(y0)
        if y0.ndim == 1:
            y0 = y0[:, None]

    if perturbation_labels is not None and expansion_method == "dyson_like":
        raise DynamicsError(
            "perturbation_labels argument not usable with expansion_method='dyson_like'."
        )

    if expansion_method in ["dyson", "magnus"]:
        if perturbation_labels is None:
            perturbation_labels = [(idx,) for idx in range(len(perturbations))]
        else:
            original_len = len(perturbation_labels)
            perturbation_labels = [to_multiset(x) for x in perturbation_labels]
            if len(clean_multisets(perturbation_labels)) != original_len:
                raise DynamicsError("perturbation_labels argument contains duplicates.")
        expansion_labels = merge_multiset_expansion_order_labels(
            perturbation_labels=perturbation_labels,
            expansion_order=expansion_order,
            expansion_labels=expansion_labels,
        )
    elif expansion_method == "dyson_like":
        expansion_labels = merge_list_expansion_order_labels(
            perturbation_num=len(perturbations),
            expansion_order=expansion_order,
            expansion_labels=expansion_labels,
        )
    else:
        raise DynamicsError(f"expansion_method {expansion_method} not supported.")

    if expansion_method in ["dyson", "dyson_like"]:
        return solve_lmde_dyson(
            perturbations=perturbations,
            t_span=t_span,
            dyson_terms=expansion_labels,
            perturbation_labels=perturbation_labels,
            generator=generator,
            y0=y0,
            dyson_in_frame=dyson_in_frame,
            dyson_like=expansion_method == "dyson_like",
            integration_method=integration_method,
            t_eval=t_eval,
            **kwargs,
        )
    return solve_lmde_magnus(
        perturbations=perturbations,
        t_span=t_span,
        magnus_terms=expansion_labels,
        perturbation_labels=perturbation_labels,
        generator=generator,
        y0=y0,
        integration_method=integration_method,
        t_eval=t_eval,
        **kwargs,
    )
