r"""Multivariable Dyson series / Magnus expansion computation.

Counterpart of ``qiskit_dynamics_tpu/perturbation/dyson_magnus.py``
(algorithms from Puzzuoli et al., arXiv:2210.11595, and Haas et al.,
New J. Phys. 21, 103011 for the Dyson-like case).

All multiset/rule bookkeeping happens at set-up time, producing compiled
gather/linear-combination tables (:mod:`.custom_dot`). The computation is one
joint ODE solve of the stacked state ``[V, D_{I_1} V, D_{I_2} V, ...]``, a
``(k+1, n, n)`` array whose right-hand side is a stack of generator
evaluations contracted through the compiled tables. It runs on the host in
complex128 through :func:`~qiskit_dynamics_tpu_torch.solvers.solve_ode`
(the scipy methods by default): this is a once-per-model precompute. With a
device ``integration_method`` (``tpu_dop853``, ``jax_RK4``, ...) the stacked
state lives on ``device`` (the CUDA device when None) and the terms come back
to the host. The Magnus terms are then obtained from the Dyson terms via the
Q-matrix recursion.
"""
from __future__ import annotations

from math import factorial
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..solvers.solver_functions import _is_device_method, solve_ode
from ..unified import default_device, to_numpy
from .custom_dot import CustomMatmul, compile_rule
from .multiset_utils import (
    Multiset,
    get_all_submultisets,
    is_submultiset,
    multiset_complement,
    submultiset_filter,
    submultisets_and_complements,
)
from .perturbation_data import PowerSeriesData, DysonLikeData

__all__ = ["solve_lmde_dyson", "solve_lmde_magnus", "magnus_from_dyson"]


def solve_lmde_dyson(
    perturbations: List[Callable],
    t_span,
    dyson_terms,
    perturbation_labels: Optional[List[Multiset]] = None,
    generator: Optional[Callable] = None,
    y0=None,
    dyson_in_frame: bool = True,
    dyson_like: bool = False,
    integration_method: str = "DOP853",
    t_eval=None,
    device=None,
    **kwargs,
):
    """Compute Dyson (or Dyson-like) terms via one joint stacked ODE solve.
    ``device`` places the stacked state of a device ``integration_method``
    (None: the CUDA device); the scipy methods run on the host."""
    mat_dim = np.shape(perturbations[0](t_span[0]))[0]

    if generator is None:
        def generator(t):  # pylint: disable=function-redefined
            return np.zeros((mat_dim, mat_dim), dtype=complex)

    if y0 is None:
        y0 = np.eye(mat_dim, dtype=complex)

    if dyson_like:
        complete_term_list = complete_dyson_like_terms(dyson_terms)
    else:
        complete_term_list = get_all_submultisets(dyson_terms)

    dyson_rhs = _setup_dyson_rhs(
        generator,
        perturbations,
        complete_term_list,
        dyson_like=dyson_like,
        perturbation_labels=perturbation_labels,
    )

    # stacked initial state [y0, 0, 0, ...]
    y0 = np.concatenate(
        [
            np.expand_dims(np.asarray(y0, dtype=complex), 0),
            np.zeros((len(complete_term_list), np.shape(y0)[-2], np.shape(y0)[-1]), dtype=complex),
        ],
        axis=0,
    )

    if _is_device_method(integration_method):
        y0 = torch.as_tensor(y0, device=default_device(device))
    results = solve_ode(
        rhs=dyson_rhs, t_span=t_span, y0=y0, method=integration_method, t_eval=t_eval, **kwargs
    )

    # unstack: axis layout (time, term, n, n) -> (term, time, n, n)
    ys = to_numpy(results.y).transpose((1, 0, 2, 3))
    base_solution = ys[0]
    dyson_data = ys[1:]

    if dyson_in_frame:
        dyson_data = np.array([np.linalg.solve(base_solution, term) for term in dyson_data])

    results.y = base_solution
    if dyson_like:
        results.perturbation_data = DysonLikeData(
            data=dyson_data,
            labels=[list(t) for t in complete_term_list],
            metadata={"expansion_type": "dyson_like"},
        )
    else:
        results.perturbation_data = PowerSeriesData(
            data=dyson_data,
            labels=complete_term_list,
            metadata={"expansion_type": "dyson"},
        )
    return results


def solve_lmde_magnus(
    perturbations: List[Callable],
    t_span,
    magnus_terms,
    perturbation_labels: Optional[List[Multiset]] = None,
    generator: Optional[Callable] = None,
    y0=None,
    integration_method: str = "DOP853",
    t_eval=None,
    **kwargs,
):
    """Compute Magnus terms: Dyson solve + Q-matrix recursion."""
    results = solve_lmde_dyson(
        perturbations,
        t_span,
        dyson_terms=magnus_terms,
        perturbation_labels=perturbation_labels,
        generator=generator,
        y0=y0,
        dyson_in_frame=True,
        dyson_like=False,
        integration_method=integration_method,
        t_eval=t_eval,
        **kwargs,
    )
    magnus_data = magnus_from_dyson(
        results.perturbation_data.labels, results.perturbation_data.data
    )
    results.perturbation_data = PowerSeriesData(
        data=magnus_data,
        labels=results.perturbation_data.labels,
        metadata={"expansion_type": "magnus"},
    )
    return results


# ---------------------------------------------------------------------------
# RHS construction
# ---------------------------------------------------------------------------


def _setup_dyson_rhs(
    generator: Callable,
    perturbations: List[Callable],
    complete_term_list: List,
    dyson_like: bool,
    perturbation_labels: Optional[List[Multiset]] = None,
) -> Callable:
    """Build the stacked-state RHS ``t, y -> custom_matmul(evals(t), y)``."""
    if dyson_like:
        generator_indices = _required_dyson_generator_indices(complete_term_list)
        evaluation_order = [0] + [idx + 1 for idx in generator_indices]
        lmult_rule = _dyson_like_lmult_rule(complete_term_list, generator_indices)
    else:
        if perturbation_labels is None:
            perturbation_labels = [(idx,) for idx in range(len(perturbations))]
        reduced_labels = submultiset_filter(perturbation_labels, complete_term_list)
        evaluation_order = [0] + [
            perturbation_labels.index(label) + 1 for label in reduced_labels
        ]
        lmult_rule = _dyson_lmult_rule(complete_term_list, reduced_labels)

    custom_matmul = CustomMatmul(lmult_rule, index_offset=1)
    funcs = [generator] + list(perturbations)
    needed = [funcs[i] for i in evaluation_order]

    def evaluator(t):
        return np.stack([to_numpy(f(t)) for f in needed])

    def dyson_rhs(t, y):
        return custom_matmul(evaluator(t), y)

    return dyson_rhs


def _required_dyson_generator_indices(complete_dyson_terms: List) -> List[int]:
    """Leading indices appearing in any Dyson-like term."""
    return sorted({term[0] for term in complete_dyson_terms})


def _dyson_like_lmult_rule(complete_dyson_terms: List, generator_indices: List[int]) -> List:
    r"""Sparse lmult rule for Dyson-like terms.

    Stacked state rows: ``[V, D_{term_1} V, ...]``; generator is encoded as
    index ``-1`` in both factls (offset later).
    ``d/dt(D_{[i_1..i_k]}V) = G (D V) + G_{i_1} (D_{[i_2..i_k]} V)``.
    """
    lmult_rule = [(np.array([1.0]), np.array([[-1, -1]]))]
    for term_idx, term in enumerate(complete_dyson_terms):
        l_idx = generator_indices.index(term[0])
        if len(term) == 1:
            pairs = [[-1, term_idx], [l_idx, -1]]
        else:
            r_idx = complete_dyson_terms.index(list(term[1:]))
            pairs = [[-1, term_idx], [l_idx, r_idx]]
        lmult_rule.append((np.ones(len(pairs)), np.array(pairs, dtype=int)))
    return lmult_rule


def _dyson_lmult_rule(
    complete_multisets: List[Multiset], perturbation_labels: Optional[List[Multiset]] = None
) -> List:
    r"""Sparse lmult rule for multiset Dyson terms.

    ``d/dt(D_I V) = G (D_I V) + sum_{J <= I, J in labels} G_J (D_{I-J} V)``
    with ``D_{emptyset} V = V`` encoded as right-index ``-1``.
    """
    if perturbation_labels is None:
        perturbation_labels = [ms for ms in complete_multisets if len(ms) == 1]

    lmult_rule = [(np.array([1.0]), np.array([[-1, -1]]))]
    for term_idx, term in enumerate(complete_multisets):
        if len(term) == 1 and term in perturbation_labels:
            pairs = [[-1, term_idx], [perturbation_labels.index(term), -1]]
        else:
            pairs = [[-1, term_idx]]
            for l_idx, l_term in enumerate(perturbation_labels):
                if is_submultiset(l_term, term):
                    if len(l_term) == len(term):
                        pairs.append([l_idx, -1])
                    else:
                        r_term = multiset_complement(term, l_term)
                        pairs.append([l_idx, complete_multisets.index(r_term)])
        lmult_rule.append((np.ones(len(pairs)), np.array(pairs, dtype=int)))
    return lmult_rule


def complete_dyson_like_terms(dyson_terms: List[List[int]]) -> List[List[int]]:
    """Close a list of Dyson-like index lists under tail-taking, sorted by
    (length, string)."""
    terms = {tuple(t) for t in dyson_terms}
    max_order = max(len(t) for t in terms)
    by_order = {k: set() for k in range(1, max_order + 1)}
    for t in terms:
        by_order[len(t)].add(t)
    for order in range(max_order, 1, -1):
        for t in by_order[order]:
            by_order[order - 1].add(t[1:])
    out = []
    for order in range(1, max_order + 1):
        out.extend(sorted(by_order[order], key=lambda t: str(list(t))))
    return [list(t) for t in out]


# ---------------------------------------------------------------------------
# Magnus from Dyson: Q-matrix recursion
# ---------------------------------------------------------------------------


def magnus_from_dyson(complete_multisets: List[Multiset], dyson_terms):
    """Convert Dyson terms to Magnus terms via the Q-matrix recursion
    (arXiv:2210.11595), executed as sequential compiled-rule updates on the
    host."""
    dyson_terms = to_numpy(dyson_terms)
    complete_multisets = [tuple(ms) for ms in complete_multisets]
    q_terms = _magnus_q_ladder(complete_multisets)
    if all(len(ms) == 1 for ms in complete_multisets):
        return dyson_terms  # all first order: Magnus == Dyson
    start_idx, magnus_indices, stacked_rules = _stack_q_ladder_rules(q_terms)

    q_shape = (len(q_terms) + 1,) + tuple(np.shape(dyson_terms)[1:])
    eye = np.broadcast_to(np.eye(q_shape[-1], dtype=complex), q_shape[1:])
    pairs_s, coeffs_s, idx_s = stacked_rules

    q_mat = np.zeros(q_shape, dtype=complex)
    q_mat[magnus_indices] = dyson_terms
    q_mat[-1] = eye
    for rule_idx in range(len(pairs_s)):
        cm = CustomMatmul((pairs_s[rule_idx], (coeffs_s[rule_idx], idx_s[rule_idx])))
        q_mat[start_idx + rule_idx] = cm(q_mat, q_mat)[0]
    return q_mat[magnus_indices]


def _magnus_q_ladder(complete_multisets: List[Multiset]) -> List[Tuple[Multiset, int]]:
    """Q-matrix specs ``(multiset, product_order)``, orders descending per term."""
    return [
        (term, order) for term in complete_multisets for order in range(len(term), 0, -1)
    ]


def _q_ladder_product_rule(q_term: Tuple[Multiset, int], oc_q_term_list: List) -> List:
    """Sparse rule computing one Q matrix from earlier ones.

    ``Q_(I,1) = D_I - sum_{q=2..|I|} Q_(I,q)/q!`` (D_I pre-loaded at the
    ``(I,1)`` slot); ``Q_(I,q) = sum_{J} Q_(J,1) Q_(I-J,q-1)`` over strict
    submultisets J with ``|J| <= |I| - q + 1``. Identity is encoded at index
    ``len(oc_q_term_list)``.
    """
    sym_index, order = q_term
    q_idx = oc_q_term_list.index(q_term)
    n = len(sym_index)
    ident = len(oc_q_term_list)

    if order == 1:
        coeffs = np.concatenate(
            [[1.0], [-1.0 / factorial(q) for q in range(2, n + 1)]]
        )
        products = [[ident, q_idx]] + [
            [ident, oc_q_term_list.index((sym_index, q))] for q in range(2, n + 1)
        ]
        return [(coeffs, np.array(products, dtype=int))]

    products = []
    subs, comps = submultisets_and_complements(sym_index, n - (order - 1) + 1)
    for sub, comp in zip(subs, comps):
        product = [oc_q_term_list.index((sub, 1)), oc_q_term_list.index((comp, order - 1))]
        if product not in products:
            products.append(product)
    return [(np.ones(len(products)), np.array(products, dtype=int))]


def _stack_q_ladder_rules(q_terms: List) -> Tuple[int, np.ndarray, Tuple]:
    """Compile every Q-update rule, padded to a common shape for stacking."""
    start_idx = sum(1 for ms, _ in q_terms if len(ms) == 1)
    magnus_indices = np.array([i for i, (_, order) in enumerate(q_terms) if order == 1])

    rules = [_q_ladder_product_rule(q_term, q_terms) for q_term in q_terms[start_idx:]]
    compiled = [compile_rule(rule) for rule in rules]
    max_pairs = max(len(c.pairs) for c in compiled)
    max_combo = max(c.coeffs.shape[1] for c in compiled)
    compiled = [
        compile_rule(rule, unique_evaluation_len=max_pairs, linear_combo_len=max_combo)
        for rule in rules
    ]
    pairs_s = np.stack([c.pairs for c in compiled])
    coeffs_s = np.stack([c.coeffs for c in compiled])
    idx_s = np.stack([c.idx for c in compiled])
    return start_idx, magnus_indices, (pairs_s, coeffs_s, idx_s)
