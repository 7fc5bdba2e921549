"""Parity of the port's ``perturbation`` package with the JAX package.

The same numpy inputs, made from a seed, go through both packages (the JAX
side on the CPU with x64).

Tolerances and their reasons:

- ``compile_rule`` tables and multiset helpers: exact (host integer
  bookkeeping; the port keeps its own copy of the pure-Python code).
- ``CustomMatmul``/``CustomMul`` and ``ArrayPolynomial`` evaluation and
  algebra: 1e-12 (the same float64 sums in another order).
- ``solve_lmde_perturbation`` (dyson, magnus, dyson_like) and
  ``magnus_from_dyson``: 1e-9, both sides integrating with DOP853 at
  ``atol = rtol = 1e-12`` (the two right-hand sides differ by roundoff, the
  adaptive steps then differ slightly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, rng, to_np

from qiskit_dynamics_tpu.perturbation import ArrayPolynomial as JaxArrayPolynomial
from qiskit_dynamics_tpu.perturbation import magnus_from_dyson as jax_magnus_from_dyson
from qiskit_dynamics_tpu.perturbation import multiset_utils as jax_multiset
from qiskit_dynamics_tpu.perturbation import solve_lmde_perturbation as jax_solve_perturbation
from qiskit_dynamics_tpu.perturbation.custom_dot import CustomMatmul as JaxCustomMatmul
from qiskit_dynamics_tpu.perturbation.custom_dot import CustomMul as JaxCustomMul
from qiskit_dynamics_tpu.perturbation.custom_dot import compile_rule as jax_compile_rule
from qiskit_dynamics_tpu.perturbation.perturbation_utils import (
    merge_list_expansion_order_labels as jax_merge_list,
    merge_multiset_expansion_order_labels as jax_merge_multiset,
)

import qiskit_dynamics_tpu_torch as port
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError
from qiskit_dynamics_tpu_torch.perturbation import (
    ArrayPolynomial,
    CustomMatmul,
    CustomMul,
    compile_rule,
    magnus_from_dyson,
    multiset_utils,
    solve_lmde_perturbation,
)
from qiskit_dynamics_tpu_torch.perturbation.perturbation_utils import (
    merge_list_expansion_order_labels,
    merge_multiset_expansion_order_labels,
)

TOL = 1e-12
PERT_TOL = 1e-9


# --------------------------------------------------------------------------
# multisets and label merging: the port's copy against the JAX package's
# --------------------------------------------------------------------------
def test_multiset_helpers_match():
    raw = [(1, 0, 0), [2, 1], {0: 2, 3: 1}, 2, (0, 1, 1, 2)]
    assert [multiset_utils.to_multiset(x) for x in raw] == [
        jax_multiset.to_multiset(x) for x in raw
    ]
    cleaned = multiset_utils.clean_multisets(raw)
    assert cleaned == jax_multiset.clean_multisets(raw)
    assert multiset_utils.get_all_submultisets(cleaned) == jax_multiset.get_all_submultisets(
        cleaned
    )
    ms = (0, 0, 1, 2)
    assert multiset_utils.submultisets_and_complements(
        ms, 3
    ) == jax_multiset.submultisets_and_complements(ms, 3)
    assert multiset_utils.multiset_complement(ms, (0, 2)) == (0, 1)
    assert multiset_utils.is_submultiset((0, 0), ms) and not multiset_utils.is_submultiset(
        (1, 1), ms
    )
    with pytest.raises(DynamicsError):
        multiset_utils.to_multiset([-1])


@pytest.mark.parametrize("order, labels", [(2, None), (None, [[0, 1], [1, 1, 2]]), (3, [[0, 4]])])
def test_merge_expansion_labels_match(order, labels):
    pert = [(0,), (1,), (2,)]
    assert merge_multiset_expansion_order_labels(pert, order, labels) == jax_merge_multiset(
        pert, order, labels
    )
    list_labels = None if labels is None else [list(x) for x in labels]
    assert merge_list_expansion_order_labels(3, order, list_labels) == jax_merge_list(
        3, order, list_labels
    )


# --------------------------------------------------------------------------
# custom_dot
# --------------------------------------------------------------------------
def rule_three_rows():
    return [
        (np.array([1.0, 2.0, 3.0]), np.array([[0, 2], [1, 1], [2, 0]])),
        (np.array([1.0]), np.array([[0, 2]])),
        (np.array([3.0]), np.array([[1, 1]])),
    ]


def rule_repeated_pairs():
    return [(np.array([1.0, 2.0, 3.0]), np.array([[0, 2], [0, 0], [0, 0]]))]


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"index_offset": 1}, {"unique_evaluation_len": 8, "linear_combo_len": 5}],
)
def test_compile_rule_tables_match(kwargs):
    rule = [(c, p - kwargs.get("index_offset", 0)) for c, p in rule_three_rows()]
    ours, theirs = compile_rule(rule, **kwargs), jax_compile_rule(rule, **kwargs)
    np.testing.assert_array_equal(ours.pairs, theirs.pairs)
    np.testing.assert_array_equal(ours.idx, theirs.idx)
    np.testing.assert_array_equal(ours.coeffs, theirs.coeffs)


_DOT_SHAPES = {
    "square_complex": ((3, 4, 4), (3, 4, 4), True),
    "batched": ((3, 7, 4, 4), (3, 7, 4, 4), False),
    "unequal": ((3, 5, 1), (3, 1, 5), False),
}


@pytest.mark.parametrize("rule_fn", [rule_three_rows, rule_repeated_pairs])
@pytest.mark.parametrize("case", sorted(_DOT_SHAPES))
@pytest.mark.parametrize("kind", ["matmul", "mul"])
def test_custom_dot_matches_jax(kind, case, rule_fn):
    shape_a, shape_b, is_complex = _DOT_SHAPES[case]
    gen = rng(41)
    A, B = gen.normal(size=shape_a), gen.normal(size=shape_b)
    if is_complex:
        A = A + 1j * gen.normal(size=shape_a)
    ours = (CustomMatmul if kind == "matmul" else CustomMul)(rule_fn())
    theirs = (JaxCustomMatmul if kind == "matmul" else JaxCustomMul)(rule_fn())
    expected = to_np(theirs(jnp.asarray(A), jnp.asarray(B)))
    host = ours(A, B)
    assert isinstance(host, np.ndarray)
    assert_rel_close(host, expected, TOL)
    dev = ours(torch.as_tensor(A), torch.as_tensor(B))
    assert isinstance(dev, torch.Tensor)
    assert_rel_close(dev, expected, TOL)


def test_custom_dot_precompiled_and_grad():
    compiled = compile_rule(rule_three_rows())
    op = CustomMatmul(compiled)
    assert op.compiled_rule is compiled
    gen = rng(47)
    A = torch.as_tensor(gen.normal(size=(3, 4, 4)), dtype=torch.float64).requires_grad_(True)
    B = torch.as_tensor(gen.normal(size=(3, 4, 4)))
    assert_rel_close(CustomMatmul(compiled.astuple())(A, B), op(A, B), TOL)
    (g,) = torch.autograd.grad((op(A, B) ** 2).sum(), A)
    eps, dA = 1e-6, torch.zeros_like(A)
    dA[1, 2, 3] = eps
    fd = (((op(A + dA, B) ** 2).sum() - (op(A - dA, B) ** 2).sum()) / (2 * eps)).item()
    np.testing.assert_allclose(g[1, 2, 3].item(), fd, rtol=1e-6)


# --------------------------------------------------------------------------
# ArrayPolynomial
# --------------------------------------------------------------------------
LABELS = ((0,), (1,), (0, 1), (1, 1))


def poly_pair(seed, shape=(3, 3), labels=LABELS, const=True, tensor=False):
    """The same random polynomial in both packages (the port's with tensor
    coefficients if ``tensor``)."""
    gen = rng(seed)
    full = (len(labels),) + shape
    coeffs = gen.normal(size=full) + 1j * gen.normal(size=full)
    c = gen.normal(size=shape) + 1j * gen.normal(size=shape) if const else None
    wrap = torch.as_tensor if tensor else (lambda x: x)
    ours = ArrayPolynomial(
        constant_term=None if c is None else wrap(c), array_coefficients=wrap(coeffs),
        monomial_labels=list(labels),
    )
    theirs = JaxArrayPolynomial(
        constant_term=c, array_coefficients=coeffs, monomial_labels=list(labels)
    )
    return ours, theirs


def assert_same_polynomial(ours, theirs, tol=TOL):
    assert ours.monomial_labels == theirs.monomial_labels
    for got, want in (
        (ours.constant_term, theirs.constant_term),
        (ours.array_coefficients, theirs.array_coefficients),
    ):
        assert (got is None) == (want is None)
        if got is not None:
            assert_rel_close(got, to_np(want), tol)


@pytest.mark.parametrize(
    "labels",
    [LABELS, ((0,), (0, 1), (1, 1)), ((0, 0, 1), (2,)), ((0,), (1,), (2,)),
     ((0,), (1,), (0, 0), (0, 1), (1, 1), (0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1))],
    ids=["basic", "missing_prefix", "skipped_variable", "first_order", "complete_order3"],
)
@pytest.mark.parametrize("batch", [(), (5,), (4, 3)], ids=["scalar", "batch", "batch2d"])
def test_polynomial_evaluation_matches_jax(labels, batch):
    ours, theirs = poly_pair(5, labels=labels, const=False)
    c = rng(6).normal(size=(3,) + batch)
    mono = to_np(theirs.compute_monomials(jnp.asarray(c)))
    assert_rel_close(ours.compute_monomials(c), mono, TOL)
    assert_rel_close(ours.compute_monomials(torch.as_tensor(c)), mono, TOL)
    value = to_np(theirs(jnp.asarray(c)))
    assert isinstance(ours(c), np.ndarray)
    assert_rel_close(ours(c), value, TOL)
    assert_rel_close(ours(torch.as_tensor(c)), value, TOL)


def test_polynomial_constant_term_and_cache():
    ours, theirs = poly_pair(7)
    c = rng(8).normal(size=2)
    assert_rel_close(ours(c), to_np(theirs(jnp.asarray(c))), TOL)
    # evaluated at a batch, the constant broadcasts over the trailing axes
    batch = rng(9).normal(size=(2, 6))
    stacked = np.stack([to_np(theirs(jnp.asarray(batch[:, i]))) for i in range(6)], axis=-1)
    assert_rel_close(ours(torch.as_tensor(batch)), stacked, TOL)
    # the host coefficients are uploaded once per device and dtype
    first = ours.tensors("cpu", torch.complex128)
    assert ours.tensors("cpu", torch.complex128)[0] is first[0]
    assert ours.tensors("cpu", torch.complex64)[0].dtype == torch.complex64
    only_const = ArrayPolynomial(constant_term=np.eye(2))
    np.testing.assert_allclose(only_const(), np.eye(2))


def test_polynomial_gradient_through_evaluation():
    ours, _ = poly_pair(10, shape=(2, 2))
    c = torch.tensor([0.3, 0.4], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(torch.real(ours(c).sum()), c)
    eps = 1e-6
    for i in range(2):
        step = torch.zeros(2, dtype=torch.float64)
        step[i] = eps
        fd = (torch.real(ours(c.detach() + step).sum()) - torch.real(
            ours(c.detach() - step).sum())) / (2 * eps)
        np.testing.assert_allclose(g[i].item(), fd.item(), rtol=1e-7)


_METHODS = {
    "conj": lambda p: p.conj(),
    "transpose": lambda p: p.transpose(),
    "transpose_axes": lambda p: p.transpose((1, 0)),
    "trace": lambda p: p.trace(),
    "sum": lambda p: p.sum(),
    "sum_axis": lambda p: p.sum(axis=0),
    "sum_axes": lambda p: p.sum(axis=(0, 1)),
    "real": lambda p: p.real,
    "getitem": lambda p: p[0, 1],
    "getitem_slice": lambda p: p[1:],
    "neg": lambda p: -p,
}


@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("method", sorted(_METHODS))
def test_polynomial_array_methods_match_jax(method, tensor):
    ours, theirs = poly_pair(7, tensor=tensor)
    assert_same_polynomial(_METHODS[method](ours), _METHODS[method](theirs))
    assert len(ours) == len(theirs) == 5
    assert ours.shape == theirs.shape and ours.ndim == theirs.ndim


_FILTERS = {
    "none": None,
    "degree2": lambda m: len(m) <= 2,
    "first_order": lambda m: len(m) <= 1,
    "no_constant": lambda m: m in [(0,), (0, 1), (1, 1)],
}
_ALGEBRA = {
    "add": lambda a, b, f: a.add(b, monomial_filter=f),
    "matmul": lambda a, b, f: a.matmul(b, monomial_filter=f),
    "mul": lambda a, b, f: a.mul(b, monomial_filter=f),
}


@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("filt", sorted(_FILTERS))
@pytest.mark.parametrize("op", sorted(_ALGEBRA))
def test_polynomial_algebra_matches_jax(op, filt, tensor):
    a, ja = poly_pair(8, labels=((0,), (1,), (0, 1)), tensor=tensor)
    b, jb = poly_pair(9, labels=((0,), (0, 0)), tensor=tensor)
    ours = _ALGEBRA[op](a, b, _FILTERS[filt])
    theirs = _ALGEBRA[op](ja, jb, _FILTERS[filt])
    assert_same_polynomial(ours, theirs, 1e-11)
    if tensor and ours.array_coefficients is not None:
        assert isinstance(ours.array_coefficients, torch.Tensor)


_MIXED = {
    "add_array": lambda p, A: p + A,
    "radd_array": lambda p, A: A + p,
    "sub_array": lambda p, A: p - A,
    "rsub_array": lambda p, A: A - p,
    "matmul_array": lambda p, A: p @ A,
    "rmatmul_array": lambda p, A: A @ p,
    "mul_array": lambda p, A: p * A,
    "scalar_mul": lambda p, A: 2.5 * p,
}


@pytest.mark.parametrize("case", sorted(_MIXED))
def test_polynomial_algebra_with_arrays_matches_jax(case):
    ours, theirs = poly_pair(12)
    A = np.arange(9.0).reshape(3, 3)
    assert_same_polynomial(_MIXED[case](ours, A), _MIXED[case](theirs, A), 1e-11)


def test_polynomial_constant_only_and_broadcast_algebra():
    a, ja = ArrayPolynomial(constant_term=np.eye(3)), JaxArrayPolynomial(constant_term=np.eye(3))
    b, jb = poly_pair(13, const=False)
    assert_same_polynomial(a @ a + a, ja @ ja + ja)
    assert_same_polynomial(a @ b, ja @ jb)
    row, jrow = poly_pair(14, shape=(1, 3), labels=((0,), (1, 1)))
    assert_same_polynomial(b + row, jb + jrow)


def test_polynomial_validation():
    with pytest.raises(DynamicsError):
        ArrayPolynomial()
    with pytest.raises(DynamicsError):
        ArrayPolynomial(array_coefficients=np.ones((2, 2, 2)), monomial_labels=[[0]])
    with pytest.raises(DynamicsError):
        ArrayPolynomial(array_coefficients=np.ones((1, 2, 2)), monomial_labels=[[-1]])
    with pytest.raises(DynamicsError):
        ArrayPolynomial(constant_term=np.ones(3)).trace()
    with pytest.raises(DynamicsError, match="array_library"):
        ArrayPolynomial(constant_term=np.eye(2), array_library="jax")
    with pytest.raises(DynamicsError):
        ArrayPolynomial(constant_term=np.eye(2)) + "x"
    with pytest.raises(DynamicsError, match="broadcastable"):
        ArrayPolynomial(constant_term=np.ones((2, 2))) + ArrayPolynomial(
            constant_term=np.ones((3, 3)))


def test_polynomial_scipy_sparse_densifies():
    sparse = pytest.importorskip("scipy.sparse")
    mats = [sparse.csr_matrix(np.eye(2) * (k + 1)) for k in range(2)]
    with pytest.warns(UserWarning, match="densified"):
        ours = ArrayPolynomial(
            constant_term=sparse.csr_matrix(np.eye(2)), array_coefficients=mats,
            monomial_labels=[[0], [1]], array_library="scipy_sparse",
        )
    np.testing.assert_allclose(ours(np.array([1.0, 1.0])), 4.0 * np.eye(2))


# --------------------------------------------------------------------------
# solve_lmde_perturbation
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lmde_problem():
    gen = rng(21)
    mats = gen.normal(size=(4, 3, 3)) + 1j * gen.normal(size=(4, 3, 3))
    generator_matrix = mats[3] - mats[3].conj().T

    def perturbation(k):
        return lambda t: np.cos((k + 1) * t) * mats[k] + 1j * np.sin(t) * mats[(k + 1) % 3]

    return dict(
        perturbations=[perturbation(k) for k in range(3)],
        generator=lambda t: 0.3 * np.cos(2 * t) * generator_matrix,
        y0=gen.normal(size=(3, 3)) + 0j,
    )


_PERT_CASES = {
    "dyson_order2": dict(expansion_method="dyson", expansion_order=2),
    "dyson_labels": dict(expansion_method="dyson", expansion_labels=[[0, 1], [1, 1, 2]]),
    "dyson_custom_labels": dict(
        expansion_method="dyson", expansion_order=2,
        perturbation_labels=[[0], [1], [0, 1]],
    ),
    "dyson_generator_y0": dict(
        expansion_method="dyson", expansion_order=2, use_generator=True, use_y0=True,
        dyson_in_frame=False,
    ),
    "dyson_t_eval": dict(expansion_method="dyson", expansion_order=1, t_eval=[0.1, 0.4]),
    "magnus_order3": dict(expansion_method="magnus", expansion_order=3, n_pert=2),
    "magnus_generator": dict(expansion_method="magnus", expansion_order=2, use_generator=True),
    "dyson_like_order2": dict(expansion_method="dyson_like", expansion_order=2),
    "dyson_like_labels": dict(
        expansion_method="dyson_like", expansion_labels=[[0, 1, 2], [2, 0]], use_generator=True,
    ),
}


@pytest.mark.parametrize("case", sorted(_PERT_CASES))
def test_solve_lmde_perturbation_matches_jax(case, lmde_problem):
    kwargs = dict(_PERT_CASES[case])
    perturbations = lmde_problem["perturbations"][: kwargs.pop("n_pert", 3)]
    if kwargs.pop("use_generator", False):
        kwargs["generator"] = lmde_problem["generator"]
    if kwargs.pop("use_y0", False):
        kwargs["y0"] = lmde_problem["y0"]
    kwargs.update(t_span=[0.0, 0.5], atol=1e-12, rtol=1e-12)
    ours = solve_lmde_perturbation(perturbations, **kwargs)
    theirs = jax_solve_perturbation(perturbations, **kwargs)
    assert list(ours.perturbation_data.labels) == list(theirs.perturbation_data.labels)
    assert ours.perturbation_data.metadata == theirs.perturbation_data.metadata
    assert_rel_close(ours.perturbation_data.data, to_np(theirs.perturbation_data.data), PERT_TOL)
    assert_rel_close(ours.y, to_np(theirs.y), PERT_TOL)
    label = ours.perturbation_data.labels[-1]
    assert_rel_close(
        ours.perturbation_data.get_item(label), to_np(theirs.perturbation_data.get_item(label)),
        PERT_TOL,
    )


def test_magnus_from_dyson_matches_jax():
    labels = multiset_utils.get_all_submultisets([(0, 0, 1), (0, 1, 1)])
    gen = rng(23)
    dyson = 0.3 * (
        gen.normal(size=(len(labels), 2, 3, 3)) + 1j * gen.normal(size=(len(labels), 2, 3, 3))
    )
    assert_rel_close(magnus_from_dyson(labels, dyson), to_np(jax_magnus_from_dyson(labels, dyson)),
                     TOL)
    first_order = [(0,), (1,)]
    np.testing.assert_array_equal(magnus_from_dyson(first_order, dyson[:2]), dyson[:2])


def test_solve_lmde_perturbation_validation(lmde_problem):
    perturbations = lmde_problem["perturbations"]
    with pytest.raises(DynamicsError, match="A12"):
        solve_lmde_perturbation(
            perturbations, [0.0, 0.1], "dyson", expansion_order=1,
            integration_method="jax_odeint",
        )
    with pytest.raises(DynamicsError, match="not supported"):
        solve_lmde_perturbation(perturbations, [0.0, 0.1], "taylor", expansion_order=1)
    with pytest.raises(DynamicsError, match="magnus"):
        solve_lmde_perturbation(
            perturbations, [0.0, 0.1], "magnus", expansion_order=1, y0=np.eye(3))
    with pytest.raises(DynamicsError, match="dyson_in_frame"):
        solve_lmde_perturbation(
            perturbations, [0.0, 0.1], "dyson", expansion_order=1, y0=np.eye(3))
    with pytest.raises(DynamicsError, match="duplicates"):
        solve_lmde_perturbation(
            perturbations, [0.0, 0.1], "dyson", expansion_order=1,
            perturbation_labels=[[0], [0], [1]],
        )
    with pytest.raises(DynamicsError, match="At least one"):
        solve_lmde_perturbation(perturbations, [0.0, 0.1], "dyson")


def test_package_exports():
    for name in ("solve_lmde_perturbation", "ArrayPolynomial", "PowerSeriesData",
                 "DysonLikeData", "Multiset", "to_multiset", "CustomMatmul", "CustomMul",
                 "magnus_from_dyson"):
        assert hasattr(port.perturbation, name)
    assert port.ArrayPolynomial is ArrayPolynomial
    assert port.solve_lmde_perturbation is solve_lmde_perturbation
