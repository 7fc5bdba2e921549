"""Kernel B11's wrapper (``qiskit_dynamics_tpu_torch/ops/monomial_contract.py``)
on the CPU.

The CPU route is the perturbative sweep's expression as it was before the
kernel (``compute_monomials``, then ``addmm`` or a product, then the complex
or planar layout): equal bit for bit. The kernel's operands (each term's
variables in order, the coefficients packed by tile, the constant term)
reproduce the expansion when a Python model of the kernel's arithmetic reads
them: the monomials as left-to-right products equal ``compute_monomials``
bit for bit, complete and incomplete expansions alike, and the contraction
by tile the plain version's in float64. The launch shape covers every entry;
the backward is the plain version's VJP. The card tests are in
``test_torch_perturbative_cuda.py``. This file imports nothing of JAX.
"""
import itertools

import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch import interop
from qiskit_dynamics_tpu_torch.kernels import MAX_SHARED_BYTES, launches
from qiskit_dynamics_tpu_torch.ops import monomial_contract as mc
from qiskit_dynamics_tpu_torch.utils import metrics

N_VARS = 4


def complete_labels(order, n_vars=N_VARS):
    """Every multiset of 1 to ``order`` of the variables, by degree."""
    return [list(ms) for d in range(1, order + 1)
            for ms in itertools.combinations_with_replacement(range(n_vars), d)]


# node prefixes missing from the labels (positions not the identity) and
# variables 1 and 3 never named
INCOMPLETE = [[0], [2], [0, 2], [2, 2, 2], [0, 0, 2], [0, 2, 2, 2]]


def make_expansion(labels, n, dtype=torch.complex128, constant=True, seed=3):
    """The :class:`Expansion` a seeded Dyson solver of dimension n builds for
    its sweep (as ``solve_sweep`` does), around the given labels."""
    gen = np.random.default_rng(seed)

    def anti_hermitian(scale):
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return -1j * scale * (a + a.conj().T) / (2 * np.sqrt(n))

    solver = interop.perturbative_solver_from_arrays(
        operators=anti_hermitian(1.0)[None], frame_operator=None, dt=0.1,
        carrier_freqs=np.array([5.0]), chebyshev_orders=[1], include_imag=[True],
        Udt=np.eye(n, dtype=complex), expansion_method="dyson",
        poly_constant=np.eye(n) if constant else None,
        poly_coefficients=np.stack([anti_hermitian(0.3) for _ in labels]),
        poly_labels=labels, device="cpu", dtype=dtype,
    )
    return solver._sweep_expansion(dtype)[0]


def coefficient_table(L, dtype, seed=4):
    gen = np.random.default_rng(seed)
    return torch.as_tensor(gen.uniform(-1.2, 1.2, size=(N_VARS, L))).to(dtype)


def todays_expression(coeffs, expansion, interleaved):
    """The sweep's table and product as ``_sweep_chain`` wrote them."""
    n = expansion.n
    monomials = expansion.polynomial.compute_monomials(coeffs)
    if expansion.start is None:
        lanes = expansion.planes @ monomials
    else:
        lanes = torch.addmm(expansion.start, expansion.planes, monomials)
    lanes = lanes.reshape(2, n, n, coeffs.shape[1])
    return torch.complex(lanes[0], lanes[1]) if interleaved else lanes


def folded_monomials(coeffs, expansion):
    """The kernel's monomials in fold mode: each term's variables multiplied
    left to right."""
    offsets, variables = expansion.offsets, expansion.variables
    rows = []
    for k in range(len(offsets) - 1):
        names = variables[offsets[k]:offsets[k + 1]].tolist()
        value = coeffs[names[0]]
        for v in names[1:]:
            value = value * coeffs[v]
        rows.append(value)
    return torch.stack(rows)


def table_monomials(coeffs, expansion):
    """The kernel's monomials in table mode: the nodes degree by degree, each
    its parent's slot times its variable, the terms in slots 0 .. M - 1."""
    nodes, levels = expansion.nodes, expansion.levels
    slots = {}
    for d in range(len(levels) - 1):
        for slot, parent, var, _ in nodes[levels[d]:levels[d + 1]].tolist():
            slots[slot] = coeffs[var] if parent < 0 else slots[parent] * coeffs[var]
    assert sorted(slots) == list(range(len(nodes)))
    return torch.stack([slots[k] for k in range(len(expansion.offsets) - 1)])


def kernel_model(coeffs, expansion, shape, interleaved):
    """The kernel's contraction from its operands, tile by tile, in float64."""
    _, _, _, _, packed, start = expansion.operands(shape)
    n, L = expansion.n, coeffs.shape[1]
    mono = table_monomials(coeffs, expansion).double()
    tiles = [torch.einsum("kjp,kl->jpl", packed[t].double(), mono) for t in range(shape.tiles)]
    out = torch.cat(tiles)[:n * n]                    # (E, 2, L)
    if start is not None:
        out = out + start.double().reshape(2, n * n).T[:, :, None]
    out = out.permute(1, 0, 2).reshape(2, n, n, L)
    return torch.complex(out[0], out[1]) if interleaved else out


# ---------------------------------------------------------------------------
# the CPU route is the expression it replaced
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("constant", [True, False], ids=["constant", "no-constant"])
@pytest.mark.parametrize("interleaved", [True, False], ids=["complex", "planes"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cpu_route_is_the_table_and_addmm_bit_for_bit(dtype, interleaved, constant):
    expansion = make_expansion(complete_labels(3), 3, dtype, constant)
    coeffs = coefficient_table(75, expansion.planes.dtype)
    metrics.reset_spans()
    got = mc.contract_monomials(coeffs, expansion, interleaved)
    want = todays_expression(coeffs, expansion, interleaved)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert launches("monomial_contract_launch") == 0


def test_cpu_route_incomplete_expansion_bit_for_bit():
    expansion = make_expansion(INCOMPLETE, 2, torch.complex64)
    assert expansion.polynomial._positions is not None  # the nodes are not the labels
    coeffs = coefficient_table(33, torch.float32)
    for interleaved in (True, False):
        assert torch.equal(mc.contract_monomials(coeffs, expansion, interleaved),
                           todays_expression(coeffs, expansion, interleaved))


# ---------------------------------------------------------------------------
# the kernel's operands
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("labels", [complete_labels(6), complete_labels(3), INCOMPLETE],
                         ids=["dyson6", "order3", "incomplete"])
def test_both_modes_monomials_equal_compute_monomials_bit_for_bit(labels):
    expansion = make_expansion(labels, 2, torch.complex64)
    coeffs = coefficient_table(130, torch.float32)
    assert len(expansion.offsets) == len(labels) + 1 and expansion.offsets.dtype == np.int32
    want = expansion.polynomial.compute_monomials(coeffs)
    assert torch.equal(folded_monomials(coeffs, expansion), want)
    assert torch.equal(table_monomials(coeffs, expansion), want)


def test_node_table_puts_the_terms_first_and_parents_a_degree_below():
    expansion = make_expansion(INCOMPLETE, 2, torch.complex64)
    nodes, levels = expansion.nodes, expansion.levels
    assert nodes.shape == (9, 4) and levels.tolist() == [0, 2, 5, 8, 9]  # 3 prefixes not terms
    degree = {int(slot): d + 1 for d in range(len(levels) - 1)
              for slot in nodes[levels[d]:levels[d + 1], 0]}
    for slot, parent, _, _ in nodes.tolist():
        assert parent == -1 if degree[slot] == 1 else degree[parent] == degree[slot] - 1
    assert sorted(nodes[:, 0].tolist()) == list(range(9))


def test_repeated_labels_fold():
    expansion = make_expansion([[0], [1], [0, 1], [0, 1]], 2, torch.complex64)
    shape = mc.launch_shape(2)
    assert len(expansion.nodes) == 0 and mc.plan(expansion, shape, N_VARS) == (0, 64)
    coeffs = coefficient_table(9, torch.float32)
    assert torch.equal(folded_monomials(coeffs, expansion),
                       expansion.polynomial.compute_monomials(coeffs))


def test_plan_keeps_the_table_where_it_fits():
    """The cells' expansions keep every node in shared memory with chunks of
    64 terms; a table past the limit folds; a forced fold folds."""
    shape = mc.launch_shape(10)
    dyson = make_expansion(complete_labels(6), 2, torch.complex64)
    assert mc.plan(dyson, shape, N_VARS) == (209, 64)
    assert mc.plan(dyson, shape, N_VARS, fold=True) == (0, 64)
    big = make_expansion(complete_labels(8, 5), 2, torch.complex64)  # 1,286 terms
    assert mc.plan(big, shape, 5) == (0, 64)
    wide = mc.LaunchShape(10, 12, 1)  # 120 entries a tile: 209 nodes fit with chunks of 32 only
    assert mc.plan(dyson, wide, N_VARS) == (209, 32)
    for n_nodes, chunk in [mc.plan(dyson, shape, N_VARS), mc.plan(dyson, wide, N_VARS)]:
        assert shape.smem_bytes(n_nodes, N_VARS, chunk) <= MAX_SHARED_BYTES


@pytest.mark.parametrize("n, te", [(10, None), (3, None), (12, None), (5, 2), (5, 4), (9, 8),
                                   (7, 10)])
@pytest.mark.parametrize("interleaved", [True, False], ids=["complex", "planes"])
def test_kernel_operands_reproduce_the_expansion(n, te, interleaved):
    """Tiles (n = 12 takes two), padded entries and both layouts: the
    kernel's arithmetic on its operands is the plain version's in float64."""
    expansion = make_expansion(complete_labels(2), n, torch.complex128)
    shape = mc.launch_shape(n, te)
    coeffs = coefficient_table(19, torch.float64)
    got = kernel_model(coeffs, expansion, shape, interleaved)
    # the kernel reads the coefficients in float32
    rounded = mc.Expansion(expansion.polynomial, expansion.planes.float().double(),
                           expansion.start.float().double(), n)
    want = mc.contract_monomials_plain(coeffs, rounded, interleaved)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))


def test_packed_planes_hold_every_entry_once_and_zeros_past_them():
    n, terms = 12, 5
    planes = torch.arange(2 * n * n * terms, dtype=torch.float32).reshape(2 * n * n, terms) + 1
    shape = mc.launch_shape(n)
    packed = mc.pack_planes(planes, n, shape)
    per_tile = shape.entries_per_tile
    assert packed.shape == (shape.tiles, terms, per_tile, 2) and packed.is_contiguous()
    entries = packed.transpose(0, 1).reshape(terms, shape.tiles * per_tile, 2)
    assert torch.equal(entries[:, :n * n].permute(2, 1, 0).reshape(2 * n * n, terms), planes)
    assert not entries[:, n * n:].any()


# ---------------------------------------------------------------------------
# launch shape (pure)
# ---------------------------------------------------------------------------
def test_launch_shape_at_the_cell_is_one_tile_of_ten_warps():
    shape = mc.launch_shape(10)
    assert (shape.te, shape.warps, shape.tiles) == (10, 10, 1)
    assert shape.threads == 320
    assert shape.smem_bytes(209, 4, 64) == 4 * (209 * 128 + 2 * 64 * 200 + 2 * 4 * 128 + 4 * 209)
    assert shape.smem_bytes(0, 4, 32) == 4 * (32 * 128 + 2 * 32 * 200)


@pytest.mark.parametrize("te", [None, 2, 4, 8, 10])
def test_launch_shape_covers_every_entry_within_the_block_limits(te):
    for n in list(range(1, 40)) + [64, 65, 100, 256]:
        shape = mc.launch_shape(n, te)
        assert te is None or shape.te == te
        assert 1 <= shape.warps <= mc.MAX_WARPS[shape.te]
        assert shape.tiles * shape.entries_per_tile >= n * n
        assert shape.tiles * (shape.warps - 1) * shape.te < n * n  # no warp of padding alone
        assert shape.smem_bytes(0, 1_000, 32) <= MAX_SHARED_BYTES  # fold mode always fits
    with pytest.raises(ValueError, match="te must be 2, 4, 8 or 10"):
        mc.launch_shape(10, 3)


# ---------------------------------------------------------------------------
# the backward and the checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("interleaved", [True, False], ids=["complex", "planes"])
def test_backward_is_the_vjp_of_the_plain_version(monkeypatch, interleaved):
    """The autograd function's backward, with its forward stood in for by the
    plain version: the plain version's own gradient, bit for bit."""
    monkeypatch.setattr(mc, "_launch_kernel", lambda c, e, i: mc.contract_monomials_plain(c, e, i))
    expansion = make_expansion(complete_labels(3), 3, torch.complex64)
    weights = torch.as_tensor(np.random.default_rng(8).normal(size=(2, 3, 3, 21)),
                              dtype=torch.float32)
    grads = []
    for run in (lambda c: mc._Contract.apply(c, expansion, interleaved),
                lambda c: mc.contract_monomials_plain(c, expansion, interleaved)):
        coeffs = coefficient_table(21, torch.float32).requires_grad_(True)
        out = run(coeffs)
        planes = torch.stack([out.real, out.imag]) if interleaved else out
        (grad,) = torch.autograd.grad((planes * weights).sum(), coeffs)
        grads.append(grad)
    assert torch.equal(grads[0], grads[1]) and bool(grads[0].abs().sum() > 0)


def test_checks():
    expansion = make_expansion(complete_labels(2), 2, torch.complex64)
    with pytest.raises(ValueError, match="coeffs must be"):
        mc.contract_monomials(torch.zeros(N_VARS, 3, 2), expansion)
    with pytest.raises(ValueError, match="name variable 3; coeffs has 2"):
        mc.contract_monomials(torch.zeros(2, 5), expansion)
    with pytest.raises(TypeError, match="one device and one dtype"):
        mc.contract_monomials(torch.zeros(N_VARS, 5, dtype=torch.float64), expansion)
    with pytest.raises(ValueError, match="planes must be"):
        mc.Expansion(expansion.polynomial, expansion.planes[:, :3], None, 2)
