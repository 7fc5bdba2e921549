"""The CUDA kernels of the perturbative sweep against their plain versions, on the card.

The streamed propagator chain (``csrc/chain_apply.cu``), the batched
product, Taylor expm and expm backward (``csrc/batched_linalg.cu``) and the
monomials and their contraction (``csrc/monomial_contract.cu``, B11). These
tests need an NVIDIA GPU with nvcc; without one they skip. On the card run
them with ``python -m pytest tests/test_torch_perturbative_cuda.py -m cuda
--noconftest``.

The chain kernel is built without multiply-add contraction and its plain
version repeats its rounded operations in order: they agree bit for bit. The
batched_linalg kernels fuse multiply-adds and sum in their own order, so they
agree with the plain versions (``torch.einsum``) to float32 roundoff: within
1e-5 on unit-norm inputs. B11 forms the plain version's monomials bit for
bit and sums them in FP32 multiply-adds in term order where the plain
version's cuBLAS product takes its own order: within ``B11_TOL`` of the
largest output entry. This file imports nothing of JAX.
"""
import itertools

import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import batched_linalg as bl
from qiskit_dynamics_tpu_torch.ops import chain_apply as ca
from qiskit_dynamics_tpu_torch.ops import monomial_contract as mc
from qiskit_dynamics_tpu_torch.utils import metrics

pytestmark = pytest.mark.cuda

TOL = 1e-5
# B11 against its plain version, relative to the largest output entry: two
# float32 sums of up to 209 terms of the cells' size in different orders
B11_TOL = 1e-5
DIMS = (2, 4, 10, 16, 32)
BATCHES = (37, 1000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def unitary_stack(gen, T, n, B):
    """(T, n, n, B) complex64 near-unitary propagators: exp(-i H) to second
    order for small Hermitian H, so a chain of them keeps the state's norm."""
    h = gen.normal(size=(T, B, n, n)) + 1j * gen.normal(size=(T, B, n, n))
    h = 0.3 / np.sqrt(n) * (h + np.conj(np.swapaxes(h, -1, -2))) / 2
    u = np.eye(n) - 1j * h - h @ h / 2
    return np.ascontiguousarray(np.transpose(u, (0, 2, 3, 1))).astype(np.complex64)


def unit_planes(gen, n, B, device, count=2, scale=1.0, dtype=torch.float32):
    """``count`` (n, n, B) planes, float32 unless ``dtype`` says otherwise;
    each lane's complex matrix has Frobenius norm ``scale``."""
    x = gen.normal(size=(count, n, n, B))
    pairs = x.reshape(count // 2, 2, n, n, B)
    pairs = scale * pairs / np.sqrt((pairs**2).sum(axis=(1, 2, 3), keepdims=True))
    return [torch.as_tensor(p, device=device).to(dtype) for p in pairs.reshape(count, n, n, B)]


def max_diff(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("n", DIMS)
def test_chain_kernel_matches_plain_bitwise(cuda, n, B, T):
    gen = np.random.default_rng(100 * n + T)
    props = torch.as_tensor(unitary_stack(gen, T, n, B), device=cuda)
    y0 = gen.normal(size=(n, B)) + 1j * gen.normal(size=(n, B))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=cuda).to(torch.complex64)
    before = launches("chain_apply_launch")
    out = ca.chain_apply_bol(props, y0)
    plain = ca.chain_apply_bol_plain(props, y0)
    torch.cuda.synchronize()
    assert launches("chain_apply_launch") == before + 1
    assert out.shape == (n, B)
    assert torch.equal(out, plain)


def test_chain_kernel_strided_stack(cuda):
    """The (n, n, T, B) product of a matmul, viewed as (T, n, n, B), is read
    in place."""
    gen = np.random.default_rng(5)
    T, n, B = 6, 10, 37
    stack = torch.as_tensor(unitary_stack(gen, T, n, B), device=cuda)
    view = torch.movedim(torch.movedim(stack, 0, 2).contiguous(), 2, 0)
    assert not view.is_contiguous()
    y0 = torch.as_tensor(np.ones((n, B)) / np.sqrt(n), device=cuda).to(torch.complex64)
    assert torch.equal(ca.chain_apply_bol(view, y0), ca.chain_apply_bol(stack, y0))


def test_chain_gradient_uses_eager_backward(cuda):
    gen = np.random.default_rng(6)
    T, n, B = 5, 4, 9
    props = torch.as_tensor(unitary_stack(gen, T, n, B), device=cuda).requires_grad_(True)
    y0 = torch.as_tensor(np.ones((n, B)) / 2.0, device=cuda).to(torch.complex64)
    y0.requires_grad_(True)
    (ca.chain_apply_bol_ad(props, y0)[1].abs() ** 2).sum().backward()
    twin_p = props.detach().clone().requires_grad_(True)
    twin_y = y0.detach().clone().requires_grad_(True)
    y = twin_y
    for t in range(T):
        y = torch.einsum("ijb,jb->ib", twin_p[t], y)
    (y[1].abs() ** 2).sum().backward()
    assert float((props.grad - twin_p.grad).abs().max()) <= TOL
    assert float((y0.grad - twin_y.grad).abs().max()) <= TOL


def test_chain_kernel_rejects(cuda):
    props = torch.zeros((2, 4, 4, 3), dtype=torch.complex64, device=cuda)
    y0 = torch.zeros((4, 3), dtype=torch.complex64, device=cuda)
    with pytest.raises(TypeError, match="of one type"):
        ca.chain_apply_bol(props, y0.to(torch.complex128))
    with pytest.raises(ValueError, match="at least one propagator"):
        ca.chain_apply_bol(props[:0], y0)
    n = ca.MAX_N + 1
    big = torch.zeros((1, n, n, 1), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match=f"n <= {ca.MAX_N}"):
        ca.chain_apply_bol(big, torch.zeros((n, 1), dtype=torch.complex64, device=cuda))


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("n", DIMS)
def test_matmul_kernel_matches_plain(cuda, n, B):
    planes = unit_planes(np.random.default_rng(n), n, B, cuda, count=4)
    before = launches("matmul_bol_launch")
    out = bl.matmul_bol(*planes)
    plain = bl.matmul_bol_plain(*planes)
    torch.cuda.synchronize()
    assert launches("matmul_bol_launch") == before + 1
    assert out[0].shape == out[1].shape == (n, n, B)
    assert max_diff(out, plain) <= TOL


@pytest.mark.parametrize("order, squarings", [(8, 0), (8, 2), (12, 0), (12, 1), (12, 2)])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("n", DIMS)
def test_expm_kernel_matches_plain(cuda, n, B, order, squarings):
    planes = unit_planes(np.random.default_rng(n + order), n, B, cuda)
    before = launches("expm_bol_launch")
    out = bl.expm_taylor_bol(*planes, order=order, squarings=squarings)
    plain = bl.expm_taylor_bol_plain(*planes, order, squarings)
    torch.cuda.synchronize()
    assert launches("expm_bol_launch") == before + 1
    assert max_diff(out, plain) <= TOL


@pytest.mark.parametrize("order, squarings", [(8, 0), (8, 2), (12, 0), (12, 1), (12, 2)])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("n", DIMS)
def test_expm_bwd_kernel_matches_plain(cuda, n, B, order, squarings):
    planes = unit_planes(np.random.default_rng(n + order + 50), n, B, cuda, count=4)
    before = launches("expm_bwd_bol_launch")
    out = bl.expm_taylor_bol_bwd(*planes, order=order, squarings=squarings)
    plain = bl.expm_taylor_bol_bwd_plain(*planes, order, squarings)
    torch.cuda.synchronize()
    assert launches("expm_bwd_bol_launch") == before + 1
    assert max_diff(out, plain) <= TOL


# the lane kernels (n <= 16) and the tiled ones above them, at unaligned n and
# lane counts that split the lane groups (3 lanes per warp at n = 10) raggedly
LANE_DIMS = (1, 3, 7, 10, 11, 13, 16, 17, 33, 64)
LANE_BATCHES = (1, 7, 33, 1000)


def bwd_scale(want):
    return max(1.0, max(float(w.abs().max()) for w in want))


@pytest.mark.parametrize("B", LANE_BATCHES)
@pytest.mark.parametrize("n", LANE_DIMS)
def test_expm_kernels_ragged_lanes(cuda, n, B):
    planes = unit_planes(np.random.default_rng(1000 + n + B), n, B, cuda, count=4)
    before = (launches("expm_bol_launch"), launches("expm_bwd_bol_launch"))
    for order, squarings in ((12, 1), (5, 0), (1, 3)):
        out = bl.expm_taylor_bol(*planes[:2], order, squarings)
        assert max_diff(out, bl.expm_taylor_bol_plain(*planes[:2], order, squarings)) <= TOL
        out = bl.expm_taylor_bol_bwd(*planes, order, squarings)
        want = bl.expm_taylor_bol_bwd_plain(*planes, order, squarings)
        assert out[0].shape == (n, n, B)
        assert max_diff(out, want) <= TOL * bwd_scale(want)
    torch.cuda.synchronize()
    assert (launches("expm_bol_launch"), launches("expm_bwd_bol_launch")) == (
        before[0] + 3, before[1] + 3)


@pytest.mark.parametrize("B", LANE_BATCHES)
@pytest.mark.parametrize("n", LANE_DIMS)
def test_expm_kernel_complex128(cuda, n, B):
    planes = unit_planes(np.random.default_rng(2000 + n + B), n, B, cuda, dtype=torch.float64)
    before = launches("expm_bol_launch")
    out = bl.expm_taylor_bol(*planes, 12, 1)
    torch.cuda.synchronize()
    assert launches("expm_bol_launch") == before + 1
    assert out[0].dtype == torch.float64
    assert max_diff(out, bl.expm_taylor_bol_plain(*planes, 12, 1)) <= 1e-12


@pytest.mark.parametrize("n", [3, 10, 17, 65])
def test_expm_bwd_kernel_is_the_autograd_vjp(cuda, n):
    """B7 against autograd through the forward recursion (on the card, in
    float32): the VJP the tangent recursion stands for."""
    planes = unit_planes(np.random.default_rng(3000 + n), n, 33, cuda, count=4)
    xr, xi = [p.clone().requires_grad_(True) for p in planes[:2]]
    outs = bl.expm_taylor_bol_plain(xr, xi, 12, 1)
    want = torch.autograd.grad(outs, (xr, xi), tuple(planes[2:]))
    got = bl.expm_taylor_bol_bwd(*planes, 12, 1)
    assert max_diff(got, want) <= TOL * bwd_scale(want)


def test_expm_bwd_needs_no_work_buffer(cuda):
    """No tape: the backward asks for device memory only where its six
    working matrices pass a block's shared memory (n > 69)."""
    lib = bl._LIB
    assert lib.batched_linalg_work_bytes(2, 10, 256000, 12, 1, 0) == 0
    for n in (1, 16, 17, 64, 69):
        assert lib.batched_linalg_work_bytes(2, n, 1000, 12, 1, 0) == 0
    assert lib.batched_linalg_work_bytes(2, 70, 1000, 12, 1, 0) > 0


def test_launch_shapes(cuda):
    expm = bl.launch_shape("expm", 10, 2_048_000)
    # rounds of 8 warps x 3 lanes
    assert expm.lane_kernel and expm.threads_per_lane == 10 and expm.lanes_per_block % 24 == 0
    assert expm.blocks == -(-2_048_000 // expm.lanes_per_block) and expm.warps_per_sm >= 16
    bwd = bl.launch_shape("expm_bwd", 10, 256_000)
    assert bwd.lane_kernel and bwd.lanes_per_block % 24 == 0 and bwd.warps_per_sm >= 8
    assert bl.launch_shape("expm", 10, 1_024_000, double=True).lane_kernel
    assert not bl.launch_shape("expm", 17, 100).lane_kernel
    assert not bl.launch_shape("matmul", 10, 100).lane_kernel
    wide = bl.launch_shape("expm_bwd", 100, 256)
    assert wide.in_device and wide.wide and not wide.lane_kernel
    with pytest.raises(ValueError, match="refuses"):
        bl.launch_shape("expm", bl.MAX_N + 1, 8)


def test_kernels_read_complex_views_in_place(cuda):
    """The real/imag views of a complex tensor (element stride 2) give the
    same result as contiguous planes."""
    n, B = 10, 37
    planes = unit_planes(np.random.default_rng(9), n, B, cuda, count=4)
    x = torch.complex(planes[0], planes[1])
    ct = torch.complex(planes[2], planes[3])
    assert torch.equal(bl.expm_taylor_bol(x.real, x.imag, 12, 1)[0],
                       bl.expm_taylor_bol(planes[0], planes[1], 12, 1)[0])
    assert torch.equal(bl.expm_taylor_bol_bwd(x.real, x.imag, ct.real, ct.imag, 12, 1)[1],
                       bl.expm_taylor_bol_bwd(*planes, 12, 1)[1])
    assert torch.equal(bl.matmul_bol(x.real, x.imag, ct.real, ct.imag)[0],
                       bl.matmul_bol(*planes)[0])


def test_expm_ad_launches_both_kernels(cuda):
    planes = [p.requires_grad_(True) for p in unit_planes(np.random.default_rng(3), 4, 9, cuda)]
    fwd, bwd = launches("expm_bol_launch"), launches("expm_bwd_bol_launch")
    pr, pi = bl.expm_taylor_bol_ad(*planes, 12, 1)
    (pr.sum() + 2.0 * pi.sum()).backward()
    assert launches("expm_bol_launch") == fwd + 1
    assert launches("expm_bwd_bol_launch") == bwd + 1
    twins = [p.detach().clone().requires_grad_(True) for p in planes]
    tr, ti = bl.expm_taylor_bol_plain(*twins, 12, 1)
    (tr.sum() + 2.0 * ti.sum()).backward()
    assert max_diff([p.grad for p in planes], [t.grad for t in twins]) <= TOL


def test_batched_linalg_kernels_reject(cuda):
    planes = unit_planes(np.random.default_rng(1), 4, 3, cuda)
    with pytest.raises(TypeError, match="float32 only"):
        bl.matmul_bol(*[p.double() for p in planes * 2])
    with pytest.raises(TypeError, match="float32 only"):
        bl.expm_taylor_bol_bwd(*[p.double() for p in planes * 2])
    with pytest.raises(ValueError, match="shape mismatch"):
        bl.matmul_bol(planes[0], planes[1], planes[0], planes[1][:, :, :2])
    big = unit_planes(np.random.default_rng(2), bl.MAX_N + 1, 2, cuda)
    with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
        bl.expm_taylor_bol(*big)


# --------------------------------------------------------------------------
# above n = 64 (a lane's matrices in device memory above 98) the kernels run
# --------------------------------------------------------------------------
def launch_counts():
    return tuple(launches(entry) for entry in ("chain_apply_launch", "matmul_bol_launch",
                                               "expm_bol_launch", "expm_bwd_bol_launch"))


@pytest.mark.parametrize("n", [65, 80, 100])
def test_ops_past_64_run_the_kernels(cuda, n):
    """chain_apply_bol, matmul_bol, expm_taylor_bol and the gradients of
    their ``_ad`` forms at n > 64 on the card: the CPU plain version's
    results within float32 roundoff, each through its kernel."""
    gen = np.random.default_rng(n)
    before = launch_counts()
    props = unitary_stack(gen, 3, n, 5)
    y0 = (gen.normal(size=(n, 5)) + 1j * gen.normal(size=(n, 5))).astype(np.complex64)
    got = ca.chain_apply_bol(torch.as_tensor(props, device=cuda), torch.as_tensor(y0, device=cuda))
    want = ca.chain_apply_bol_plain(torch.as_tensor(props), torch.as_tensor(y0))
    assert float((got.cpu() - want).abs().max()) <= TOL * np.sqrt(n)

    planes = unit_planes(gen, n, 6, "cpu", count=4)
    got = bl.matmul_bol(*[p.to(cuda) for p in planes])
    assert max_diff([g.cpu() for g in got], bl.matmul_bol_plain(*planes)) <= TOL
    got = bl.expm_taylor_bol(*[p.to(cuda) for p in planes[:2]], 8, 1)
    assert max_diff([g.cpu() for g in got], bl.expm_taylor_bol_plain(*planes[:2], 8, 1)) <= TOL

    grads = []
    for device in (cuda, "cpu"):
        xs = [p.to(device).requires_grad_(True) for p in planes[:2]]
        pr, pi = bl.expm_taylor_bol_ad(*xs, 8, 1)
        (pr * planes[2].to(device) + pi * planes[3].to(device)).sum().backward()
        u = torch.as_tensor(props, device=device).requires_grad_(True)
        out = ca.chain_apply_bol_ad(u, torch.as_tensor(y0, device=device))
        (out.abs() ** 2).sum().backward()
        grads.append([xs[0].grad, xs[1].grad, u.grad])
    for g, w in zip(*grads):
        assert float((g.cpu() - w).abs().max()) <= TOL * max(1.0, float(w.abs().max()))
    # chain twice (plain and _ad), matmul once, expm twice, its backward once
    assert tuple(a - b for a, b in zip(launch_counts(), before)) == (2, 1, 2, 1)


def synthetic_solver(method, n, device, seed=5, labels=None):
    """A Dyson or Magnus solver of dimension ``n`` around seeded arrays in
    place of a precomputed expansion (one drive, Chebyshev order 1 with the
    imaginary part: four coefficients; by default six terms), complex64."""
    from qiskit_dynamics_tpu_torch import interop

    gen = np.random.default_rng(seed)

    def anti_hermitian(scale):
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return -1j * scale * (a + a.conj().T) / (2 * np.sqrt(n))

    udt, _ = np.linalg.qr(gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n)))
    labels = labels or [[0], [1], [2], [3], [0, 0], [0, 2]]
    return interop.perturbative_solver_from_arrays(
        operators=anti_hermitian(1.0)[None], frame_operator=None, dt=0.1,
        carrier_freqs=np.array([5.0]), chebyshev_orders=[1], include_imag=[True], Udt=udt,
        expansion_method=method, poly_constant=np.eye(n) if method == "dyson" else None,
        poly_coefficients=np.stack([anti_hermitian(0.05) for _ in labels]),
        poly_labels=labels, device=device, dtype=torch.complex64,
    )


@pytest.mark.parametrize("method", ["dyson", "magnus"])
def test_perturbative_sweep_past_64(cuda, method):
    """``DysonSolver``/``MagnusSolver.solve_sweep`` at dimension 65 on the card:
    the CPU's result within complex64 roundoff, through the chain kernel (and
    the expm kernel for Magnus)."""
    from qiskit_dynamics_tpu_torch import Signal

    def signals(amp):
        return [Signal(lambda t: amp * torch.ones_like(t), carrier_freq=5.0)]

    y0 = np.zeros(65, dtype=complex)
    y0[0] = 1.0
    amps = torch.linspace(0.2, 1.0, 7, dtype=torch.float64)
    before = launch_counts()
    got = synthetic_solver(method, 65, cuda).solve_sweep(0.0, 4, y0, signals, amps.to(cuda))
    torch.cuda.synchronize()
    rose = tuple(a - b for a, b in zip(launch_counts(), before))
    assert rose == (1, 0, int(method == "magnus"), 0)
    want = synthetic_solver(method, 65, "cpu").solve_sweep(0.0, 4, y0, signals, amps)
    assert got.device.type == "cuda" and got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= TOL


# --------------------------------------------------------------------------
# B11: the monomials and their contraction
# --------------------------------------------------------------------------
def complete_labels(order, n_vars=4):
    """Every multiset of 1 to ``order`` of the variables: 209 terms at order
    6 (the Dyson cell's), 34 at order 3 (the Magnus cell's)."""
    return [list(ms) for d in range(1, order + 1)
            for ms in itertools.combinations_with_replacement(range(n_vars), d)]


# node prefixes missing from the labels (positions not the identity) and
# variables 1 and 3 never named
INCOMPLETE = [[0], [2], [0, 2], [2, 2, 2], [0, 0, 2], [0, 2, 2, 2]]


def b11_expansion(method, n, labels, device):
    """The expansion the sweep of a seeded solver contracts, in complex64."""
    solver = synthetic_solver(method, n, device, labels=labels)
    return solver._sweep_expansion(torch.complex64)[0]


def b11_table(L, device, seed=6):
    """Chebyshev-coefficient-like variables, (4, L) float32."""
    gen = np.random.default_rng(seed)
    return torch.as_tensor(gen.uniform(-0.8, 0.8, size=(4, L)), dtype=torch.float32,
                           device=device)


def b11_against_plain(method, n, labels, L, interleaved):
    expansion = b11_expansion(method, n, labels, "cuda")
    coeffs = b11_table(L, "cuda")
    before = launches("monomial_contract_launch")
    got = mc.contract_monomials(coeffs, expansion, interleaved)
    want = mc.contract_monomials_plain(coeffs, expansion, interleaved)
    torch.cuda.synchronize()
    assert launches("monomial_contract_launch") == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.dtype == (torch.complex64 if interleaved else torch.float32)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= B11_TOL * scale
    return got, want


@pytest.mark.parametrize("interleaved", [True, False], ids=["complex", "planes"])
@pytest.mark.parametrize("method, order", [("dyson", 6), ("magnus", 3)])
def test_b11_matches_plain_at_the_cells_shapes(cuda, method, order, interleaved):
    """n = 10 with the cells' 209 terms and constant term (Dyson) and 34
    terms without one (Magnus), in both layouts."""
    b11_against_plain(method, 10, complete_labels(order), 12_800, interleaved)


@pytest.mark.parametrize("L", [1, 7, 130, 1_001, 4_100])
def test_b11_ragged_lanes(cuda, L):
    """Lane counts that are not a multiple of the 128-lane tile, nor of 4
    (the kernel's scalar loads and stores)."""
    for interleaved in (True, False):
        b11_against_plain("dyson", 4, complete_labels(4), L, interleaved)


@pytest.mark.parametrize("method", ["dyson", "magnus"])
def test_b11_incomplete_expansion(cuda, method):
    """Labels whose prefixes are not terms and that skip variables: the
    monomials are formed from each label alone."""
    for interleaved in (True, False):
        b11_against_plain(method, 3, INCOMPLETE, 999, interleaved)


@pytest.mark.parametrize("fold", [False, True], ids=["table", "fold"])
@pytest.mark.parametrize("te", [2, 4, 8, 10])
def test_b11_every_entries_per_thread_and_mode(cuda, te, fold):
    """Each instantiation at n = 10 (TE = 2 over two tiles of entries), the
    monomials from the node table or folded per chunk, against the plain
    version over ragged lanes."""
    expansion = b11_expansion("dyson", 10, complete_labels(6), "cuda")
    coeffs = b11_table(1_001, "cuda")
    for interleaved in (True, False):
        got = mc._launch_kernel(coeffs, expansion, interleaved, te=te, fold=fold)
        want = mc.contract_monomials_plain(coeffs, expansion, interleaved)
        assert float((got - want).abs().max()) <= B11_TOL * max(1.0, float(want.abs().max()))


def test_b11_fold_mode_where_the_table_does_not_fit(cuda):
    """1,286 terms of five variables: a lane tile's nodes pass shared memory,
    the kernel folds each term's variables per chunk."""
    labels = complete_labels(8, n_vars=5)
    expansion = b11_expansion("magnus", 3, labels, "cuda")
    assert mc.plan(expansion, mc.launch_shape(3), 5)[0] == 0
    coeffs = torch.cat([b11_table(500, "cuda"), b11_table(500, "cuda", seed=7)[:1]]) * 0.5
    for interleaved in (True, False):
        got = mc.contract_monomials(coeffs, expansion, interleaved)
        want = mc.contract_monomials_plain(coeffs, expansion, interleaved)
        assert float((got - want).abs().max()) <= B11_TOL * max(1.0, float(want.abs().max()))


def test_b11_past_64_with_planes_larger_than_shared_memory(cuda):
    """n = 65: the 34-term planes are 1.2 MB, many tiles of entries."""
    shape = mc.launch_shape(65)
    assert shape.tiles > 1 and 2 * 65 * 65 * 34 * 4 > 232448
    for interleaved in (True, False):
        b11_against_plain("magnus", 65, complete_labels(3), 300, interleaved)


def _sweep_passes(method, device, precision, amps, df_chunk_b=2048):
    """The sweep of a seeded 6-level solver (Dyson 4: 69 terms) under
    recorded metrics: its output, ``sweep.engine`` passes and B11 launches."""
    from qiskit_dynamics_tpu_torch import Signal

    def signals(amp):
        return [Signal(lambda t: amp * torch.cos(t), carrier_freq=5.0)]

    y0 = np.eye(6, dtype=complex)[0]
    solver = synthetic_solver(method, 6, device, labels=complete_labels(4))
    metrics.enable_metrics()
    try:
        metrics.reset_spans()
        out = solver.solve_sweep(0.0, 12, y0, signals, amps, precision=precision,
                                 df_chunk_b=df_chunk_b)
        if out.is_cuda:
            torch.cuda.synchronize()
        passes = [r for r in metrics.span_records() if r.name == "sweep.engine"]
        return out, len(passes), launches("monomial_contract_launch")
    finally:
        metrics.disable_metrics(clear=True)


@pytest.mark.parametrize("method", ["dyson", "magnus"])
def test_b11_one_launch_a_pass_at_f32_none_at_df32(cuda, method):
    amps = torch.linspace(0.2, 1.0, 5, dtype=torch.float64, device=cuda)
    _, passes, launched = _sweep_passes(method, cuda, "f32", amps)
    assert passes == 1 and launched == 1
    _, passes, launched = _sweep_passes(method, cuda, "df32", amps, df_chunk_b=3)
    assert passes == 2 and launched == 0


@pytest.mark.parametrize("method", ["dyson", "magnus"])
def test_b11_sweep_gradient_equals_the_plain_route(cuda, method):
    """The gradient of ``solve_sweep`` in its parameters through the kernel
    route (the card) equals the plain route's (the CPU, complex64) within
    float32 roundoff; the forward states too."""
    from qiskit_dynamics_tpu_torch import Signal

    def signals(amp):
        return [Signal(lambda t: amp * torch.cos(t), carrier_freq=5.0)]

    y0 = np.eye(6, dtype=complex)[0]
    results = []
    for device in (cuda, "cpu"):
        solver = synthetic_solver(method, 6, device, labels=complete_labels(4))
        amps = torch.linspace(0.2, 1.0, 9, dtype=torch.float64, device=device)
        amps.requires_grad_(True)
        out = solver.solve_sweep(0.0, 12, y0, signals, amps)
        (grad,) = torch.autograd.grad((out[:, 1].abs() ** 2).sum(), amps)
        results.append((out.detach().cpu(), grad.cpu()))
    (out, grad), (want_out, want_grad) = results
    assert float((out - want_out).abs().max()) <= TOL
    assert float((grad - want_grad).abs().max()) <= 1e-4 * float(want_grad.abs().max())
