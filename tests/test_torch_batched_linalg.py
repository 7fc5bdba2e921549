"""Parity of the port's batch-minor kernels' plain versions with the JAX package.

``ops/chain_apply.py`` (the streamed propagator chain) and
``ops/batched_linalg.py`` (batched product, Taylor expm, its backward). On the
CPU the port's wrappers run their plain versions; the JAX side runs its Pallas
kernels in interpret mode under x64, so both compute in float64.

Tolerances and their reasons:

- plain versions in float64 against the Pallas kernels: 1e-12 (the same
  recursion, sums in another order); the backward at 1e-10 against the Pallas
  backward kernel (order 6, one squaring: interpret time grows with the
  unrolled order) and against ``_xla_twin_vjp`` (orders 8 and 12 too);
- complex64/float32 plain versions against the same float64 references:
  1e-5 (float32 roundoff on O(1) values);
- ``expm`` against ``scipy.linalg.expm``: 1e-9 at order 12 with one squaring on
  matrices of norm 0.5 (Taylor truncation ~1e-14), 1e-5 at order 8 unscaled;
- gradients of the two ``_ad`` functions: 1e-10 against ``jax.grad`` of the JAX
  ``_ad`` functions, 1e-6 relative against central differences (step 1e-6);
- the backward's plain version (the tangent recursion at ``X^H``) against
  autograd through the forward recursion in complex128: 1e-12 relative to
  max |g| (the same polynomial differentiated two ways; float64 roundoff of
  up to 3 x 15 products).

Distinct Pallas interpret configurations here: chain (1), matmul (1), expm (2),
expm backward (1), plus the two ``jax.grad`` traces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm as scipy_expm

from torch_parity import assert_rel_close, rng, to_np

from qiskit_dynamics_tpu.ops import batched_linalg as jbl
from qiskit_dynamics_tpu.ops import chain_apply as jca

from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import batched_linalg as bl
from qiskit_dynamics_tpu_torch.ops import chain_apply as ca

N, B, T = 2, 8, 7


def planes(seed, count=2, scale=0.5, dtype=np.float64):
    """``count`` (N, N, B) planes; each lane's complex matrix has Frobenius
    norm ``scale``."""
    x = rng(seed).normal(size=(count // 2, 2, N, N, B))
    x = scale * x / np.sqrt((x**2).sum(axis=(1, 2, 3), keepdims=True))
    return [p.astype(dtype) for p in x.reshape(count, N, N, B)]


def tensors(arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.fixture(scope="module")
def chain_problem():
    gen = rng(0)
    props = np.eye(N)[None, :, :, None] + 0.4 / N * (
        gen.normal(size=(T, N, N, B)) + 1j * gen.normal(size=(T, N, N, B))
    )
    y0 = gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B))
    reference = to_np(jca.chain_apply_bol(jnp.asarray(props), jnp.asarray(y0), tile_b=B,
                                          interpret=True))
    return props, y0, reference


# --------------------------------------------------------------------------
# the streamed chain (B5)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype, tol", [(torch.complex128, 1e-12), (torch.complex64, 1e-5)])
def test_chain_plain_matches_pallas(chain_problem, dtype, tol):
    props, y0, reference = chain_problem
    before = launches("chain_apply_launch")
    out = ca.chain_apply_bol(torch.as_tensor(props).to(dtype), torch.as_tensor(y0).to(dtype))
    assert out.dtype == dtype and launches("chain_apply_launch") == before  # no kernel on the CPU
    assert_rel_close(out, reference, tol)
    explicit = y0.copy()
    for t in range(T):
        explicit = np.einsum("ijb,jb->ib", props[t], explicit)
    assert_rel_close(out, explicit, tol)


def test_chain_reads_strided_stack(chain_problem):
    props, y0, reference = chain_problem
    view = torch.movedim(torch.as_tensor(np.ascontiguousarray(np.moveaxis(props, 0, 2))), 2, 0)
    assert not view.is_contiguous()
    assert_rel_close(ca.chain_apply_bol(view, torch.as_tensor(y0)), reference, 1e-12)


def test_chain_rejects():
    y0 = torch.zeros((2, 8), dtype=torch.complex128)
    with pytest.raises(ValueError, match="at least one propagator"):
        ca.chain_apply_bol(torch.zeros((0, 2, 2, 8), dtype=torch.complex128), y0)
    with pytest.raises(ValueError, match="y0 must be"):
        ca.chain_apply_bol(torch.zeros((1, 2, 2, 4), dtype=torch.complex128), y0)
    with pytest.raises(ValueError, match="props must be"):
        ca.chain_apply_bol(torch.zeros((1, 2, 3, 8), dtype=torch.complex128), y0)
    with pytest.raises(TypeError, match="complex"):
        ca.chain_apply_bol(torch.zeros((1, 2, 2, 8)), y0)


def test_chain_ad_matches_jax_grad_and_fd(chain_problem):
    props, y0, _ = chain_problem
    props, y0 = props[:4], y0.real + 0j

    def jax_loss(p, y):
        return jnp.sum(jnp.abs(jca.chain_apply_bol_ad(p, y, B, True)) ** 2)

    ref_p, ref_y = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(props), jnp.asarray(y0))
    tp = torch.as_tensor(props).requires_grad_(True)
    ty = torch.as_tensor(y0).requires_grad_(True)

    def loss(p, y):
        return (ca.chain_apply_bol_ad(p, y).abs() ** 2).sum()

    gp, gy = torch.autograd.grad(loss(tp, ty), (tp, ty))
    # jax.grad of a real loss returns the conjugate of torch's convention
    assert_rel_close(gp, np.conj(to_np(ref_p)), 1e-10)
    assert_rel_close(gy, np.conj(to_np(ref_y)), 1e-10)
    # both arguments scaled by one real parameter: autograd against central differences
    tp, ty = tp.detach(), ty.detach()

    def scaled(a):
        return loss(tp * a, ty * (2.0 - a))

    eps = 1e-6
    for a0 in (0.7, 1.3):
        a = torch.tensor(a0, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(scaled(a), a)
        with torch.no_grad():
            fd = (scaled(a + eps) - scaled(a - eps)) / (2 * eps)
        np.testing.assert_allclose(g.item(), fd.item(), rtol=1e-6)


# --------------------------------------------------------------------------
# batched product (B10)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_matmul_plain_matches_pallas(dtype, tol):
    args = planes(1, count=4, scale=1.0)
    reference = jbl.matmul_bol(*[jnp.asarray(a) for a in args], interpret=True, tile_b=B)
    before = launches("matmul_bol_launch")
    out = bl.matmul_bol(*tensors([a.astype(dtype) for a in args]))
    assert launches("matmul_bol_launch") == before
    for got, want in zip(out, reference):
        assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
        assert_rel_close(got, to_np(want), tol)


def test_bol_layout_helpers_match():
    gen = rng(2)
    A = gen.normal(size=(B, N, N)) + 1j * gen.normal(size=(B, N, N))
    ours, theirs = bl.to_bol(torch.as_tensor(A)), jbl.to_bol(jnp.asarray(A))
    for got, want in zip(ours, theirs):
        assert_rel_close(got, to_np(want), 0.0)
    assert_rel_close(bl.from_bol(*ours), A, 0.0)


# --------------------------------------------------------------------------
# Taylor expm (B6)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("order, squarings, scipy_tol", [(8, 0, 1e-5), (12, 1, 1e-9)])
def test_expm_plain_matches_pallas_and_scipy(order, squarings, scipy_tol):
    xr, xi = planes(3)
    reference = jbl.expm_taylor_bol(
        jnp.asarray(xr), jnp.asarray(xi), order=order, squarings=squarings, interpret=True,
        tile_b=B,
    )
    out = bl.expm_taylor_bol(*tensors([xr, xi]), order=order, squarings=squarings)
    for got, want in zip(out, reference):
        assert_rel_close(got, to_np(want), 1e-12)
    got = to_np(bl.from_bol(*out))
    for b in range(B):
        assert_rel_close(got[b], scipy_expm(xr[:, :, b] + 1j * xi[:, :, b]), scipy_tol)
    single = bl.expm_taylor_bol(*tensors([xr.astype(np.float32), xi.astype(np.float32)]),
                                order=order, squarings=squarings)
    for got32, want in zip(single, reference):
        assert got32.dtype == torch.float32
        assert_rel_close(got32, to_np(want), 1e-5)


@pytest.mark.parametrize("order, squarings", [(8, 2), (12, 0), (12, 2), (1, 0), (2, 3)])
def test_expm_plain_matches_scipy_other_orders(order, squarings):
    xr, xi = planes(4, scale=0.02 if order < 8 else 0.5)
    got = to_np(bl.from_bol(*bl.expm_taylor_bol(*tensors([xr, xi]), order, squarings)))
    tol = {1: 1e-3, 2: 1e-7}.get(order, 1e-5 if order == 8 else 1e-9)
    for b in range(B):
        assert_rel_close(got[b], scipy_expm(xr[:, :, b] + 1j * xi[:, :, b]), tol)


def test_expm_rejects():
    xr, xi = tensors(planes(3))
    with pytest.raises(ValueError, match="order must be"):
        bl.expm_taylor_bol(xr, xi, order=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        bl.expm_taylor_bol(xr, xi[:, :, :4])
    with pytest.raises(ValueError, match=r"\(n, n, B\)"):
        bl.expm_taylor_bol(xr[0], xi[0])
    with pytest.raises(TypeError):
        bl.expm_taylor_bol(xr, xi.float())


# --------------------------------------------------------------------------
# expm backward (B7)
# --------------------------------------------------------------------------
def test_expm_bwd_plain_matches_pallas_and_twin():
    order, squarings = 6, 1  # a small unrolled kernel: interpret time grows with order
    args = planes(5, count=4)
    jargs = [jnp.asarray(a) for a in args]
    pallas = jbl.expm_taylor_bol_bwd(*jargs, order=order, squarings=squarings, interpret=True,
                                     tile_b=B)
    twin = jbl._xla_twin_vjp(*jargs, order, squarings)
    before = launches("expm_bwd_bol_launch")
    out = bl.expm_taylor_bol_bwd(*tensors(args), order=order, squarings=squarings)
    assert launches("expm_bwd_bol_launch") == before
    for got, want_p, want_t in zip(out, pallas, twin):
        assert_rel_close(got, to_np(want_p), 1e-10)
        assert_rel_close(got, to_np(want_t), 1e-10)
    single = bl.expm_taylor_bol_bwd(*tensors([a.astype(np.float32) for a in args]), order,
                                    squarings)
    for got32, want in zip(single, twin):
        assert_rel_close(got32, to_np(want), 1e-5)


@pytest.mark.parametrize("order, squarings", [(8, 0), (8, 2), (12, 1), (12, 2), (1, 0)])
def test_expm_bwd_plain_matches_twin_other_orders(order, squarings):
    args = planes(6, count=4)
    twin = jbl._xla_twin_vjp(*[jnp.asarray(a) for a in args], order, squarings)
    out = bl.expm_taylor_bol_bwd(*tensors(args), order=order, squarings=squarings)
    for got, want in zip(out, twin):
        assert_rel_close(got, to_np(want), 1e-10)


def autograd_expm_vjp(Xr, Xi, CTr, CTi, order, squarings):
    """The VJP of ``expm_taylor_bol_plain`` by autograd through its recursion:
    the reference the tangent recursion is held to."""
    xr = Xr.detach().clone().requires_grad_(True)
    xi = Xi.detach().clone().requires_grad_(True)
    outs = bl.expm_taylor_bol_plain(xr, xi, order, squarings)
    return torch.autograd.grad(outs, (xr, xi), (CTr, CTi))


@pytest.mark.parametrize("order, squarings", [(1, 0), (6, 1), (12, 1), (12, 3)])
@pytest.mark.parametrize("n", [1, 2, 5, 10, 13])
def test_expm_bwd_plain_is_the_autograd_vjp(n, order, squarings):
    gen = rng(1000 + 10 * n + order + squarings)
    args = [torch.as_tensor(gen.normal(size=(n, n, 3))) for _ in range(4)]
    got = bl.expm_taylor_bol_bwd_plain(*args, order, squarings)
    want = autograd_expm_vjp(*args, order, squarings)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert float((g - w).abs().max()) <= 1e-12 * scale


def test_expm_ad_matches_jax_grad_and_fd():
    order, squarings = 6, 1  # the backward configuration of the test above
    xr, xi = planes(7)
    weights = planes(8)

    def jax_loss(r, i, wr, wi):
        pr, pi = jbl.expm_taylor_bol_ad(r, i, order, squarings, True, B)
        return jnp.sum(pr * wr) + jnp.sum(pi * wi)

    ref = jax.grad(jax_loss, argnums=(0, 1))(*[jnp.asarray(a) for a in (xr, xi, *weights)])
    tr, ti = [t.requires_grad_(True) for t in tensors([xr, xi])]
    wr, wi = tensors(weights)

    def loss(r, i):
        pr, pi = bl.expm_taylor_bol_ad(r, i, order, squarings)
        return (pr * wr).sum() + (pi * wi).sum()

    grads = torch.autograd.grad(loss(tr, ti), (tr, ti))
    for got, want in zip(grads, ref):
        assert_rel_close(got, to_np(want), 1e-10)
    eps = 1e-6
    direction = tensors(planes(9))
    with torch.no_grad():
        fd = (loss(tr + eps * direction[0], ti + eps * direction[1])
              - loss(tr - eps * direction[0], ti - eps * direction[1])) / (2 * eps)
    along = (grads[0] * direction[0]).sum() + (grads[1] * direction[1]).sum()
    np.testing.assert_allclose(along.item(), fd.item(), rtol=1e-6)


# --------------------------------------------------------------------------
# what the kernels are handed: strides and routing
# --------------------------------------------------------------------------
def test_plane_strides_seen_by_the_launcher():
    xr, xi = tensors(planes(3))
    assert bl._element_stride(xr) == 1
    z = torch.complex(xr, xi)
    assert bl._element_stride(z.real) == bl._element_stride(z.imag) == 2
    assert bl._pair(z.real, z.imag)[2] == 2
    transposed = xr.transpose(0, 1)
    assert bl._element_stride(transposed) == 0
    copied = bl._pair(transposed, xi)
    assert copied[2] == 1 and copied[0].is_contiguous()
    # mixed forms are copied to contiguous planes
    assert bl._pair(z.real, xi)[2] == 1


def test_exports():
    from qiskit_dynamics_tpu_torch import ops

    for name in ("chain_apply_bol", "chain_apply_bol_ad", "matmul_bol", "expm_taylor_bol",
                 "expm_taylor_bol_ad", "expm_taylor_bol_bwd", "to_bol", "from_bol"):
        assert hasattr(ops, name)
    assert set(jbl.__all__) <= set(bl.__all__)
    assert set(jca.__all__) <= set(ca.__all__)
