"""Kernel B9 (the fused expm chain), the wide shapes of B5, B6, B7 and B10, and
the on-card ``solve_ode``/``solve_lmde`` methods, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip. On the card
run them with ``python -m pytest tests/test_torch_expm_cuda.py -m cuda
--noconftest``. This file imports nothing of JAX.

Tolerances and their reasons:

- B9 against its plain version (``expm_taylor`` step by step, products by
  ``torch.matmul``), unitary propagator chains of T = 6 steps at
  ``||G dt|| = 1.8``: 2e-5 in complex64 (float32 roundoff of 6 x 7 chained
  products, summed in another order: ~1e-6 per product at n = 256), 1e-12 in
  complex128.
- B5 at n = 48 to 129: bit for bit (built without multiply-add contraction,
  the same rounded operations in order). B6, B7, B10: 1e-5 on unit-norm
  inputs in float32 (float32 roundoff), 1e-12 for B6 in float64.
- The device methods at dim 4 against the host DOP853 at 1e-12, in
  complex128: 1e-8 for the adaptive methods at tol 1e-10 and for the
  fixed-step methods of fourth order or better at ``max_dt = 0.01``; 2e-5 for
  the second-order midpoint rules (Magnus-1, the Lanczos step), whose
  truncation at this step is ~8e-6.
"""
import warnings

import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import batched_linalg as bl
from qiskit_dynamics_tpu_torch.ops import chain_apply as ca
from qiskit_dynamics_tpu_torch.ops import expm_chain_pallas as ecp

pytestmark = pytest.mark.cuda

B9_TOL = {torch.complex64: 2e-5, torch.complex128: 1e-12}
# past 32 (a runtime n); 97: the last in shared memory for the product and the
# expm, ragged tiles; 129: every lane's matrices in device memory, more tiles
# than a block's threads
WIDE_DIMS = (48, 64, 65, 97, 100, 129)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def unitary_chain(gen, T, b, n, m):
    """(T, b, n, n) anti-Hermitian generators of Frobenius norm 2 and (b, n, m)
    unit-norm states."""
    g = gen.normal(size=(T, b, n, n)) + 1j * gen.normal(size=(T, b, n, n))
    g = -0.5j * (g + np.conj(np.swapaxes(g, -1, -2)))
    g = g / np.linalg.norm(g, axis=(-2, -1), keepdims=True) * 2.0
    y = gen.normal(size=(b, n, m)) + 1j * gen.normal(size=(b, n, m))
    return g, y / np.linalg.norm(y, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n, m", [(8, 5), (100, 7), (256, 3)])
def test_expm_chain_kernel_matches_plain(cuda, n, m, b, dtype):
    gens, y0 = unitary_chain(np.random.default_rng(n + b), 6, b, n, m)
    gens = torch.as_tensor(gens, device=cuda).to(dtype)
    y0 = torch.as_tensor(y0, device=cuda).to(dtype)
    before = launches("expm_chain_launch")
    out = ecp.expm_chain_fused(gens, 0.9, y0, order=12, squarings=1)
    plain = ecp.expm_chain_fused_plain(gens, 0.9, y0, order=12, squarings=1)
    torch.cuda.synchronize()
    assert launches("expm_chain_launch") == before + 1
    assert out.shape == (b, n, m) and out.dtype == dtype and out.device.type == "cuda"
    assert float((out - plain).abs().max()) <= B9_TOL[dtype]


@pytest.mark.parametrize("order, squarings", [(6, 0), (9, 2), (16, 3)])
def test_expm_chain_kernel_orders_and_unbatched(cuda, order, squarings):
    gens, y0 = unitary_chain(np.random.default_rng(order), 4, 1, 37, 37)
    gens = torch.as_tensor(gens[:, 0], device=cuda)
    y0 = torch.as_tensor(y0[0], device=cuda)
    out = ecp.expm_chain_fused(gens, 1.1, y0, order=order, squarings=squarings)
    plain = ecp.expm_chain_fused_plain(gens, 1.1, y0, order=order, squarings=squarings)
    assert out.shape == (37, 37)
    assert float((out - plain).abs().max()) <= B9_TOL[torch.complex128]


def test_expm_chain_kernel_rejects(cuda):
    gens = torch.zeros((2, 1, 4, 4), dtype=torch.complex64, device=cuda)
    y0 = torch.zeros((1, 4, 4), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="order >= 6"):
        ecp.expm_chain_fused(gens, 1.0, y0, order=5)
    with pytest.raises(TypeError, match="complex64 or complex128"):
        ecp.expm_chain_fused(gens, 1.0, y0.to(torch.complex128))
    with pytest.raises(ValueError, match="order <= 40"):
        ecp.expm_chain_fused(gens, 1.0, y0, order=41)


def unit_planes(gen, n, B, device, count=2, dtype=torch.float32):
    x = gen.normal(size=(count // 2, 2, n, n, B))
    x = x / np.sqrt((x**2).sum(axis=(1, 2, 3), keepdims=True))
    return [torch.as_tensor(p, device=device).to(dtype) for p in x.reshape(count, n, n, B)]


def max_diff(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", WIDE_DIMS)
def test_wide_chain_kernel_bitwise(cuda, n, dtype):
    gen = np.random.default_rng(n)
    T, B = 5, 37
    h = gen.normal(size=(T, B, n, n)) + 1j * gen.normal(size=(T, B, n, n))
    h = 0.3 / np.sqrt(n) * (h + np.conj(np.swapaxes(h, -1, -2))) / 2
    u = np.eye(n) - 1j * h - h @ h / 2
    props = torch.as_tensor(np.ascontiguousarray(np.transpose(u, (0, 2, 3, 1))), device=cuda)
    y0 = gen.normal(size=(n, B)) + 1j * gen.normal(size=(n, B))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=cuda)
    props, y0 = props.to(dtype), y0.to(dtype)
    before = launches("chain_apply_launch")
    out = ca.chain_apply_bol(props, y0)
    plain = ca.chain_apply_bol_plain(props, y0)
    torch.cuda.synchronize()
    assert launches("chain_apply_launch") == before + 1
    assert torch.equal(out, plain)


@pytest.mark.parametrize("n", WIDE_DIMS)
def test_wide_batched_linalg_kernels(cuda, n):
    before = (launches("matmul_bol_launch"), launches("expm_bol_launch"),
              launches("expm_bwd_bol_launch"))
    planes = unit_planes(np.random.default_rng(n), n, 37, cuda, count=4)
    assert max_diff(bl.matmul_bol(*planes), bl.matmul_bol_plain(*planes)) <= 1e-5
    for order, squarings in ((8, 0), (12, 1)):
        got = bl.expm_taylor_bol(*planes[:2], order, squarings)
        assert max_diff(got, bl.expm_taylor_bol_plain(*planes[:2], order, squarings)) <= 1e-5
        got = bl.expm_taylor_bol_bwd(*planes, order, squarings)
        want = bl.expm_taylor_bol_bwd_plain(*planes, order, squarings)
        assert max_diff(got, want) <= 1e-5
    planes64 = unit_planes(np.random.default_rng(n), n, 37, cuda, dtype=torch.float64)
    got = bl.expm_taylor_bol(*planes64, 12, 1)
    assert max_diff(got, bl.expm_taylor_bol_plain(*planes64, 12, 1)) <= 1e-12
    torch.cuda.synchronize()
    # one product, three expms (two float32, one float64), two backward passes
    assert (launches("matmul_bol_launch"), launches("expm_bol_launch"),
            launches("expm_bwd_bol_launch")) == (before[0] + 1, before[1] + 3, before[2] + 2)


def test_wide_caps_raise_above_64(cuda):
    """Past the kernels' caps (n = 4096 for the chain, 256 for the products,
    the expm and its backward, whose matrices go to device memory above 98)
    the ops raise on the card."""
    n = ca.MAX_N + 1
    props = torch.zeros((1, n, n, 1), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match=f"n <= {ca.MAX_N}"):
        ca.chain_apply_bol(props, torch.zeros((n, 1), dtype=torch.complex64, device=cuda))
    del props
    n, B = bl.MAX_N + 1, 3
    planes = [torch.zeros((n, n, B), device=cuda) for _ in range(4)]
    with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
        bl.matmul_bol(*planes)
    with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
        bl.expm_taylor_bol(*planes[:2])
    with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
        bl.expm_taylor_bol_bwd(*planes)


# (method, keywords, bar against DOP853 at 1e-12): the midpoint rules (Magnus-1
# and the Lanczos step) are second order, ~8e-6 at max_dt = 0.01; the others
# are fourth order or better
DEVICE_METHODS = [
    ("jax_expm", dict(max_dt=0.01, magnus_order=1), 2e-5),
    ("jax_expm", dict(max_dt=0.01, magnus_order=2, expm_method="taylor"), 1e-8),
    ("jax_expm", dict(max_dt=0.01, magnus_order=3), 1e-8),
    ("jax_RK4", dict(max_dt=0.01), 1e-8),
    ("jax_lanczos_diag", dict(max_dt=0.01, k_dim=4), 2e-5),
    ("jax_expm_parallel", dict(max_dt=0.01, magnus_order=2, expm_method="taylor"), 1e-8),
    ("jax_RK4_parallel", dict(max_dt=0.01), 1e-8),
    ("tpu_dopri5", dict(atol=1e-10, rtol=1e-10), 1e-8),
    ("tpu_dop853", dict(atol=1e-10, rtol=1e-10), 1e-8),
]


@pytest.fixture(scope="module")
def cr_dim4():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from qiskit_dynamics_tpu_torch import Signal
    from qiskit_dynamics_tpu_torch.benchmarks import cr_solver

    host, w1 = cr_solver(dim=2, device="cpu")
    card, _ = cr_solver(dim=2, device="cuda")
    y0 = np.eye(4, dtype=complex)[0]
    ref = host.solve(t_span=[0.0, 1.0], y0=y0, signals=[Signal(0.3, w1)], method="DOP853",
                     atol=1e-12, rtol=1e-12).y[-1]
    return card, [Signal(0.3, w1)], y0, ref


@pytest.mark.parametrize("method, kwargs, bar", DEVICE_METHODS,
                         ids=[f"{m}-{i}" for i, (m, _, _) in enumerate(DEVICE_METHODS)])
def test_device_methods_on_the_card(cr_dim4, method, kwargs, bar):
    solver, signals, y0, ref = cr_dim4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the lanczos sparse-mode note
        res = solver.solve(t_span=[0.0, 1.0], y0=y0, signals=signals, method=method, **kwargs)
    assert isinstance(res.y, torch.Tensor) and res.y.device.type == "cuda"
    assert res.y.dtype == torch.complex128
    assert float(np.max(np.abs(res.y[-1].cpu().numpy() - ref))) <= bar
