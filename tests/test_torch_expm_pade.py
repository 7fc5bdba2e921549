"""Parity of the port's ``expm_pade`` with ``jax.scipy.linalg.expm``, the expm
behind the JAX package's ``expm_method="pade"``.

Inputs are random complex matrices made with numpy from a seed and scaled to
1-norms spread over 1e-3 to 10, with a dense band at 0.03-0.06 (where the
degree thresholds of a norm-adaptive expm sit close to the fixed-step
solvers' step norms), at n = 2, 16 and 37, one matrix at a time and batched
over two leading axes.

Tolerances and their reasons (relative to max |expected|):

- complex128: 1e-13. The same degree, squarings and products on both
  sides; only the order of sums and the linear solve's pivoting differ, so
  the results agree to a few float64 ulps times the squarings.
- complex64: 1e-5. The same algorithm with float32 thresholds on both
  sides; float32 roundoff grows with the squarings of the larger norms.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.linalg import expm as jax_expm

from torch_parity import assert_rel_close, rng

from qiskit_dynamics_tpu_torch.ops.expm import expm_pade

NORMS = np.concatenate([np.geomspace(1e-3, 10.0, 13), np.linspace(0.03, 0.06, 7)])
TOLS = {np.complex128: 1e-13, np.complex64: 1e-5}


def _matrices(seed, n, norms):
    """Random complex (len(norms), n, n) matrices with the given 1-norms."""
    gen = rng(seed)
    a = gen.normal(size=(len(norms), n, n)) + 1j * gen.normal(size=(len(norms), n, n))
    one_norms = np.abs(a).sum(axis=-2).max(axis=-1)
    return a * (np.asarray(norms) / one_norms)[:, None, None]


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("n", [2, 16, 37])
def test_expm_pade_matches_jax_one_at_a_time(n, dtype):
    mats = _matrices(10 + n, n, NORMS).astype(dtype)
    for a in mats:
        got = expm_pade(torch.as_tensor(a))
        assert got.dtype == torch.as_tensor(a).dtype
        assert_rel_close(got, np.asarray(jax_expm(jnp.asarray(a))), TOLS[dtype])


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("n", [2, 16, 37])
def test_expm_pade_matches_jax_batched(n, dtype):
    """Every matrix of a (4, 5) batch picks its own degree and squarings."""
    mats = _matrices(20 + n, n, NORMS).astype(dtype).reshape(4, 5, n, n)
    got = expm_pade(torch.as_tensor(mats))
    assert got.shape == mats.shape
    assert_rel_close(got, np.asarray(jax_expm(jnp.asarray(mats))), TOLS[dtype])


def test_expm_pade_real_zero_and_too_many_squarings():
    """Real input stays real, the zero matrix gives the identity, and a
    matrix that needs more than ``max_squarings`` squarings gives NaN."""
    a = rng(3).normal(size=(3, 6, 6))
    assert_rel_close(expm_pade(torch.as_tensor(a)), np.asarray(jax_expm(jnp.asarray(a))), 1e-13)
    assert torch.equal(expm_pade(torch.zeros(4, 4, dtype=torch.complex128)),
                       torch.eye(4, dtype=torch.complex128))
    big = torch.as_tensor(np.stack([np.eye(3) * 1e3, np.eye(3) * 0.1]))
    out = expm_pade(big, max_squarings=4)
    assert torch.isnan(out[0]).all() and not torch.isnan(out[1]).any()
    assert np.isnan(np.asarray(jax_expm(jnp.asarray(big[0].numpy()), max_squarings=4))).all()
    with pytest.raises(ValueError, match="square"):
        expm_pade(torch.zeros(3, 4))
    with pytest.raises(TypeError, match="complex64"):
        expm_pade(torch.zeros(3, 3, dtype=torch.int64))
