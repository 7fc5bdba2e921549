"""The frozen work counts against the bounds ``chip_smoke.py`` recorded."""
import pytest

from portbench.counts import adaptive_dopri5, magnus_direct, magnus_poly, roofline

CR = dict(n=16, k=2, order=8, steps=200, members=10_000, magnus_order=2, hermitian=True)
LINDBLAD3 = dict(n=4, k=1, order=8, steps=1000, members=10_240, magnus_order=2, hermitian=False)
OPEN = dict(n=256, k=1, order=8, steps=125, members=2048, magnus_order=3)


@pytest.mark.parametrize("shape, ms", [(CR, 1.773), (LINDBLAD3, 0.411)])
def test_magnus_direct_gives_b2s_recorded_bound(shape, ms):
    seconds, by = roofline.bound(*magnus_direct.work(shape))
    assert by == "operations"
    assert round(seconds * 1e3, 3) == ms


@pytest.mark.parametrize("order, k, q", [(2, 1, 4), (2, 2, 9), (3, 1, 24), (3, 2, 150)])
def test_monomials_match_the_polynomial_engine(order, k, q):
    # Q as qiskit_dynamics_tpu_torch.ops.polynomial_sweep.expand_magnus_polynomial
    # forms it (its stacked X has Q matrices at these orders and operator counts)
    assert len(magnus_poly.monomials(order, k)) == q


def test_magnus_poly_leaves_out_the_step_matrices():
    # chip_smoke.py bounds kernel B4 per launch at 2,048 x n = 256, order 8 by
    # its bytes, 0.323 ms, because it counts the step matrices M (two float32
    # planes of B n^2) as input. They are an intermediate of the polynomial
    # engine, so the copy does not count them: the whole call, contraction
    # and Horner for 125 steps, is bound by its operations.
    n, B, order = 256, 2048, 8
    b4_bytes = 4 * (2 * B * n * n + 4 * B * n)
    assert round(roofline.bound(order * 8 * n * n * B, b4_bytes)[0] * 1e3, 3) == 0.323
    flops, nbytes = magnus_poly.work(OPEN)
    seconds, by = roofline.bound(flops, nbytes)
    assert by == "operations"
    assert nbytes < 0.05 * b4_bytes  # the M planes of one step alone are 1.07 GB
    horner = order * (8 * n * n + 4 * n) * B * 125
    contraction = 4 * 24 * n * n * B * 125
    assert horner + contraction < flops < 1.01 * (horner + contraction)
    assert round(seconds * 1e3, 1) == 40.1


def test_adaptive_count_is_b1_work():
    # chip_smoke.py's b1_work at n = 16, k = 2, one tile of 512 lanes, 10 steps
    assert adaptive_dopri5.flops(16, 2, 512, [10]) == 6 * 10 * 512 * (256 * 16 + 320)


def test_fp64_bound_weighs_products_at_the_tensor_core_peak():
    seconds, _ = roofline.bound_f64(67e12, 34e12, 0.0)
    assert seconds == pytest.approx(2.0)
