"""The roofline bounds' counts at the cells' shapes (B = 1024 scenarios,
quadrotor 12 x 4, three GPs of three inputs)."""

import pytest

from benchmark import bounds


def test_gp_bound_counts_live_points_at_fig8():
    b = bounds.bound_gp(1024 * 25, [40, 40, 40], 3)
    assert b.flops == 3 * 1024 * 25 * (2 * 40 * 40 + 40 * (3 * 3 + 6))
    assert b.by == "operations"
    assert b.seconds == pytest.approx(b.flops / 67e12)


def test_gp_bound_at_gp5k_bucket():
    b = bounds.bound_gp(1024 * 50, [128] * 3, 3)
    assert b.flops == 3 * 1024 * 50 * (2 * 128 * 128 + 128 * 15)
    assert b.bytes == 4 * 3 * (1024 * 50 * 3 + 128 * 3 + 128 + 128 * 128 + 3 + 2 + 2 * 1024 * 50)


@pytest.mark.parametrize("T, formulation", [(25, "direct"), (50, "direct")])
def test_tighten_bound_takes_the_cheaper_formulation(T, formulation):
    b = bounds.bound_tighten(1024, T, 5, 12, 4)
    direct = 1024 * 5 * (12 * T * (T + 1) + 4 * T * (T - 1))
    recursion = 1024 * T * (2 * 12 ** 3 + 144 * 13 + 4 * 12 * 13 + 5)
    assert b.flops == min(direct, recursion) == (direct if formulation == "direct" else recursion)


def test_linearize_bound_is_bytes_bound_at_fig8():
    b = bounds.bound_linearize(1024, 25, 12, 4, 3, 40, 3)
    assert b.by == "bytes"
    per_stage = 4 * 3 * 40 * (6 * 3 + 4) + 3 * 2 * 18 * 16
    assert b.flops == 1024 * 25 * per_stage


def test_qp_stage_operations():
    # one stage of one Mehrotra iteration of the 12 x 4 QP
    assert bounds.qp_stage_flops(12, 4, True) == 11525
    assert bounds.qp_stage_flops(12, 4, False) < bounds.qp_stage_flops(12, 4, True)


@pytest.mark.parametrize("T", [25, 50])
def test_qp_bound_scales_with_the_iterations_it_is_given(T):
    one = bounds.bound_qp(8, 128, 8, T, 12, 4, True, launches=6)
    two = bounds.bound_qp(16, 128, 8, T, 12, 4, True, launches=6)
    assert two.flops == 2 * one.flops == 2 * 8 * 128 * T * 11525
    assert one.bytes == two.bytes
    assert bounds.bound_qp(8, 128, 8, T, 12, 4, True, launches=1).bytes * 6 == one.bytes
