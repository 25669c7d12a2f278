"""The roofline's counts reproduce the kernel table's bounds."""
import pytest

from bench import roofline


def test_or_and_bounds_of_the_kernel_table():
    # chip_smoke.py's _mm_bound at the main path's shapes: the squaring
    # [16039]^2 is bound by operations, the compose [256, 16039] x
    # [16039, 16039] by bytes
    assert roofline.or_and_s(16039, 16039, 16039) * 1e3 == pytest.approx(
        4.170, abs=5e-4)
    assert roofline.or_and_s(256, 16039, 16039) * 1e3 == pytest.approx(
        0.079, abs=5e-4)


def test_min_plus_rate_is_the_data_sheet_constant():
    assert roofline.MIN_PLUS_OPS_PER_S == 64 * 132 * 1.98e9
    # the squaring, bound by operations: 16039^3 at the fixed rate
    assert roofline.min_plus_s(16039, 16039, 16039) == pytest.approx(
        16039 ** 3 / (64 * 132 * 1.98e9))
    # an evalDG step [1, 16041] x [16041, 16041] is bound by bytes
    assert roofline.min_plus_s(1, 16041, 16041) * 1e3 == pytest.approx(
        0.3073, abs=5e-4)
