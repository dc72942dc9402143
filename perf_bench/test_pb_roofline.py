"""The frozen NTT bound equals the smoke's, and its int32 rate is the one
derived in ``roofline.py``."""

from __future__ import annotations

import pytest

import chip_smoke
from perf_bench import roofline


@pytest.mark.parametrize("name,polys,nl,n", [
    ("ntt_fwd", 64 * 7, 7, 8192), ("ntt_inv", 64 * 7, 7, 8192),
    ("ntt_fwd", 14, 14, 16384), ("ntt_inv", 2, 2, 16384), ("ntt_fwd", 20, 10, 8192),
])
def test_bound_equals_the_smokes(name, polys, nl, n):
    assert roofline.bound_ms(name, polys, nl, n) == chip_smoke.bound_of(name, polys, nl, n)["bound_ms"]


def test_peaks():
    assert roofline.PEAK_INT32_OPS_PER_S == pytest.approx(16.72704e12)
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_INT32_OPS_PER_S == chip_smoke.PEAK_INT32_OPS_PER_S


def test_reader():
    work = [("ntt_fwd", 64 * 7, 7, 8192)]
    bound = roofline.work_bound_ms(work)
    record = {"trace": {"calls": 3, "ntt_s": 3 * 2 * bound / 1e3}, "transforms": work}
    assert roofline.ntt_roofline(record) == pytest.approx(50.0)
    assert roofline.ntt_roofline({"trace": {"calls": 3, "ntt_s": 0.0}, "transforms": work}) is None
