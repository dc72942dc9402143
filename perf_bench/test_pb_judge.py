"""The comparison's numbers and their limits."""

from __future__ import annotations

import numpy as np

from perf_bench import judge


def test_exact_answers_pass_at_limit_zero():
    want = [[np.array([5], dtype=np.int64)], [np.array([-7], dtype=np.int64)]]
    got = [[np.array([5.0])], [np.array([-7])]]
    v = judge.compare(got, want, {"max_abs_gap": 0})
    assert v["correct"] and v["failed"] == 0
    assert v["checks"]["max_abs_gap"] == {"value": 0.0, "limit": 0}


def test_one_wrong_integer_fails_one_call():
    want = [[np.array([5], dtype=np.int64)], [np.array([-7], dtype=np.int64)]]
    got = [[np.array([5])], [np.array([-6])]]
    v = judge.compare(got, want, {"max_abs_gap": 0})
    assert not v["correct"] and v["failed"] == 1
    assert v["checks"]["max_abs_gap"]["value"] == 1.0


def test_gap_beyond_limit_nan_and_missing_answers():
    want = [[np.array([0.5, 0.25])]]
    assert judge.compare([[np.array([0.5, 0.25 + 1e-9])]], want, {"max_abs_gap": 2e-9})["correct"]
    assert not judge.compare([[np.array([0.5, 0.25 + 3e-9])]], want, {"max_abs_gap": 2e-9})["correct"]
    nan = judge.compare([[np.array([0.5, np.nan])]], want, {"max_abs_gap": 2e-9})
    assert not nan["correct"] and nan["checks"]["max_abs_gap"]["value"] == float("inf")
    short = judge.compare([[np.array([0.5])]], want, {"max_abs_gap": 2e-9})
    assert not short["correct"] and short["checks"]["answers_missing"]["value"] == 1
    assert not judge.compare([], [], {"max_abs_gap": 1.0})["correct"]  # nothing checked
