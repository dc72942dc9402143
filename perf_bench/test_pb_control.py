"""The control -- the plain reference in the program's place, in a lower
precision -- comes out as not correct in every cell, at the cells' own
sizes (the reference is numpy alone), on three seeds."""

from __future__ import annotations

import json

import numpy as np
import pytest

from perf_bench import cell as cell_mod
from perf_bench import control, judge, traffic
from perf_bench.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2147483901, 2147483902, 2147483903)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = cell_mod.load(REPO, workload)
    for seed in SEEDS:
        out = control.control(cell, seed)
        assert out["correct"] is False, out


def test_int32_cannot_be_the_bfv_control(tiny_root):
    # int32 computes every drawn dot product exactly: it reads 0, as the
    # program must, so the BFV control breaks exactness instead (float16).
    # The tiny BFV dot product draws the configuration's operands (n = 100).
    cell = cell_mod.load(tiny_root, "tiny_dot.tiny_offline")
    ref = cell.reference()
    sets = traffic.input_sets(cell.config, cell.traffic, SEEDS[0])
    got = [judge.expected(ref.answers(s, "bfv", np.int32), "bfv") for s in sets]
    want = [judge.expected(ref.answers(s, "bfv"), "bfv") for s in sets]
    verdict = judge.compare(got, want, cell.limits)
    assert verdict["correct"] is True and verdict["checks"]["max_abs_gap"]["value"] == 0
    assert control.control(cell, SEEDS[0])["correct"] is False
    assert np.dtype(control.DTYPES["bfv"]) == np.float16
