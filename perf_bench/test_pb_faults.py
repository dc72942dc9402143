"""A run whose timed path is broken underneath comes out as not correct:
the whole run on the CPU at a tiny size (``--device cpu`` skips the look
for a card), once for each fault a cell can have.  One chip, so no
exchange between chips to leave out."""

from __future__ import annotations

import pytest

from perf_bench.conftest import run_cell

# a step that returns its state unchanged: the sum across slots returns the
# products as they came
UNCHANGED = """
from reference_seal_backend_tpu_torch.evaluator import composite
composite.accumulate = lambda ev, ct, count: ct
"""
# an answer altered where it is produced: the summed slots doubled
ALTERED = """
from reference_seal_backend_tpu_torch.evaluator import composite
_accumulate = composite.accumulate
def accumulate(ev, ct, count):
    out = _accumulate(ev, ct, count)
    return ev.add(out, out)
composite.accumulate = accumulate
"""
# half of the batch left out: the first half computed, its answers standing
# in for the rest
HALF = """
import torch
from dataclasses import replace
from reference_seal_backend_tpu_torch.models.dot_product import DotProductBenchmark
from reference_seal_backend_tpu_torch.models.logreg import LogRegBenchmark
def halved(impl, axis_arg):
    def run(self, *args):
        args = list(args)
        x = args[axis_arg]
        half = x.data.shape[0] // 2
        args[axis_arg] = replace(x, data=x.data[:half])
        out = impl(self, *args)
        return replace(out, data=torch.cat([out.data, out.data[:x.data.shape[0] - half]]))
    run.__name__ = impl.__name__
    return run
DotProductBenchmark._operate_impl = halved(DotProductBenchmark._operate_impl, 0)
LogRegBenchmark._dots_impl = halved(LogRegBenchmark._dots_impl, 1)
"""

CASES = [(w, fault) for w in ("tiny_dot.latency", "tiny_logreg.latency",
                              "tiny_dot.tiny_offline", "tiny_logreg.tiny_offline")
         for fault in ("unchanged", "altered")]
CASES += [("tiny_dot.tiny_offline", "half"), ("tiny_logreg.tiny_offline", "half")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_path_is_not_correct(tiny_root, workload, fault):
    prelude = {"unchanged": UNCHANGED, "altered": ALTERED, "half": HALF}[fault]
    rc, result, err = run_cell(["--workload", workload, "--seed", "2147483911", "--seconds",
                                "0.2", "--device", "cpu", "--root", str(tiny_root)], prelude)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1


def test_the_same_run_unbroken_is_correct(tiny_root):
    rc, result, err = run_cell(["--workload", "tiny_dot.tiny_offline", "--seed", "2147483911",
                                "--seconds", "0.2", "--device", "cpu", "--root", str(tiny_root)])
    assert rc == 0, err[-3000:]
    assert result["correct"] is True
