"""The plain references give the port's runner's cleartext truth, and the
comparison reads them as the program's decode reports its answers."""

from __future__ import annotations

import ast

import numpy as np
import pytest

from perf_bench import judge, traffic
from perf_bench.conftest import HERE
from perf_bench.references import dot_product, logistic_regression_poly_d3
from reference_seal_backend_tpu_torch.engine import runner
from reference_seal_backend_tpu_torch.engine.registry import Engine


@pytest.mark.parametrize("name,module,counts", [
    ("bfv_dot_product_offline", dot_product, [8, 8]),
    ("ckks_dot_product_offline", dot_product, [3, 2]),
    ("ckks_logistic_regression_poly_d3_offline", logistic_regression_poly_d3, [1, 1, 100]),
])
def test_answers_equal_the_runners_truth(name, module, counts):
    desc = Engine("cpu").find(name)
    params = dict(desc.default_params, batch_size=counts[-1])
    inputs, truth = runner.gen_inputs(desc, params, np.random.default_rng(99), counts[0], counts[-1])
    want = truth()
    got = module.answers(inputs, desc.scheme.value)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g).reshape(-1), np.asarray(w).reshape(-1)
        if desc.scheme.value == "bfv":
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_lower_precision_reads_wider():
    config = {"workload": "logistic_regression_poly_d3", "scheme": "ckks",
              "params": {"n": 16}, "data_count": [1, 1, 0]}
    sets = traffic.input_sets(config, {"category": "offline", "sample_size": 100,
                                       "input_sets": 1}, 5)
    exact = logistic_regression_poly_d3.answers(sets[0], "ckks")[0]
    low = logistic_regression_poly_d3.answers(sets[0], "ckks", np.float32)[0]
    assert low.dtype == np.float32
    assert 1e-9 < np.abs(exact - low).max() < 1e-5


def test_expected_reads_small_ckks_values_as_zero():
    got = judge.expected([np.array([4e-5, -4.9e-5, 5e-5, 0.3])], "ckks")[0]
    np.testing.assert_array_equal(got, [0.0, 0.0, 5e-5, 0.3])
    got = judge.expected([np.array([3, -1], dtype=np.int64)], "bfv")[0]
    assert got.dtype == np.int64


def test_references_import_numpy_alone():
    for path in (HERE / "references").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("numpy", "__future__"), (path.name, n)
