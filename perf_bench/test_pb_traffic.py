"""The frozen traffic generator draws what the port's runner draws."""

from __future__ import annotations

import numpy as np
import pytest

from perf_bench import traffic
from reference_seal_backend_tpu_torch.engine import runner
from reference_seal_backend_tpu_torch.engine.registry import Engine

CASES = [  # (descriptor, counts)
    ("ckks_dot_product_offline", [3, 2]),
    ("bfv_dot_product_offline", [8, 8]),
    ("bfv_eltwise_mult_latency", [1, 1]),
    ("ckks_matrix_multiply_latency", [1, 1]),
    ("bfv_matrix_multiply_row_latency", [1, 1]),
    ("ckks_logistic_regression_poly_d3_offline", [1, 1, 100]),
    ("ckks_logistic_regression_poly_d3_latency", [1, 1, 1]),
]


@pytest.mark.parametrize("name,counts", CASES)
def test_draws_equal_the_runners(name, counts):
    desc = Engine("cpu").find(name)
    params = dict(desc.default_params)
    if desc.workload.value == "logistic_regression_poly_d3" and desc.category.value == "offline":
        params["batch_size"] = counts[-1]
    seed = 2 ** 31 + 12345  # seeds may pass 32 signed bits
    want, _ = runner.gen_inputs(desc, params, np.random.default_rng(seed), counts[0], counts[-1])
    got = traffic.gen_inputs(desc.workload.value, desc.scheme.value, params,
                             np.random.default_rng(seed), counts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_input_sets_follow_the_seed():
    config = {"workload": "dot_product", "scheme": "bfv", "params": {"n": 100},
              "data_count": [0, 0]}
    mix = {"category": "offline", "sample_size": 8, "input_sets": 3}
    a = traffic.input_sets(config, mix, 2 ** 31 + 7)
    b = traffic.input_sets(config, mix, 2 ** 31 + 7)
    c = traffic.input_sets(config, mix, 2 ** 31 + 8)
    assert len(a) == 3 and a[0][0].shape == (8, 100)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0], y[0])
    assert not np.array_equal(a[0][0], a[1][0])  # the sets differ
    assert not np.array_equal(a[0][0], c[0][0])


def test_data_counts():
    assert traffic.data_counts("latency", [1, 1, 0], 100) == [1, 1, 1]
    assert traffic.data_counts("offline", [1, 1, 0], 100) == [1, 1, 100]
    assert traffic.data_counts("offline", [0, 0], 8) == [8, 8]
