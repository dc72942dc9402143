"""Seeded traffic: the operands of every input set of a cell.

``gen_inputs`` is a frozen copy of the draws of
``reference_seal_backend_tpu_torch/engine/runner.py:gen_inputs`` (the
HEBench harness's seeded random op parameters), without its ground truth:
the answers come from ``references/``.  The same seed gives the same
operands, draw for draw as the runner draws them.  It takes plain names, so
it imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

ELEMENTWISE = ("eltwise_add", "eltwise_mult", "dot_product")


def gen_inputs(workload: str, scheme: str, params: Dict[str, int],
               rng: np.random.Generator, counts: Sequence[int]) -> List[np.ndarray]:
    """The operands of one input set: ``counts`` samples of each operand
    (the HEBench data counts), drawn from ``rng`` in the runner's order."""
    is_ckks = scheme == "ckks"
    if workload in ELEMENTWISE:
        n = params["n"]
        batch0, batch1 = counts
        if is_ckks:
            a = rng.uniform(-1, 1, (batch0, n))
            b = rng.uniform(-1, 1, (batch1, n))
        else:
            # keep dot products within the plain modulus
            hi = max(2, int((2 ** 19 / max(n, 1)) ** 0.5))
            a = rng.integers(-hi, hi, (batch0, n))
            b = rng.integers(-hi, hi, (batch1, n))
        return [a, b]
    if workload == "matrix_multiply":
        r0, c0, c1 = params["rows_m0"], params["cols_m0"], params["cols_m1"]
        if is_ckks:
            m0 = rng.uniform(-1, 1, (r0, c0))
            m1 = rng.uniform(-1, 1, (c0, c1))
        else:
            hi = max(2, int((2 ** 19 / max(c0, 1)) ** 0.5))
            m0 = rng.integers(-hi, hi, (r0, c0))
            m1 = rng.integers(-hi, hi, (c0, c1))
        return [m0, m1]
    if workload == "logistic_regression_poly_d3":
        n = params["n"]
        batch = counts[-1]
        w = rng.uniform(-1, 1, n)
        b = float(rng.uniform(-1, 1))
        x = rng.uniform(-1, 1, (batch, n))
        return [w, b, x]
    raise KeyError(workload)


def data_counts(category: str, registered: Sequence[int], sample_size: int) -> List[int]:
    """Samples per operand: one each under Latency; under Offline the
    registered count, where 0 (flexible) takes ``sample_size``."""
    if category == "latency":
        return [1] * len(registered)
    return [c if c > 0 else sample_size for c in registered]


def input_sets(config: dict, traffic: dict, seed: int) -> List[List[np.ndarray]]:
    """Every input set of a cell, drawn one after another from one
    generator seeded by ``seed``: the same seed, the same sets."""
    rng = np.random.default_rng(seed)
    counts = data_counts(traffic["category"], config["data_count"],
                         traffic.get("sample_size", 1))
    return [gen_inputs(config["workload"], config["scheme"], config["params"], rng, counts)
            for _ in range(traffic["input_sets"])]
