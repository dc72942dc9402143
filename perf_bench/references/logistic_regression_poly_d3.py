"""HEBench LogisticRegression_PolyD3: ``sigmoid(x . w + b)`` for each
sample, the sigmoid approximated by the degree-3 polynomial of the
reference backend (``include/benchmarks/ckks/seal_ckks_logreg_horner.h``:
{0.5, 0.15012, 0.0, -0.0015930078125}).  One answer: the batch's values."""

from __future__ import annotations

import numpy as np

SIGMOID_D3 = (0.5, 0.15012, 0.0, -0.0015930078125)


def answers(inputs, scheme, dtype=None):
    dtype = np.float64 if dtype is None else dtype
    w = np.asarray(inputs[0]).astype(dtype).reshape(-1)
    b = dtype(np.asarray(inputs[1]).reshape(()))
    x = np.atleast_2d(np.asarray(inputs[2])).astype(dtype)
    c = [dtype(v) for v in SIGMOID_D3]
    z = np.array([dtype(dtype(row @ w) + b) for row in x], dtype=dtype)
    # the polynomial as written, each product and sum rounded in ``dtype``
    out = c[0] + c[1] * z + c[2] * z * z + c[3] * z * z * z
    return [out.astype(dtype)]
