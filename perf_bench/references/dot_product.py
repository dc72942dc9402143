"""HEBench DotProduct: ``a[i] . b[j]`` for every pair, ``i`` major."""

from __future__ import annotations

import numpy as np


def answers(inputs, scheme, dtype=None):
    a, b = (np.asarray(x) for x in inputs)
    if dtype is None:
        dtype = np.float64 if scheme == "ckks" else np.int64
    a, b = a.astype(dtype), b.astype(dtype)
    out = []
    for i in range(a.shape[0]):
        for j in range(b.shape[0]):
            acc = dtype(0)
            for x, y in zip(a[i], b[j]):
                # term by term in ``dtype``: each product and each partial sum
                # is rounded there, as a program computing in it would round
                acc = dtype(acc + dtype(x * y))
            out.append(np.array([acc]))
    return out
