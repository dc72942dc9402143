"""HEBench MatrixMultiply: ``M0 @ M1``, one answer, the ``r0 x c1`` product
in row-major order (the program's decode of every packing)."""

from __future__ import annotations

import numpy as np


def answers(inputs, scheme, dtype=None):
    if dtype is None:
        dtype = np.float64 if scheme == "ckks" else np.int64
    m0, m1 = (np.asarray(x).astype(dtype) for x in inputs)
    out = np.empty((m0.shape[0], m1.shape[1]), dtype=dtype)
    for i in range(m0.shape[0]):
        for j in range(m1.shape[1]):
            acc = dtype(0)
            for x, y in zip(m0[i], m1[:, j]):
                # term by term in ``dtype``: each product and each partial sum
                # is rounded there, as a program computing in it would round
                acc = dtype(acc + dtype(x * y))
            out[i, j] = acc
    return [out]
