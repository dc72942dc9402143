"""HEBench MatrixMultiply's default packing (MatMultVal) under BFV, in plain
``torch`` int64 on the slot vectors: what the encrypted call computes,
written without encryption, kernels or anything of either package.

A BFV batching slot vector of ``n`` slots is two rows of ``n / 2``.  Row
``i`` of M0 and column ``j`` of M1 each fill the first ``c0`` slots of the
first row, zeros elsewhere.  The call multiplies them slot by slot mod
``t``, then sums the rotations by steps ``0 .. c0 - 1``, each rotation
moving a row's slots left inside that row (slot ``k`` takes slot ``k + s``
of the same row, wrapping at its end).  Slot 0 of the ``r0 x c1`` results,
centred in ``(-t/2, t/2]``, is the product ``M0 . M1``.
"""

from __future__ import annotations

import torch


def slot_vectors(m0, m1, n: int, t: int) -> torch.Tensor:
    """The decrypted slot vectors of every output: ``[r0, c1, n]`` int64,
    centred."""
    m0, m1 = torch.as_tensor(m0, dtype=torch.int64), torch.as_tensor(m1, dtype=torch.int64)
    r0, c0 = m0.shape
    c1 = m1.shape[1]
    rows = torch.zeros(r0, n, dtype=torch.int64)
    cols = torch.zeros(c1, n, dtype=torch.int64)
    rows[:, :c0] = m0 % t
    cols[:, :c0] = m1.T % t
    prod = (rows[:, None, :] * cols[None, :, :]) % t        # [r0, c1, n]
    halves = prod.reshape(r0, c1, 2, n // 2)                # the two batching rows
    out = sum(torch.roll(halves, -s, dims=-1) for s in range(c0)) % t
    out = out.reshape(r0, c1, n)
    return torch.where(out > t // 2, out - t, out)


def answers(m0, m1, n: int, t: int) -> torch.Tensor:
    """``M0 . M1`` as the packing gives it: slot 0 of each output."""
    return slot_vectors(m0, m1, n, t)[..., 0]
