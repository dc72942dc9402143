"""The least time the card could take for the NTT work of a call.

A frozen copy of ``chip_smoke.py:bound_of`` and its constants.  Peaks of
one NVIDIA H100 SXM (NVIDIA's data sheet, at the full 700 W power limit):
3.35 TB/s of HBM3.  The data sheet publishes no int32 rate; it is derived
here: 132 SMs x 64 int32 lanes an SM (half of the 128 float32 lanes behind
the 67 TFLOP/s float32 figure) x 1.98 GHz boost = 16.7e12 int32
instructions a second.  A card set below 700 W runs slower under load, so a
share is stated with the card's power limit beside it.

The work is counted from the transforms a call asks for, ``(name, rows,
limbs, N)`` as the evaluator hands them to ``NttPlan.fwd`` / ``inv`` (the
harness notes them, ``system.py:transforms``), never from the kernels that
happen to carry them.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The least integer instructions the lazy arithmetic needs.  A butterfly:
# high product, low product and multiply-add of the Shoup multiply, subtract
# and minimum of the conditional subtraction, one add, one three-input add.
# The forward transform's first stage takes u as it comes (no conditional
# subtraction).  Per output element: two conditional subtractions forward,
# a Shoup multiply and one conditional subtraction inverse.
OPS_PER_BUTTERFLY = 7
OPS_FIRST_FWD_BUTTERFLY = 5
OPS_PER_OUTPUT = {"ntt_fwd": 4, "ntt_inv": 5}


def bound_ms(name: str, polys: int, nl: int, n: int) -> float:
    """Least milliseconds for ``polys`` transforms (``name``: ``ntt_fwd`` or
    ``ntt_inv``) of ``n`` points over ``nl`` distinct limbs: the larger of
    the bytes (each input read once, each output written once, the two
    twiddle tables and the per-limb constants) over HBM and the operations
    over the int32 rate."""
    log_n = int(math.log2(n))
    n_bytes = 2 * polys * n * 4 + 2 * nl * n * 4 + 3 * nl * 4
    per_poly = n // 2 * log_n * OPS_PER_BUTTERFLY + OPS_PER_OUTPUT[name] * n
    if name == "ntt_fwd":
        per_poly -= n // 2 * (OPS_PER_BUTTERFLY - OPS_FIRST_FWD_BUTTERFLY)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = polys * per_poly / PEAK_INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops)


def work_bound_ms(work: Iterable[Tuple[str, int, int, int]]) -> float:
    """Sum of :func:`bound_ms` over ``(name, polys, limbs, N)`` transforms."""
    return sum(bound_ms(name, polys, nl, n) for name, polys, nl, n in work)


def ntt_roofline(record):
    """Metric reader: the bound of the transforms one call asks for, times
    the traced calls, over the traced NTT kernels' time, in %."""
    t, work = record.get("trace"), record.get("transforms")
    if not t or not work or not t["ntt_s"]:
        return None
    return 100.0 * work_bound_ms(work) * t["calls"] / (t["ntt_s"] * 1e3)
