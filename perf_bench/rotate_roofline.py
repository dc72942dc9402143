"""The least time the card could take for the hoisted rotations of one
``operate`` call, and the BFV matrix multiply's share of its roofline.

Counted, as ``bfv_roofline.py`` counts the BFV multiply, from the program's
own counters (``utils/counters.py`` of the port), read from the program's
module in ``sys.modules``.  A ``rotate_sum`` key is ``("rotate_sum", R, l,
l, n, elem_bytes, rotations, identities, special primes, key-switch
digits)``: one hoisted rotate-and-sum of ``R`` ciphertexts at level ``l``
over ``rotations`` Galois rotations and ``identities`` steps of 0.

Its least time is the larger of two bounds, at ``bfv_roofline``'s peaks,
residue width and instruction counts:

* bytes: the c0 and c1 rows read once and the output written once, and
  each rotation's key read once;
* operations: the one lift (``l`` inverse transforms, the lift's products
  and sums onto the ``l + ns`` targets, ``digits x (l + ns)`` forward
  transforms), each rotation's inner products and their sums over the
  digits, the accumulation across rotations, the sums of the rotated and
  identity c0s and c1s, and the one mod-down of both halves, counted as
  ``bfv_roofline.step_work`` counts a relinearization's.  The rolls are
  moves, not arithmetic: a kernel folds them into its indexing.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

from perf_bench.bfv_roofline import (
    ADD_OPS,
    COUNTERS,
    MUL_OPS,
    RESIDUE_BYTES,
    ntt_ops,
    step_bound_ms as bfv_step_bound_ms,
)
from perf_bench.roofline import PEAK_BYTES_PER_S, PEAK_INT32_OPS_PER_S

STEP = "rotate_sum"


def step_work(key: Tuple) -> Optional[Dict[str, int]]:
    """What one noted ``rotate_sum`` asks for, in rows of ``n``
    coefficients, under ``bfv_roofline.step_work``'s names; None for any
    other step."""
    if key[0] != STEP:
        return None
    _, R, l, _, _, _, rot, ident, ns, digits = key
    t = l + ns
    w = {"rows": 4 * R * l, "key_rows": 0, "products": 0, "sums": 0, "fwd": 0, "inv": 0}
    if not rot:  # identity steps alone: the input summed ident times
        return dict(w, sums=2 * R * l * max(ident - 1, 0))
    w.update(
        key_rows=rot * 2 * digits * t,
        # the lift, each rotation's two inner products, the mod-down of both
        products=R * (l + l * t) + rot * 2 * R * digits * t
        + 2 * R * (ns + ns * l + 2 * l),
        # the lift's group sums, the inner products' sums over the digits,
        # the accumulation across rotations, the rolled c0s, the mod-down's
        # sums, kb onto the c0 sum, and the identity steps onto c0 and c1
        sums=R * (l - digits) * t + rot * 2 * R * (digits - 1) * t
        + 2 * R * (rot - 1) * t + R * (rot - 1) * l
        + 2 * R * ((ns - 1) * l + l) + R * l + 2 * R * l * ident,
        fwd=R * digits * t + 2 * R * l, inv=R * l + 2 * R * ns)
    return w


def step_bound_ms(key: Tuple) -> float:
    """Least milliseconds of one noted ``rotate_sum``; 0 for any other
    step."""
    w = step_work(key)
    if w is None:
        return 0.0
    n = key[4]
    n_bytes = (w["rows"] + w["key_rows"]) * n * RESIDUE_BYTES
    ops = (n * (w["products"] * MUL_OPS + w["sums"] * ADD_OPS)
           + w["fwd"] * ntt_ops("ntt_fwd", n) + w["inv"] * ntt_ops("ntt_inv", n))
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS_PER_S) * 1e3


def call_bound_ms(counts: Dict[Tuple, int]) -> Optional[float]:
    """Least milliseconds of one call: its BFV multiply steps and
    relinearizations (``bfv_roofline.step_bound_ms``) and its rotate_sums,
    over the ``operate`` calls ``counts`` holds.  None where it holds no
    call or no rotate_sum."""
    calls = counts.get(("operate",), 0)
    if not calls or not any(k[0] == STEP for k in counts):
        return None
    return sum((bfv_step_bound_ms(k) + step_bound_ms(k)) * v
               for k, v in counts.items()) / calls


def bfv_matmult_roofline(record):
    """Metric reader: one call's least time (:func:`call_bound_ms`) over
    one traced call's device busy time, in %.  None where the program
    holds no counters or notes no rotate_sum (a program older than the
    note)."""
    mod, t = sys.modules.get(COUNTERS), record.get("trace")
    if mod is None or not t or not t["busy_s"]:
        return None
    bound = call_bound_ms(mod.counts)
    if not bound:
        return None
    return 100.0 * bound * t["calls"] / (t["busy_s"] * 1e3)
