"""The least time the card could take for the BFV multiplies and the
relinearizations of one ``operate`` call.

Counted from the program's own counters (``utils/counters.py`` of the
port): each step a call ran, at the shapes it ran at.  They are read from
the program's module in ``sys.modules``, so nothing of the program is
imported here; where that module is absent (a program without counters)
there is nothing to read.  A key is ``(step, polys, rows_in, rows_out, n,
elem_bytes, *extra)``: ``polys`` polynomials of ``rows_in`` residue rows of
``n`` coefficients in, ``rows_out`` out.  The steps on the operands count
the operands' distinct polynomials, not the broadcast copies a program
may make of them, so the bound is what the call asks for whatever the
program's algorithm.

Each step's least time is the larger of two bounds (the peaks of
``roofline.py``):

* bytes: each residue the step reads once and each it writes once, at
  ``RESIDUE_BYTES`` (the program may hold residues wider, as its int64
  domain does: that is its choice, not the work's), and a relinearization's
  key read once, over HBM's peak;
* operations: its modular products (``MUL_OPS`` int32 instructions each),
  its modular sums and differences (``ADD_OPS``) and its NTT transforms
  (as ``roofline.py`` counts them), over the int32 rate.

The counts of products and sums follow the port's algorithm
(``evaluator/behz.py``, ``evaluator/eval.py:key_switch``), each of its
steps' least: a lift that takes two products where one would do counts
one.  Steps a call runs that are not counted here (the inner-axis sum of
the matrix multiply, copies) add to the busy time, not to the bound.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Optional, Tuple

from perf_bench.roofline import (
    OPS_FIRST_FWD_BUTTERFLY,
    OPS_PER_BUTTERFLY,
    OPS_PER_OUTPUT,
    PEAK_BYTES_PER_S,
    PEAK_INT32_OPS_PER_S,
)

COUNTERS = "reference_seal_backend_tpu_torch.utils.counters"
#: bytes of one residue: every prime is below 2^30, so 32 bits hold it
RESIDUE_BYTES = 4
#: a modular product by a precomputed (Shoup) or Montgomery constant: its
#: high and low products and a multiply-add, then the conditional
#: subtraction (subtract, minimum); a Montgomery product's extra multiply
#: is not counted
MUL_OPS = 5
#: a modular sum or difference: add, subtract, minimum
ADD_OPS = 3


#: the steps :func:`step_work` counts
STEPS = ("behz.to_coeff", "behz.conv_q_bsk_mtilde", "behz.tensor_product",
         "behz.floor_q_bsk", "behz.sk_bsk_q", "behz.to_ntt", "relinearize")


def ntt_ops(name: str, n: int) -> int:
    """Least int32 instructions of one transform of ``n`` points, as
    ``roofline.bound_ms`` counts them."""
    ops = n // 2 * int(math.log2(n)) * OPS_PER_BUTTERFLY + OPS_PER_OUTPUT[name] * n
    if name == "ntt_fwd":
        ops -= n // 2 * (OPS_PER_BUTTERFLY - OPS_FIRST_FWD_BUTTERFLY)
    return ops


def step_work(key: Tuple) -> Optional[Dict[str, int]]:
    """What one run of the step ``key`` asks for, in rows of ``n``
    coefficients: ``rows`` read and written, modular ``products`` and
    ``sums``, forward and inverse transforms (``fwd``, ``inv``), and
    ``key_rows`` of a key read once.  None for a step that carries no
    work of its own (``bfv_multiply``, whose steps are counted apart)
    or that this reckoning does not know."""
    if key[0] not in STEPS:
        return None
    step, V, r_in, r_out = key[:4]
    w = {"rows": 0, "products": 0, "sums": 0, "fwd": 0, "inv": 0, "key_rows": 0}
    if step == "behz.to_coeff":  # inverse NTT, out of Montgomery form
        w.update(rows=2 * V * r_in, products=V * r_in, inv=V * r_in)
    elif step == "behz.conv_q_bsk_mtilde":  # q -> Bsk u {m~}, then the m~ reduction
        r, kb = r_in, r_out
        w.update(rows=V * (r + kb), products=V * (2 * r + r * kb + 2 * kb),
                 sums=V * ((r - 1) * (kb + 1) + 2 * kb))
    elif step == "behz.tensor_product":  # polys = products, rows = q u Bsk
        # the D operand polynomials in and forward, their pair sums; three
        # Karatsuba products and two differences a product, 3P inverse.
        # Operand a's entry into Montgomery form folds into the product by
        # a constant that ends its base conversion, so it is not counted
        P, rows, D = V, r_in, key[6]
        w.update(rows=(D + 3 * P) * rows, products=3 * P * rows,
                 sums=(D // 2 + 2 * P) * rows, fwd=D * rows, inv=3 * P * rows)
    elif step == "behz.floor_q_bsk":  # fast conversion q -> Bsk, x t, / q
        r, kb = r_in, r_out
        w.update(rows=V * (r + 2 * kb), products=V * (r + r * kb + 2 * kb),
                 sums=V * ((r - 1) * kb + 2 * kb))
    elif step == "behz.sk_bsk_q":  # Shenoy-Kumaresan Bsk -> q
        kb, r = r_in, r_out
        ka = kb - 1
        w.update(rows=V * (kb + r), products=V * (2 * ka + 1 + ka * r + 2 * r),
                 sums=V * (ka + (ka - 1) * r + 3 * r))
    elif step == "behz.to_ntt":  # into Montgomery form, forward NTT
        w.update(rows=2 * V * r_in, products=V * r_in, fwd=V * r_in)
    else:  # relinearize: the key switch of c2, added to c0 and c1
        R, l = V, r_in
        ns, digits = key[6], key[7]
        t = l + ns
        w.update(
            rows=5 * R * l, key_rows=2 * digits * t,
            # lift onto every target, inner products, two mod-downs
            products=R * (l + l * t) + 2 * R * digits * t + 2 * R * (ns + ns * l + 2 * l),
            sums=R * (l - digits) * t + 2 * R * (digits - 1) * t
            + 2 * R * ((ns - 1) * l + l) + 2 * R * l,
            fwd=R * digits * t + 2 * R * l, inv=R * l + 2 * R * ns)
    return w


def step_bound_ms(key: Tuple) -> float:
    """Least milliseconds of one run of the step ``key`` (module
    docstring); 0 for a step :func:`step_work` does not count."""
    w = step_work(key)
    if w is None:
        return 0.0
    n = key[4]
    n_bytes = (w["rows"] + w["key_rows"]) * n * RESIDUE_BYTES
    ops = (n * (w["products"] * MUL_OPS + w["sums"] * ADD_OPS)
           + w["fwd"] * ntt_ops("ntt_fwd", n) + w["inv"] * ntt_ops("ntt_inv", n))
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS_PER_S) * 1e3


def call_bound_ms(counts: Dict[Tuple, int]) -> Optional[float]:
    """Least milliseconds of one call: the steps ``counts`` holds, over the
    ``operate`` calls it holds.  None where it holds no call."""
    calls = counts.get(("operate",), 0)
    if not calls:
        return None
    return sum(step_bound_ms(k) * v for k, v in counts.items()) / calls


def bfv_mult_roofline(record):
    """Metric reader: one call's least time (:func:`call_bound_ms`) over
    one traced call's device busy time, in %.  None where the program
    holds no counters or they count no work."""
    mod, t = sys.modules.get(COUNTERS), record.get("trace")
    if mod is None or not t or not t["busy_s"]:
        return None
    bound = call_bound_ms(mod.counts)
    if not bound:
        return None
    return 100.0 * bound * t["calls"] / (t["busy_s"] * 1e3)
