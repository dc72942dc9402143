"""Composite HE primitives shared by the workloads.

Counterpart of ``reference_seal_backend_tpu/evaluator/composite.py``:

* :func:`accumulate` — sum-across-slots, by one hoisted multi-rotation for
  small counts, a baby-step/giant-step pair of hoisted rotations for medium
  counts, and a log2 rotate-add tree beyond.

``collapse`` and ``evaluate_polynomial`` come with the logistic-regression
slice (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import math
from typing import List

from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext

# Below this count the linear hoisted form (count-1 rotations sharing ONE
# digit decomposition + ONE mod-down, Evaluator.rotate_sum) costs fewer
# operations than ceil(log2(count)) full key-switches; above it the log
# tree wins.  Between _HOIST_MAX_COUNT and _BSGS_MAX_COUNT a
# baby-step/giant-step split (window sum of ceil(sqrt(count)) slots, then
# ceil(count/sqrt(count)) window strides — TWO hoisted key-switches total)
# beats the tree.  The thresholds are the reference's, kept so that both
# packages choose the same rotations and produce the same ciphertexts.
_HOIST_MAX_COUNT = 32
_BSGS_MAX_COUNT = 1024


def _hoisted(count: int) -> bool:
    return 1 < count <= _HOIST_MAX_COUNT


def _bsgs_split(count: int) -> tuple:
    baby = math.isqrt(count - 1) + 1  # ceil(sqrt(count))
    giant = -(-count // baby)         # ceil(count / baby)
    return baby, giant


def rotations_for_accumulate(count: int, slots: int) -> List[int]:
    """Rotation steps accumulate() will use for ``count`` (drives which
    Galois keys a benchmark generates): linear 1..count-1 for small counts
    (one hoisted key-switch), baby-step/giant-step for medium counts (two
    hoisted key-switches), power-of-two tree otherwise."""
    count = min(count, slots)
    if count <= 1:
        return []
    if _hoisted(count):
        return list(range(1, count))
    if count <= _BSGS_MAX_COUNT:
        baby, giant = _bsgs_split(count)
        return list(range(1, baby)) + [baby * i for i in range(1, giant)]
    return [1 << i for i in range(math.ceil(math.log2(count)))]


def accumulate(ev: Evaluator, ct: Ciphertext, count: int) -> Ciphertext:
    """Sum slots 0..count-1 into slot 0.

    Small counts: one hoisted multi-rotation (slot j then holds the exact
    window sum over v[j..j+count)).  Medium counts: baby-step/giant-step —
    slot j of the baby pass holds the window sum of ``baby`` slots;
    striding those windows by ``baby`` covers baby*giant >= count slots
    (the overshoot reads zero-padded slots).  Large counts: log2 rotate-add
    tree.  Every caller reads slot 0 only.
    """
    ctx = ev.ctx
    row_count = min(count, ctx.slots)
    if _hoisted(row_count):
        return ev.rotate_sum(ct, list(range(row_count)))
    if 1 < row_count <= _BSGS_MAX_COUNT:
        baby, giant = _bsgs_split(row_count)
        out = ev.rotate_sum(ct, list(range(baby)))
        return ev.rotate_sum(out, [baby * i for i in range(giant)])
    out = ct
    for step in rotations_for_accumulate(row_count, ctx.slots):
        out = ev.add(out, ev.rotate(out, step))
    return out
