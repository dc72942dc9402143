"""Composite HE primitives shared by the workloads.

Counterpart of ``reference_seal_backend_tpu/evaluator/composite.py``:

* :func:`accumulate` — sum-across-slots, by one hoisted multi-rotation for
  small counts, a baby-step/giant-step pair of hoisted rotations for medium
  counts, and a log2 rotate-add tree beyond (both schemes; BFV folds its
  second batching row with one rotate_columns).
* :func:`collapse` — gather slot 0 of k ciphertexts into one ciphertext by a
  one-hot mask and a log2(k) doubling merge: each round rotates half the
  survivors by a power-of-two step, one batched key switch per round.
* :func:`evaluate_polynomial` — Horner evaluation with plaintext
  coefficients, each encoded at the running value's exact scale.

The plaintext constants of ``collapse`` and ``evaluate_polynomial`` (the
mask, the coefficients) are encoded on the host with the float64 FFT.  They
depend only on the value, the scale and the level, so they are encoded once
per evaluator and kept (``Evaluator.plain_cache``): a timed ``operate`` after
the warm-up encodes nothing.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import List, Sequence

import numpy as np
import torch

from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
from reference_seal_backend_tpu_torch.schemes import ckks as ckks_mod
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext

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
    tree.  Every caller reads slot 0 only.  BFV: rotations act per batching
    row of N/2 slots, plus one rotate_columns fold (the conjugation key)
    when ``count`` exceeds the row.
    """
    ctx = ev.ctx
    row = ctx.n // 2 if ctx.scheme == "bfv" else ctx.slots
    row_count = min(count, row)
    if _hoisted(row_count):
        out = ev.rotate_sum(ct, list(range(row_count)))
    elif 1 < row_count <= _BSGS_MAX_COUNT:
        baby, giant = _bsgs_split(row_count)
        out = ev.rotate_sum(ct, list(range(baby)))
        out = ev.rotate_sum(out, [baby * i for i in range(giant)])
    else:
        out = ct
        for step in rotations_for_accumulate(row_count, row):
            out = ev.add(out, ev.rotate(out, step))
    if ctx.scheme == "bfv" and count > row:
        out = ev.add(out, ev.conjugate(out))
    return out


def _const_plain(
    ev: Evaluator, kind: str, value: float, scale: float, level: int
) -> Plaintext:
    """Plaintext of a public constant at ``scale``, switched to ``level``:
    ``kind`` "fill" puts ``value`` into every slot, "slot0" into slot 0 only.
    Encoded once per evaluator; the key is everything the integers depend on."""
    key = (kind, float(value), float(scale), level)
    if key not in ev.plain_cache:
        ctx = ev.ctx
        if kind == "fill":
            vec = np.full(ctx.slots, float(value))
        else:
            vec = np.zeros(ctx.slots)
            vec[0] = float(value)
        pt = ckks_mod.encoder_for(ctx).encode(vec, scale=scale)
        ev.plain_cache[key] = ev.mod_switch_plain_to(pt, level)
    return ev.plain_cache[key]


def collapse(ev: Evaluator, cts: Ciphertext, count: int) -> Ciphertext:
    """From a batched ciphertext [count, ...] whose samples hold their
    value in slot 0, build one ciphertext with sample i's value in slot i.

    Consumes one rescale level (the one-hot mask multiply).  Requires Galois
    keys for steps -2^s, s < ceil(log2(count)).
    """
    ctx = ev.ctx
    if cts.data.ndim < 4 or cts.data.shape[0] < count:
        raise ValueError("expected leading batch axis of >= count samples")
    # One-hot mask at slot 0, encoded at the *compensating* scale so the
    # post-rescale result lands at exactly ctx.scale.  The expression keeps
    # the reference's order of operations: one ulp in the scale flips
    # roundings of the encode.
    drop = 1.0
    for i in range(cts.level - ctx.rescale_group, cts.level):
        drop *= ctx.data_primes[i]
    pt = _const_plain(
        ev, "slot0", 1.0, drop * ctx.scale / cts.scale, cts.level
    )
    masked = ev.rescale_to_next(ev.multiply_plain(cts, pt))
    # doubling merge: round s combines block pairs, rotating the odd
    # block right by 2^s so its slots land after the even block's.
    cur = masked
    k = cur.data.shape[0]
    s = 1
    while k > 1:
        pairs = k // 2
        even = replace(cur, data=cur.data[0 : 2 * pairs : 2])
        odd = replace(cur, data=cur.data[1 : 2 * pairs : 2])
        moved = ev.rotate(odd, -s)
        merged = ev.add(even, moved)
        if k % 2:
            merged = replace(
                merged, data=torch.cat([merged.data, cur.data[-1:]], dim=0)
            )
        cur = merged
        k = pairs + (k % 2)
        s *= 2
    return replace(cur, data=cur.data[0])


def collapse_rotation_steps(count: int) -> List[int]:
    """Galois rotation steps collapse() needs for a given batch size."""
    if count <= 1:
        return []
    return [-(1 << s) for s in range(math.ceil(math.log2(count)))]


def evaluate_polynomial(
    ev: Evaluator, ct: Ciphertext, coeffs: Sequence[float]
) -> Ciphertext:
    """Horner evaluation of sum coeffs[i]·x^i on a CKKS ciphertext.

    The running value starts as the *plaintext* top coefficient, so the
    first Horner step is a ct-pt multiply, and each coefficient is encoded
    at the running value's exact scale.  Needs len(coeffs)-1 rescale levels
    below ct's current level.
    """
    if len(coeffs) == 0:
        raise ValueError("polynomial needs at least one coefficient")
    if len(coeffs) == 1:
        # Constant polynomial: a transparent (noiseless) ciphertext of
        # the public constant — nothing secret to protect.
        pt = _const_plain(ev, "fill", coeffs[0], ct.scale, ct.level)
        zero = torch.zeros_like(pt.data)
        return replace(
            ct, data=torch.stack([pt.data, zero], dim=-3), scale=pt.scale
        )
    rest = list(coeffs[:-1])[::-1]
    # First step: r = c_top·x + a via ct-pt multiply (no relin needed).
    top = _const_plain(ev, "fill", coeffs[-1], ct.scale, ct.level)
    r = ev.rescale_to_next(ev.multiply_plain(ct, top))
    r = ev.add_plain(r, _const_plain(ev, "fill", rest[0], r.scale, r.level))
    x = ct
    for a in rest[1:]:
        x = ev.mod_switch_to(x, r.level)
        r = ev.rescale_to_next(ev.relinearize(ev.multiply(r, x)))
        r = ev.add_plain(r, _const_plain(ev, "fill", a, r.scale, r.level))
    return r
