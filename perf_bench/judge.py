"""Whether what the timed path produced is correct.

Each checked call's decoded answers are held against the plain reference's
answers for the same input set (``references/``).  The numbers compared,
each beside the limit the cell's ``limits/<cell>.json`` gives it:

* ``max_abs_gap``: the widest ``|program - reference|`` over every value of
  every checked answer.  Under CKKS the reference's values go through the
  decode convention of the reference backend first (``|x| < 5e-5`` reads 0,
  ``CKKS_EPS``); under BFV the values are exact integers and the limit 0.
* ``answers_missing``: checked calls whose answers are fewer than, or shaped
  otherwise than, the reference's (limit 0).

A call that raised is no answer: the run ends there, with no result.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

CKKS_EPS = 5e-5  # decode clamp of the reference backend


def expected(answers: Sequence[np.ndarray], scheme: str) -> List[np.ndarray]:
    """The reference's answers as the program's decode reports them."""
    out = []
    for a in answers:
        a = np.asarray(a).reshape(-1)
        if scheme == "ckks":
            a = a.astype(np.float64).copy()
            a[np.abs(a) < CKKS_EPS] = 0.0
        out.append(a)
    return out


def compare(got_calls: Sequence[Sequence[np.ndarray]],
            want_calls: Sequence[Sequence[np.ndarray]],
            limits: Dict[str, float]) -> dict:
    """``got_calls[i]``: the decoded answers of checked call ``i``;
    ``want_calls[i]``: its expected answers.  Returns ``checks`` (each
    number with its limit), ``correct`` and ``failed`` (calls off limit)."""
    gap = 0.0
    missing = 0
    failed = 0
    for got, want in zip(got_calls, want_calls):
        if len(got) != len(want) or any(
                np.asarray(g).size != w.size for g, w in zip(got, want)):
            missing += 1
            failed += 1
            continue
        call_gap = 0.0
        for g, w in zip(got, want):
            g = np.asarray(g).reshape(-1)
            if np.issubdtype(w.dtype, np.integer):
                d = np.abs(g.astype(np.int64) - w.astype(np.int64))
            else:
                d = np.abs(g.astype(np.float64) - w)
            worst = float(d.max()) if d.size else 0.0
            call_gap = max(call_gap, worst if worst == worst else float("inf"))
        if not call_gap <= limits["max_abs_gap"]:
            failed += 1
        gap = max(gap, call_gap)
    checks = {
        "max_abs_gap": {"value": gap, "limit": limits["max_abs_gap"]},
        "answers_missing": {"value": missing, "limit": 0},
    }
    correct = (gap <= limits["max_abs_gap"] and missing == 0
               and len(got_calls) == len(want_calls) and len(got_calls) > 0)
    return {"checks": checks, "correct": correct, "failed": failed}
