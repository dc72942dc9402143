"""Counts of the work ``operate`` asks for, by step and shape, and a
profiler span around each counted step.

A step is noted where its Python runs: in an eager call, and in the
capture of a stage (``utils/staging.py``).  A replay runs no Python, so
:class:`~reference_seal_backend_tpu_torch.utils.staging.StagedCall` keeps
what its capture noted and credits it to :data:`counts` once per call,
the first included (its warm-up notes nothing), as it credits the
collectives of the parallel path.  So :data:`counts` holds what ran on the
device, eager or replayed, and one call's counts are ``counts`` over the
count of ``("operate",)``.

A key is ``(step, polys, rows_in, rows_out, n, elem_bytes, *extra)``:
``polys`` polynomials of ``rows_in`` residue rows of ``n`` coefficients in,
of ``rows_out`` rows out, stored ``elem_bytes`` to a residue in the step's
output; ``extra`` as the step's note says.  The steps:

* ``("operate",)``: one ``operate`` call of any workload;
* ``bfv_multiply``: one BEHZ multiply (``evaluator/behz.py``) of
  ``polys`` ct x ct products over ``rows_in`` = ``rows_out`` = k q limbs;
  its six steps below, each noted with the multiply's shapes:
  ``behz.to_coeff``, ``behz.conv_q_bsk_mtilde``, ``behz.tensor_product``,
  ``behz.floor_q_bsk``, ``behz.sk_bsk_q``, ``behz.to_ntt``.  The steps on
  the operands count the operands' distinct polynomials, as stored before
  they broadcast against each other: ``polys`` of the first two,
  ``extra`` = ``(operand polys,)`` of the tensor product, whose ``polys``
  are its products.  ``behz.operand_polys`` (the shape of
  ``behz.to_coeff``) notes the polynomials that the operands' inverse
  sweep received, read from the tensor: the operand side runs once per
  distinct polynomial, so it equals ``behz.to_coeff``'s ``polys``, not
  the 4P polynomials of the operands broadcast.  On the card
  ``behz.fused_floor_sk`` (``polys`` the 3P product polynomials, ``rows_in``
  = k + kb, ``rows_out`` = k) notes the one kernel that runs the floor,
  the conversion back to q and the Montgomery entry; ``behz.floor_q_bsk``
  and ``behz.sk_bsk_q`` are noted beside it, without spans, as the work it
  does;
* ``relinearize``: ``polys`` size-3 ciphertexts at level ``rows_in``,
  ``extra`` = ``(special primes, key-switch digits)``;
* ``rotate_sum``: one hoisted ``Evaluator.rotate_sum`` of ``polys``
  ciphertexts at level ``rows_in``, noted once a call on the flat and the
  limb path alike, ``extra`` = ``(rotations, identity steps, special
  primes, key-switch digits)``.  It has no span of its own: its three
  phases are spans (:func:`span`), ``rotate_sum.lift`` (the shared
  inverse sweep, lift and forward sweeps), ``rotate_sum.inner`` (each
  rotation's inner product and roll, and c0 rolled by each step) and
  ``rotate_sum.mod_down`` (the one mod-down, its sum with the rolled c0s,
  and the identity steps).

Each span is a ``torch.profiler.record_function`` range named
``SPAN_PREFIX + step``: it names the step in a traced eager call
(``utils/profile_operate.py``).  A graph holds neither counts nor spans:
a replay costs one dict update.  Where a step counts is the calling
thread's own (:func:`into`): a capture redirects only its thread's notes.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Optional

import torch

SPAN_PREFIX = "rsb."

#: times each step ran since the last :func:`reset`, by key (module docstring)
counts: Counter = Counter()


class _Where(threading.local):
    """Where this thread's :func:`step` and :func:`note` count:
    :data:`counts`, a capture's own counter (:func:`into`), or nowhere
    (None: a stage's warm-up)."""

    sink: Optional[Counter] = counts


_where = _Where()


def reset() -> None:
    counts.clear()


def note(name: str, *shape: int) -> None:
    """One run of step ``name`` at ``shape`` (module docstring)."""
    sink = _where.sink
    if sink is not None:
        sink[(name, *shape)] += 1


def span(name: str):
    """The block inside a profiler span ``SPAN_PREFIX + name``, noting
    nothing."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def step(name: str, *shape: int):
    """:func:`note`, and the block inside a profiler span of the step."""
    note(name, *shape)
    with span(name):
        yield


@contextlib.contextmanager
def into(sink: Optional[Counter]):
    """Within the block, this thread's steps count into ``sink`` (None:
    nowhere), not into :data:`counts`."""
    saved, _where.sink = _where.sink, sink
    try:
        yield
    finally:
        _where.sink = saved


def credit(noted: Counter) -> None:
    """A replay of a graph whose capture noted ``noted``."""
    sink = _where.sink
    if sink is not None:
        sink.update(noted)
