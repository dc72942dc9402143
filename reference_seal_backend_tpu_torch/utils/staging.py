"""Each stage of ``operate`` captured once as a CUDA graph and replayed.

The port's counterpart of ``jax.jit`` as the JAX package applies it to a
pipeline stage (``reference_seal_backend_tpu/models/base.py:jit_with_keys``)
and to the sharded chains of its parallel path: one stage, one program,
dispatched once.  :class:`StagedCall` wraps a stage function and keeps one
``torch.cuda.CUDAGraph`` per input signature, the key ``jax.jit`` keys a
call on (:func:`signature`): every tensor leaf's shape, dtype, device and
strides, which leaves are one tensor, the static fields (``level``,
``scale``, ``is_ntt``) of each ``Ciphertext``/``Plaintext``/``SpCiphertext``
among the arguments, and of each ``ShardedTensor`` (``parallel/mesh.py``)
its mesh (axis names, device array), spec and global shape, its blocks the
leaves in mesh order.

On a CUDA device the first call of a signature

1. copies the inputs into static buffers of their own (one per distinct
   tensor: a replicated block that is one object in several blocks stays
   one buffer);
2. runs the stage once eagerly on a side stream, which fills every
   first-use cache the stage reads (hoisted Galois keys, encoded plaintext
   constants, permutation indices, BEHZ windows, sharded key slices, the
   kernels' shared-memory opt-in) so that nothing is built on the host
   during the capture;
3. captures the stage over the static buffers, and replays it.

A later call copies its inputs into the static buffers, replays, and
returns the output structure noted at capture with its tensors cloned: as
with a jitted call, a result stays valid after the next call.  The stage
reads everything else (keys, tables) in place, so those must outlive the
graph and stay as they were at capture: a benchmark sets its keys and its
evaluator once (``models/base.py``).  A sharded result is rebuilt on the
mesh object of the capture (equal by key to the caller's).

One graph belongs to one device.  A stage over a mesh whose blocks all lie
on one device (virtual devices of one card, ``utils/device.py:
mesh_devices``) is captured as one graph there, its collectives (copies
between blocks) inside it.  A stage over a mesh of several devices is not
staged at all, by :func:`stage`'s branch when the stage is built
(:func:`one_device`), never by a failed capture.

On the CPU a staged call is the function itself: the CPU has no graphs.
There is no fallback on the card: a capture or replay that fails raises,
naming the stage and the CUDA error; the stage is never rerun eagerly.  A
failed capture is ended before the error is raised (:func:`_abort_capture`),
so the stages captured after it, of this owner or another, are sound.

The NTT launch counters (``ops/cuda/ntt.py:launches``) count where the
wrapper launches its kernel: in the eager warm-up, and in the capture, which
records the launch into the graph.  A replay runs the graph's kernels
without Python and moves no counter: the kernels a replay ran are counted
from a trace (``utils/profile_operate.py``).  The collectives of the parallel
path are counted otherwise: each graph keeps those its capture ran
(``parallel/mesh.py:counts``, ``a2a_bytes`` included), and while
``sp_eval.collective_stats`` counts, every call credits them once, the
first (warm-up, capture, replay) as a replay, since the graph holds exactly
those copies.  The steps of ``utils/counters.py`` are credited the same
way: each graph keeps those its capture noted, the warm-up notes none, and
every call credits them once.  :data:`counts` counts the captures and the replays
themselves, and :func:`eager` runs an owner's stages as plain functions:
the reference a staged run is held against.
"""

from __future__ import annotations

import contextlib
import inspect
import threading
import time
import weakref
from collections import Counter
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
from reference_seal_backend_tpu_torch.parallel.mesh import Mesh, ShardedTensor
from reference_seal_backend_tpu_torch.parallel.sp_eval import SpCiphertext
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext
from reference_seal_backend_tpu_torch.utils import counters

#: graphs captured and replayed since the last :func:`reset_counts`
counts: Dict[str, int] = {"captures": 0, "replays": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _walk(x, tensors: List[torch.Tensor], seen: Dict[int, int]):
    """Key of ``x``'s structure and static fields; its tensor leaves are
    appended to ``tensors`` in order, each distinct tensor once (``seen``:
    its id -> its place), a repeat keyed by the place of its first."""
    if isinstance(x, torch.Tensor):
        if id(x) in seen:
            return ("same tensor as leaf", seen[id(x)])
        seen[id(x)] = len(tensors)
        tensors.append(x)
        return ("tensor", tuple(x.shape), x.dtype, x.device, x.stride())
    if isinstance(x, ShardedTensor):
        mesh = x.mesh
        return ("ShardedTensor", mesh.axis_names, mesh.devices.shape,
                tuple(mesh.devices.flat), x.spec, tuple(x.shape),
                tuple(_walk(b, tensors, seen) for b in x.blocks.flat))
    if isinstance(x, (Ciphertext, Plaintext)):
        return (type(x).__name__, x.level, x.scale, x.is_ntt,
                _walk(x.data, tensors, seen))
    if isinstance(x, SpCiphertext):
        return ("SpCiphertext", x.level, x.scale, _walk(x.data, tensors, seen))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_walk(v, tensors, seen) for v in x))
    if x is None or isinstance(x, (bool, int, float, str)):
        return (type(x).__name__, x)
    raise TypeError(
        "a staged call takes tensors, ShardedTensors, Ciphertexts, "
        "Plaintexts, SpCiphertexts, tuples and lists of them and plain "
        f"scalars, not {type(x).__name__}"
    )


def signature(args):
    """``(key, tensor leaves)`` of a stage's positional arguments: the
    distinct tensors, a ``ShardedTensor``'s blocks in mesh order."""
    tensors: List[torch.Tensor] = []
    return _walk(tuple(args), tensors, {}), tensors


def _rebuild(x, leaves, done=None):
    """``x`` with its distinct tensors replaced, in order, by ``leaves``'s
    (a tensor that recurs in ``x`` takes the same replacement each time);
    a ``ShardedTensor`` rebuilt on its mesh and spec."""
    done = {} if done is None else done
    if isinstance(x, torch.Tensor):
        if id(x) not in done:
            done[id(x)] = next(leaves)
        return done[id(x)]
    if isinstance(x, ShardedTensor):
        blocks = np.empty(x.blocks.size, dtype=object)
        for i, b in enumerate(x.blocks.flat):
            blocks[i] = _rebuild(b, leaves, done)
        return ShardedTensor(blocks.reshape(x.blocks.shape), x.mesh, x.spec)
    if isinstance(x, (Ciphertext, Plaintext, SpCiphertext)):
        return replace(x, data=_rebuild(x.data, leaves, done))
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, leaves, done) for v in x)
    return x


def one_device(mesh: Mesh) -> bool:
    """Do all blocks of ``mesh`` lie on one device (a card, virtual devices
    of one card, or the CPU)?  Only then is a stage over it one graph."""
    return len(mesh.unique_devices()) == 1


def _held(fn):
    """A getter of ``fn``: a bound method is held weakly, so that an object
    that keeps a stage of its own method forms no reference cycle (it is
    freed, its graphs and keys with it, when the last reference goes)."""
    if inspect.ismethod(fn):
        return weakref.WeakMethod(fn)
    return lambda: fn


def unstaged(fn):
    """``fn``, called as it is and held as a :class:`StagedCall` holds it:
    a stage of an owner that runs it eagerly and never captures."""
    get = _held(fn)
    return lambda *args: get()(*args)


def stage(fn, name: str, guard: threading.Lock, mesh: Optional[Mesh] = None):
    """``fn`` as a :class:`StagedCall`, unless it runs over ``mesh`` and the
    mesh spans several devices: then :func:`unstaged`, decided here, when
    the stage is built (one CUDA graph belongs to one device)."""
    if mesh is not None and not one_device(mesh):
        return unstaged(fn)
    return StagedCall(fn, name, guard)


def _abort_capture(graph, pool, device) -> None:
    """End a capture that raised, and leave the card as it was before it
    began: the stream capturing no more, allocations no longer routed to
    the graph's private pool, no error pending.  (The failure has
    invalidated the capture, so ending it raises: it ends all the same.
    ``capture_end`` stops the routing only when it succeeds.)"""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except RuntimeError:
        pass  # capture_end has stopped it
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a failed CUDA graph capture could not be ended")
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def _collectives_into(stats: Optional[Dict[str, int]]):
    """Within the block the collectives of ``parallel/mesh.py`` count into
    ``stats`` (None: not at all), whatever counted before."""
    saved, mesh_mod.counts = mesh_mod.counts, stats
    try:
        yield
    finally:
        mesh_mod.counts = saved


def _run_noting(fn, args, collectives: Optional[Dict[str, int]],
                steps: Optional[Counter]):
    """``fn(*args)``, its collectives counted into ``collectives`` and its
    steps (``utils/counters.py``) into ``steps``; None counts nothing (a
    warm-up).  What a capture runs: the graph then holds exactly those."""
    with _collectives_into(collectives), counters.into(steps):
        return fn(*args)


@dataclass
class _Entry:
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]   # static input buffers, in leaf order
    out: object                  # the output structure noted at capture
    outputs: List[torch.Tensor]  # its tensor leaves (the graph writes them)
    collectives: Dict[str, int]  # what the capture counted (mesh.counts)
    steps: Counter               # what the capture noted (counters.py)


class StagedCall:
    """One stage of ``operate``, captured once per :func:`signature` on the
    card and replayed (module docstring).

    ``guard`` is a lock shared by the stages of one owner: a stage called
    while another of them is being warmed up or captured raises, as the JAX
    package's single-trace guard does.  ``fn`` is held by :func:`_held`."""

    def __init__(self, fn, name: str, guard: threading.Lock):
        self._fn = _held(fn)
        self.name = name
        self.guard = guard
        self._entries: Dict[object, _Entry] = {}
        self.captures = 0
        self.replays = 0
        self.warmup_s = 0.0   # eager warm-up runs, synchronised
        self.capture_s = 0.0  # captures, synchronised

    @property
    def fn(self):
        """The stage function, run eagerly."""
        fn = self._fn()
        if fn is None:
            raise ReferenceError(f"stage {self.name}: its owner is gone")
        return fn

    def release(self) -> None:
        """Drop every graph and its buffers (the private memory pools go
        with the graphs)."""
        self._entries.clear()

    def __call__(self, *args):
        if self.guard.locked():
            raise RuntimeError(
                f"stage {self.name} called while a stage of the same owner "
                "is being captured (one capture at a time)"
            )
        key, tensors = signature(args)
        devices = {t.device for t in tensors}
        if all(d.type == "cpu" for d in devices):
            return self.fn(*args)
        if len(devices) != 1:
            raise ValueError(
                f"stage {self.name}: inputs on {sorted(map(str, devices))}")
        entry = self._entries.get(key)
        if entry is None:
            entry = self._capture(key, args, tensors, devices.pop())
        else:
            for dst, src in zip(entry.inputs, tensors):
                dst.copy_(src)
        return self._replay(entry)

    def _replay(self, entry: _Entry):
        """Replay ``entry``'s graph, credit what its capture counted, and
        return its output with the tensors cloned."""
        try:
            entry.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"stage {self.name}: CUDA graph replay failed: {e}") from e
        counts["replays"] += 1
        self.replays += 1
        if mesh_mod.counts is not None:
            for k, v in entry.collectives.items():
                mesh_mod.counts[k] += v
        counters.credit(entry.steps)
        return _rebuild(entry.out, iter([t.clone() for t in entry.outputs]))

    def _capture(self, key, args, tensors, device) -> _Entry:
        if not self.guard.acquire(blocking=False):
            raise RuntimeError(
                f"stage {self.name}: a capture started while another capture "
                "of the same owner is running (one capture at a time)"
            )
        try:
            with torch.cuda.device(device):
                inputs = [torch.empty_like(t) for t in tensors]
                for dst, src in zip(inputs, tensors):
                    dst.copy_(src)
                static_args = _rebuild(args, iter(inputs))
                t0 = time.perf_counter()
                main = torch.cuda.current_stream(device)
                side = torch.cuda.Stream(device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    _run_noting(self.fn, static_args, None, None)
                main.wait_stream(side)
                torch.cuda.synchronize(device)
                t1 = time.perf_counter()
                # as torch.cuda.graph does: the pools of released graphs
                # stay reserved until the cache is emptied
                torch.cuda.empty_cache()
                graph = torch.cuda.CUDAGraph()
                pool = torch.cuda.graph_pool_handle()
                collectives, steps = mesh_mod.zero_counts(), Counter()
                with torch.cuda.stream(side):
                    # "thread_local": the stage's own thread may make no
                    # call that a capture cannot hold (a host sync, a copy
                    # from pageable memory); other threads are not ours
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        result = _run_noting(self.fn, static_args, collectives, steps)
                        graph.capture_end()
                    except Exception as e:
                        _abort_capture(graph, pool, device)
                        raise RuntimeError(
                            f"stage {self.name}: CUDA graph capture failed: {e}"
                        ) from e
                main.wait_stream(side)
                torch.cuda.synchronize(device)
                t2 = time.perf_counter()
        finally:
            self.guard.release()
        outputs: List[torch.Tensor] = []
        _walk(result, outputs, {})
        entry = _Entry(graph, inputs, result, outputs, collectives, steps)
        self._entries[key] = entry
        counts["captures"] += 1
        self.captures += 1
        self.warmup_s += t1 - t0
        self.capture_s += t2 - t1
        return entry


@contextlib.contextmanager
def eager(owner):
    """Within the block, every :class:`StagedCall` attribute of ``owner``
    is its plain function: ``owner``'s methods run their stages eagerly, as
    they ran before staging (the reference a replay is held against and
    timed beside)."""
    stages = {k: v for k, v in vars(owner).items() if isinstance(v, StagedCall)}
    for k, v in stages.items():
        setattr(owner, k, v.fn)
    try:
        yield owner
    finally:
        for k, v in stages.items():
            setattr(owner, k, v)


def same_result(a, b) -> bool:
    """Two results (of ``operate``, of a stage) equal integer for integer:
    the same structure, the same ``level`` / ``scale`` / ``is_ntt``, equal
    tensors; sharded data on the same mesh and spec, equal block for block.
    The check a staged result is held to against its eager run."""
    from reference_seal_backend_tpu_torch.models.base import Handle

    if isinstance(a, Handle):
        return isinstance(b, Handle) and (a.tag, a.meta) == (b.tag, b.meta) \
            and same_result(a.payload, b.payload)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, ShardedTensor):
        return isinstance(b, ShardedTensor) and a.mesh is b.mesh \
            and a.spec == b.spec and \
            all(same_result(x, y) for x, y in zip(a.blocks.flat, b.blocks.flat))
    if isinstance(a, SpCiphertext):
        return isinstance(b, SpCiphertext) and (a.level, a.scale) == (b.level, b.scale) \
            and same_result(a.data, b.data)
    if isinstance(a, (Ciphertext, Plaintext)):
        return type(a) is type(b) and \
            (a.level, a.scale, a.is_ntt) == (b.level, b.scale, b.is_ntt) \
            and same_result(a.data, b.data)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(same_result(x, y) for x, y in zip(a, b))
    return a == b
