"""Each stage of ``operate`` captured once as a CUDA graph and replayed.

The port's counterpart of ``jax.jit`` as the JAX package applies it to a
pipeline stage (``reference_seal_backend_tpu/models/base.py:jit_with_keys``):
one stage, one program, dispatched once.  :class:`StagedCall` wraps a stage
function and keeps one ``torch.cuda.CUDAGraph`` per input signature, the key
``jax.jit`` keys a call on (:func:`signature`): every tensor leaf's shape,
dtype, device and strides, and the static fields (``level``, ``scale``,
``is_ntt``) of each ``Ciphertext``/``Plaintext`` among the arguments.

On a CUDA device the first call of a signature

1. copies the inputs into static buffers of their own;
2. runs the stage once eagerly on a side stream, which fills every
   first-use cache the stage reads (hoisted Galois keys, encoded plaintext
   constants, permutation indices, BEHZ windows, the kernels' shared-memory
   opt-in) so that nothing is built on the host during the capture;
3. captures the stage over the static buffers, and replays it.

A later call copies its inputs into the static buffers, replays, and
returns the output structure noted at capture with its tensors cloned: as
with a jitted call, a result stays valid after the next call.  The stage
reads everything else (keys, tables) in place, so those must outlive the
graph and stay as they were at capture: a benchmark sets its keys and its
evaluator once (``models/base.py``).

On the CPU a staged call is the function itself: the CPU has no graphs.
There is no fallback on the card: a capture or replay that fails raises,
naming the stage and the CUDA error; the stage is never rerun eagerly.  A
failed capture is ended before the error is raised (:func:`_abort_capture`),
so the stages captured after it, of this owner or another, are sound.

The NTT launch counters (``ops/cuda/ntt.py:launches``) count where the
wrapper launches its kernel: in the eager warm-up, and in the capture, which
records the launch into the graph.  A replay runs the graph's kernels
without Python and moves no counter: the kernels a replay ran are counted
from a trace (``utils/profile_operate.py``).  :data:`counts` counts the
captures and the replays themselves, and :func:`eager` runs an owner's
stages as plain functions: the reference a staged run is held against.
"""

from __future__ import annotations

import contextlib
import inspect
import threading
import time
import weakref
from dataclasses import dataclass, replace
from typing import Dict, List

import torch

from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext

#: graphs captured and replayed since the last :func:`reset_counts`
counts: Dict[str, int] = {"captures": 0, "replays": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _walk(x, tensors: List[torch.Tensor]):
    """Key of ``x``'s structure and static fields; its tensor leaves are
    appended to ``tensors`` in order."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return ("tensor", tuple(x.shape), x.dtype, x.device, x.stride())
    if isinstance(x, (Ciphertext, Plaintext)):
        return (type(x).__name__, x.level, x.scale, x.is_ntt,
                _walk(x.data, tensors))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_walk(v, tensors) for v in x))
    if x is None or isinstance(x, (bool, int, float, str)):
        return (type(x).__name__, x)
    raise TypeError(
        "a staged call takes tensors, Ciphertexts, Plaintexts, tuples and "
        f"lists of them and plain scalars, not {type(x).__name__}"
    )


def signature(args):
    """``(key, tensor leaves)`` of a stage's positional arguments."""
    tensors: List[torch.Tensor] = []
    return _walk(tuple(args), tensors), tensors


def _rebuild(x, leaves):
    """``x`` with its tensor leaves replaced, in order, by ``leaves``'s."""
    if isinstance(x, torch.Tensor):
        return next(leaves)
    if isinstance(x, (Ciphertext, Plaintext)):
        return replace(x, data=_rebuild(x.data, leaves))
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, leaves) for v in x)
    return x


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


@dataclass
class _Entry:
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]   # static input buffers, in leaf order
    out: object                  # the output structure noted at capture
    outputs: List[torch.Tensor]  # its tensor leaves (the graph writes them)


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
        try:
            entry.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"stage {self.name}: CUDA graph replay failed: {e}") from e
        counts["replays"] += 1
        self.replays += 1
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
                    self.fn(*static_args)
                main.wait_stream(side)
                torch.cuda.synchronize(device)
                t1 = time.perf_counter()
                # as torch.cuda.graph does: the pools of released graphs
                # stay reserved until the cache is emptied
                torch.cuda.empty_cache()
                graph = torch.cuda.CUDAGraph()
                pool = torch.cuda.graph_pool_handle()
                with torch.cuda.stream(side):
                    # "thread_local": the stage's own thread may make no
                    # call that a capture cannot hold (a host sync, a copy
                    # from pageable memory); other threads are not ours
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        result = self.fn(*static_args)
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
        _walk(result, outputs)
        entry = _Entry(graph, inputs, result, outputs)
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
