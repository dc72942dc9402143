"""The benchmark suite of the port: key-switch-inclusive metrics, each behind
its correctness gate, on the card.

    python -m reference_seal_backend_tpu_torch.bench [--record PATH] [--device cuda|cpu]

Counterpart of the JAX package's ``bench.py``: the same steps at the same
sizes, the same ten metric keys (:data:`CURRENT_METRIC_KEYS`) beside the
headline ``ckks_ctct_mults_per_sec_n16384``, the same gates and the same
record, printed as one JSON line after every step.

1. The headline: the bare CKKS ciphertext-ciphertext multiply at N = 16384
   (depth 2), a batch of ``BATCH``, on a context whose keys already carry
   the relinearisation key and the rotation keys 5^1 .. 5^7 (seed 1234).
2. The three key-switch metrics on the same context, keys and operands
   (a batch of ``BATCH_KS``): multiply + relinearize + rescale, rotate by
   1, the hoisted sum of 8 rotations.
3. CKKS element-wise multiply Offline (16 x 16 samples, N = 8192), the BFV
   BEHZ multiply (N = 8192), CKKS dot product Latency (n = 100, N = 8192),
   logistic regression Latency and Offline (batch 100) at N = 16384 and at
   N = 32768, where the depth-6 chain takes three special primes and digit
   groups of 3 (``schemes/params.py:_resolve_digit_group``).  The record's
   ``describe`` holds each logistic-regression chain.

Where ``bench.py`` jits a step, the port stages it (``utils/staging.py``):
each is captured once as a CUDA graph and replayed; the keys are read in
place.  The engine's benchmarks stage their own ``operate``.  Every step
is also run eagerly (``staging.eager``, or the plain function), its result
held equal to the staged one integer for integer, and timed beside it in
turns.

Timing.  A throughput step warms up (the warm-up includes the capture),
then times ``CHUNKS`` chunks of calls each way, staged and eager in turns,
with CUDA events; its metric is the **median** chunk rate (``bench.py``
took the best chunk, which is biased high), the chunk rates beside it in
``steps``.  A staged call copies its inputs into the graph's buffers and
clones its outputs: ``steps`` gives the bytes and the time of those copies
per call.  A Latency step is the median of host-clock ``operate`` calls,
each ending in ``torch.cuda.synchronize()``.  Every step runs: the
JAX package's budget, cold factor and warm estimates are not ported.  The
first call of each step (warm-up and capture; the process's first BFV
multiply among them) lands in ``steps``, never in a metric.

Failures are not hidden.  A gate that fails raises ``SystemExit`` and ends
the run non-zero; a step that raises is recorded in ``skipped`` and the
run goes on, but exits non-zero at the end.

The record (:class:`Run`): ``metric``, ``value``, ``unit``, ``vs_baseline``
(against the SEAL estimate of 150 multiplies a second at N = 16384,
``BASELINE.md``), ``extras``, ``skipped``, ``timings``, ``describe``,
``date``, ``elapsed_s`` as ``bench.py`` writes them, and ``device`` (the
card's name, power limit and count) and ``steps`` (each step's detail).
It is written to a file only where ``--record PATH`` says: ``PATH`` when
the record is at least as complete as the one there
(:func:`_more_complete`), and always to ``PATH`` with ``.latest`` before
its suffix.

Runs on the card (``--device cuda``, the default); ``cuda`` without a card
raises.  ``--device cpu`` exists for the tests, which run the headline and
the key-switch steps at small sizes (:func:`headline` passes its sizes to
:class:`_State`); every other step runs at ``bench.py``'s sizes, and the
command line has no size flags.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import threading
import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from reference_seal_backend_tpu_torch.engine.descriptor import (
    Category,
    Scheme,
    Workload,
)
from reference_seal_backend_tpu_torch.engine.registry import Engine
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
from reference_seal_backend_tpu_torch.models.logreg import DEFAULT_BATCH, SIGMOID_D3
from reference_seal_backend_tpu_torch.schemes import bfv, ckks
from reference_seal_backend_tpu_torch.schemes import keys as keys_mod
from reference_seal_backend_tpu_torch.schemes.params import (
    make_bfv_context,
    make_ckks_context,
)
from reference_seal_backend_tpu_torch.utils import profile_operate, staging
from reference_seal_backend_tpu_torch.utils.device import (
    card_name_and_power_limit,
    pick_device,
)

SEAL_SINGLE_CORE_MULTS_PER_SEC = 150.0  # documented estimate, BASELINE.md

N = 16384
BATCH = 64      # dyadic-op batch
BATCH_KS = 8    # key-switch-op batch
EPS = 5e-5      # the reference's CKKS decode epsilon
KS_TOL = 5e-4   # after a key switch
SEED = 1234
ROTATE_SUM_STEPS = tuple(range(8))
LOGREG_BATCH = DEFAULT_BATCH  # 100, the reference's default batch
ELTWISE_SAMPLES = 16
# throughput: seconds of chunks each way (staged, eager); the headline's
# window is HEADLINE_WINDOWS times as long, as bench.py's 8 s against 4 s
WINDOW_S = 4.0
HEADLINE_WINDOWS = 2
CHUNKS = 5
DOT_REPS = 10
OFFLINE_REPS = 5
# the chain fields the record keeps of each logistic-regression step
DESCRIBE_KEYS = (
    "poly_modulus_degree",
    "coeff_modulus_chain_bits",
    "special_modulus_bits",
    "key_switch_digit_group",
    "security",
)

HEADLINE = "ckks_ctct_mults_per_sec_n16384"
# Every metric key this suite can produce (completeness basis for record
# promotion — see _more_complete); bench.py's, unchanged.
CURRENT_METRIC_KEYS = frozenset(
    {
        "ckks_rotate_per_sec_n16384",
        "ckks_mult_relin_rescale_per_sec_n16384",
        "ckks_rotate_sum8_per_sec_n16384",
        "bfv_behz_mult_per_sec_n8192",
        "ckks_dot_n100_latency_ms_n8192",
        "ckks_eltwise_mult_offline_samples_per_sec_n8192",
        "ckks_logreg_n16384_latency_ms",
        "ckks_logreg_offline_b100_samples_per_sec_n16384",
        "ckks_logreg_n32768_latency_ms",
        "ckks_logreg_offline_b100_samples_per_sec_n32768",
    }
)


# -- the ops of the suite's own steps (bench.py's jitted lambdas) ---------- #

def ctct_mult(ev, x, y):
    return ev.multiply(x, y)


def mult_relin_rescale(ev, x, y):
    return ev.rescale_to_next(ev.relinearize(ev.multiply(x, y)))


def rotate_1(ev, x):
    return ev.rotate(x, 1)


def rotate_sum8(ev, x):
    return ev.rotate_sum(x, list(ROTATE_SUM_STEPS))


# -- the record -------------------------------------------------------------- #

def _more_complete(new: dict, old: dict) -> bool:
    """True iff ``new`` may overwrite ``old``: a real headline and extras
    at least as complete, judged on the keys this suite can still produce
    (:data:`CURRENT_METRIC_KEYS`).  ``bench.py``'s rule, without its
    environment override: to keep a record beside a fuller one, give
    ``--record`` a new path."""
    if new.get("value") is None:
        return False
    if not isinstance(old, dict) or old.get("value") is None:
        return True
    old_keys = set(old.get("extras", {}))
    stale = old_keys - CURRENT_METRIC_KEYS
    if stale:
        print(
            f"bench: the record on disk carries retired metric keys "
            f"{sorted(stale)}; comparing completeness on current keys only",
            file=sys.stderr,
        )
    return set(new.get("extras", {})) >= (old_keys & CURRENT_METRIC_KEYS)


def device_fields(device: torch.device) -> dict:
    """What the record says of the device: on the card its name and power
    limit as ``nvidia-smi`` gives them, and the visible count."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None, "count": 0}
    line = card_name_and_power_limit()
    name, _, limit = line.rpartition(", ")
    return {"platform": "gpu", "name": name, "power_limit": limit,
            "count": torch.cuda.device_count()}


class Run:
    """One run of the suite: the device, the throughput window, the record
    and where it goes.  ``emit`` takes each JSON line (default: print);
    ``after_step(key, bench, loaded, result)``, where given, is called on
    every engine step after its timing, while the benchmark and its graphs
    live, and what it returns lands in ``steps[key]["inspected"]``."""

    def __init__(self, device=None, window_s: float = WINDOW_S,
                 record_path: Optional[str] = None,
                 emit: Optional[Callable[[str], None]] = None,
                 after_step=None):
        self.device = pick_device(device)
        self.window_s = float(window_s)
        self.record_path = record_path
        self._out = emit or (lambda line: print(line, flush=True))
        self.after_step = after_step
        self.t0 = time.monotonic()
        self.record = {
            "metric": HEADLINE,
            "value": None,
            "unit": "ops/s",
            "vs_baseline": None,
            "extras": {},
            "skipped": [],
            "timings": {},
            "describe": {},
            "date": time.strftime("%Y-%m-%d", time.gmtime()),
            "device": device_fields(self.device),
            "steps": {},
        }

    @property
    def extras(self) -> dict:
        return self.record["extras"]

    def emit(self) -> None:
        """The record as one JSON line, to ``emit`` and, with a record
        path, to ``PATH.latest`` always and to ``PATH`` where it is at
        least as complete as what is there."""
        self.record["elapsed_s"] = time.monotonic() - self.t0
        line = json.dumps(self.record)
        if self.record_path:
            root, ext = os.path.splitext(self.record_path)
            with open(f"{root}.latest{ext}", "w") as f:
                f.write(line + "\n")
            try:
                with open(self.record_path) as f:
                    old = json.load(f)
            except (OSError, ValueError):
                old = {}
            if _more_complete(self.record, old):
                with open(self.record_path, "w") as f:
                    f.write(line + "\n")
        self._out(line)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# -- gates, equality, timing --------------------------------------------------- #

def _gate(name: str, got, want, tol: float) -> float:
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    if not err <= tol:
        raise SystemExit(f"bench correctness gate failed [{name}]: max err {err}")
    return err


def _equal_to_eager(name: str, staged_out, eager_out) -> None:
    if not staging.same_result(staged_out, eager_out):
        raise SystemExit(
            f"bench correctness gate failed [{name}]: the staged result "
            "differs from the eager one")


def _broadcast(ct, batch):
    """``ct`` repeated along a new leading batch axis, as a tensor of its
    own (``jnp.broadcast_to`` outside a jit materialises the array)."""
    data = ct.data.expand((batch,) + tuple(ct.data.shape)).contiguous()
    return replace(ct, data=data)


def chunk_rates(calls_per_chunk: int, chunk_ms: List[float], batch: int = 1) -> dict:
    """Results per second of each chunk (``calls_per_chunk`` calls of
    ``batch`` results in ``chunk_ms``) and their median, the metric."""
    rates = [batch * calls_per_chunk * 1e3 / ms for ms in chunk_ms]
    return {"rate": statistics.median(rates), "chunk_rates": rates}


def _throughput(run: Run, calls: Dict[str, Callable], batch: int,
                windows: int = 1) -> dict:
    """Each of ``calls`` (how -> call) warmed up, then ``CHUNKS`` chunks of
    each, in turns, a chunk sized from one timed call to last
    ``windows * window_s / CHUNKS``, timed with CUDA events
    (``profile_operate.event_ms``).  Returns per way its calls per chunk,
    chunk milliseconds, chunk rates and median rate (:func:`chunk_rates`)."""
    k = {}
    for how, call in calls.items():
        call()  # warm-up: a staged call warms up, captures and replays
        one = profile_operate.event_ms(call)
        k[how] = max(1, int(windows * run.window_s / CHUNKS * 1e3 / max(one, 1e-3)))
    ms = {how: [] for how in calls}
    for i in range(CHUNKS):
        for how in (list(calls) if i % 2 == 0 else list(calls)[::-1]):
            ms[how].append(profile_operate.event_ms(calls[how], k[how]))
    return {how: {"calls_per_chunk": k[how], "chunk_ms": ms[how],
                  **chunk_rates(k[how], ms[how], batch)} for how in calls}


def _copy_cost(args, out) -> dict:
    """What a staged call copies beyond its stage (``utils/staging.py``):
    every input into the graph's buffer, every output cloned.  Bytes, and
    milliseconds of the same copies on tensors of the same shapes (the
    mean of 20)."""
    _, ins = staging.signature(args)
    _, outs = staging.signature((out,))
    bufs = [torch.empty_like(t) for t in ins]

    def copies():
        for dst, src in zip(bufs, ins):
            dst.copy_(src)
        for t in outs:
            t.clone()

    copies()
    reps = 20
    return {"copied_bytes": sum(t.nbytes for t in ins + outs),
            "copy_ms": profile_operate.event_ms(copies, reps) / reps}


def _staged_step(run: Run, name: str, fn, args, batch: int, windows: int = 1):
    """A step of the suite's own: ``fn`` staged (one CUDA graph, the
    counterpart of ``bench.py``'s ``jax.jit``) and eager, each result equal
    to the other integer for integer, both timed (:func:`_throughput`).
    Returns the staged output (its batch row 0 is gated by the caller),
    the metric (staged median results per second) and the step's detail."""
    staged = staging.StagedCall(fn, f"bench.{name}", threading.Lock())
    try:
        t = time.perf_counter()
        out = staged(*args)
        run.sync()
        first_s = time.perf_counter() - t
        last = {}

        def staged_call():
            last["out"] = staged(*args)

        timed = _throughput(run, {"staged": staged_call, "eager": lambda: fn(*args)},
                            batch, windows)
        _equal_to_eager(name, last["out"], fn(*args))
        _equal_to_eager(name, out, last["out"])
        rate = timed["staged"]["rate"]
        cost = _copy_cost(args, out)
        detail = {
            "batch": batch, "first_call_s": first_s,
            "warmup_s": staged.warmup_s, "capture_s": staged.capture_s,
            "staged": timed["staged"], "eager": timed["eager"],
            "staged_over_eager_rate": rate / timed["eager"]["rate"],
            "equal_to_eager": True, "tolerance": 0,
            **cost, "copy_share": cost["copy_ms"] * rate / batch / 1e3,
        }
        return out, rate, detail
    finally:
        staged.release()


# -- the suite's own steps ----------------------------------------------------- #

class _State:
    """Context, keys and operands shared by the headline and the three
    key-switch metrics: one keygen (relin + the 7 rotation keys 5^1..5^7)."""

    def __init__(self, run: Run, n: int = N, sec_level: int = 128,
                 batch: int = BATCH, batch_ks: int = BATCH_KS):
        ctx = make_ckks_context(poly_modulus_degree=n, mult_depth=2,
                                sec_level=sec_level, device=run.device)
        self.ctx = ctx
        self.keys = keys_mod.keygen(
            ctx, seed=SEED,
            galois_elts=tuple(pow(5, s, 2 * ctx.n) for s in range(1, 8)),
            need_relin=True,
        )
        enc = ckks.CkksEncoder(ctx)
        encryptor = ckks.CkksEncryptor(ctx, self.keys, seed=SEED)
        self.decryptor = ckks.CkksDecryptor(ctx, self.keys)
        self.ev = Evaluator(ctx, self.keys)
        rng = np.random.default_rng(SEED)
        self.va = rng.uniform(-1, 1, ctx.slots)
        self.vb = rng.uniform(-1, 1, ctx.slots)
        self.ca = encryptor.encrypt_pt(enc.encode(self.va))
        self.cb = encryptor.encrypt_pt(enc.encode(self.vb))
        self.batch, self.batch_ks = batch, batch_ks
        self.a64, self.b64 = _broadcast(self.ca, batch), _broadcast(self.cb, batch)
        self.a8, self.b8 = _broadcast(self.ca, batch_ks), _broadcast(self.cb, batch_ks)

    def decrypt0(self, out):
        return np.real(self.decryptor.decrypt(replace(out, data=out.data[0])))


def headline(run: Run, **sizes) -> _State:
    """Bare ciphertext-ciphertext multiply throughput; returns the shared
    state the key-switch metrics reuse.  ``sizes`` go to :class:`_State`."""
    t = time.perf_counter()
    st = _State(run, **sizes)
    run.sync()
    setup_s = time.perf_counter() - t
    out, rate, detail = _staged_step(
        run, "ctct_mult", functools.partial(ctct_mult, st.ev), (st.a64, st.b64),
        st.batch, HEADLINE_WINDOWS)
    detail["max_abs_err"] = _gate("ctct_mult", st.decrypt0(out), st.va * st.vb, EPS)
    detail["setup_s"] = setup_s
    run.record["steps"][HEADLINE] = detail
    run.record["value"] = rate
    run.record["vs_baseline"] = rate / SEAL_SINGLE_CORE_MULTS_PER_SEC
    return st


def _ks_step(run: Run, st: _State, key: str, name: str, fn, args, want, tol):
    out, rate, detail = _staged_step(run, name, functools.partial(fn, st.ev), args,
                                     st.batch_ks)
    detail["max_abs_err"] = _gate(name, st.decrypt0(out), want, tol)
    run.record["steps"][key] = detail
    run.extras[key] = rate


def ks_mult_relin_rescale(run: Run, st: _State):
    """multiply + relinearize + rescale (the workloads' multiply path)."""
    _ks_step(run, st, "ckks_mult_relin_rescale_per_sec_n16384", "mult_relin_rescale",
             mult_relin_rescale, (st.a8, st.b8), st.va * st.vb, KS_TOL)


def ks_rotate(run: Run, st: _State):
    """rotate by 1 (Galois key switch)."""
    _ks_step(run, st, "ckks_rotate_per_sec_n16384", "rotate", rotate_1, (st.a8,),
             np.roll(st.va, -1), KS_TOL)


def ks_rotate_sum(run: Run, st: _State):
    """hoisted 8-rotation sum (MatMultRow / small-count accumulate path)."""
    want = sum(np.roll(st.va, -s) for s in ROTATE_SUM_STEPS)
    _ks_step(run, st, "ckks_rotate_sum8_per_sec_n16384", "rotate_sum8", rotate_sum8,
             (st.a8,), want, KS_TOL * len(ROTATE_SUM_STEPS))


def bfv_suite(run: Run):
    """The BFV BEHZ multiply.  Its first call may hold the process's first
    BFV multiply (seconds, cold): in ``steps``, not in the metric."""
    key = "bfv_behz_mult_per_sec_n8192"
    t = time.perf_counter()
    ctx = make_bfv_context(poly_modulus_degree=8192, device=run.device)
    ks = keys_mod.keygen(ctx, seed=SEED, need_relin=False)
    enc = bfv.BfvBatchEncoder(ctx)
    encryptor = bfv.BfvEncryptor(ctx, ks, seed=SEED)
    decryptor = bfv.BfvDecryptor(ctx, ks)
    ev = Evaluator(ctx, ks)
    rng = np.random.default_rng(SEED)
    ia = rng.integers(-50, 50, ctx.slots)
    ib = rng.integers(-50, 50, ctx.slots)
    a = _broadcast(encryptor.encrypt_pt(enc.encode(ia)), BATCH_KS)
    b = _broadcast(encryptor.encrypt_pt(enc.encode(ib)), BATCH_KS)
    run.sync()
    setup_s = time.perf_counter() - t
    out, rate, detail = _staged_step(run, "bfv_behz_mult",
                                     functools.partial(ctct_mult, ev), (a, b),
                                     BATCH_KS)
    got = decryptor.decrypt(replace(out, data=out.data[0]))
    detail["max_abs_err"] = _gate("bfv_behz_mult", got, ia * ib, 0)
    detail["setup_s"] = setup_s
    run.record["steps"][key] = detail
    run.extras[key] = rate


# -- steps through the engine's benchmarks ------------------------------------ #

def _engine_bench(run: Run, workload_name: str, category_name: str,
                  scheme_name: str, params: dict):
    engine = Engine(run.device)
    desc = next(
        d for d in engine.descriptors
        if d.workload is Workload[workload_name]
        and d.category is Category[category_name]
        and d.scheme is Scheme[scheme_name]
    )
    return engine.create_benchmark(desc, params)


def _record_describe(run: Run, bench, key: str) -> None:
    """Chain-shape evidence for the record (the N = 32768 run's digit
    groups of 3 and its three special primes among it)."""
    d = bench.describe()
    run.record["describe"][key] = {k: d[k] for k in DESCRIBE_KEYS}


def _engine_step(run: Run, key: str, workload: str, category: str,
                 params: dict, make_inputs, reps: int) -> float:
    """One step through an engine benchmark: set-up, a first ``operate``
    (its stages warmed up, captured and replayed), the gate
    (``make_inputs(bench)`` gives the inputs and the check of the decoded
    outputs), then ``operate`` replayed and eager, ``reps`` each in turns
    (``utils/profile_operate.py:replayed_and_eager``, untraced), the first
    result equal to the eager one.  Returns the replayed median
    milliseconds; the detail lands in ``steps[key]``."""
    on_card = run.device.type == "cuda"
    if on_card:
        run.sync()
        torch.cuda.reset_peak_memory_stats(run.device)
    t = time.perf_counter()
    bench = _engine_bench(run, workload, category, "CKKS", params)
    try:
        inputs, check = make_inputs(bench)
        h = bench.block(bench.load(bench.encrypt(bench.encode(inputs))))
        setup_s = time.perf_counter() - t
        t = time.perf_counter()
        result = bench.block(bench.operate(h))
        first_s = time.perf_counter() - t
        err = check(bench.decode(bench.decrypt(bench.store(result))))
        eager, timed = profile_operate.replayed_and_eager(bench, h, rounds=reps,
                                                          traced=())
        _equal_to_eager(key, result, eager)
        detail = {
            "setup_s": setup_s, "first_call_s": first_s, "max_abs_err": err,
            "staged": timed["replayed"], "eager": timed["eager"],
            "staged_over_eager": timed["replayed_over_eager"],
            "equal_to_eager": True, "tolerance": 0,
            "peak_device_bytes":
                torch.cuda.max_memory_allocated(run.device) if on_card else None,
            **bench.run_notes(h),
        }
        if run.after_step is not None:
            detail["inspected"] = run.after_step(key, bench, h, result)
        run.record["steps"][key] = detail
        if workload == "LOGREG_POLY_D3":
            _record_describe(run, bench, key)
        return timed["replayed"]["operate_ms"]
    finally:
        bench.release_graphs()


def dot_latency(run: Run):
    """CKKS dot product n = 100 at the descriptor default N = 8192 (the
    baby-step/giant-step accumulate)."""
    key = "ckks_dot_n100_latency_ms_n8192"

    def make(bench):
        n = bench.params["n"]
        rng = np.random.default_rng(SEED)
        va = rng.uniform(-1, 1, (1, n))
        vb = rng.uniform(-1, 1, (1, n))
        return [va, vb], lambda outs: _gate(
            "ckks_dot_n100", outs[0][0], va[0] @ vb[0], KS_TOL)

    run.extras[key] = _engine_step(run, key, "DOT_PRODUCT", "LATENCY", {},
                                   make, DOT_REPS)


def eltwise_mult_offline(run: Run):
    """CKKS element-wise multiply Offline results per second at the
    registered default (N = 8192, n = 1000) over an ``ELTWISE_SAMPLES`` x
    ``ELTWISE_SAMPLES`` cross product; one result = one multiply."""
    key = "ckks_eltwise_mult_offline_samples_per_sec_n8192"
    b0 = b1 = ELTWISE_SAMPLES

    def make(bench):
        n = bench.params["n"]
        rng = np.random.default_rng(SEED)
        va = rng.uniform(-1, 1, (b0, n))
        vb = rng.uniform(-1, 1, (b1, n))
        want = (va[:, None, :] * vb[None, :, :]).reshape(b0 * b1, n)
        return [va, vb], lambda outs: _gate(
            "eltwise_mult_offline", np.stack(outs), want, EPS)

    ms = _engine_step(run, key, "ELTWISE_MULT", "OFFLINE", {}, make, OFFLINE_REPS)
    run.extras[key] = b0 * b1 / (ms / 1e3)


def _logreg_inputs(key: str, batch: int):
    def make(bench):
        n = bench.params["n"]
        rng = np.random.default_rng(SEED)
        w = rng.uniform(-1, 1, n)
        b = float(rng.uniform(-1, 1))
        x = rng.uniform(-1, 1, (batch, n))
        z = x @ w + b
        want = SIGMOID_D3[0] + SIGMOID_D3[1] * z + SIGMOID_D3[3] * z ** 3
        return [w, b, x], lambda outs: _gate(key, outs[0], want, KS_TOL)

    return make


def logreg_latency(run: Run, poly: int, key: str):
    """Logistic-regression Latency at ``poly``; at N = 32768 the chain
    takes digit groups of 3 over three special primes."""
    run.extras[key] = _engine_step(run, key, "LOGREG_POLY_D3", "LATENCY",
                                   {"poly_modulus_degree": poly},
                                   _logreg_inputs(key, 1), OFFLINE_REPS)


def logreg_offline(run: Run, poly: int, key: str):
    """Logistic-regression Offline samples per second, a batch of 100 (the
    reference's default behind the flexible registration); the dots stage
    runs in chunks (``models/logreg.py``)."""
    p = {"poly_modulus_degree": poly, "batch_size": LOGREG_BATCH}
    ms = _engine_step(run, key, "LOGREG_POLY_D3", "OFFLINE", p,
                      _logreg_inputs(key, LOGREG_BATCH), OFFLINE_REPS)
    run.extras[key] = LOGREG_BATCH / (ms / 1e3)


def steps(run: Run, st: _State):
    """(name, step) in ``bench.py``'s order, after the headline."""
    return [
        ("ckks_rotate_sum8", lambda: ks_rotate_sum(run, st)),
        ("ckks_rotate", lambda: ks_rotate(run, st)),
        ("ckks_mult_relin_rescale", lambda: ks_mult_relin_rescale(run, st)),
        ("ckks_eltwise_mult_offline", lambda: eltwise_mult_offline(run)),
        ("bfv_behz_mult", lambda: bfv_suite(run)),
        ("ckks_dot_n100", lambda: dot_latency(run)),
        ("ckks_logreg_n16384", lambda: logreg_latency(
            run, 16384, "ckks_logreg_n16384_latency_ms")),
        ("ckks_logreg_n32768", lambda: logreg_latency(
            run, 32768, "ckks_logreg_n32768_latency_ms")),
        ("ckks_logreg_offline_b100", lambda: logreg_offline(
            run, 16384, "ckks_logreg_offline_b100_samples_per_sec_n16384")),
        ("ckks_logreg_offline_b100_n32768", lambda: logreg_offline(
            run, 32768, "ckks_logreg_offline_b100_samples_per_sec_n32768")),
    ]


def run_suite(run: Run) -> int:
    """The headline, then every step; the record emitted after each.
    Returns the exit code: 1 where a step was skipped (it raised).  A gate
    that fails raises ``SystemExit``."""
    t = time.monotonic()
    st = headline(run)
    run.record["timings"]["headline"] = time.monotonic() - t
    run.emit()
    for name, step in steps(run, st):
        t = time.monotonic()
        try:
            step()
        except SystemExit:
            raise
        except Exception as e:  # noqa: BLE001 — recorded, and the exit code says so
            run.record["skipped"].append(f"{name}: {type(e).__name__}: {e}")
        run.record["timings"][name] = time.monotonic() - t
        run.emit()
    return 1 if run.record["skipped"] else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the suite runs; cuda without a card raises")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="write the record to PATH where it is at least as "
                    "complete as the one there, and to PATH with .latest "
                    "before its suffix always")
    args = ap.parse_args(argv)
    run = Run(args.device, record_path=args.record)
    return run_suite(run)


if __name__ == "__main__":
    raise SystemExit(main())
