"""Where one ``operate`` of the PyTorch/CUDA port spends its time on the card,
replayed from its stages' CUDA graphs and run eagerly.

    python3 -m reference_seal_backend_tpu_torch.utils.profile_operate [benchmark ...]

For each named benchmark (default: the CKKS dot product, Latency and Offline
8 x 8; Offline logistic regression runs at its default batch of 100) at its
registered parameters it builds the benchmark through the port's ``Engine``
on the GPU and reports, as one JSON line, ``operate`` as the pipeline runs it
(each stage a replayed CUDA graph, ``utils/staging.py``) and with its stages
run eagerly (``staging.eager``), on the same loaded operands:

* ``first_call_s``: the first ``operate``, whose stages warm up, are
  captured and replay once;
* ``operate_ms``: host clock around ``operate`` ending in a synchronise,
  median of ``ROUNDS`` calls, the two ways taken in turns;
* ``event_ms``: CUDA events around one ``operate``, its span on the device
  (the host clock on a machine without a card);
* ``device_busy_ms`` / ``idle_share``: sum of CUDA kernel time in one
  profiled ``operate`` (``torch.profiler``) against its wall time;
* ``kernel_launches`` and the ten kernels with the most device time;
* ``ntt_ms`` / ``ntt_launches``: the hand-written NTT kernels' share, the
  kernels counted in the trace by name (``ntt_fwd_*``, ``ntt_inv_*``): the
  only count of a replay's NTT kernels, since a replay moves no launch
  counter.  The tracer can drop the first records of a trace (on the
  H100, an NTT among them), so each trace is padded at
  both ends by ``PADS`` kernels of ``PAD``, left out of the counts, and is
  whole where a pad record survives at each end; each way is traced until
  a trace is whole, ``TRACES`` times at most, and reported from that trace
  (``*_each`` lists every trace's counts and surviving pads);
* ``ntt_launches_per_operate``: the launch counters' moves per ``operate``
  (``ops/cuda/ntt.py``; 0 for a replay);
* ``spans``: host milliseconds and count of each counted step's span
  (``utils/counters.py``) in the trace: the steps of an eager call, none
  in a replay's.

Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from reference_seal_backend_tpu_torch.engine import runner
from reference_seal_backend_tpu_torch.engine.descriptor import Category, Workload
from reference_seal_backend_tpu_torch.engine.registry import Engine
from reference_seal_backend_tpu_torch.models.logreg import DEFAULT_BATCH
from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
from reference_seal_backend_tpu_torch.utils import counters, staging
from reference_seal_backend_tpu_torch.utils.device import card_name_and_power_limit

DEFAULT = ("ckks_dot_product_latency", "ckks_dot_product_offline")
SAMPLES = 8
ROUNDS = 5
TRACES = 5
PAD = "spin_kernel"  # the kernel of torch.cuda._sleep
PADS = 64


def build(engine: Engine, name: str, seed: int = 1234):
    """The benchmark ``name`` at registered parameters, its operands loaded:
    Offline at ``SAMPLES`` x ``SAMPLES`` pairs (logistic regression: a batch
    of ``DEFAULT_BATCH``).  Returns ``(bench, loaded, truth, samples)``."""
    desc = engine.find(name)
    b = SAMPLES if desc.category is Category.OFFLINE else 1
    samples, params = [b, b], None
    if desc.workload is Workload.LOGREG_POLY_D3:  # operands (W, b, X)
        b = DEFAULT_BATCH if desc.category is Category.OFFLINE else 1
        samples, params = [1, 1, b], {"batch_size": b}
    bench = engine.create_benchmark(desc, params)
    inputs, truth = runner.gen_inputs(
        desc, bench.params, np.random.default_rng(seed), b, b)
    loaded = bench.block(bench.load(bench.encrypt(bench.encode(inputs))))
    return bench, loaded, truth, samples


def _pad() -> None:
    """``PADS`` kernels of ``PAD``, finished, then a pause: they pad a
    trace at either end, where the tracer drops records."""
    for _ in range(PADS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.002)


def _trace(run) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _pad()
        t0 = time.perf_counter()
        run()
        profiled_ms = (time.perf_counter() - t0) * 1e3
        _pad()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    spans = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA and \
                e.name.startswith(counters.SPAN_PREFIX):
            ms, count = spans.get(e.name, (0.0, 0))
            spans[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    is_pad = [PAD in e.name for e in evs]
    lead = is_pad.index(False) if False in is_pad else len(evs)
    tail = is_pad[::-1].index(False) if False in is_pad else len(evs)
    by_name = {}
    for e, pad in zip(evs, is_pad):
        if not pad:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    kernels = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    ntt = [k for k in kernels if "ntt_fwd_" in k[0] or "ntt_inv_" in k[0]]
    return {
        # a record of the leading and of the trailing pad survived: nothing
        # of the run was dropped at either end
        "whole": lead > 0 and tail > 0,
        "pads_seen": [lead, tail],
        "profiled_operate_ms": profiled_ms,
        "device_busy_ms": busy,
        "idle_share": None if not kernels else 1.0 - busy / profiled_ms,
        "kernel_launches": sum(k[2] for k in kernels),
        "ntt_ms": sum(k[1] for k in ntt),
        "ntt_launches": sum(k[2] for k in ntt),
        "top_kernels": [
            {"name": k[0][:80], "ms": k[1], "count": k[2]} for k in kernels[:10]
        ],
        "spans": {k: {"host_ms": ms, "count": n} for k, (ms, n) in spans.items()},
    }


def profile_run(run, traces: int = TRACES) -> dict:
    """The first whole trace of ``run``, of at most ``traces`` (module
    docstring); ``ntt_launches`` None where none was whole."""
    each = []
    while len(each) < traces and not (each and each[-1]["whole"]):
        each.append(_trace(run))
    whole = [t for t in each if t["whole"]]
    row = dict(whole[0] if whole else each[0])
    row["ntt_launches"] = whole[0]["ntt_launches"] if whole else None
    for key in ("kernel_launches", "ntt_launches", "pads_seen"):
        row[key + "_each"] = [t[key] for t in each]
    return row


def event_ms(run, calls: int = 1) -> float:
    """Milliseconds of ``calls`` calls of ``run``: CUDA events where a card
    is present, the host clock on a machine without one (every call is
    synchronous there)."""
    if not torch.cuda.is_available():
        t = time.perf_counter()
        for _ in range(calls):
            run()
        return (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def replayed_and_eager(bench, loaded, rounds: int = ROUNDS,
                       traced=("replayed", "eager")):
    """``operate`` on ``loaded`` as the pipeline runs it (replayed: its
    stages must have been captured by an earlier call) and with its stages
    eager, measured as the module docstring says; only the ways named in
    ``traced`` are traced.  An sp benchmark (``sp_shard`` on a mesh of one
    device) is measured the same way: ``bench.block`` synchronises every
    device of its mesh, and since the sp path launches no K1 / K2 its
    traces count every kernel and an NTT count of 0.  Returns an eager
    result handle and the row."""

    def replayed():
        return bench.block(bench.operate(loaded))

    def eager():
        with staging.eager(bench):
            return bench.block(bench.operate(loaded))

    eager_out = eager()
    runs = {"replayed": replayed, "eager": eager}
    ms = {how: [] for how in runs}
    launched = {how: set() for how in runs}
    for i in range(rounds):
        for how in (("replayed", "eager") if i % 2 == 0 else ("eager", "replayed")):
            before = sum(ntt_cuda.launches.values())
            t = time.perf_counter()
            runs[how]()
            ms[how].append((time.perf_counter() - t) * 1e3)
            launched[how].add(sum(ntt_cuda.launches.values()) - before)
    row = {"rounds": rounds}
    for how, run in runs.items():
        row[how] = {
            "operate_ms": statistics.median(ms[how]),
            "operate_ms_each": ms[how],
            "ntt_launches_per_operate": sorted(launched[how]),
            "event_ms": event_ms(run),
            **(profile_run(run) if how in traced else {}),
        }
    row["replayed_over_eager"] = (
        row["replayed"]["operate_ms"] / row["eager"]["operate_ms"])
    return eager_out, row


def profile_one(engine: Engine, name: str) -> dict:
    bench, loaded, _, samples = build(engine, name)
    try:
        t0 = time.perf_counter()
        bench.block(bench.operate(loaded))
        first_call_s = time.perf_counter() - t0
        _, row = replayed_and_eager(bench, loaded)
        return {"benchmark": name, "samples": samples, "first_call_s": first_call_s,
                **bench.run_notes(loaded), **row}
    finally:
        bench.release_graphs()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = argv or DEFAULT
    engine = Engine("cuda")
    print(json.dumps({"card": card_name_and_power_limit(),
                      "torch": torch.__version__}))
    for name in names:
        print(json.dumps(profile_one(engine, name)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
