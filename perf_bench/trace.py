"""Padded traces of the window's calls, and the arithmetic on them.

A frozen copy of ``reference_seal_backend_tpu_torch/utils/profile_operate.py``
``_trace`` / ``profile_run``: the tracer can drop the first records of a
trace (on the H100, an NTT among them), so each trace is padded at both
ends by ``PADS`` kernels of ``PAD``, left out of every count, and is whole
where a pad record survives at each end; a run is traced until a trace is
whole, ``TRACES`` times at most.

Added here: the device's busy time as the union of its operations'
intervals, the largest operations by name, and the idle gaps between
operations, each named by the innermost host event under its middle (what
the host was doing while the card waited).

:func:`summarize` works on plain ``(name, start_us, duration_us)`` records,
so the CPU tests reach it; :func:`traced` takes them from ``torch.profiler``.
"""

from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, Sequence, Tuple

PAD = "spin_kernel"  # the kernel of torch.cuda._sleep
PADS = 64
TRACES = 5
NTT_NAMES = ("ntt_fwd_", "ntt_inv_")
TOP = 10

Record = Tuple[str, float, float]  # name, start (us), duration (us)


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _name_gaps(gaps, host: Sequence[Record]) -> Dict[str, float]:
    """Seconds of ``gaps`` ((start, end) us) by the innermost host event
    that covers each gap's middle (``"(no host event)"`` where none does)."""
    events = sorted((s, s + d, d, name) for name, s, d in host)
    by_name: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []  # heap of (end, duration, name)
    i = 0
    for start, end in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (start + end) / 2
        while i < len(events) and events[i][0] <= mid:
            heapq.heappush(active, (events[i][1], events[i][2], events[i][3]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = min(active, key=lambda a: a[1])[2] if active else "(no host event)"
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    return by_name


def summarize(device: Sequence[Record], host: Sequence[Record], window_s: float) -> dict:
    """The trace's numbers.  ``device``: every device operation (kernels,
    copies, sets) in start order, pads included; ``host``: host events;
    ``window_s``: the host clock around the traced calls."""
    device = sorted(device, key=lambda r: r[1])
    is_pad = [PAD in r[0] for r in device]
    lead = is_pad.index(False) if False in is_pad else len(device)
    tail = is_pad[::-1].index(False) if False in is_pad else len(device)
    ops = [r for r, pad in zip(device, is_pad) if not pad]
    by_name: Dict[str, List[float]] = {}
    for name, _, dur in ops:
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += dur / 1e6
        entry[1] += 1
    spans = _union([(s, s + d) for _, s, d in ops])
    gaps = [(a[1], b[0]) for a, b in zip(spans, spans[1:])]
    gap_names = _name_gaps(gaps, host)
    return {
        # a record of the leading and of the trailing pad survived: nothing
        # of the calls was dropped at either end
        "whole": lead > 0 and tail > 0,
        "pads_seen": [lead, tail],
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in spans) / 1e6,
        "op_s": sum(v[0] for v in by_name.values()),
        "ops": len(ops),
        "ntt_s": sum(v[0] for k, v in by_name.items() if any(n in k for n in NTT_NAMES)),
        "ntt_ops": {n[:-1]: sum(v[1] for k, v in by_name.items() if n in k) for n in NTT_NAMES},
        "device_ops": sorted(([k, v[0]] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in gap_names.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


def _pad(torch) -> None:
    """``PADS`` kernels of ``PAD``, finished, then a pause: they pad a trace
    at either end, where the tracer drops records."""
    for _ in range(PADS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.002)


def _trace_once(run: Callable[[], object]) -> Tuple[dict, object]:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _pad(torch)
        t0 = time.perf_counter()
        out = run()
        window_s = time.perf_counter() - t0
        _pad(torch)
    device, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.elapsed_us())
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(rec)
        else:
            host.append(rec)
    return summarize(device, host, window_s), out


def traced(run: Callable[[], object], traces: int = TRACES) -> Tuple[dict, object]:
    """The first whole trace of ``run``, of at most ``traces``, and what
    that run returned; ``whole`` False where none was."""
    tries = []
    while len(tries) < traces:
        summary, out = _trace_once(run)
        tries.append(summary["pads_seen"])
        if summary["whole"]:
            break
    summary["pads_seen_each"] = tries
    return summary, out


def ntt_disagreement(summary: dict, noted: Sequence[Tuple[str, int, int, int]]):
    """Where the transforms one call asks of ``NttPlan`` (``noted``), times
    the traced calls, are not the NTT kernels the trace counts, kind by
    kind, a line that says so; None where they agree.  Then the NTT
    roofline would count work that the traced kernels do not carry (a
    transform done elsewhere, a kernel renamed): the traced run fails.  A
    call that asks for no transform disagrees too.  A trace that is not
    whole lost records to the tracer, not to the program: it is not held
    to the count."""
    calls = summary["calls"]
    want = {n[:-1]: calls * sum(1 for t in noted if t[0] == n[:-1]) for n in NTT_NAMES}
    if noted and (want == summary["ntt_ops"] or not summary["whole"]):
        return None
    return (f"the transforms noted in NttPlan ({want}, {calls} calls) are not the NTT "
            f"kernels traced ({summary['ntt_ops']}, names {list(NTT_NAMES)})")


def idle_share(record):
    """Metric reader: the share of the traced calls' wall time (host clock
    around them) in which no operation ran on the device (the union of the
    same calls' device operations), in %.  The profiler slows the host,
    each graph launch most, so a traced call waits longer on the host than
    an untraced one: read the share against the same cell's earlier
    readings, not against the untraced window."""
    t = record.get("trace")
    if not t or not t["ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
