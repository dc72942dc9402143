"""Run one cell of ``BENCHMARK.json`` once, and print its result line.

    python3 -m perf_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.

Set-up, timed from process start to the first timed call (``setup_s``):
imports, CUDA initialisation, the engine's benchmark with its context and
keys (``create_benchmark``; keys from ``--seed``), encode -> encrypt -> load
of every input set of the traffic mix (drawn from ``--seed``), and the
first ``operate`` (each stage warmed up eagerly and captured as a CUDA
graph), then one more call.

The window.  One caller, a closed loop: ``operate`` then the
synchronise, back to back, cycling over the input sets, until ``--seconds``
have passed; the window ends with the last call's synchronise.  A sample
of the calls, drawn from the seed, keeps its result.  ``--trace 0`` prints the
cell's end-to-end metrics.

``--trace 1`` goes on after the window: the traffic mix's ``trace_calls``
calls in one padded ``torch.profiler`` trace (``trace.py``), all kept; then
one more call with the stages eager, which notes the transforms a call asks
of ``NttPlan``; where those, times the traced calls, are not the NTT
kernels in the trace, the run fails (``trace.ntt_disagreement``).  It
prints the cell's per-layer metrics, the device's busy and traced seconds,
and the trace's breakdown.

Then, with the window closed and the peak of device memory read: the kept
results through store -> decrypt -> decode, the program freed, the plain
reference, and the comparison (``judge.py``), whose numbers are printed
beside their limits as the last lines of standard error and under
``checks``, the last key of the result line.

Exits non-zero and prints no result line where there is no CUDA card or
fewer than the cell asks for, where the program is missing, where a traced
run's NTT kernels are not the transforms noted, or where a module of JAX or
of the JAX package is loaded once the window has closed.
``--device cpu`` runs the same steps on the CPU, for the tests; its
numbers are not device numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from perf_bench import cell as cell_mod
from perf_bench import judge, trace, traffic

#: top-level module names that no process of the benchmark may hold: JAX and
#: the JAX package (the port's own name begins with the latter's, so names
#: are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "reference_seal_backend_tpu")

_IMPORTED_AT = time.monotonic()


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``); where that
    cannot be read, since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _IMPORTED_AT


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_and_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Refused(Exception):
    """The run cannot give a result: it prints none and exits 2."""


def closed_loop(system, loaded, seconds, keep, rng):
    """The window (module docstring).  Returns the window's seconds, its
    calls, and the kept ``(call, input set, result)``."""
    kept = []
    n = 0
    t0 = time.perf_counter()
    while True:
        k = n % len(loaded)
        out = system.block(system.operate(loaded[k]))
        # a uniform sample of ``keep`` calls (reservoir sampling)
        if n < keep:
            kept.append((n, k, out))
        else:
            j = int(rng.integers(0, n + 1))
            if j < keep:
                kept[j] = (n, k, out)
        del out
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return elapsed, n, kept


def run(args) -> dict:
    spans = {"interpreter_s": process_age_s()}
    root = Path(args.root).resolve()
    cell = cell_mod.load(root, args.workload)
    config, mix = cell.config, cell.traffic
    t0 = time.perf_counter()
    import torch

    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False: no CUDA card")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{torch.cuda.device_count()} CUDA cards, the cell asks for {cell.chips}")
        torch.zeros(1, device="cuda")  # the CUDA context
    elif args.trace:
        raise Refused("--trace 1 reads a device trace: it needs --device cuda")
    spans["torch_cuda_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        from perf_bench import system as system_mod
    except ImportError as e:
        raise Refused(f"the program is missing: {e}") from e
    spans["program_import_s"] = time.perf_counter() - t0

    counts = traffic.data_counts(mix["category"], config["data_count"], mix.get("sample_size", 1))
    results_per_call = math.prod(counts)
    system = system_mod.System(args.device, config, mix["category"], counts, args.seed)
    sets = traffic.input_sets(config, mix, args.seed)
    t0 = time.perf_counter()
    loaded = [system.load(s) for s in sets]
    inputs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    system.block(system.operate(loaded[0]))
    first_operate_s = time.perf_counter() - t0
    system.block(system.operate(loaded[1 % len(loaded)]))

    spans.update(context_keys_s=system.context_keys_s, inputs_s=inputs_s,
                 first_operate_s=first_operate_s)
    record = {"results_per_call": results_per_call, "spans": spans,
              "setup_s": process_age_s()}
    rng = np.random.default_rng([args.seed, 1])
    window_s, attempted, kept = closed_loop(
        system, loaded, args.seconds, int(mix["checked_calls"]), rng)
    record["window"] = {"seconds": window_s, "calls": attempted}
    if args.trace:
        calls = int(mix["trace_calls"])

        def traced_calls():
            return [(i, i % len(loaded), system.block(system.operate(loaded[i % len(loaded)])))
                    for i in range(calls)]

        summary, traced_kept = trace.traced(traced_calls)
        kept += [(attempted + i, k, out) for i, k, out in traced_kept]
        attempted += calls
        record["trace"] = dict(summary, calls=calls)
        with system.transforms() as noted, system.eager():
            system.block(system.operate(loaded[0]))
        record["transforms"] = list(noted)
        disagreement = trace.ntt_disagreement(record["trace"], noted)
        if disagreement:
            raise Refused(f"ntt_roofline cannot be read: {disagreement}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"perf_bench: spans {json.dumps(record['spans'])} setup_s {record['setup_s']!r} "
          f"window {window_s!r} s, {attempted} calls", file=sys.stderr)

    # the window is closed: the kept results through the program's own
    # store -> decrypt -> decode, then the program freed, then the reference
    kept.sort(key=lambda c: c[0])
    got = [system.answers(out) for _, _, out in kept]
    kept_sets = [k for _, k, _ in kept]
    del kept, loaded
    system.release()
    if on_card:
        torch.cuda.empty_cache()
    reference = cell.reference()
    want_by_set = {k: judge.expected(reference.answers(sets[k], config["scheme"]), config["scheme"])
                   for k in sorted(set(kept_sets))}
    verdict = judge.compare(got, [want_by_set[k] for k in kept_sets], cell.limits)

    kinds = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in kinds:
        value = cell.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name() if on_card else "cpu",
              "count": cell.chips if on_card else 0,
              "memory_peak_bytes": peak}
    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": verdict["failed"], "metrics": metrics, "device": device}
    if args.trace:
        summary = record["trace"]
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        result["trace_whole"] = summary["whole"]
    result["card"] = card_and_power_limit() if on_card else "cpu"
    result["checks"] = verdict["checks"]
    return result


def parse(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the tests' run on the CPU, never a device number")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the directory that holds BENCHMARK.json")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    try:
        result = run(args)
    except Refused as e:
        print(f"perf_bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"perf_bench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
