"""Harness-style end-to-end runner of the port: the verification + timing
oracle.

Counterpart of ``reference_seal_backend_tpu/engine/runner.py``.  The HEBench
Test Harness contract, in-process: seeded random inputs, cleartext ground
truth, decrypted-output comparison, and a final ``[ Info    ] Failed: 0``
line that CI greps for.

* ``--random_seed`` drives input generation (default 1234 like CI);
* per-benchmark Latency timing (warmup + repeated operate) and Offline
  batch throughput, timed around the ``operate`` step only, ending in a
  device synchronisation;
* validation: BFV exact equality, CKKS absolute tolerance (the decode
  path already applies the 5e-5 clamp);
* ``report.csv`` / ``descriptions.csv`` / ``summary.csv`` outputs;
* the harness's YAML config tier: ``--config_file cfg.yaml --dump`` writes
  the default configuration of the 20 benchmarks, and a subsequent run
  with ``--config_file cfg.yaml`` executes it with per-benchmark
  parameter/sample-size overrides;
* ``--device {cuda,cpu}``: the card by default; ``cuda`` without a card
  raises, nothing falls back to the CPU by itself;
* ``--sp_shard k``: the slot-parallel path over a k-device mesh
  (``models/base.py``).

Usage:
    python -m reference_seal_backend_tpu_torch.engine.runner \
        --random_seed 1234 --benchmarks ckks_eltwise_add_latency ...
    python -m reference_seal_backend_tpu_torch.engine.runner \
        --device cpu --poly_modulus_degree 2048 --sec_level 0
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from reference_seal_backend_tpu_torch.engine.descriptor import (
    BenchmarkDescriptor,
    Category,
    Scheme,
    Workload,
)
from reference_seal_backend_tpu_torch.engine.registry import Engine
from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
from reference_seal_backend_tpu_torch.utils.device import DEFAULT_DEVICE


@dataclass
class RunResult:
    name: str
    passed: bool
    wall_ms_operate: float
    ops_per_sec: float
    iterations: int
    error: str = ""
    # report fragments from HEBenchmark.describe (models/base.py)
    description: Dict[str, str] = field(default_factory=dict)
    # What follows is not written to report.csv.
    # CUDA NTT kernel launches of one timed ``operate`` as the wrapper
    # counts them (0 on the CPU, where the plain version runs, and where
    # ``operate`` replays its stages' CUDA graphs: a replay launches nothing
    # from Python; utils/profile_operate.py counts its kernels in a trace):
    # the most over the timed iterations, and whether every iteration
    # launched as many; and the launches of the warm-up, where on the card
    # each stage runs eagerly once and its capture records the launches
    ntt_launches_per_operate: int = 0
    ntt_launches_steady: bool = True
    ntt_launches_warmup: int = 0
    # seconds from building the benchmark (context, keygen) to the loaded
    # operands, i.e. everything before the first ``operate``
    setup_s: float = 0.0
    # torch.cuda.max_memory_allocated() over set-up and every ``operate``:
    # all that the process held on the card at that moment, including
    # ``held_before_bytes``, what it already held when this benchmark began
    # (earlier benchmarks' cached plans and tables).  Both 0 on the CPU.
    peak_device_bytes: int = 0
    held_before_bytes: int = 0
    # the workload's own remarks on this run (HEBenchmark.run_notes); under
    # BFV also ``noise_budget_bits``: the invariant noise budget left in the
    # result ciphertext (the least over its batch)
    notes: Dict[str, int] = field(default_factory=dict)
    # what run_benchmark's ``after_timing`` returned
    inspected: Dict[str, Any] = field(default_factory=dict)


def gen_inputs(
    desc: BenchmarkDescriptor,
    params: Dict[str, int],
    rng: np.random.Generator,
    batch0: int,
    batch1: int,
):
    """Seeded random op parameters + a cleartext ground-truth function."""
    wl = desc.workload
    is_ckks = desc.scheme is Scheme.CKKS
    if wl in (Workload.ELTWISE_ADD, Workload.ELTWISE_MULT, Workload.DOT_PRODUCT):
        n = params["n"]
        if is_ckks:
            a = rng.uniform(-1, 1, (batch0, n))
            b = rng.uniform(-1, 1, (batch1, n))
        else:
            # keep dot products within the plain modulus
            hi = max(2, int((2 ** 19 / max(n, 1)) ** 0.5))
            a = rng.integers(-hi, hi, (batch0, n))
            b = rng.integers(-hi, hi, (batch1, n))
        if wl is Workload.ELTWISE_ADD:
            truth = lambda: [
                a[i] + b[j] for i in range(batch0) for j in range(batch1)
            ]
        elif wl is Workload.ELTWISE_MULT:
            truth = lambda: [
                a[i] * b[j] for i in range(batch0) for j in range(batch1)
            ]
        else:
            truth = lambda: [
                np.atleast_1d(a[i] @ b[j])
                for i in range(batch0)
                for j in range(batch1)
            ]
        return [a, b], truth
    if wl is Workload.MATRIX_MULTIPLY:
        r0, c0, c1 = params["rows_m0"], params["cols_m0"], params["cols_m1"]
        if is_ckks:
            m0 = rng.uniform(-1, 1, (r0, c0))
            m1 = rng.uniform(-1, 1, (c0, c1))
        else:
            hi = max(2, int((2 ** 19 / max(c0, 1)) ** 0.5))
            m0 = rng.integers(-hi, hi, (r0, c0))
            m1 = rng.integers(-hi, hi, (c0, c1))
        return [m0, m1], lambda: [m0 @ m1]
    if wl is Workload.LOGREG_POLY_D3:
        n = params["n"]
        batch = params.get("batch_size", 1) if desc.category is Category.OFFLINE else 1
        w = rng.uniform(-1, 1, n)
        b = float(rng.uniform(-1, 1))
        x = rng.uniform(-1, 1, (batch, n))
        sig = lambda z: 0.5 + 0.15012 * z - 0.0015930078125 * z ** 3
        return [w, b, x], lambda: [sig(x @ w + b)]
    raise KeyError(wl)


# Per-workload CKKS validation tolerances: the 5e-5 decode-clamp scale of
# the reference.  Comparisons are absolute-only (rtol=0): inputs are in
# [-1, 1], and a relative term would loosen the dot-product gate
# (|result| up to ~n).
CKKS_ATOL = {
    Workload.ELTWISE_ADD: 5e-5,
    Workload.ELTWISE_MULT: 5e-5,
    Workload.DOT_PRODUCT: 5e-5,
    Workload.MATRIX_MULTIPLY: 5e-5,
    Workload.LOGREG_POLY_D3: 5e-5,
}


def run_benchmark(
    engine: Engine,
    desc: BenchmarkDescriptor,
    seed: int,
    params: Optional[Dict[str, int]] = None,
    sample_size: int = 3,
    min_test_time_ms: Optional[float] = None,
    warmup_iterations: Optional[int] = None,
    atol: Optional[float] = None,
    after_timing: Optional[Callable[[Any, Any, Any], Dict[str, Any]]] = None,
) -> RunResult:
    """``min_test_time_ms`` / ``warmup_iterations`` = None defer to the
    descriptor's registered timing attributes (the reference's
    ``cat_params``); an explicit value (CLI / YAML config) overrides.
    ``atol`` = None takes the per-workload clamp-scale tolerance.
    ``after_timing(bench, loaded, result)``, where given, is called after
    the timed loop, while the benchmark and its graphs live, with the last
    timed result; what it returns is the result's ``inspected``."""
    name = desc.name
    if atol is None:
        atol = CKKS_ATOL[desc.workload]
    if min_test_time_ms is None:
        min_test_time_ms = float(desc.min_test_time_ms)
    if warmup_iterations is None:
        warmup_iterations = desc.warmup_iterations
    bench = None
    try:
        if desc.category is Category.OFFLINE:
            # Per-operand sample counts: the descriptor's registered
            # offline data_count, 0 = flexible -> sample_size (the
            # harness default_sample_size contract).
            dc = desc.default_data_count or (0, 0)
            b0 = dc[0] if dc[0] > 0 else sample_size
            b1 = (dc[-1] if dc[-1] > 0 else sample_size) if len(dc) > 1 else 1
        else:
            b0 = b1 = 1
        if (
            desc.workload is Workload.LOGREG_POLY_D3
            and desc.category is Category.OFFLINE
            and not (params or {}).get("batch_size")
        ):
            # The logreg batch is registered FLEXIBLE (0) and runs at the
            # sample size unless the caller pinned an explicit batch_size.
            params = dict(params or {}, batch_size=b1)
        on_card = engine.device.type == "cuda"
        held_before = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(engine.device)
            held_before = torch.cuda.memory_allocated(engine.device)
        t_setup = time.perf_counter()
        bench = engine.create_benchmark(desc, params)
        rng = np.random.default_rng(seed)
        inputs, truth_fn = gen_inputs(desc, bench.params, rng, b0, b1)
        h = bench.encode(inputs)
        h = bench.encrypt(h)
        loaded = bench.block(bench.load(h))
        setup_s = time.perf_counter() - t_setup

        # warmup (like the harness's warmup_iterations_count for Latency;
        # on the card the first pass also builds and loads the kernels and
        # captures the stages' graphs, so the timed loop only replays them)
        launched = sum(ntt_cuda.launches.values())
        for _ in range(max(warmup_iterations, 1)):
            result = bench.block(bench.operate(loaded))
        warmup_launches = sum(ntt_cuda.launches.values()) - launched

        iters = 0
        per_iter = set()
        t0 = time.perf_counter()
        while True:
            launched = sum(ntt_cuda.launches.values())
            result = bench.block(bench.operate(loaded))
            per_iter.add(sum(ntt_cuda.launches.values()) - launched)
            iters += 1
            elapsed = (time.perf_counter() - t0) * 1e3
            if elapsed >= min_test_time_ms and iters >= 1:
                break
        wall_ms = elapsed / iters
        peak = torch.cuda.max_memory_allocated(engine.device) if on_card else 0
        inspected = after_timing(bench, loaded, result) if after_timing else {}

        stored = bench.store(result)
        notes = bench.run_notes(loaded)
        if desc.scheme is Scheme.BFV:
            notes["noise_budget_bits"] = bench.decryptor.noise_budget_bits(
                stored.payload
            )
        outs = bench.decode(bench.decrypt(stored))
        want = truth_fn()
        passed = len(outs) == len(want)
        if passed:
            for got, exp in zip(outs, want):
                got = np.asarray(got).reshape(-1)
                exp = np.asarray(exp, dtype=np.float64).reshape(-1)
                if desc.scheme is Scheme.BFV:
                    ok = np.array_equal(got.astype(np.int64), exp.astype(np.int64))
                else:
                    ok = np.allclose(got, exp, atol=atol, rtol=0.0)
                if not ok:
                    passed = False
                    break
        n_results = len(want)
        ops = n_results / (wall_ms / 1e3) if wall_ms > 0 else 0.0
        return RunResult(
            name, passed, wall_ms, ops, iters, description=bench.describe(),
            ntt_launches_per_operate=max(per_iter),
            ntt_launches_steady=len(per_iter) == 1,
            ntt_launches_warmup=warmup_launches,
            setup_s=setup_s, peak_device_bytes=peak,
            held_before_bytes=held_before,
            notes=notes, inspected=inspected,
        )
    except Exception as e:  # noqa: BLE001 — harness reports, not raises
        return RunResult(name, False, 0.0, 0.0, 0, error=f"{type(e).__name__}: {e}")
    finally:
        if bench is not None:
            bench.release_graphs()  # the stages' graphs end with the benchmark


def run_all(
    benchmark_names: Optional[Sequence[str]] = None,
    seed: int = 1234,
    sample_size: int = 3,
    report_dir: Optional[str] = None,
    params: Optional[Dict[str, int]] = None,
    verbose: bool = True,
    min_test_time_ms: Optional[float] = None,
    per_benchmark: Optional[Dict[str, Dict]] = None,
    device=DEFAULT_DEVICE,
    after_timing=None,
) -> List[RunResult]:
    """Run benchmarks by name.  ``params`` applies to every benchmark;
    ``per_benchmark[name]`` may carry {"params": {...}, "sample_size": n,
    "min_test_time_ms": t, "warmup_iterations": w} overrides from a YAML
    config (config params under CLI params; None timing values defer to
    each descriptor's registered attributes).  ``device`` is the card
    unless the caller asks for ``"cpu"``; ``after_timing`` goes to every
    :func:`run_benchmark`."""
    engine = Engine(device)
    names = benchmark_names or engine.names()
    unknown = [n for n in names if n not in engine.names()]
    if unknown:
        raise SystemExit(
            f"unknown benchmark(s): {', '.join(unknown)}\n"
            f"available: {', '.join(engine.names())}"
        )
    results = []
    for name in names:
        desc = engine.find(name)
        entry = (per_benchmark or {}).get(name, {})
        eff_params = dict(entry.get("params") or {})
        eff_params.update(params or {})
        res = run_benchmark(
            engine,
            desc,
            seed=seed,
            params=eff_params or None,
            sample_size=entry.get("sample_size", sample_size),
            min_test_time_ms=entry.get("min_test_time_ms", min_test_time_ms),
            warmup_iterations=entry.get("warmup_iterations"),
            after_timing=after_timing,
        )
        results.append(res)
        if verbose:
            status = "OK    " if res.passed else "FAILED"
            print(
                f"[ {status} ] {name}: operate {res.wall_ms_operate:.2f} ms, "
                f"{res.ops_per_sec:.1f} result ops/s"
                + (f" — {res.error}" if res.error else "")
            )
    failed = sum(1 for r in results if not r.passed)
    if verbose:
        # the exact CI grep contract of the harness
        print(f"[ Info    ] Total: {len(results)}")
        print(f"[ Info    ] Failed: {failed}")
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
        with open(os.path.join(report_dir, "report.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(
                ["benchmark", "passed", "operate_ms", "ops_per_sec", "iterations", "error"]
            )
            for r in results:
                w.writerow(
                    [r.name, int(r.passed), f"{r.wall_ms_operate:.4f}",
                     f"{r.ops_per_sec:.2f}", r.iterations, r.error]
                )
        with open(
            os.path.join(report_dir, "descriptions.csv"), "w", newline=""
        ) as f:
            keys = sorted({k for r in results for k in r.description})
            w = csv.writer(f)
            w.writerow(["benchmark"] + keys)
            for r in results:
                w.writerow([r.name] + [r.description.get(k, "") for k in keys])
        with open(os.path.join(report_dir, "summary.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["total", "failed"])
            w.writerow([len(results), failed])
    return results


# -- YAML configuration tier -------------------------------------------------
#
# Mirrors the harness's --config_file/--dump flow (dump, edit
# ``default_sample_size``, re-run).  ``default_sample_size: 0`` means
# "each benchmark's full registered default".

FULL_DEFAULT_SAMPLE_SIZE = 5


def dump_config(path: str) -> None:
    """Write the default configuration of the descriptors as YAML."""
    import yaml

    engine = Engine("cpu")  # descriptors only: builds nothing on a device
    cfg = {
        "default_min_test_time": 0,
        "default_sample_size": 0,
        "random_seed": 1234,
        "benchmark": [
            {
                "name": d.name,
                "params": dict(d.default_params),
                # registered per-descriptor timing attributes — editable
                # in the dumped config and honored on re-run
                "min_test_time_ms": d.min_test_time_ms,
                "warmup_iterations": d.warmup_iterations,
                **(
                    {"data_count": list(d.default_data_count)}
                    if d.default_data_count
                    else {}
                ),
            }
            for d in engine.descriptors
        ],
    }
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


def load_config(path: str):
    """-> (names, per_benchmark, seed, min_test_time_ms) from a YAML config."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    default_n = int(cfg.get("default_sample_size", 0) or 0)
    eff_default = default_n if default_n > 0 else FULL_DEFAULT_SAMPLE_SIZE
    names = []
    per_benchmark: Dict[str, Dict] = {}
    for entry in cfg.get("benchmark", []):
        name = entry["name"]
        names.append(name)
        per_benchmark[name] = {
            "params": dict(entry.get("params") or {}),
            "sample_size": int(entry.get("sample_size", eff_default)),
        }
        # optional per-benchmark timing overrides (round-tripped by
        # dump_config; absent keys defer to the descriptor's registration)
        if "min_test_time_ms" in entry:
            per_benchmark[name]["min_test_time_ms"] = float(
                entry["min_test_time_ms"]
            )
        if "warmup_iterations" in entry:
            per_benchmark[name]["warmup_iterations"] = int(
                entry["warmup_iterations"]
            )
    default_min = cfg.get("default_min_test_time", None)
    return (
        names,
        per_benchmark,
        int(cfg.get("random_seed", 1234)),
        None if default_min in (None, 0) else float(default_min),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--random_seed", type=int, default=None)
    ap.add_argument("--benchmarks", nargs="*", default=None,
                    help="benchmark names (default: all 20)")
    ap.add_argument("--default_sample_size", type=int, default=3,
                    help="offline batch size per parameter (CI uses 3)")
    ap.add_argument("--report_root_path", default=None)
    ap.add_argument("--poly_modulus_degree", type=int, default=None,
                    help="override N for every benchmark")
    ap.add_argument("--sec_level", type=int, default=128, choices=(128, 0),
                    help="HE-standard security enforcement: 128 refuses "
                    "insecure parameter sets; 0 allows small test configs")
    ap.add_argument("--min_test_time_ms", type=float, default=None,
                    help="minimum timed-loop duration for the operate "
                    "step (the harness's min_test_time_ms)")
    ap.add_argument("--sp_shard", type=int, default=0,
                    help="run every benchmark slot-parallel: each "
                    "polynomial's coefficient axis sharded over this many "
                    "devices (an sp mesh); more than the visible cards "
                    "raises unless RSB_TORCH_VIRTUAL_DEVICES=K allows K "
                    "shards on one card (--device cpu: any count)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    choices=("cuda", "cpu"),
                    help="where contexts, keys and operate live; cuda "
                    "without a card raises")
    ap.add_argument("--config_file", default=None,
                    help="YAML benchmark configuration (see --dump)")
    ap.add_argument("--dump", action="store_true",
                    help="write the default configuration to --config_file "
                    "and exit")
    args = ap.parse_args(argv)

    if args.dump:
        if not args.config_file:
            ap.error("--dump requires --config_file")
        dump_config(args.config_file)
        print(f"[ Info    ] Default configuration dumped to {args.config_file}")
        return 0

    params: Dict[str, int] = {}
    if args.poly_modulus_degree:
        params["poly_modulus_degree"] = args.poly_modulus_degree
    if args.sec_level != 128:
        params["sec_level"] = args.sec_level
    if args.sp_shard:
        params["sp_shard"] = args.sp_shard

    names = args.benchmarks
    per_benchmark = None
    seed = 1234 if args.random_seed is None else args.random_seed
    # None defers to each descriptor's registered min_test_time_ms
    min_ms = args.min_test_time_ms
    if args.config_file:
        names_cfg, per_benchmark, seed_cfg, min_ms_cfg = load_config(
            args.config_file
        )
        names = names or names_cfg
        if args.random_seed is None:
            seed = seed_cfg
        if args.min_test_time_ms is None:
            min_ms = min_ms_cfg

    results = run_all(
        names,
        seed=seed,
        sample_size=args.default_sample_size,
        report_dir=args.report_root_path,
        params=params or None,
        min_test_time_ms=min_ms,
        per_benchmark=per_benchmark,
        device=args.device,
    )
    return 1 if any(not r.passed for r in results) else 0


if __name__ == "__main__":
    raise SystemExit(main())
