#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and no network.  Exits non-zero, printing no
result line, when there is no card or when the port's package is missing.

Phases (each prints one JSON line; any failure ends the run non-zero):

1. ``device``      torch / CUDA versions, the card's name and power limit.
2. ``build``       builds the CUDA kernels from the sources in the package.
3. ``kernel_checks`` ``ntt_fwd`` / ``ntt_inv`` against their plain PyTorch
   versions on the card (integers: tolerance 0) at N = 8192 with the
   registered context's primes, at N = 16384 and 32768, at the shapes the
   main path gives them, and timed with CUDA events at ``[64, 7, 8192]``.
4. ``main_path``   the port's harness runner on the six CKKS descriptors at
   their registered parameters (N = 8192, depth 2, 128-bit security
   enforced), seed 1234, 8 x 8 sample pairs for the Offline ones; requires
   ``Failed: 0`` and NTT kernel launches in every dot-product ``operate``.
5. the ``kernels`` line (launch counts are those of the main-path run), the
   card's name and power limit, and the result line.
"""

from __future__ import annotations

import json
import math
import sys
import tempfile
import time

import torch

SEED = 1234
SIX = (
    "ckks_eltwise_add_latency",
    "ckks_eltwise_mult_latency",
    "ckks_dot_product_latency",
    "ckks_eltwise_add_offline",
    "ckks_eltwise_mult_offline",
    "ckks_dot_product_offline",
)
TIMED_SHAPE = (64, 7, 8192)
# H100 SXM peaks: 3.35 TB/s of device memory; int32 issue = 132 SMs x 64
# lanes x 1.98 GHz (half the float32 lane count behind the 67 TFLOP/s figure)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_BUTTERFLY = 10  # lazy Harvey butterfly: 3 multiplies + 7 add/cmp/select


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def random_residues(gen, primes, lead, lo, nl, n, bound_mult, device):
    """uint32 residues below ``bound_mult * p`` per limb, as storage tensor."""
    from reference_seal_backend_tpu_torch.ops import modops

    cols = []
    for p in primes[lo : lo + nl]:
        cols.append(
            torch.randint(
                0, bound_mult * p, (*lead, n), generator=gen,
                dtype=torch.int64, device=device,
            )
        )
    return modops.narrow(torch.stack(cols, dim=-2))


def check_plan(plan, gen, cases, device):
    """Hold both kernels against the plain versions on the card."""
    worst = {"ntt_fwd": 0, "ntt_inv": 0}
    n_checked = 0
    for lead, lo, nl in cases:
        for bound_mult in (1, 2):  # canonical and lazy [0, 2p) inputs
            if bound_mult == 2 and not plan.lazy:
                continue
            x = random_residues(
                gen, plan.primes, lead, lo, nl, plan.n, bound_mult, device
            )
            for epilogue in (True, False):
                got = plan.fwd(x, lo=lo, epilogue=epilogue)
                want = plan.fwd_plain(x, lo=lo, epilogue=epilogue)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                worst["ntt_fwd"] = max(worst["ntt_fwd"], err)
                n_checked += 1
            got = plan.inv(x, lo=lo)
            want = plan.inv_plain(x, lo=lo)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            worst["ntt_inv"] = max(worst["ntt_inv"], err)
            n_checked += 1
            if bound_mult == 1:
                back = plan.inv(plan.fwd(x, lo=lo), lo=lo)
                torch.cuda.synchronize()
                if not torch.equal(back, x):
                    fail(f"inv(fwd(x)) != x at N={plan.n} lead={lead} lo={lo}")
    return worst, n_checked


def time_ms(fn, inputs, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events; the
    calls walk over ``inputs`` so that no call finds its input in L2."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernels(device):
    from reference_seal_backend_tpu_torch.nums import primegen
    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
    from reference_seal_backend_tpu_torch.schemes.params import make_ckks_context

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    ctx = make_ckks_context(8192, mult_depth=2, sec_level=128, device=device)
    if len(ctx.primes) != 7 or not ctx.plan.lazy:
        fail(f"registered context changed: primes={ctx.primes}")
    L, sp = ctx.L, ctx.sp_row
    # shapes the main path gives the kernels (Latency 1x1, Offline 8x8),
    # then a row count of 1 and of 37 and a lone special-prime row
    main_shapes = [
        ((1, 1), 0, L), ((1, 1, L), 0, L), ((1, 1, L), sp, 1),
        ((1, 1), sp, 1), ((1, 1, 2), L - 1, 1), ((1, 1, 2), 0, L - 1),
        ((1, 1, 2), 0, L - 2),
        ((8, 8), 0, L), ((8, 8, L), 0, L), ((8, 8, L), sp, 1),
        ((8, 8, 2), sp, 1), ((8, 8, 2), 0, L - 2),
    ]
    edge_shapes = [((1,), 0, 7), ((37,), 0, 7), ((37,), sp, 1), ((), 2, 3)]
    worst = {"ntt_fwd": 0, "ntt_inv": 0}
    checked = 0
    plans = [(ctx.plan, main_shapes + edge_shapes)]
    for n in (16384, 32768):  # above 48 KB of shared memory: the opt-in
        primes = tuple(primegen.gen_ntt_primes(3, 30, 2 * n))
        plans.append(
            (ntt_mod.make_plan(n, primes, device),
             [((1,), 0, 3), ((37,), 0, 3), ((5,), 2, 1)])
        )
    # a plan with 31-bit primes takes the fully reduced (non-lazy) butterflies
    primes31 = tuple(primegen.gen_ntt_primes(2, 31, 2 * 8192))
    plan31 = ntt_mod.make_plan(8192, primes31, device)
    if plan31.lazy:
        fail("expected a non-lazy plan for 31-bit primes")
    plans.append((plan31, [((3,), 0, 2), ((3,), 1, 1)]))
    for plan, cases in plans:
        w, c = check_plan(plan, gen, cases, device)
        checked += c
        for k in worst:
            worst[k] = max(worst[k], w[k])
    if any(worst.values()):
        fail(f"kernel disagrees with its plain version: max_abs_err={worst}")

    # timing at [64, 7, 8192]: 5 input sets of 14.7 MB (+ as much output
    # each) exceed the 50 MB L2
    b, nl, n = TIMED_SHAPE
    inputs = [
        random_residues(gen, ctx.primes, (b,), 0, nl, n, 1, device)
        for _ in range(5)
    ]
    plan = ctx.plan
    times = {
        "ntt_fwd": (
            time_ms(lambda x: plan.fwd(x), inputs, 50),
            time_ms(lambda x: plan.fwd_plain(x), inputs, 5),
        ),
        "ntt_inv": (
            time_ms(lambda x: plan.inv(x), inputs, 50),
            time_ms(lambda x: plan.inv_plain(x), inputs, 5),
        ),
    }
    rows = b * nl
    log_n = int(math.log2(n))
    # each input read once, each output written once: data in and out, the
    # two twiddle tables, the per-limb constants
    n_bytes = 2 * rows * n * 4 + 2 * nl * n * 4 + 3 * nl * 4
    # butterflies plus the per-element epilogue (2 compare-subtracts forward,
    # one Shoup multiply inverse: about 6 operations per element either way)
    n_ops = rows * (n // 2 * log_n * OPS_PER_BUTTERFLY + 6 * n)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_INT32_OPS_PER_S * 1e3
    bound = {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
    }
    emit({"phase": "kernel_checks", "comparisons": checked,
          "max_abs_err": worst, "tolerance": 0, "timed_shape": TIMED_SHAPE,
          "times_ms": {k: {"kernel": v[0], "plain": v[1]} for k, v in times.items()},
          **bound})
    return worst, times, bound


def phase_main_path(device):
    from reference_seal_backend_tpu_torch.engine import runner
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda

    with tempfile.TemporaryDirectory() as report_dir:
        ntt_cuda.reset_launches()
        t0 = time.perf_counter()
        results = runner.run_all(
            SIX, seed=SEED, sample_size=8, report_dir=report_dir,
            device=device,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ntt_cuda.launches)
    failed = [r.name for r in results if not r.passed]
    if failed or len(results) != len(SIX):
        fail(f"main path: failed benchmarks {failed}: "
             f"{[r.error for r in results if r.error]}")
    for r in results:
        if "dot_product" in r.name and r.ntt_launches_per_operate <= 0:
            fail(f"{r.name}: operate launched no NTT kernel")
        if r.description.get("poly_modulus_degree") != "8192" or (
            r.description.get("security") != "128 bits"
        ):
            fail(f"{r.name}: not at the registered parameters: {r.description}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"main path never launched {name}")
    emit({
        "phase": "main_path", "failed": 0, "total": len(results),
        "wall_s": wall, "launches": launches,
        "benchmarks": {
            r.name: {
                "operate_ms": r.wall_ms_operate,
                "results_per_s": r.ops_per_sec,
                "iterations": r.iterations,
                "ntt_launches_per_operate": r.ntt_launches_per_operate,
            }
            for r in results
        },
    })
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
    from reference_seal_backend_tpu_torch.utils.device import (
        card_name_and_power_limit,
        pick_device,
    )

    t_start = time.perf_counter()
    device = pick_device("cuda")
    card = card_name_and_power_limit()
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card,
          "capability": torch.cuda.get_device_capability(0)})

    seconds = ntt_cuda.build()
    emit({"phase": "build", "sources": ["reference_seal_backend_tpu_torch/csrc/ntt.cu"],
          "seconds": seconds})

    worst, times, bound = phase_kernels(device)
    launches = phase_main_path(device)

    replaces = {
        "ntt_fwd": "reference_seal_backend_tpu/ops/pallas/ntt_kernel.py:186",
        "ntt_inv": "reference_seal_backend_tpu/ops/pallas/ntt_kernel.py:205",
    }
    emit({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "reference_seal_backend_tpu_torch/csrc/ntt.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "library_ms": None,  # no single PyTorch call computes an NTT mod p
            "shape": list(TIMED_SHAPE),
        }
        for name in ("ntt_fwd", "ntt_inv")
    ]})
    print(f"total_seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
