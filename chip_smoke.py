#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and no network.  Exits non-zero, printing no
result line, when there is no card or when the port's package is missing.

Phases (each prints one JSON line; any failure ends the run non-zero):

1. ``device``      torch / CUDA versions, the card's name and power limit.
2. ``build``       builds the CUDA kernels from the source in the package.
3. ``kernel_checks`` ``ntt_fwd`` / ``ntt_inv`` against their plain PyTorch
   versions on the card (integers: tolerance 0) at N = 8192 with the
   registered context's primes, at N = 16384 and 32768, at the shapes the
   main path gives them, on strided limb-slice views as the evaluator passes
   them, at every size the kernels are specialised for and at N = 1024 (the
   generic kernels), lazy and non-lazy.
   ``kernel_times`` (run after ``main_path``) both kernels timed at
   ``[64, 7, 8192]``, at the one-wave shapes of a 1 x 1 dot product and at
   the shapes a depth-6 context gives them at N = 16384 and 32768, each
   beside its bound; the plain versions at ``[64, 7, 8192]``.
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
BIG_LIMBS = 14
L2_BYTES = 50e6
# H100 SXM peaks: 3.35 TB/s of device memory; int32 issue = 132 SMs x 64
# lanes x 1.98 GHz (half the float32 lane count behind the 67 TFLOP/s figure)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The least integer instructions the lazy arithmetic needs.  A butterfly:
# high product, low product and multiply-add of the Shoup multiply, subtract
# and minimum of the conditional subtraction, one add, one three-input add.
# The forward transform's first stage takes u as it comes (no conditional
# subtraction).  Per output element: two conditional subtractions forward,
# a Shoup multiply and one conditional subtraction inverse.
OPS_PER_BUTTERFLY = 7
OPS_FIRST_FWD_BUTTERFLY = 5
OPS_PER_OUTPUT = {"ntt_fwd": 4, "ntt_inv": 5}
# what this script counted before it counted instructions: 10 per butterfly,
# 6 per output; kept so that earlier records compare
OPS_PER_BUTTERFLY_BEFORE, OPS_PER_OUTPUT_BEFORE = 10, 6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check_plan(plan, gen, cases, device):
    """Hold both kernels against the plain versions on the card.  A case is
    ``(lead, lo, nl)`` for a contiguous input or ``(lead, lo, nl, total,
    start)`` for the limb slice ``[start, start + nl)`` of a contiguous
    ``[*lead, total, N]`` tensor, handed to the kernel as that view."""
    from reference_seal_backend_tpu_torch.utils.kernel_bench import random_residues

    worst = {"ntt_fwd": 0, "ntt_inv": 0}
    n_checked = 0
    for lead, lo, nl, *view in cases:
        for bound_mult in (1, 2):  # canonical and lazy [0, 2p) inputs
            if bound_mult == 2 and not plan.lazy:
                continue
            dense = random_residues(
                gen, plan.primes, lead, lo, nl, plan.n, bound_mult, device
            )
            x = dense
            if view:
                total, start = view
                whole = torch.zeros((*lead, total, plan.n), dtype=dense.dtype,
                                    device=device)
                whole[..., start : start + nl, :] = dense
                x = whole[..., start : start + nl, :]
                if x.data_ptr() != whole.data_ptr() + 4 * start * plan.n:
                    fail("limb slice is not a view")
            for epilogue in (True, False):
                got = plan.fwd(x, lo=lo, epilogue=epilogue)
                want = plan.fwd_plain(dense, lo=lo, epilogue=epilogue)
                torch.cuda.synchronize()
                if not got.is_contiguous():
                    fail("ntt_fwd returned a non-contiguous tensor")
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                worst["ntt_fwd"] = max(worst["ntt_fwd"], err)
                n_checked += 1
            got = plan.inv(x, lo=lo)
            want = plan.inv_plain(dense, lo=lo)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            worst["ntt_inv"] = max(worst["ntt_inv"], err)
            n_checked += 1
            if bound_mult == 1:
                back = plan.inv(plan.fwd(x, lo=lo), lo=lo)
                torch.cuda.synchronize()
                if not torch.equal(back, dense):
                    fail(f"inv(fwd(x)) != x at N={plan.n} lead={lead} lo={lo}")
    return worst, n_checked


def bound_of(name, polys, nl, n):
    """Least milliseconds the card could take for ``polys`` transforms
    (``name``: ``ntt_fwd`` or ``ntt_inv``) of ``n`` points over ``nl``
    distinct limbs."""
    log_n = int(math.log2(n))
    # each input read once, each output written once: data in and out, the
    # two twiddle tables, the per-limb constants
    n_bytes = 2 * polys * n * 4 + 2 * nl * n * 4 + 3 * nl * 4
    per_poly = n // 2 * log_n * OPS_PER_BUTTERFLY + OPS_PER_OUTPUT[name] * n
    if name == "ntt_fwd":
        per_poly -= n // 2 * (OPS_PER_BUTTERFLY - OPS_FIRST_FWD_BUTTERFLY)
    before = n // 2 * log_n * OPS_PER_BUTTERFLY_BEFORE + OPS_PER_OUTPUT_BEFORE * n
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = polys * per_poly / PEAK_INT32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "operations_ms": t_ops,
        "bound_ms_at_10_ops": max(
            t_bytes, polys * before / PEAK_INT32_OPS_PER_S * 1e3),
    }


def time_shape(plan, gen, lead, lo, nl, device, with_host_loop=False):
    """Both kernels' device time (a CUDA graph's replay) at ``[*lead, nl, N]``,
    limbs from ``lo``, each beside its bound.  The inputs rotate over buffers
    that together exceed the L2 (up to 400 of them; ``l2_cold`` says whether
    they do).  ``with_host_loop``: also the plain versions, and the kernels
    once more as the plain versions must be timed, the host launching every
    call (``eager_ms``: the host's pace where the kernel is shorter)."""
    from reference_seal_backend_tpu_torch.utils.kernel_bench import (
        random_residues,
        time_eager_ms,
        time_graph_ms,
    )

    n = plan.n
    polys = nl * math.prod(lead)
    n_bufs = max(2, min(400, math.ceil(1.2 * L2_BYTES / (polys * n * 4))))
    inputs = list(random_residues(
        gen, plan.primes, (n_bufs, *lead), lo, nl, n, 1, device).unbind(0))
    reps = max(50, n_bufs)
    calls = {
        "ntt_fwd": (lambda x: plan.fwd(x, lo=lo), lambda x: plan.fwd_plain(x, lo=lo)),
        "ntt_inv": (lambda x: plan.inv(x, lo=lo), lambda x: plan.inv_plain(x, lo=lo)),
    }
    row = {
        "shape": [*lead, nl, n], "lo": lo, "polys": polys,
        "blocks_per_sm": polys / 132,
        "l2_cold": n_bufs * polys * n * 4 >= L2_BYTES,
    }
    for name, (kernel, plain) in calls.items():
        row[name] = {"ms": time_graph_ms(kernel, inputs, reps),
                     **bound_of(name, polys, nl, n)}
        if with_host_loop:
            row[name]["eager_ms"] = time_eager_ms(kernel, inputs, 50)
            row[name]["plain_ms"] = time_eager_ms(plain, inputs[:5], 5)
    return row


def phase_kernels(device):
    from reference_seal_backend_tpu_torch.nums import primegen
    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
    from reference_seal_backend_tpu_torch.schemes.params import make_ckks_context

    t0 = time.perf_counter()
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
    # limb slices as the evaluator hands them over, uncopied: the special row
    # of a [.., l + 1, N] key-switch result (mod-down), the lifted digits'
    # data rows and special row (hoisting), the top row of a ciphertext
    # (rescale), each at 1 x 1 and 8 x 8
    slice_shapes = []
    for b in ((1, 1), (8, 8)):
        slice_shapes += [
            ((*b, 2), sp, 1, L + 1, L), ((*b, 2), sp, 1, L, L - 1),
            ((*b, L), 0, L, L + 1, 0), ((*b, L), sp, 1, L + 1, L),
            ((*b, 2), L - 1, 1, L, L - 1), ((*b, 2), L - 2, 1, L - 1, L - 2),
        ]
    worst = {"ntt_fwd": 0, "ntt_inv": 0}
    checked = 0
    plans = [(ctx.plan, main_shapes + edge_shapes + slice_shapes)]
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
    # every size with kernels of its own, and N = 1024 for the generic ones,
    # lazy and not, dense and as limb slices
    for n in (1024, 2048, 4096, 8192, 16384, 32768):
        for bits in (30, 31):
            primes = tuple(primegen.gen_ntt_primes(3, bits, 2 * n))
            plans.append(
                (ntt_mod.make_plan(n, primes, device),
                 [((3,), 0, 3), ((5,), 2, 1, 3, 2), ((2, 3), 1, 2, 3, 1)])
            )
    for plan, cases in plans:
        w, c = check_plan(plan, gen, cases, device)
        checked += c
        for k in worst:
            worst[k] = max(worst[k], w[k])
    if any(worst.values()):
        fail(f"kernel disagrees with its plain version: max_abs_err={worst}")

    emit({"phase": "kernel_checks", "comparisons": checked,
          "max_abs_err": worst, "tolerance": 0,
          "seconds": time.perf_counter() - t0})
    return worst


def phase_kernel_times(device):
    """``kernel_times``: both kernels at the shapes that matter, with the
    bound of each.  Returns the row at ``TIMED_SHAPE``."""
    from reference_seal_backend_tpu_torch.nums import primegen
    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
    from reference_seal_backend_tpu_torch.schemes.params import make_ckks_context

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    ctx = make_ckks_context(8192, mult_depth=2, sec_level=128, device=device)
    L, sp = ctx.L, ctx.sp_row
    b, nl, n = TIMED_SHAPE
    rows = [time_shape(ctx.plan, gen, (b,), 0, nl, device, with_host_loop=True)]
    # one wave or less: what a 1 x 1 dot product launches
    for lead, lo, k in (((1, 1), 0, L), ((1, 1, L), 0, L), ((1, 1, L), sp, 1)):
        rows.append(time_shape(ctx.plan, gen, lead, lo, k, device))
    # what logistic regression will launch: its depth-6, 128-bit context
    # (make_ckks_context(N, mult_depth=6, scale_bits=50)) has 14 data limbs at
    # either size, all below 2^30; 6 stands for a level late in the circuit
    for n_big in (16384, 32768):
        primes = tuple(primegen.gen_ntt_primes(BIG_LIMBS, 30, 2 * n_big))
        plan = ntt_mod.make_plan(n_big, primes, device)
        for k in (6, BIG_LIMBS):
            rows.append(time_shape(plan, gen, (8,), 0, k, device))
    emit({"phase": "kernel_times", "method": "CUDA graph replay, CUDA events",
          "seconds": time.perf_counter() - t0, "rows": rows})
    return rows[0]


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
          "specialised_log_n": list(ntt_cuda.KERNEL_LOG_NS), "seconds": seconds})

    worst = phase_kernels(device)
    launches = phase_main_path(device)
    timed = phase_kernel_times(device)

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
            "ms": timed[name]["ms"],
            "plain_ms": timed[name]["plain_ms"],
            "bound_ms": timed[name]["bound_ms"],
            "bound_by": timed[name]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes an NTT mod p
            "shape": list(TIMED_SHAPE),
            "eager_ms": timed[name]["eager_ms"],
            "bound_ms_at_10_ops": timed[name]["bound_ms_at_10_ops"],
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
