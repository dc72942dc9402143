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
   registered context's primes, at N = 16384 and 32768, at the shapes a dot
   product gives them, on strided limb-slice views as the evaluator passes
   them, at every size the kernels are specialised for and at N = 1024 (the
   generic kernels), lazy and non-lazy.
   ``path_views`` (run after ``main_path``) both kernels against their plain
   versions once more, on every distinct view (plan, shape, strides,
   alignment, first limb, epilogue) that the main path handed them: the
   views are noted while the main path runs, not listed by hand (among them
   the BFV multiply's 10-limb views over q u Bsk at N = 8192).
   ``kernel_times`` (run last) both kernels timed at
   ``[64, 7, 8192]``, at the one-wave shapes of a 1 x 1 dot product, with the
   logistic-regression context's plan at N = 16384 and with a 14-limb plan at
   N = 32768, each beside its bound; the plain versions at ``[64, 7, 8192]``.
4. ``main_path``   the port's harness runner on all 20 descriptors at their
   registered parameters, 128-bit security enforced, seed 1234: under CKKS
   and BFV element-wise and dot product at N = 8192, depth 2, 8 x 8 sample
   pairs for the Offline ones, and the three matrix-multiply packings at
   N = 8192, 10 x 9 x 8 (BFV: 4 data primes, t = 1032193, digit groups of
   2); CKKS logistic regression at N = 16384, depth 6, scale 50, 16
   features, Latency and Offline at a batch of 100.  Requires ``Failed: 0``
   (exact equality under BFV) and NTT kernel launches, as many in every
   iteration, in every ``operate`` that switches keys or multiplies under
   BFV (the BEHZ multiply: four).  Per descriptor: ``operate_ms``, results
   per second, launches, set-up seconds, peak device memory, the chunking of
   the logistic-regression dots stage and, under BFV, the noise budget left
   in the result.  (Where the device time of one
   ``operate`` goes, launch by launch, is read by
   ``reference_seal_backend_tpu_torch/utils/profile_operate.py``.)
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
LOGREG = (
    "ckks_logistic_regression_poly_d3_latency",
    "ckks_logistic_regression_poly_d3_offline",
)
MATMULT = (
    "ckks_matrix_multiply_latency",
    "ckks_matrix_multiply_cipherbatchaxis_latency",
    "ckks_matrix_multiply_row_latency",
)
ELEVEN = SIX + MATMULT + LOGREG
BFV = tuple(name.replace("ckks_", "bfv_") for name in SIX + MATMULT)
TWENTY = ELEVEN + BFV
# NTT launches of one BEHZ multiply: both operands' inverse transforms, the
# tensor product's forward and inverse over q u Bsk, the output's forward
BEHZ_SWEEPS = 4
LOGREG_BATCH = 100  # the batch behind the flexible Offline registration
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


def phase_path_views(log, device):
    """Hold both kernels against their plain versions on every view the main
    path handed them.  ``log`` is ``ops.ntt.call_log`` as that run filled it.
    A view is rebuilt with its shape and strides; of its storage offset only
    the alignment is kept, which is all of it that the kernel can see."""
    from reference_seal_backend_tpu_torch.utils.kernel_bench import random_residues

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    worst = {"ntt_fwd": 0, "ntt_inv": 0}
    views = {"ntt_fwd": 0, "ntt_inv": 0}
    leads, done, checked = {}, set(), 0
    for (pid, name, shape, strides, offset, lo, epilogue), plan in log.items():
        key = (pid, name, shape, strides, offset % 4, lo, epilogue)
        if key in done:
            continue
        done.add(key)
        views[name] += 1
        leads.setdefault(plan.n, set()).add(shape[:-2])
        # a broadcast dimension (stride 0) holds one polynomial, read again
        held = tuple(1 if st == 0 else sz for sz, st in zip(shape, strides))
        extent = offset % 4 + 1 + sum(
            (sz - 1) * st for sz, st in zip(held, strides))
        for bound_mult in (1, 2) if plan.lazy else (1,):
            dense = random_residues(gen, plan.primes, held[:-2], lo, shape[-2],
                                    plan.n, bound_mult, device)
            base = torch.zeros(extent, dtype=dense.dtype, device=device)
            base.as_strided(held, strides, offset % 4).copy_(dense)
            x = base.as_strided(shape, strides, offset % 4)
            dense = dense.expand(shape)
            if name == "ntt_fwd":
                got = plan.fwd(x, lo=lo, epilogue=epilogue)
                want = plan.fwd_plain(dense, lo=lo, epilogue=epilogue)
            else:
                got = plan.inv(x, lo=lo)
                want = plan.inv_plain(dense, lo=lo)
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            worst[name] = max(worst[name], err)
            if err:
                fail(f"path_views: {name} disagrees with its plain version "
                     f"(max_abs_err {err}) at N={plan.n} shape={shape} "
                     f"strides={strides} lo={lo} epilogue={epilogue}")
            checked += 1
    if not all(views.values()):
        fail(f"path_views: the main path noted no view of a kernel: {views}")
    # the BFV multiply's tensor product over q u Bsk: 4 + 6 limbs at N = 8192
    behz = {name: sum(1 for (_, nm, *_), plan in log.items()
                      if nm == name and plan.n == 8192 and len(plan.primes) == 10)
            for name in views}
    if not all(behz.values()):
        fail(f"path_views: no 10-limb BEHZ view of a kernel: {behz}")
    emit({"phase": "path_views", "views": views, "noted": len(log),
          "behz_10_limb_views": behz,
          "comparisons": checked,
          "leading_shapes": {n: sorted(v) for n, v in sorted(leads.items())},
          "max_abs_err": worst, "tolerance": 0,
          "seconds": time.perf_counter() - t0})
    return worst


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


def logreg_context(device):
    """The registered logistic-regression context (14 data limbs, two
    special primes, digit groups of 2), whose plan ``kernel_times`` times."""
    from reference_seal_backend_tpu_torch.schemes.params import make_ckks_context

    ctx = make_ckks_context(16384, mult_depth=6, scale_bits=50, device=device)
    if (ctx.L, ctx.n_special, ctx.digit_group, ctx.plan.lazy) != (14, 2, 2, True):
        fail(f"logistic-regression context changed: L={ctx.L} "
             f"ns={ctx.n_special} G={ctx.digit_group} lazy={ctx.plan.lazy}")
    return ctx


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
    # shapes a dot product gives the kernels (Latency 1x1, Offline 8x8),
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
    # what logistic regression launches: the plan of its registered context
    # at N = 16384 (14 data limbs; 6 is a level late in the circuit), and a
    # plan of as many limbs, all below 2^30, at N = 32768
    primes = tuple(primegen.gen_ntt_primes(BIG_LIMBS, 30, 2 * 32768))
    for plan in (logreg_context(device).plan,
                 ntt_mod.make_plan(32768, primes, device)):
        for k in (6, BIG_LIMBS):
            rows.append(time_shape(plan, gen, (8,), 0, k, device))
    emit({"phase": "kernel_times", "method": "CUDA graph replay, CUDA events",
          "seconds": time.perf_counter() - t0, "rows": rows})
    return rows[0]


def phase_main_path(device):
    from reference_seal_backend_tpu_torch.engine import runner
    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda

    # more than one timed iteration of each descriptor of the later slices,
    # so that the launch counts of two iterations can be compared
    per = {name: {"min_test_time_ms": 300.0} for name in MATMULT + LOGREG + BFV}
    per[LOGREG[1]] = {"params": {"batch_size": LOGREG_BATCH},
                      "min_test_time_ms": 1500.0}
    with tempfile.TemporaryDirectory() as report_dir:
        ntt_mod.call_log = {}  # every view the kernels are handed
        ntt_cuda.reset_launches()
        t0 = time.perf_counter()
        results = runner.run_all(
            TWENTY, seed=SEED, sample_size=8, report_dir=report_dir,
            per_benchmark=per, device=device,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ntt_cuda.launches)
        views, ntt_mod.call_log = ntt_mod.call_log, None
    failed = [r.name for r in results if not r.passed]
    if failed or len(results) != len(TWENTY):
        fail(f"main path: failed benchmarks {failed}: "
             f"{[r.error for r in results if r.error]}")
    for r in results:
        if "eltwise" not in r.name and r.ntt_launches_per_operate <= 0:
            fail(f"{r.name}: operate launched no NTT kernel")
        if not r.ntt_launches_steady:
            fail(f"{r.name}: operate's NTT launches differ between iterations")
        if r.name in MATMULT + LOGREG + BFV and r.iterations < 2:
            fail(f"{r.name}: one timed iteration only")
        if "bfv_eltwise_mult" in r.name and r.ntt_launches_per_operate != BEHZ_SWEEPS:
            fail(f"{r.name}: {r.ntt_launches_per_operate} NTT launches per "
                 f"operate, not the BEHZ multiply's {BEHZ_SWEEPS}")
        want = {"poly_modulus_degree": "8192", "security": "128 bits"}
        if r.name in LOGREG:
            want.update(poly_modulus_degree="16384", key_switch_digit_group="2",
                        scale_bits="50")
        if r.name in BFV:
            want.update(key_switch_digit_group="2", plain_modulus="1032193",
                        coeff_modulus_chain_bits="30|30|30|30")
            if r.notes.get("noise_budget_bits", 0) <= 0:
                fail(f"{r.name}: no noise budget left: {r.notes}")
        got = {k: r.description.get(k) for k in want}
        if got != want:
            fail(f"{r.name}: not at the registered parameters: {r.description}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"main path never launched {name}")
    emit({
        "phase": "main_path", "failed": 0, "total": len(results),
        "wall_s": wall, "launches": launches,
        "offline_samples": {"eltwise, dot product (both schemes)": [8, 8],
                            "logistic regression": [1, 1, LOGREG_BATCH]},
        "benchmarks": {
            r.name: {
                "operate_ms": r.wall_ms_operate,
                "results_per_s": r.ops_per_sec,
                "iterations": r.iterations,
                "ntt_launches_per_operate": r.ntt_launches_per_operate,
                "setup_s": r.setup_s,
                "peak_device_bytes": r.peak_device_bytes,
                "held_before_bytes": r.held_before_bytes,
                **r.notes,
                # one Offline logistic-regression result holds the batch
                **({"samples_per_s": LOGREG_BATCH * r.ops_per_sec}
                   if r.name == LOGREG[1] else {}),
            }
            for r in results
        },
    })
    return launches, views


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
    launches, views = phase_main_path(device)
    on_path = phase_path_views(views, device)
    worst = {k: max(worst[k], on_path[k]) for k in worst}
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
