#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc``, ``g++``, a shared libpython with its
headers, and no network.  Exits non-zero, printing no result line, when
there is no card or when the port's package is missing.

Phases (each prints one JSON line; any failure ends the run non-zero):

1. ``device``      torch / CUDA versions, the card's name and power limit.
2. ``build``       builds, side by side, the CUDA kernels (``nvcc``) and the
   port's plugin library with the harness (``g++``: ``csrc/capi_shim.cpp``,
   ``native/src/native_harness.cpp``) from the sources in the checkout.
3. ``kernel_checks`` ``ntt_fwd`` / ``ntt_inv`` against their plain PyTorch
   versions on the card (integers: tolerance 0) at N = 8192 with the
   registered context's primes, at N = 16384 and 32768, at the shapes a dot
   product gives them, on strided limb-slice views as the evaluator passes
   them, at every size the kernels are specialised for and at N = 1024 (the
   generic kernels), lazy and non-lazy.
   ``path_views`` (run after ``capi_path``) both kernels against their
   plain versions once more, on every distinct view (plan, shape, strides,
   alignment, first limb, epilogue) that the main path and ``capi_path``
   (b) handed them: the views are noted while those paths run, not listed
   by hand (among them the BFV multiply's 10-limb views over q u Bsk at
   N = 8192, and the harness's own sizes).
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
5. ``capi_path`` (after ``main_path``) the port through the C ABI of
   ``native/include/rsb_tpu_backend.h``.  (a) The unchanged harness binary,
   built against the port's library, as a subprocess on the card: the 18
   descriptors other than logistic regression at N = 8192 (``--n 100``) and
   the two logistic-regression ones at N = 16384, 128-bit, each call
   ``Total`` as named, ``Failed: 0`` and exit code 0 (its own teardown
   included).  (b) The library loaded into this interpreter with
   ``ctypes.CDLL``: the seven steps of the CKKS dot product and the BFV
   element-wise multiply (Latency, registered parameters, inputs from the
   seed) through ``rsbtpu_*``; every ``rsbtpu_operate`` must launch the NTT
   kernels as often as one ``operate`` of the main path (21 and 4), the
   decoded result must match the cleartext (5e-5 under CKKS, exact under
   BFV) and equal the Python path's bit for bit.  Then all 20 descriptors
   with the params and sample counts the harness feeds them (read from
   ``native/src/native_harness.cpp``), ``rsbtpu_operate`` three times each:
   NTT launches per call (the warm calls' equal), the result against the cleartext at the runner's
   tolerances, and the first and warm call's milliseconds beside the
   harness's own first call; the cold build of the BEHZ tables at N = 8192;
   ``operate`` timed through the ABI and from Python, and the crossing alone
   (``rsbtpu_benchmark_count``).
6. the ``kernels`` line (``launches``: the main-path run; ``capi_path_launches``:
   the ``rsbtpu_*`` calls of ``capi_path`` (b), counted from 0), the
   card's name and power limit, and the result line.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
# the unchanged harness (native/src/native_harness.cpp) against the port's
# plugin library, 128-bit enforced (it sets sec_level 128 from N = 8192 up):
# (--poly, --n, descriptors) of each call; everything but logistic
# regression at N = 8192, whose depth 6 needs N = 16384 at 128 bits
HARNESS_RUNS = (
    (8192, 100, SIX + MATMULT + BFV),
    (16384, 100, LOGREG),
)
HARNESS_SOURCE = "native/src/native_harness.cpp"
# the sizes the harness's make_workload feeds, read from its source so that
# what this script feeds in process is what the harness binary runs
HARNESS_SIZE_PATTERNS = {
    "sec_level": r"const int sec = poly >= (\d+) \? (\d+) : 0;",
    "offline_samples": r"const int b0 = offline \? (\d+) : 1, b1 = offline \? (\d+) : 1;",
    "matrices": r"const int r0 = (\d+), c0 = (\d+), c1 = (\d+);",
    "logreg": r"const int n = (\d+), batch = offline \? (\d+) : 1;",
}
HARNESS_TIMEOUT_S = 420
OK_LINE = re.compile(r"^\[ OK     \] (\S+) \(operate ([0-9.]+) ms\)$")
# driven in this process through the C ABI (ctypes), at registered parameters
ABI_IN_PROCESS = ("ckks_dot_product_latency", "bfv_eltwise_mult_latency")
ABI_TIMED_ROUNDS = 7
ABI_CROSSINGS = 2000
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


def phase_path_views(logs, device):
    """Hold both kernels against their plain versions on every view that the
    driven paths handed them.  ``logs`` maps a path to ``ops.ntt.call_log``
    as its run filled it.  A view is rebuilt with its shape and strides; of
    its storage offset only the alignment is kept, which is all of it that
    the kernel can see."""
    from reference_seal_backend_tpu_torch.utils.kernel_bench import random_residues

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    worst = {"ntt_fwd": 0, "ntt_inv": 0}
    views = {"ntt_fwd": 0, "ntt_inv": 0}
    log = {key: plan for path in logs.values() for key, plan in path.items()}
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
        fail(f"path_views: the paths noted no view of a kernel: {views}")
    # the BFV multiply's tensor product over q u Bsk: 4 + 6 limbs at N = 8192
    behz = {name: sum(1 for (_, nm, *_), plan in log.items()
                      if nm == name and plan.n == 8192 and len(plan.primes) == 10)
            for name in views}
    if not all(behz.values()):
        fail(f"path_views: no 10-limb BEHZ view of a kernel: {behz}")
    emit({"phase": "path_views", "views": views,
          "noted": {path: len(v) for path, v in logs.items()},
          "noted_only_by": {
              path: len(v.keys() - {k for other, o in logs.items()
                                    if other != path for k in o})
              for path, v in logs.items()},
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
    benchmarks = {
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
    }
    emit({
        "phase": "main_path", "failed": 0, "total": len(results),
        "wall_s": wall, "launches": launches,
        "offline_samples": {"eltwise, dot product (both schemes)": [8, 8],
                            "logistic regression": [1, 1, LOGREG_BATCH]},
        "benchmarks": benchmarks,
    })
    return launches, views, benchmarks


def harness_sizes():
    """The sizes of ``native_harness.cpp``'s ``make_workload``, read from its
    source: the security rule, Offline sample counts, matrix dimensions,
    logistic-regression features and Offline batch."""
    from pathlib import Path

    text = (Path(__file__).resolve().parent / HARNESS_SOURCE).read_text()
    sizes = {}
    for key, pattern in HARNESS_SIZE_PATTERNS.items():
        m = re.search(pattern, text)
        if m is None:
            fail(f"capi_path: {HARNESS_SOURCE} no longer holds {pattern!r}")
        sizes[key] = tuple(int(g) for g in m.groups())
    return sizes


def harness_case(name, poly, n, sizes):
    """What the harness feeds ``name`` in its run at ``--poly poly --n n``:
    the benchmark's params and the two operands' sample counts."""
    min_poly, sec = sizes["sec_level"]
    params = {"poly_modulus_degree": poly}
    b0 = b1 = 1
    if "matrix_multiply" in name:
        params.update(zip(("rows_m0", "cols_m0", "cols_m1"), sizes["matrices"]))
    elif "logistic_regression" in name:
        features, batch = sizes["logreg"]
        params.update(n=features, batch_size=batch if "_offline" in name else 1)
    else:
        params["n"] = n
        if "_offline" in name:
            b0, b1 = sizes["offline_samples"]
    params["sec_level"] = sec if poly >= min_poly else 0
    return params, b0, b1


def harness_runs(built):
    """(a) of ``capi_path``: the unchanged harness binary, as a harness runs
    a plugin, once per entry of ``HARNESS_RUNS``.  Returns the phase's rows
    and each descriptor's ``operate`` milliseconds as the harness printed
    them."""
    import subprocess

    from reference_seal_backend_tpu_torch.engine import native

    rows, printed = [], {}
    for poly, n, names in HARNESS_RUNS:
        args = ["--poly", str(poly), "--n", str(n)]
        cmd = [str(built.harness), *args, "--seed", str(SEED), *names]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, env=native.embedded_env("cuda"),
                                  capture_output=True, text=True,
                                  timeout=HARNESS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"capi_path: the harness ({' '.join(args)}) ran past "
                 f"{HARNESS_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        ok = {m.group(1): float(m.group(2))
              for m in map(OK_LINE.match, lines) if m}
        if (proc.returncode != 0 or set(ok) != set(names)
                or f"[ Info    ] Total: {len(names)}" not in lines
                or "[ Info    ] Failed: 0" not in lines):
            fail(f"capi_path: the harness ({' '.join(args)}) exited "
                 f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                 f"{proc.stderr[-4000:]}")
        printed.update(ok)
        rows.append({"args": args, "total": len(names), "failed": 0,
                     "returncode": proc.returncode, "wall_s": wall})
    return rows, printed


def cleartext_error(desc, outs, want):
    """Largest absolute difference of the decoded outputs from the cleartext
    truth, output by output as the runner compares them (integers under
    BFV); infinite where their count or a shape differs."""
    import numpy as np

    from reference_seal_backend_tpu_torch.engine.descriptor import Scheme

    if len(outs) != len(want):
        return math.inf
    err = 0.0
    for got, exp in zip(outs, want):
        got = np.asarray(got, dtype=np.float64).reshape(-1)
        exp = np.asarray(exp, dtype=np.float64).reshape(-1)
        if got.shape != exp.shape:
            return math.inf
        if desc.scheme is Scheme.BFV:
            got, exp = got.astype(np.int64), exp.astype(np.int64)
        err = max(err, float(np.abs(got - exp).max(initial=0)))
    return err


def behz_tables_cold_ms(ctx, device):
    """Milliseconds to build from nothing what the first BFV multiply of a
    process builds (``evaluator/behz.py:tables_for``): the NTT plan over
    q u Bsk, and the tables around it."""
    from reference_seal_backend_tpu_torch.evaluator import behz
    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ntt_mod._make_plan.__wrapped__(
        ctx.n, tuple(ctx.data_primes) + tuple(ctx.bsk_primes),
        torch.device(device))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    behz.BehzTables(ctx)  # the plan now from make_plan's cache
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"q_u_bsk_plan_ms": (t1 - t0) * 1e3,
            "tables_without_plan_ms": (t2 - t1) * 1e3}


def abi_in_process(device, main_benchmarks, harness_printed):
    """(b) of ``capi_path``: the library loaded into this interpreter with
    ``ctypes.CDLL``.  First the seven steps of ``ABI_IN_PROCESS`` at
    registered parameters on inputs from ``SEED``: every ``rsbtpu_operate``
    must launch the NTT kernels as often as an ``operate`` of the main path,
    and the decoded result must match the cleartext and equal, bit for bit,
    what the same benchmark gives driven from Python.  Then every descriptor
    at the harness's own sizes, fed as the harness feeds them, each
    ``rsbtpu_operate`` three times (a first call and two warm ones).  The
    NTT launch counts are set to 0 just before these ``rsbtpu_*`` calls and
    read just after, with ``ops/ntt.py:call_log`` noting every view they
    hand the kernels.
    Afterwards ``operate`` is timed through the ABI and from Python, and the
    crossing alone.  Returns the phase's fields, the launches and the
    views."""
    import numpy as np

    from reference_seal_backend_tpu_torch.engine import capi, native, runner
    from reference_seal_backend_tpu_torch.engine.descriptor import Scheme
    from reference_seal_backend_tpu_torch.engine.registry import Engine
    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda

    os.environ[capi.DEVICE_ENV] = device.type
    lib = native.load_library()

    def abi(fn, *args):
        """One call of the library; a sentinel fails the run with the
        library's message."""
        value = getattr(lib, fn)(*args)
        if value is None or value < 0:
            err = native.take_string(lib, lib.rsbtpu_last_error())
            fail(f"capi_path: {fn}{args[:1]} failed: {err}")
        return value

    def seven_steps(bid, inputs):
        """encode .. decode through the ABI, ``rsbtpu_operate`` three
        times (a first call, then two warm ones).  Returns the loaded handle,
        the decoded JSON and, per operate, its NTT launches and
        milliseconds."""
        h = abi("rsbtpu_encode", bid, json.dumps(
            [np.asarray(x).tolist() for x in inputs]).encode())
        loaded = abi("rsbtpu_load", bid, abi("rsbtpu_encrypt", bid, h))
        per_call, ms = [], []
        for _ in range(3):
            before = sum(ntt_cuda.launches.values())
            t0 = time.perf_counter()
            out = abi("rsbtpu_operate", bid, loaded)
            ms.append((time.perf_counter() - t0) * 1e3)
            per_call.append(sum(ntt_cuda.launches.values()) - before)
        h = abi("rsbtpu_decrypt", bid, abi("rsbtpu_store", bid, out))
        return loaded, native.take_string(lib, abi("rsbtpu_decode", bid, h)), \
            per_call, ms

    def tolerance(desc):
        return 0.0 if desc.scheme is Scheme.BFV else runner.CKKS_ATOL[desc.workload]

    if abi("rsbtpu_api_version_check", 1, 0, 1) != 0:
        fail("capi_path: rsbtpu_api_version_check(1, 0, 1) refused")
    abi("rsbtpu_initialize")
    eid = abi("rsbtpu_engine_create")
    if capi._engines[eid].device != device:
        fail(f"capi_path: the engine is on {capi._engines[eid].device}")
    engine = Engine(device)
    # the Python path: the same benchmark, parameters and key seed
    python = {}
    for name in ABI_IN_PROCESS:
        desc = engine.find(name)
        py = engine.create_benchmark(desc, None)
        inputs, truth = runner.gen_inputs(
            desc, py.params, np.random.default_rng(SEED), 1, 1)
        py_loaded = py.load(py.encrypt(py.encode(inputs)))
        py_out = py.decode(py.decrypt(py.store(py.block(py.operate(py_loaded)))))
        python[name] = (py, py_loaded, inputs, truth,
                        [np.asarray(np.real(o), dtype=np.float64).tolist()
                         for o in py_out])

    ntt_cuda.reset_launches()
    ntt_mod.call_log = {}
    registered, timed = {}, {}
    for name in ABI_IN_PROCESS:
        desc = engine.find(name)
        py, py_loaded, inputs, truth, py_json = python[name]
        want_launches = main_benchmarks[name]["ntt_launches_per_operate"]
        bid = abi("rsbtpu_benchmark_create", eid, name.encode(), b"")
        loaded, abi_json, per_call, _ = seven_steps(bid, inputs)
        if per_call != [want_launches] * 3:
            fail(f"capi_path: {name}: NTT launches per rsbtpu_operate "
                 f"{per_call}, the main path's {want_launches}")
        if json.loads(abi_json) != py_json:
            fail(f"capi_path: {name}: the ABI decoded {abi_json[:200]}, the "
                 f"Python path {py_json}"[:600])
        err = cleartext_error(desc, json.loads(abi_json), truth())
        if err > tolerance(desc):
            fail(f"capi_path: {name}: result off the cleartext by {err}")
        registered[name] = {
            "ntt_launches_per_operate": per_call,
            "main_path_ntt_launches_per_operate": want_launches,
            "equal_to_python_path": True,
            "max_abs_err_vs_cleartext": err, "tolerance": tolerance(desc),
        }
        timed[name] = (bid, loaded, py, py_loaded)

    sizes = harness_sizes()
    at_harness_sizes, bfv_ctx = {}, None
    for poly, n, names in HARNESS_RUNS:
        for name in names:
            desc = engine.find(name)
            params, b0, b1 = harness_case(name, poly, n, sizes)
            t0 = time.perf_counter()
            launched = dict(ntt_cuda.launches)
            bid = abi("rsbtpu_benchmark_create", eid, name.encode(),
                      json.dumps(params).encode())
            bench = capi._benchmarks[bid]
            inputs, truth = runner.gen_inputs(
                desc, bench.params, np.random.default_rng(SEED), b0, b1)
            _, abi_json, per_call, ms = seven_steps(bid, inputs)
            if name == "bfv_eltwise_mult_latency":
                bfv_ctx = bench.ctx
            lib.rsbtpu_benchmark_destroy(bid)
            err = cleartext_error(desc, json.loads(abi_json), truth())
            if err > tolerance(desc):
                fail(f"capi_path: {name} at {params}: result off the "
                     f"cleartext by {err}")
            # a first call may launch more: logistic regression encodes its
            # plaintext constants then (as in the main path's warm-up)
            first, warm = per_call[0], per_call[1]
            if per_call[2] != warm or first < warm:
                fail(f"capi_path: {name} at {params}: NTT launches per "
                     f"rsbtpu_operate {per_call}: warm calls differ")
            if "eltwise" not in name and warm <= 0:
                fail(f"capi_path: {name} at {params}: operate launched no "
                     f"NTT kernel")
            if "bfv_eltwise_mult" in name and warm != BEHZ_SWEEPS:
                fail(f"capi_path: {name}: {warm} NTT launches per "
                     f"operate, not the BEHZ multiply's {BEHZ_SWEEPS}")
            at_harness_sizes[name] = {
                "params": params, "samples": [b0, b1],
                "ntt_launches_per_operate": {"first": first, "warm": warm},
                "ntt_launches_seven_steps": {
                    k: ntt_cuda.launches[k] - launched[k] for k in launched},
                "operate_ms": {"harness_first": harness_printed[name],
                               "in_process_first": ms[0],
                               "in_process_warm": ms[1:]},
                "max_abs_err_vs_cleartext": err, "tolerance": tolerance(desc),
                "seconds": time.perf_counter() - t0,
            }
    launches = dict(ntt_cuda.launches)
    views, ntt_mod.call_log = ntt_mod.call_log, None

    # operate, timed in turns through the C ABI and on the benchmark itself
    for name, (bid, loaded, py, py_loaded) in timed.items():
        times = {"abi": [], "python": []}
        for _ in range(ABI_TIMED_ROUNDS):
            for how, run in (
                ("abi", lambda: lib.rsbtpu_handle_destroy(
                    abi("rsbtpu_operate", bid, loaded))),
                ("python", lambda: py.block(py.operate(py_loaded))),
            ):
                t0 = time.perf_counter()
                run()
                times[how].append((time.perf_counter() - t0) * 1e3)
        registered[name]["operate_ms_median"] = {
            k: statistics.median(v) for k, v in times.items()}
        registered[name]["timed_rounds"] = ABI_TIMED_ROUNDS
        lib.rsbtpu_benchmark_destroy(bid)
    # the crossing alone: a call that does no device work
    t0 = time.perf_counter()
    for _ in range(ABI_CROSSINGS):
        lib.rsbtpu_benchmark_count(eid)
    t1 = time.perf_counter()
    for _ in range(ABI_CROSSINGS):
        capi.engine_benchmark_count(eid)
    t2 = time.perf_counter()
    lib.rsbtpu_engine_destroy(eid)
    fields = {
        "registered": registered,
        "at_harness_sizes": at_harness_sizes,
        "harness_sizes_from": HARNESS_SOURCE,
        "behz_tables_cold": behz_tables_cold_ms(bfv_ctx, device),
        "crossing": {"call": "rsbtpu_benchmark_count", "calls": ABI_CROSSINGS,
                     "abi_us": (t1 - t0) / ABI_CROSSINGS * 1e6,
                     "python_us": (t2 - t1) / ABI_CROSSINGS * 1e6},
    }
    return fields, launches, views


def phase_capi_path(built, device, main_benchmarks):
    """``capi_path``: the port through the C ABI of
    ``native/include/rsb_tpu_backend.h`` (the plugin library built from
    ``csrc/capi_shim.cpp``): (a) the unchanged harness as a subprocess,
    (b) the library in this process.  Returns the NTT launches of (b) and
    the views they were handed."""
    t0 = time.perf_counter()
    harness, printed = harness_runs(built)
    in_process, launches, views = abi_in_process(device, main_benchmarks, printed)
    for name, count in launches.items():
        if count <= 0:
            fail(f"capi_path never launched {name}")
    emit({"phase": "capi_path", "harness": harness,
          "in_process": in_process, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches, views


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from reference_seal_backend_tpu_torch.engine import native
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

    # the kernels (nvcc) and the plugin library with the harness (g++), side
    # by side
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        nvcc = pool.submit(ntt_cuda.build)
        gxx = pool.submit(native.build)
        seconds, built = nvcc.result(), gxx.result()
    emit({"phase": "build",
          "sources": ["reference_seal_backend_tpu_torch/csrc/ntt.cu",
                      "reference_seal_backend_tpu_torch/csrc/capi_shim.cpp",
                      "native/src/native_harness.cpp"],
          "specialised_log_n": list(ntt_cuda.KERNEL_LOG_NS),
          "seconds": {"ntt.cu": seconds, "capi_shim.cpp + native_harness.cpp":
                      built.seconds, "wall": time.perf_counter() - t0}})

    worst = phase_kernels(device)
    launches, views, main_benchmarks = phase_main_path(device)
    capi_launches, capi_views = phase_capi_path(built, device, main_benchmarks)
    on_path = phase_path_views({"main_path": views, "capi_path": capi_views},
                               device)
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
            "capi_path_launches": capi_launches[name],
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
