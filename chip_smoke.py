#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc``, ``g++``, a shared libpython with its
headers, and no network.  Exits non-zero, printing no result line, when
there is no card or when the port's package is missing.

Phases (each prints one JSON line; any failure ends the run non-zero):

1. ``device``      torch / CUDA versions, the card's name and power limit.
2. ``build``       builds, side by side, the CUDA kernels (``nvcc``: the NTT
   kernels, and the fused BEHZ kernel for the registered BFV context's 4 q
   limbs) and the port's plugin library with the harness (``g++``:
   ``csrc/capi_shim.cpp``, ``native/src/native_harness.cpp``) from the
   sources in the checkout.
3. ``kernel_checks`` ``ntt_fwd`` / ``ntt_inv`` against their plain PyTorch
   versions on the card (integers: tolerance 0) at N = 8192 with the
   registered context's primes, at N = 16384 and 32768, at the shapes a dot
   product gives them, on strided limb-slice views as the evaluator passes
   them, at every size the kernels are specialised for and at N = 1024 (the
   generic kernels), lazy and non-lazy.
   ``path_views`` (run after ``capi_path``) both kernels against their
   plain versions once more, on every distinct view (plan, shape, strides,
   alignment, first limb, epilogue) that the main path, ``limb_path``,
   ``bench_path`` and ``capi_path`` (b) handed them: the views are noted
   while those paths
   run, not listed by hand (among them the BFV multiply's 10-limb views
   over q u Bsk at N = 8192, the limb blocks' windows from limb 3 at
   N = 8192 and limb 7 at N = 16384, the BFV limb blocks' from limb 2 and
   their 8-limb plans over a q window u Bsk, the limb windows and digit
   lifts of logistic regression at N = 32768 with digit groups of 3, and the
   harness's own sizes).
   ``behz_checks`` the fused BEHZ kernel (``csrc/behz.cu``) against the
   plain steps it replaces (``evaluator/behz.py:floor_sk_plain``) at the
   cipher-batch-axis cell's tensor product, ``[720, 3, 10, 8192]``, with a
   product of zeros and one of p - 1 in every row (tolerance 0).
   ``kernel_times`` (run last) both kernels timed at
   ``[64, 7, 8192]``, at the one-wave shapes of a 1 x 1 dot product, with the
   logistic-regression context's plan at N = 16384 and with a 14-limb plan at
   N = 32768, each beside its bound; the plain versions at ``[64, 7, 8192]``.
   ``behz_times`` (after it) the fused BEHZ kernel at ``[720, 3, 10, 8192]``
   (graph replay, call by call, and the plain steps), beside its bound from
   its bytes and from its own instructions, counted in its SASS
   (``cuobjdump``) at each pipe's most per clock.
4. ``main_path``   the port's harness runner on all 20 descriptors at their
   registered parameters, 128-bit security enforced, seed 1234: under CKKS
   and BFV element-wise and dot product at N = 8192, depth 2, 8 x 8 sample
   pairs for the Offline ones, and the three matrix-multiply packings at
   N = 8192, 10 x 9 x 8 (BFV: 4 data primes, t = 1032193, digit groups of
   2); CKKS logistic regression at N = 16384, depth 6, scale 50, 16
   features, Latency and Offline at a batch of 100.  Requires ``Failed: 0``
   (exact equality under BFV).  Every stage of ``operate`` is a CUDA graph
   captured in the warm-up and replayed in the timed loop
   (``utils/staging.py``): every descriptor must capture and replay, the
   timed ``operate`` calls must launch nothing from Python (the launch
   counters do not move), and what the process holds on the card before a
   descriptor begins must not grow within a context (the graphs are
   released with their benchmark).  After the timed loop, on the same
   benchmark (the runner's ``after_timing``, ``compare_with_eager``):
   ``operate`` replayed and with its stages eager
   (``utils/profile_operate.py:replayed_and_eager``); the last timed
   result, read after those calls, must equal the eager one integer for
   integer, and the NTT kernels of a replay, counted by name in its traces
   (``torch.profiler``), must equal the eager ``operate``'s launches and
   its traces' count, as many in every call, in every ``operate`` that
   switches keys or multiplies under BFV (the BEHZ multiply: four;
   ``EXPECTED_LAUNCHES``).  Per descriptor: ``operate_ms``, results per
   second, launches (per replay from the traces; counted in the warm-up),
   set-up seconds, peak device memory, the graphs' captures, replays and
   warm-up and capture seconds, the chunking of the logistic-regression
   dots stage and, under BFV, the noise budget left in the result; and
   replayed and eager, taken in turns: ``operate_ms``, device busy time
   and kernel count from the traces, and span (CUDA events).
5. ``capi_path`` (after ``sp_path``) the port through the C ABI of
   ``native/include/rsb_tpu_backend.h``.  (a) The unchanged harness binary,
   built against the port's library, as a subprocess on the card: the 18
   descriptors other than logistic regression at N = 8192 (``--n 100``) and
   the two logistic-regression ones at N = 16384, 128-bit, each call
   ``Total`` as named, ``Failed: 0`` and exit code 0 (its own teardown
   included).  (b) The library loaded into this interpreter with
   ``ctypes.CDLL``: the seven steps of the CKKS dot product and the BFV
   element-wise multiply (Latency, registered parameters, inputs from the
   seed) through ``rsbtpu_*``; the first ``rsbtpu_operate`` warms up and
   captures its stage, every call replays it, the warm ones launch nothing
   from Python, and the traces of a warm call count as many NTT kernels as
   a replay of the main path (21 and 4); the decoded result must match the
   cleartext (5e-5 under CKKS, exact under BFV) and equal the Python path's
   bit for bit.  Then all 20 descriptors with the params and sample counts
   the harness feeds them (read from ``native/src/native_harness.cpp``),
   ``rsbtpu_operate`` three times each and warm calls traced: NTT launches
   per call (none in the warm calls, each a replay) and in the traces, the
   result against the cleartext at the runner's tolerances, and the first
   and warm call's milliseconds beside the harness's own first call; the cold build
   of the BEHZ tables at N = 8192; ``operate`` timed through the ABI and
   from Python, and the crossing alone
   (``rsbtpu_benchmark_count``).
6. ``sp_path`` (after ``main_path``) the slot-parallel path
   (``parallel/``): five descriptors at their registered parameters (CKKS
   element-wise multiply and dot product at N = 8192, logistic regression
   Latency at N = 16384 / depth 6 / G = 2, BFV element-wise multiply and dot
   product at N = 8192), each through the seven steps flat and with
   ``sp_shard`` 1 (a one-device mesh) and 4 (four cards where four are
   visible, else four virtual devices of the card:
   ``RSB_TORCH_VIRTUAL_DEVICES=4``, set for this phase only).  Every decode
   must equal the flat run's.  The mesh lies on one device, so every stage
   of an sp ``operate`` is one CUDA graph, captured in the first call and
   replayed after (``utils/staging.py``, the counterpart of the JAX
   package's ``jax.jit`` of the sp stage): each run must capture each stage
   once and replay every stage in every timed ``operate``; the last timed
   result, read after the later calls, must equal the eager stages'
   (``staging.eager``) integer for integer, block for block; and the
   collectives credited to a replayed ``operate`` must equal those of an
   eager one (``sp_eval.collective_stats``).  Per run: ``operate_ms``
   (median of 3 timed replays), set-up seconds, peak device memory on each
   device, NTT kernel launches and graph replays per ``operate``, the
   collectives of one ``operate``; replayed and eager ``operate_ms``
   (median of 3 each, in turns), device busy time and kernels of one
   traced replay (no NTT kernel: the sp path runs none), the stages'
   warm-up and capture seconds.  Then the sharded transforms against K1
   (``epilogue`` True and False) and K2 on every shape the sp runs handed
   ``parallel/sharded_ntt.py`` (noted in its ``call_log``: the data plans
   and the BEHZ plan over q u Bsk), at sp = 1 and 4, tolerance 0.
7. ``limb_path`` (after ``sp_path``) limb-sharded ciphertexts through the
   plain ``Evaluator`` (``parallel/limb.py``) and the process-aware dp x sp
   mesh, on four virtual devices of the card (``RSB_TORCH_VIRTUAL_DEVICES``
   for this phase only; cards where four are visible), registered
   parameters, seed 1234: (a) (dp=2, limb=2), the CKKS dot product's
   context, a batch of 2 pairs, ``accumulate(rescale(relinearize(
   multiply)), 100)``, decoded within 5e-5 of the cleartext; (b) limb=2,
   the logistic-regression context (14 + 2 limbs, G = 2),
   ``rotate_sum(rescale(relinearize(multiply)), range(8))``; (c)
   ``make_process_mesh(sp=2)`` and ``SpEvaluator(batch_axes=("dp",))``,
   multiply -> relinearize -> rescale; (d) (a)'s mesh, the BFV dot
   product's context (N = 8192, 4 + 2 limbs, G = 2), a batch of 2 pairs of
   100 integers mod t, ``accumulate(relinearize(multiply), 100)`` (the BEHZ
   multiply per limb block), decoded exactly to the dot products mod t;
   (e) (b)'s ciphertexts switched to 13 limbs, a level limb = 2 does not
   divide (replicated over the limb axis), multiply -> relinearize.  Each
   placed chain runs eagerly and staged (``staging.stage`` over its mesh:
   one CUDA graph, the counterpart of the JAX package's ``jax.jit`` of the
   same chain), each equal to the flat ``Evaluator`` integer for integer;
   the collectives credited to a replay must equal the eager chain's, and
   the NTT kernels of a replay, counted in its padded traces, the eager
   chain's launches.  Per case: host ms of the staged and the eager chain
   (median of 3 each, in turns) beside the flat chain's, the collectives of
   one chain, K1 / K2 launches of one warm eager chain, the graph's warm-up
   and capture seconds, peak device memory; (a), (b), (d) and (e) must
   launch both kernels, (a), (b) and (d) at the top block's first limb
   too, and every transform must launch its kernel (no plain version).
8. ``bench_path`` (after ``limb_path``) the port's benchmark suite
   (``reference_seal_backend_tpu_torch/bench.py``, the counterpart of the
   JAX package's ``bench.py``) at ``bench.py``'s sizes, every step, each
   throughput step timed for ``BENCH_WINDOW_S`` each way (staged and
   eager): the bare multiply (N = 16384, a batch of 64), multiply +
   relinearize + rescale, rotate and the sum of 8 rotations (a batch of 8),
   the BFV BEHZ multiply (N = 8192), the CKKS dot product Latency and
   element-wise multiply Offline 16 x 16 (N = 8192), logistic regression
   Latency and Offline b100 at N = 16384 and at N = 32768 (depth 6, three
   special primes, digit groups of 3).  Every gate must hold and nothing be
   skipped, the headline and all ten metric keys present, every step's
   staged result equal to its eager one integer for integer, the chains as
   ``bench_suite.json`` ``describe`` records them (``BENCH_DESCRIBE``); at
   N = 32768 a replay's K1 / K2 kernels, counted in padded traces, equal
   to an eager ``operate``'s launches.  Prints the record.
9. the ``kernels`` line, the NTT kernels and the fused BEHZ kernel
   (``launches``: the main-path run, counted where the
   wrapper launches: the eager warm-ups, the captures and the eager
   ``operate`` calls held against the replays; ``sp_path_launches``:
   the sp runs of ``sp_path``; ``limb_path_launches``: the placed chains of
   ``limb_path``, eager, warmed up and captured; ``bench_path_launches``:
   every step of ``bench_path``, staged and eager; ``capi_path_launches``:
   the ``rsbtpu_*`` calls of ``capi_path`` (b); each counted from 0), the
   card's name and power limit, and the result line.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
# the sp path (parallel/): these descriptors at registered parameters, each
# at every mesh size of SP_SIZES, SP_TIMED timed operates a run
SP_PATH = (
    "ckks_eltwise_mult_latency",
    "ckks_dot_product_latency",
    LOGREG[0],
    "bfv_eltwise_mult_latency",
    "bfv_dot_product_latency",
)
SP_SIZES = (1, 4)
SP_TIMED = 3
# the limb path (parallel/limb.py): meshes of LIMB_DEVICES devices, a dot
# product of n = LIMB_DOT_N decoded within LIMB_DOT_ATOL, LIMB_TIMED timed
# chains a case
LIMB_DEVICES = 4
LIMB_DOT_N = 100
LIMB_DOT_ATOL = 5e-5
LIMB_TIMED = 3
# (e): the logistic-regression ciphertext's level that limb = 2 does not divide
LIMB_ODD_LEVEL = 13
# bench_path: the port's suite (reference_seal_backend_tpu_torch/bench.py) at
# bench.py's sizes, BENCH_WINDOW_S seconds of timed chunks a throughput step
# each way; the chains bench_suite.json ``describe`` records (the JAX
# package's record), held against the port's own describe()
BENCH_WINDOW_S = 1.0
BENCH_DESCRIBE = {
    16384: {"poly_modulus_degree": "16384",
            "coeff_modulus_chain_bits": "30|30|25|25|25|25|26|26|25|26|26|25|25|26",
            "special_modulus_bits": "60", "key_switch_digit_group": "2",
            "security": "128 bits"},
    32768: {"poly_modulus_degree": "32768",
            "coeff_modulus_chain_bits": "30|30|25|25|25|25|26|26|25|26|26|25|26|26",
            "special_modulus_bits": "90", "key_switch_digit_group": "3",
            "security": "128 bits"},
}
BENCH_LOGREG_32768 = ("ckks_logreg_n32768_latency_ms",
                      "ckks_logreg_offline_b100_samples_per_sec_n32768")
BENCH_LOGREG_ATOL = 5e-4  # bench.py's gate after key switches
# NTT launches of one BEHZ multiply: both operands' inverse transforms, the
# tensor product's forward and inverse over q u Bsk, the output's forward
BEHZ_SWEEPS = 4
LOGREG_BATCH = 100  # the batch behind the flexible Offline registration
# NTT kernels of one warm ``operate``: the BEHZ multiply, the dot product,
# logistic regression
EXPECTED_LAUNCHES = {
    "bfv_eltwise_mult_latency": BEHZ_SWEEPS, "bfv_eltwise_mult_offline": BEHZ_SWEEPS,
    "ckks_dot_product_latency": 21, LOGREG[0]: 46, LOGREG[1]: 127,
}
# what the process may hold on the card before a descriptor beyond what it
# held before the first descriptor of the same context: the tables that
# later descriptors cache (Galois permutations, BEHZ tables, per-level
# constants), megabytes; one benchmark's keys or graphs left behind are more
HELD_GROWTH_BYTES = 16 << 20
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
# The fused BEHZ kernel (csrc/behz.cu) at the cipher-batch-axis cell's tensor
# product: [720 products, 3, k + kb, N] of the registered BFV context (k = 4
# q limbs, kb = 6, N = 8192).  Its least time: its bytes over HBM's peak,
# and its own instructions (read from its SASS) at the most an SM takes of
# them in a clock: one warp instruction per scheduler (twice the int32 lane
# count), and the int32 lane count on each of the FMA pipe (IMAD, IMUL) and
# the ALU pipe (the other integer instructions).  An instruction that holds
# its pipe longer than a clock (IMAD.WIDE) counts once: the bound is then
# below the truth, never above it.
BEHZ_SHAPE = (720, 3, 10, 8192)
BFV_K = 4
FMA_PIPE = {"IMAD", "IMUL"}
ALU_PIPE = {"IADD3", "VIADD", "LOP3", "ISETP", "IMNMX", "VIMNMX", "VIADDMNMX",
            "SEL", "SHF", "LEA", "PLOP3", "IABS"}
BRANCHES = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "BSSY", "BSYNC", "WARPSYNC"}


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


def behz_context(device):
    """The registered BFV context and its BEHZ tables (which build the fused
    kernel's library of its k)."""
    from reference_seal_backend_tpu_torch.evaluator import behz
    from reference_seal_backend_tpu_torch.schemes.params import make_bfv_context

    ctx = make_bfv_context(device=device)
    if (ctx.L, len(ctx.bsk_primes), ctx.n) != (
            BFV_K, BEHZ_SHAPE[2] - BFV_K, BEHZ_SHAPE[3]):
        fail(f"registered BFV context changed: k={ctx.L} "
             f"kb={len(ctx.bsk_primes)} N={ctx.n}")
    return ctx, behz.tables_for(ctx)


def phase_behz_checks(device):
    """``behz_checks``: the fused BEHZ kernel against the plain steps it
    replaces (``evaluator/behz.py:floor_sk_plain``: ``_fbc_q_to_bsk`` ->
    ``floor_bsk`` -> ``_sk_to_q`` -> the Montgomery entry) on the card at
    ``BEHZ_SHAPE``, one product all zeros and one p - 1 in every row;
    integers, tolerance 0, one launch."""
    from reference_seal_backend_tpu_torch.evaluator import behz
    from reference_seal_backend_tpu_torch.ops.cuda import behz as behz_cuda
    from reference_seal_backend_tpu_torch.utils.kernel_bench import random_residues

    t0 = time.perf_counter()
    ctx, tb = behz_context(device)
    primes = ctx.data_primes + ctx.bsk_primes
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    x = random_residues(gen, primes, BEHZ_SHAPE[:2], 0, len(primes), ctx.n, 1, device)
    x[0, 0] = 0
    x[0, 1] = torch.tensor([p - 1 for p in primes], dtype=x.dtype, device=device)[:, None]
    before = behz_cuda.launches["behz_floor_sk"]
    got = behz_cuda.floor_sk(x, tb)
    launched = behz_cuda.launches["behz_floor_sk"] - before
    want = behz.floor_sk_plain(tb, x)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err or launched != 1 or got.shape != want.shape:
        fail(f"behz_floor_sk disagrees with the plain steps at {list(x.shape)}: "
             f"max_abs_err {err}, launches {launched}")
    emit({"phase": "behz_checks", "shape": list(x.shape), "k": ctx.L,
          "kb": len(ctx.bsk_primes), "max_abs_err": err, "tolerance": 0,
          "seconds": time.perf_counter() - t0})
    return err


def sass_mix(library):
    """The instructions of the fused BEHZ kernel in ``library`` (its SASS,
    by ``cuobjdump``), by opcode without modifiers, up to its last ``EXIT``
    (after it only padding).  The kernel has no branch (every loop unrolls),
    so each thread issues each instruction once; a branch fails the run,
    since a count of the code would then not be a count of what runs."""
    from reference_seal_backend_tpu_torch.ops.cuda import nvcc

    tool = Path(nvcc.find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed ({proc.returncode}): {proc.stderr[-2000:]}")
    ops, inside = [], False
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            inside = "behz_floor_sk_kernel" in line
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            ops.append(m.group(1))
    if "EXIT" not in ops:
        fail("sass_mix: no behz_floor_sk_kernel with an EXIT in the SASS")
    ops = ops[: len(ops) - ops[::-1].index("EXIT")]
    mix = Counter(op for op in ops if op != "NOP")
    if BRANCHES & set(mix):
        fail(f"sass_mix: the kernel branches: {dict(mix)}")
    return mix


def behz_bound(mix, cols, k):
    """Least milliseconds of the fused kernel over ``cols`` coefficient
    columns of ``k`` q limbs (``BEHZ_SHAPE``'s note)."""
    words = (k + (k + 2)) + k  # q and Bsk rows in, q rows out
    at = lambda count, rate: cols * count / rate * 1e3
    parts = {
        "bytes_ms": cols * words * 4 / PEAK_BYTES_PER_S * 1e3,
        "issue_ms": at(sum(mix.values()), 2 * PEAK_INT32_OPS_PER_S),
        "fma_pipe_ms": at(sum(mix[op] for op in FMA_PIPE), PEAK_INT32_OPS_PER_S),
        "alu_pipe_ms": at(sum(mix[op] for op in ALU_PIPE), PEAK_INT32_OPS_PER_S),
    }
    by = max(parts, key=parts.get)
    return {"bound_ms": parts[by], "bound_by": by[: -len("_ms")], **parts}


def phase_behz_times(device):
    """``behz_times``: the fused BEHZ kernel at ``BEHZ_SHAPE``: device time
    of a CUDA graph's replay over two inputs that together exceed the L2,
    the same launched call by call from the host (``eager_ms``), and the
    plain steps it replaces (``plain_ms``), beside its least time from its
    bytes and its own instruction mix (:func:`sass_mix`)."""
    from reference_seal_backend_tpu_torch.evaluator import behz
    from reference_seal_backend_tpu_torch.ops.cuda import behz as behz_cuda
    from reference_seal_backend_tpu_torch.utils.kernel_bench import (
        random_residues,
        time_eager_ms,
        time_graph_ms,
    )

    t0 = time.perf_counter()
    ctx, tb = behz_context(device)
    primes = ctx.data_primes + ctx.bsk_primes
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    xs = [random_residues(gen, primes, BEHZ_SHAPE[:2], 0, len(primes), ctx.n, 1,
                          device) for _ in range(2)]
    fused = lambda v: behz_cuda.floor_sk(v, tb)
    mix = sass_mix(behz_cuda._libs[ctx.L]._name)
    cols = math.prod(BEHZ_SHAPE[:2]) * ctx.n
    row = {
        "shape": list(BEHZ_SHAPE),
        "l2_cold": 2 * xs[0].numel() * 4 >= L2_BYTES,
        "ms": time_graph_ms(fused, xs, 20),
        "eager_ms": time_eager_ms(fused, xs, 20),
        "plain_ms": time_eager_ms(lambda v: behz.floor_sk_plain(tb, v), xs, 4),
        **behz_bound(mix, cols, ctx.L),
        "instructions_per_column": sum(mix.values()),
        "fma_pipe_per_column": sum(mix[op] for op in FMA_PIPE),
        "alu_pipe_per_column": sum(mix[op] for op in ALU_PIPE),
        "sass": dict(mix.most_common()),
    }
    emit({"phase": "behz_times", "method": "CUDA graph replay, CUDA events",
          "seconds": time.perf_counter() - t0, **row})
    return row


def compare_with_eager(bench, loaded, result):
    """``main_path``'s ``after_timing``: on the benchmark the runner just
    timed, ``operate`` replayed and with its stages eager
    (``utils/profile_operate.py:replayed_and_eager``).  Fails unless the
    runner's last timed result, read after those later calls, equals the
    eager one integer for integer; unless a replay moves no launch counter
    and the eager ``operate`` launches as many NTT kernels in every call;
    and unless the traces of the replay count the NTT kernels the eager
    ``operate`` launched (``EXPECTED_LAUNCHES`` where given; none under
    ``sp_shard``).  Sharded results are compared block for block."""
    from reference_seal_backend_tpu_torch.utils import profile_operate
    from reference_seal_backend_tpu_torch.utils.staging import same_result

    t0 = time.perf_counter()
    name = bench.descriptor.name
    eager, row = profile_operate.replayed_and_eager(bench, loaded)
    if not same_result(result, eager):
        fail(f"{name}: the replayed result differs from the eager one")
    rep, eag = row["replayed"], row["eager"]
    counted = eag["ntt_launches_per_operate"]
    if rep["ntt_launches_per_operate"] != [0] or len(counted) != 1:
        fail(f"{name}: NTT launches counted per operate: replayed "
             f"{rep['ntt_launches_per_operate']}, eager {counted}")
    # an sp benchmark's transforms are the sharded ones: no K1 / K2
    want = 0 if bench.sp_shard else EXPECTED_LAUNCHES.get(name, counted[0])
    if not rep["ntt_launches"] == eag["ntt_launches"] == counted[0] == want:
        fail(f"{name}: NTT kernels per operate: traces of the replay "
             f"{rep['ntt_launches_each']} (all kernels "
             f"{rep['kernel_launches_each']}), of the eager operate "
             f"{eag['ntt_launches_each']} ({eag['kernel_launches_each']}), "
             f"launched eagerly {counted[0]}, expected {want}; pad records "
             f"seen {rep['pads_seen_each']}, {eag['pads_seen_each']}")
    return {"equal_to_eager": True, "tolerance": 0, **row,
            "seconds": time.perf_counter() - t0}


def phase_main_path(device):
    from reference_seal_backend_tpu_torch.engine import runner
    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
    from reference_seal_backend_tpu_torch.ops.cuda import behz as behz_cuda
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
    from reference_seal_backend_tpu_torch.utils import staging

    # more than one timed iteration of each descriptor of the later slices,
    # so that the launch counts of two iterations can be compared
    per = {name: {"min_test_time_ms": 300.0} for name in MATMULT + LOGREG + BFV}
    per[LOGREG[1]] = {"params": {"batch_size": LOGREG_BATCH},
                      "min_test_time_ms": 1500.0}
    with tempfile.TemporaryDirectory() as report_dir:
        ntt_mod.call_log = {}  # every view the kernels are handed
        ntt_cuda.reset_launches()
        behz_cuda.reset_launches()
        staging.reset_counts()
        t0 = time.perf_counter()
        results = runner.run_all(
            TWENTY, seed=SEED, sample_size=8, report_dir=report_dir,
            per_benchmark=per, device=device, after_timing=compare_with_eager,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**ntt_cuda.launches, **behz_cuda.launches}
        graphs = dict(staging.counts)
        views, ntt_mod.call_log = ntt_mod.call_log, None
    failed = [r.name for r in results if not r.passed]
    if failed or len(results) != len(TWENTY):
        fail(f"main path: failed benchmarks {failed}: "
             f"{[r.error for r in results if r.error]}")
    for r in results:
        if "eltwise" not in r.name and r.inspected["replayed"]["ntt_launches"] <= 0:
            fail(f"{r.name}: operate ran no NTT kernel")
        # the timed operates only replay: the wrapper launches nothing then
        if r.ntt_launches_per_operate or not r.ntt_launches_steady:
            fail(f"{r.name}: the timed operates launched NTT kernels from "
                 f"Python ({r.ntt_launches_per_operate} at most)")
        if r.name in MATMULT + LOGREG + BFV and r.iterations < 2:
            fail(f"{r.name}: one timed iteration only")
        if not (r.notes["graph_captures"] and r.notes["graph_replays"]):
            fail(f"{r.name}: operate's stages were not captured and replayed: "
                 f"{r.notes}")
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
    # the graphs (and keys) of a finished benchmark are not held any more
    first_held = {}
    for r in results:
        ctx = (r.description["scheme"], r.description["poly_modulus_degree"])
        base = first_held.setdefault(ctx, r.held_before_bytes)
        if r.held_before_bytes - base > HELD_GROWTH_BYTES:
            fail(f"{r.name}: {r.held_before_bytes} bytes held on the card before "
                 f"it began, {base} before the first descriptor of {ctx}")
    benchmarks = {
        r.name: {
            "operate_ms": r.wall_ms_operate,
            "results_per_s": r.ops_per_sec,
            "iterations": r.iterations,
            # from the traces of a replay; the wrapper's count in the warm-up
            # (each stage eager once, then its capture) and per timed operate
            "ntt_launches_per_replay": r.inspected["replayed"]["ntt_launches"],
            "ntt_launches_warmup": r.ntt_launches_warmup,
            "ntt_launches_timed_operate": r.ntt_launches_per_operate,
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
        "wall_s": wall, "launches": launches, "graphs": graphs,
        "offline_samples": {"eltwise, dot product (both schemes)": [8, 8],
                            "logistic regression": [1, 1, LOGREG_BATCH]},
        "benchmarks": benchmarks,
        "staged_vs_eager": {r.name: r.inspected for r in results},
    })
    return launches, views, benchmarks


def _seven_steps_timed(engine, desc, params, inputs, devices):
    """One benchmark through the seven steps: set-up seconds, a warm-up
    ``operate`` (its stages warmed up, captured and replayed once), ``SP_TIMED``
    timed ones (NTT kernel launches and graph replays of each), the decode,
    and the peak device memory on each of ``devices`` over it all (with what
    the process held there before it began).  Returns the benchmark, its
    loaded operands, the last timed result, the decode and the row."""
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
    from reference_seal_backend_tpu_torch.utils import staging

    held = []
    for dev in devices:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held.append(torch.cuda.memory_allocated(dev))
    t0 = time.perf_counter()
    bench = engine.create_benchmark(desc, params)
    loaded = bench.block(bench.load(bench.encrypt(bench.encode(inputs))))
    setup_s = time.perf_counter() - t0
    result = bench.block(bench.operate(loaded))
    ms, launched, replays = [], [], []
    for _ in range(SP_TIMED):
        before = sum(ntt_cuda.launches.values())
        replayed = staging.counts["replays"]
        t = time.perf_counter()
        result = bench.block(bench.operate(loaded))
        ms.append((time.perf_counter() - t) * 1e3)
        launched.append(sum(ntt_cuda.launches.values()) - before)
        replays.append(staging.counts["replays"] - replayed)
    out = bench.decode(bench.decrypt(bench.store(result)))
    row = {"operate_ms": statistics.median(ms), "operate_ms_each": ms,
           "ntt_kernel_launches_per_operate": launched,
           "graph_replays_per_operate": replays, "setup_s": setup_s,
           "peak_device_bytes": [torch.cuda.max_memory_allocated(d) for d in devices],
           "held_before_bytes": held}
    return bench, loaded, result, out, row


def sp_transform_checks(views, device):
    """The sharded transforms (``parallel/sharded_ntt.py``, plain local
    stages) against K1 and K2 on every shape ``views`` noted, at each mesh
    size of ``SP_SIZES``: ``from_sp_layout(fwd(x))`` equal to ``plan.fwd``
    for both epilogues, ``inv`` equal to ``plan.inv``; inputs in [0, 2p)
    (the lazy range both take).  Fails on any difference."""
    from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
    from reference_seal_backend_tpu_torch.parallel import sharded_ntt
    from reference_seal_backend_tpu_torch.utils.device import mesh_devices
    from reference_seal_backend_tpu_torch.utils.kernel_bench import random_residues

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    meshes = {k: mesh_mod.make_mesh(k, ("sp",), shape=(k,),
                                    devices=mesh_devices(device, k))
              for k in SP_SIZES}
    worst = {"ntt_fwd": 0, "ntt_inv": 0}
    shapes, done, checked = {}, set(), 0
    for (pid, name, shape, lo, _), plan in views.items():
        if (pid, name, shape, lo) in done:
            continue
        done.add((pid, name, shape, lo))
        key = f"N={plan.n} limbs={len(plan.primes)}"
        shapes.setdefault(key, {"ntt_fwd": 0, "ntt_inv": 0})[name] += 1
        lead, nl = shape[:-3], shape[-3]
        dense = random_residues(gen, plan.primes, lead, lo, nl, plan.n,
                                2 if plan.lazy else 1, device)
        mat = dense.reshape(*lead, nl, plan.n1, plan.n2)
        spec = (None,) * (len(shape) - 1) + ("sp",)
        for mesh in meshes.values():
            if name == "ntt_fwd":
                xm = mesh_mod.ShardedTensor.distribute(mat, mesh, spec)
                pairs = [(sharded_ntt.fwd(plan, xm, mesh, lo=lo, epilogue=e).gather()
                          .transpose(-1, -2).reshape(dense.shape),
                          plan.fwd(dense, lo=lo, epilogue=e)) for e in (True, False)]
            else:
                xt = mesh_mod.ShardedTensor.distribute(mat.transpose(-1, -2), mesh, spec)
                pairs = [(sharded_ntt.inv(plan, xt, mesh, lo=lo).gather()
                          .reshape(dense.shape), plan.inv(dense, lo=lo))]
            for got, want in pairs:
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                worst[name] = max(worst[name], err)
                checked += 1
                if err:
                    fail(f"sp_path: the sharded {name} disagrees with the kernel "
                         f"(max_abs_err {err}) at N={plan.n} shape={shape} lo={lo}")
    # the BFV multiply's tensor product over q u Bsk: 4 + 6 limbs
    if not any(v["ntt_fwd"] and v["ntt_inv"]
               for key, v in shapes.items() if key.endswith(" limbs=10")):
        fail(f"sp_path: the BEHZ plan's transforms were not noted: {shapes}")
    return {"shapes": shapes, "comparisons": checked, "mesh_sizes": list(SP_SIZES),
            "max_abs_err": worst, "tolerance": 0,
            "seconds": time.perf_counter() - t0}


def sp_transform_cost(device):
    """What one sharded transform costs against the kernel: at the shape of
    a registered dot product's key-switch lift (36 polynomials of N = 8192:
    ``[1, 1, 6, 6, 8192]``), the sharded ``fwd`` / ``inv`` at each mesh size
    of ``SP_SIZES`` and K1 / K2 on the same data — host milliseconds per call
    (median of 5, each ending in a synchronise), and from one profiled call
    (``profile_operate.profile_run``: a padded trace, retried where the
    tracer dropped its first records) the CUDA kernels launched and their
    device time."""
    from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
    from reference_seal_backend_tpu_torch.parallel import sharded_ntt
    from reference_seal_backend_tpu_torch.schemes.params import make_ckks_context
    from reference_seal_backend_tpu_torch.utils import profile_operate
    from reference_seal_backend_tpu_torch.utils.device import mesh_devices
    from reference_seal_backend_tpu_torch.utils.kernel_bench import random_residues

    plan = make_ckks_context(8192, mult_depth=2, device=device).plan
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    lead, nl = (1, 1, 6), 6
    dense = random_residues(gen, plan.primes, lead, 0, nl, plan.n, 1, device)
    mat = dense.reshape(*lead, nl, plan.n1, plan.n2)
    spec = (None,) * (len(lead) + 2) + ("sp",)

    def measure(call):
        call()
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        traced = profile_operate.profile_run(lambda: (call(), torch.cuda.synchronize()))
        return {"host_ms": statistics.median(ms),
                "cuda_kernel_launches": traced["kernel_launches"],
                "device_busy_ms": traced["device_busy_ms"],
                "cuda_kernel_launches_each": traced["kernel_launches_each"]}

    rows = {"shape": [*lead, nl, plan.n],
            "K1": measure(lambda: plan.fwd(dense)),
            "K2": measure(lambda: plan.inv(dense))}
    for k in SP_SIZES:
        mesh = mesh_mod.make_mesh(k, ("sp",), shape=(k,), devices=mesh_devices(device, k))
        xm = mesh_mod.ShardedTensor.distribute(mat, mesh, spec)
        xt = mesh_mod.ShardedTensor.distribute(mat.transpose(-1, -2), mesh, spec)
        rows[f"sharded_fwd_sp{k}"] = measure(lambda: sharded_ntt.fwd(plan, xm, mesh))
        rows[f"sharded_inv_sp{k}"] = measure(lambda: sharded_ntt.inv(plan, xt, mesh))
    return rows


def sp_staged_vs_eager(bench, loaded, result, replays, name, k):
    """An sp run's stages against their eager runs, on the benchmark its
    seven steps just ran: fails unless each stage was captured once and
    every timed ``operate`` replayed each of its stages (``replays``: the
    graph replays of each; ``result``, the last timed one, is a replay),
    unless ``result``, read after the later
    calls, equals the eager stages' integer for integer, block for block,
    and unless the collectives credited to a replayed ``operate`` equal
    those of an eager one.  Returns the row: replayed and eager
    ``operate_ms`` (median of ``SP_TIMED`` each, in turns), busy time and
    kernels of one traced replay (no NTT kernel: the sp path launches no
    K1 / K2), the graphs' warm-up and capture seconds, the collectives."""
    from reference_seal_backend_tpu_torch.parallel import sp_eval
    from reference_seal_backend_tpu_torch.utils import profile_operate, staging

    t0 = time.perf_counter()
    notes = bench.run_notes(loaded)
    captures = [s.captures for s in bench._stages]
    if not captures or captures != [1] * len(captures) or notes["stages"] != "staged" \
            or replays != [len(captures)] * SP_TIMED:
        fail(f"sp_path: {name} at sp = {k}: stages captured {captures} "
             f"({notes['stages']}), not each once, or timed operates replayed "
             f"{replays}, not every stage each")
    eager, cmp = profile_operate.replayed_and_eager(
        bench, loaded, rounds=SP_TIMED, traced=("replayed",))
    if not staging.same_result(result, eager):
        fail(f"sp_path: {name} at sp = {k}: the replayed result differs from "
             f"the eager stages'")
    rep = cmp["replayed"]
    if rep["ntt_launches"] != 0 or cmp["eager"]["ntt_launches_per_operate"] != [0]:
        fail(f"sp_path: {name} at sp = {k}: NTT kernels in a replay "
             f"{rep['ntt_launches_each']} (pads seen {rep['pads_seen_each']}), "
             f"launched eagerly {cmp['eager']['ntt_launches_per_operate']}")
    replayed = sp_eval.collective_stats(lambda: bench.block(bench.operate(loaded)))
    with staging.eager(bench):
        eager_stats = sp_eval.collective_stats(lambda: bench.block(bench.operate(loaded)))
    if replayed != eager_stats:
        fail(f"sp_path: {name} at sp = {k}: collectives credited to a replay "
             f"{replayed}, of the eager stages {eager_stats}")
    return {
        "stage_calls_per_operate": len(bench._stages),
        "replayed_operate_ms": rep["operate_ms"],
        "eager_operate_ms": cmp["eager"]["operate_ms"],
        "replayed_over_eager": cmp["replayed_over_eager"],
        "replayed_operate_ms_each": rep["operate_ms_each"],
        "eager_operate_ms_each": cmp["eager"]["operate_ms_each"],
        "replayed_event_ms": rep["event_ms"],
        "eager_event_ms": cmp["eager"]["event_ms"],
        "replay_device_busy_ms": rep["device_busy_ms"],
        "replay_kernels": rep["kernel_launches"],
        "replay_kernels_each": rep["kernel_launches_each"],
        "replay_ntt_kernels": rep["ntt_launches"],
        "replay_idle_share": rep["idle_share"],
        "replay_top_kernels": rep["top_kernels"][:3],
        "graph_warmup_s": notes["graph_warmup_s"],
        "graph_capture_s": notes["graph_capture_s"],
        "graph_captures": notes["graph_captures"],
        "graph_replays": notes["graph_replays"],
        "equal_to_eager": True, "tolerance": 0,
        "collectives_per_operate": replayed,
        "collectives_equal_to_eager": True,
        "seconds": time.perf_counter() - t0,
    }


def phase_sp_path(device):
    """``sp_path``: ``SP_PATH`` flat and at every mesh size of ``SP_SIZES``,
    decodes equal to the flat run's, each sp run's stages replayed and held
    against their eager runs (:func:`sp_staged_vs_eager`), then
    :func:`sp_transform_checks`.  The NTT launch counts are set to 0 just
    before each sp run (its seven steps and that comparison) and read just
    after; the flat runs'
    launches are not among them.  Returns the sp runs' launches summed and
    the transforms' worst errors."""
    import numpy as np

    from reference_seal_backend_tpu_torch.engine import runner
    from reference_seal_backend_tpu_torch.engine.descriptor import Scheme
    from reference_seal_backend_tpu_torch.engine.registry import Engine
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
    from reference_seal_backend_tpu_torch.parallel import sharded_ntt, sp_eval
    from reference_seal_backend_tpu_torch.utils import staging
    from reference_seal_backend_tpu_torch.utils.device import (
        VIRTUAL_DEVICES_ENV,
        mesh_devices,
    )

    t0 = time.perf_counter()
    k_max = max(SP_SIZES)
    virtual = torch.cuda.device_count() < k_max
    saved = os.environ.get(VIRTUAL_DEVICES_ENV)
    if virtual:
        os.environ[VIRTUAL_DEVICES_ENV] = str(k_max)
    try:
        engine = Engine(device)
        benchmarks, mesh_of = {}, {}
        launches = {name: 0 for name in ntt_cuda.launches}
        sharded_ntt.call_log = {}
        for name in SP_PATH:
            desc = engine.find(name)
            inputs, truth = runner.gen_inputs(
                desc, dict(desc.default_params), np.random.default_rng(SEED), 1, 1)
            flat_bench, _, _, flat_out, flat_row = _seven_steps_timed(
                engine, desc, None, inputs, [device])
            flat_bench.release_graphs()
            tol = 0.0 if desc.scheme is Scheme.BFV else runner.CKKS_ATOL[desc.workload]
            err = cleartext_error(desc, flat_out, truth())
            if err > tol:
                fail(f"sp_path: {name} flat: result off the cleartext by {err}")
            rows = {"flat": dict(flat_row, max_abs_err_vs_cleartext=err)}
            for k in SP_SIZES:
                torch.cuda.synchronize()
                ntt_cuda.reset_launches()
                staging.reset_counts()
                bench, loaded, result, out, row = _seven_steps_timed(
                    engine, desc, {"sp_shard": k}, inputs,
                    list(dict.fromkeys(mesh_devices(device, k))))
                if not isinstance(bench.ev, sp_eval.SpEvaluator) or \
                        bench.describe().get("sp_shard") != str(k):
                    fail(f"sp_path: {name} at sp_shard {k} did not run sharded")
                if len(out) != len(flat_out) or not all(
                        np.array_equal(a, b) for a, b in zip(out, flat_out)):
                    fail(f"sp_path: {name} at sp = {k}: the decode differs from "
                         f"the flat run's")
                row.update(sp_staged_vs_eager(
                    bench, loaded, result, row["graph_replays_per_operate"], name, k))
                torch.cuda.synchronize()
                row["ntt_kernel_launches"] = dict(ntt_cuda.launches)
                row["graphs"] = dict(staging.counts)
                bench.release_graphs()
                for kname, n in ntt_cuda.launches.items():
                    launches[kname] += n
                row["equal_to_flat"] = True
                rows[f"sp{k}"] = row
                mesh_of[k] = [str(d) for d in bench.ev.mesh.devices.flat]
            benchmarks[name] = rows
        views, sharded_ntt.call_log = sharded_ntt.call_log, None
        transforms = sp_transform_checks(views, device)
        cost = sp_transform_cost(device)
    finally:
        if saved is None:
            os.environ.pop(VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = saved
    for name, count in launches.items():
        if count <= 0:
            fail(f"sp_path never launched {name}")
    emit({"phase": "sp_path", "virtual": virtual,
          "visible_cards": torch.cuda.device_count(), "devices": mesh_of,
          "benchmarks": benchmarks, "launches": launches,
          "transforms_vs_kernels": transforms, "one_transform": cost,
          "seconds": time.perf_counter() - t0})
    return launches, transforms["max_abs_err"]


def _in_turns(calls, rounds):
    """Host milliseconds of each of ``calls`` (name -> call, each ending in
    a synchronise), taken in turns after one warm-up call each: the median
    of ``rounds`` calls of each, and every call's."""
    for call in calls.values():
        call()
        torch.cuda.synchronize()
    ms = {how: [] for how in calls}
    for i in range(rounds):
        order = list(calls) if i % 2 == 0 else list(calls)[::-1]
        for how in order:
            t = time.perf_counter()
            calls[how]()
            torch.cuda.synchronize()
            ms[how].append((time.perf_counter() - t) * 1e3)
    return {how: statistics.median(v) for how, v in ms.items()}, ms


def _limb_case(name, chain, flat_args, placed_args, unplace, device, want_lo,
               mesh, placed_chain=None):
    """One case of ``limb_path``: the flat chain timed, then the placed
    chain (``placed_chain``, default ``chain``) eagerly and staged over
    ``mesh`` (``staging.stage``: one CUDA graph, the counterpart of the
    ``jax.jit`` the JAX package applies to it), each result's integers equal
    to the flat ones, staged and eager timed in turns, the collectives of
    each counted (the staged call's credited by its graph, equal to the
    eager ones), its K1 / K2 launches and transforms counted (counts from 0
    before the placed runs, read after; a transform that did not launch a
    kernel fails), the NTT kernels of a replay counted in its padded traces
    (equal to one eager chain's launches), its views noted and its peak
    device memory.  Returns the row, the flat result, the launches of the
    placed runs and the views they noted."""
    import threading

    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
    from reference_seal_backend_tpu_torch.parallel import sp_eval
    from reference_seal_backend_tpu_torch.utils import profile_operate, staging

    placed_chain = placed_chain or chain
    want = chain(*flat_args)
    flat_ms, flat_each = _in_turns({"flat": lambda: chain(*flat_args)}, LIMB_TIMED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    chain(*flat_args)
    torch.cuda.synchronize()
    flat_peak = torch.cuda.max_memory_allocated(device) - held
    staged = staging.stage(placed_chain, f"limb_path.{name}", threading.Lock(), mesh)
    if not isinstance(staged, staging.StagedCall):
        fail(f"limb_path ({name}): the chain over {mesh} was not staged")

    calls = {"ntt_fwd": 0, "ntt_inv": 0, "plain": 0}
    plan_cls = ntt_mod.NttPlan
    saved = {k: getattr(plan_cls, k) for k in ("fwd", "inv", "fwd_plain", "inv_plain")}

    def counted(name, key):
        def call(self, x, *a, **k):
            calls[key] += 1
            return saved[name](self, x, *a, **k)
        return call

    def same(got):
        return torch.equal(got.data, want.data) and \
            (got.level, got.scale) == (want.level, want.scale)

    plan_cls.fwd, plan_cls.inv = counted("fwd", "ntt_fwd"), counted("inv", "ntt_inv")
    plan_cls.fwd_plain = counted("fwd_plain", "plain")
    plan_cls.inv_plain = counted("inv_plain", "plain")
    ntt_mod.call_log = {}
    before = dict(ntt_cuda.launches)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        got = unplace(placed_chain(*placed_args))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) - held
        if not same(got):
            fail(f"limb_path ({name}): the placed chain's result differs from flat")
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        first = staged(*placed_args)  # warm-up, capture, replay
        torch.cuda.synchronize()
        staged_peak = torch.cuda.max_memory_allocated(device) - held
        ms, each = _in_turns({
            "staged": lambda: staged(*placed_args),
            "eager": lambda: placed_chain(*placed_args)}, LIMB_TIMED)
        if not same(unplace(first)) or not same(unplace(staged(*placed_args))):
            fail(f"limb_path ({name}): the staged chain's result differs from "
                 f"flat and from the eager placed chain")
        stats = sp_eval.collective_stats(lambda: placed_chain(*placed_args))
        credited = sp_eval.collective_stats(lambda: staged(*placed_args))
        if credited != stats:
            fail(f"limb_path ({name}): collectives credited to a replay "
                 f"{credited}, of the eager chain {stats}")
        one = dict(ntt_cuda.launches)
        placed_chain(*placed_args)
        torch.cuda.synchronize()
        warm = {k: ntt_cuda.launches[k] - one[k] for k in one}
        one = dict(ntt_cuda.launches)
        traced = profile_operate.profile_run(
            lambda: (staged(*placed_args), torch.cuda.synchronize()))
        if ntt_cuda.launches != one or traced["ntt_launches"] != sum(warm.values()):
            fail(f"limb_path ({name}): NTT kernels of a replay {traced['ntt_launches_each']} "
                 f"(traces; pads seen {traced['pads_seen_each']}), of an eager chain "
                 f"{warm}; launched by the replays {ntt_cuda.launches}, before {one}")
        launched = {k: ntt_cuda.launches[k] - before[k] for k in before}
        views = ntt_mod.call_log
    finally:
        ntt_mod.call_log = None
        for k, v in saved.items():
            setattr(plan_cls, k, v)
    if calls["plain"] or any(calls[k] != launched[k] for k in launched):
        fail(f"limb_path ({name}): a transform did not launch its kernel: "
             f"calls {calls}, kernel launches {launched}")
    at_lo = {k: sorted({key[5] for key in views if key[1] == k}) for k in launched}
    if want_lo is not None and not all(want_lo in v for v in at_lo.values()):
        fail(f"limb_path ({name}): K1 / K2 not both run at lo={want_lo}: {at_lo}")
    row = {"staged_ms": ms["staged"], "eager_ms": ms["eager"],
           "staged_over_eager": ms["staged"] / ms["eager"],
           "staged_ms_each": each["staged"], "eager_ms_each": each["eager"],
           "flat_ms": flat_ms["flat"], "flat_ms_each": flat_each["flat"],
           "equal_to_flat": True, "staged_equal_to_eager": True,
           "collectives_per_chain": stats, "collectives_credited_to_a_replay": credited,
           "kernel_launches_per_warm_chain": warm,
           "ntt_kernels_per_replay": traced["ntt_launches"],
           "replay_kernels": traced["kernel_launches"],
           "replay_device_busy_ms": traced["device_busy_ms"],
           "graph_warmup_s": staged.warmup_s, "graph_capture_s": staged.capture_s,
           "transform_calls": calls,
           "first_limbs": at_lo, "peak_device_bytes": peak,
           "staged_first_call_peak_device_bytes": staged_peak,
           "flat_peak_device_bytes": flat_peak}
    staged.release()
    return row, want, launched, views


def phase_limb_path(device):
    """``limb_path``: limb-sharded ciphertexts through the plain
    ``Evaluator`` (``parallel/limb.py``) and the process-aware dp×sp mesh,
    on ``LIMB_DEVICES`` virtual devices of the card (cards where they are
    visible), at registered parameters, inputs from ``SEED``: (a) (dp=2,
    limb=2), the CKKS dot product's context, a batch of 2 pairs,
    ``accumulate(rescale(relinearize(multiply)), 100)``, decoded against
    the cleartext dot products; (b) limb = 2, the logistic-regression
    context (G = 2, a digit group straddling the blocks), ``rotate_sum(
    rescale(relinearize(multiply)), range(8))``; (c) ``make_process_mesh(
    sp=2)`` with ``SpEvaluator(batch_axes=("dp",))``, multiply ->
    relinearize -> rescale on (a)'s batch; (e) (b)'s ciphertexts switched
    to ``LIMB_ODD_LEVEL`` limbs, multiply -> relinearize; (d) (a)'s mesh,
    the registered BFV dot product context, a batch of 2 pairs of
    ``LIMB_DOT_N`` integers mod t, ``accumulate(relinearize(multiply),
    100)``, decoded exactly against the cleartext dot products mod t.
    Each placed chain eager and staged (:func:`_limb_case`), every result
    equal to the flat ``Evaluator``'s.  Returns the K1 / K2 launches of the
    placed runs and the views they handed the kernels."""
    import dataclasses

    import numpy as np

    from reference_seal_backend_tpu_torch.engine.registry import Engine
    from reference_seal_backend_tpu_torch.evaluator import composite
    from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
    from reference_seal_backend_tpu_torch.parallel import sp_eval
    from reference_seal_backend_tpu_torch.schemes import bfv, ckks
    from reference_seal_backend_tpu_torch.utils.device import (
        VIRTUAL_DEVICES_ENV,
        mesh_devices,
    )

    t0 = time.perf_counter()
    virtual = torch.cuda.device_count() < LIMB_DEVICES
    saved = os.environ.get(VIRTUAL_DEVICES_ENV)
    if virtual:
        os.environ[VIRTUAL_DEVICES_ENV] = str(LIMB_DEVICES)
    try:
        engine = Engine(device)
        rng = np.random.default_rng(SEED)
        cases, launches, views, setup = {}, {"ntt_fwd": 0, "ntt_inv": 0}, {}, {}
        ungather = lambda ct: dataclasses.replace(ct, data=ct.data.gather())

        # (a) and (c): the registered dot product context
        t = time.perf_counter()
        dot = engine.create_benchmark(engine.find("ckks_dot_product_latency"), None)
        ctx, ev = dot.ctx, dot.ev
        if (ctx.n, ctx.L, ctx.n_special, ctx.digit_group) != (8192, 6, 1, 1):
            fail(f"limb_path: dot context changed: {ctx.n} {ctx.L} "
                 f"{ctx.n_special} {ctx.digit_group}")
        enc = ckks.encoder_for(ctx)
        vals = rng.uniform(-1, 1, (2, 2, LIMB_DOT_N))
        pad = lambda v: np.concatenate([v, np.zeros(ctx.slots - v.size)])
        a, b = (dot.encryptor.encrypt_pt(dataclasses.replace(
            enc.encode(pad(vals[i, 0])),
            data=torch.stack([enc.encode(pad(vals[i, j])).data for j in range(2)])))
            for i in range(2))
        setup["dot"] = time.perf_counter() - t
        mesh = mesh_mod.make_mesh(LIMB_DEVICES, devices=mesh_devices(device, LIMB_DEVICES))
        if mesh.shape != {"dp": 2, "limb": 2}:
            fail(f"limb_path: mesh {mesh.shape}")
        place = lambda c: mesh_mod.shard_ct(c, mesh, n_batch_axes=1,
                                            batch_axes=("dp",), limb_axis="limb")
        dot_chain = lambda x, y: composite.accumulate(
            ev, ev.rescale_to_next(ev.relinearize(ev.multiply(x, y))), LIMB_DOT_N)
        row, want, launched, noted = _limb_case(
            "a", dot_chain, (a, b), (place(a), place(b)), ungather, device, 3, mesh)
        got = dot.decryptor.decrypt(want).real[:, 0]
        err = float(np.abs(got - (vals[0] * vals[1]).sum(axis=-1)).max())
        if err > LIMB_DOT_ATOL:
            fail(f"limb_path (a): decode off the cleartext by {err}")
        row.update(mesh=mesh.shape, max_abs_err_vs_cleartext=err,
                   tolerance=LIMB_DOT_ATOL)
        cases["a_dp2_limb2_dot"] = row
        for k in launches:
            launches[k] += launched[k]
        views.update(noted)

        # (b): the registered logistic-regression context
        t = time.perf_counter()
        lr = engine.create_benchmark(engine.find(LOGREG[0]), None)
        lctx, lev = lr.ctx, lr.ev
        if (lctx.n, lctx.L, lctx.n_special, lctx.digit_group) != (16384, 14, 2, 2):
            fail(f"limb_path: logistic-regression context changed: {lctx.n} "
                 f"{lctx.L} {lctx.n_special} {lctx.digit_group}")
        lenc = ckks.encoder_for(lctx)
        la, lb = (lr.encryptor.encrypt_pt(lenc.encode(rng.uniform(-1, 1, lctx.slots)))
                  for _ in range(2))
        setup["logistic_regression"] = time.perf_counter() - t
        mesh2 = mesh_mod.make_mesh(2, devices=mesh_devices(device, 2))
        place2 = lambda c: mesh_mod.shard_ct(c, mesh2, limb_axis="limb")
        lr_chain = lambda x, y: lev.rotate_sum(
            lev.rescale_to_next(lev.relinearize(lev.multiply(x, y))), list(range(8)))
        row, _, launched, noted = _limb_case(
            "b", lr_chain, (la, lb), (place2(la), place2(lb)), ungather, device, 7,
            mesh2)
        row.update(mesh=mesh2.shape)
        cases["b_limb2_logreg"] = row
        for k in launches:
            launches[k] += launched[k]
        views.update(noted)

        # (e): (b)'s ciphertexts switched to 13 limbs, a level limb = 2 does
        # not divide: replicated over the limb axis by one all-gather each
        odd_chain = lambda x, y: lev.relinearize(lev.multiply(
            lev.mod_switch_to(x, LIMB_ODD_LEVEL), lev.mod_switch_to(y, LIMB_ODD_LEVEL)))
        row, _, launched, noted = _limb_case(
            "e", odd_chain, (la, lb), (place2(la), place2(lb)), ungather, device, 0,
            mesh2)
        row.update(mesh=mesh2.shape, level=LIMB_ODD_LEVEL)
        cases["e_limb2_logreg_odd_level"] = row
        for k in launches:
            launches[k] += launched[k]
        views.update(noted)

        # (d): the registered BFV dot product context on (a)'s mesh, exact
        t = time.perf_counter()
        bdot = engine.create_benchmark(engine.find("bfv_dot_product_latency"), None)
        bctx, bev = bdot.ctx, bdot.ev
        if (bctx.n, bctx.L, bctx.n_special, bctx.digit_group) != (8192, 4, 2, 2):
            fail(f"limb_path: BFV dot context changed: {bctx.n} {bctx.L} "
                 f"{bctx.n_special} {bctx.digit_group}")
        benc = bfv.encoder_for(bctx)
        ints = rng.integers(0, bctx.t, (2, 2, LIMB_DOT_N))
        x, y = (bdot.encryptor.encrypt_pt(dataclasses.replace(
            benc.encode(ints[i, 0]),
            data=torch.stack([benc.encode(ints[i, j]).data for j in range(2)])))
            for i in range(2))
        setup["bfv_dot"] = time.perf_counter() - t
        bfv_chain = lambda x, y: composite.accumulate(
            bev, bev.relinearize(bev.multiply(x, y)), LIMB_DOT_N)
        row, want, launched, noted = _limb_case(
            "d", bfv_chain, (x, y), (place(x), place(y)), ungather, device,
            bctx.L // mesh.shape["limb"], mesh)
        got = bdot.decryptor.decrypt(want)[:, 0].astype(np.int64) % bctx.t
        exact = (ints[0] * ints[1]).sum(axis=-1) % bctx.t
        if not np.array_equal(got, exact):
            fail(f"limb_path (d): decode {got.tolist()} is not the dot products "
                 f"mod t {exact.tolist()}")
        row.update(mesh=mesh.shape, decoded=got.tolist(), exact_mod_t=exact.tolist())
        cases["d_dp2_limb2_bfv_dot"] = row
        for k in launches:
            launches[k] += launched[k]
        views.update(noted)

        # (c): dryrun_multichip step 4, the process-aware dp x sp mesh
        pmesh = mesh_mod.make_process_mesh(
            sp=2, devices=mesh_devices(device, LIMB_DEVICES))
        spe = sp_eval.SpEvaluator(ctx, dot.keys, pmesh, batch_axes=("dp",))
        sp_chain = lambda x, y: spe.rescale_to_next(spe.relinearize(spe.multiply(x, y)))
        flat_chain = lambda x, y: ev.rescale_to_next(ev.relinearize(ev.multiply(x, y)))
        row, _, _, _ = _limb_case(
            "c", flat_chain, (a, b), (spe.shard(a), spe.shard(b)), spe.unshard, device,
            None, pmesh, placed_chain=sp_chain)
        row.update(mesh=pmesh.shape)
        cases["c_dp2_sp2_process_mesh"] = row
    finally:
        if saved is None:
            os.environ.pop(VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = saved
    for key in ("a_dp2_limb2_dot", "b_limb2_logreg", "d_dp2_limb2_bfv_dot",
                "e_limb2_logreg_odd_level"):
        if not all(cases[key]["kernel_launches_per_warm_chain"].values()):
            fail(f"limb_path: {key} launched no K1 or no K2: "
                 f"{cases[key]['kernel_launches_per_warm_chain']}")
    emit({"phase": "limb_path", "virtual": virtual,
          "visible_cards": torch.cuda.device_count(), "cases": cases,
          "launches": launches, "setup_s": setup,
          "seconds": time.perf_counter() - t0})
    return launches, views


def bench_inspect(key, bench, loaded, result):
    """``bench_path``'s ``after_step``: for logistic regression at N = 32768,
    on the benchmark the suite just timed, one eager ``operate`` (its NTT
    launches counted by the wrapper) and a replay traced in padded traces
    (``profile_operate.profile_run``): fails unless the replay launches
    nothing from Python and its traced K1 / K2 kernels equal the eager
    launches.  Returns busy time, idle share and kernels of the replay."""
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
    from reference_seal_backend_tpu_torch.utils import profile_operate, staging

    if key not in BENCH_LOGREG_32768:
        return None
    before = dict(ntt_cuda.launches)
    with staging.eager(bench):
        bench.block(bench.operate(loaded))
    eager = {k: ntt_cuda.launches[k] - before[k] for k in before}
    before = dict(ntt_cuda.launches)
    traced = profile_operate.profile_run(lambda: bench.block(bench.operate(loaded)))
    if ntt_cuda.launches != before or traced["ntt_launches"] != sum(eager.values()) \
            or not all(eager.values()):
        fail(f"bench_path: {key}: NTT kernels of a replay "
             f"{traced['ntt_launches_each']} (traces; pads seen "
             f"{traced['pads_seen_each']}), launched by an eager operate {eager}, "
             f"by the replays {ntt_cuda.launches}, before {before}")
    return {"ntt_kernels_per_replay": traced["ntt_launches"],
            "eager_ntt_launches": eager,
            "replay_kernels": traced["kernel_launches"],
            "replay_device_busy_ms": traced["device_busy_ms"],
            "replay_idle_share": traced["idle_share"],
            "replay_profiled_ms": traced["profiled_operate_ms"],
            "replay_ntt_ms": traced["ntt_ms"],
            "replay_top_kernels": traced["top_kernels"][:3]}


def phase_bench_path(device):
    """``bench_path``: the port's benchmark suite
    (``reference_seal_backend_tpu_torch/bench.py``, the counterpart of the
    JAX package's ``bench.py``) at ``bench.py``'s sizes, every step, with
    ``BENCH_WINDOW_S`` of timed chunks a throughput step each way.  Fails
    unless every gate holds (the suite raises), nothing is skipped, the
    headline and all ten metric keys are present, every step's staged
    result equals its eager one integer for integer, the record names the
    card, and the logistic-regression chains are ``BENCH_DESCRIBE``'s (at
    N = 32768: digit groups of 3, 90 special bits); for logistic
    regression at N = 32768, Latency and Offline b100, decoded within
    ``BENCH_LOGREG_ATOL`` of the cleartext sigmoid, :func:`bench_inspect`.
    The NTT launch counts are set to 0 just before the suite and read just
    after; ``ops/ntt.py:call_log`` notes every view it hands the kernels.
    Returns the launches and the views."""
    from reference_seal_backend_tpu_torch import bench as bench_mod
    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
    from reference_seal_backend_tpu_torch.utils import staging

    t0 = time.perf_counter()
    run = bench_mod.Run(device, window_s=BENCH_WINDOW_S, emit=lambda line: None,
                        after_step=bench_inspect)
    torch.cuda.synchronize()
    ntt_mod.call_log = {}
    ntt_cuda.reset_launches()
    staging.reset_counts()
    try:
        rc = bench_mod.run_suite(run)
    except SystemExit as e:
        fail(f"bench_path: {e}")
    finally:
        torch.cuda.synchronize()
        views, ntt_mod.call_log = ntt_mod.call_log, None
    launches = dict(ntt_cuda.launches)
    graphs = dict(staging.counts)
    record = run.record
    if rc != 0 or record["skipped"]:
        fail(f"bench_path: exit code {rc}, skipped {record['skipped']}")
    values = [record["value"], *record["extras"].values()]
    if set(record["extras"]) != bench_mod.CURRENT_METRIC_KEYS or \
            not all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in values):
        fail(f"bench_path: headline {record['value']}, extras {record['extras']}")
    dev = record["device"]
    if dev["platform"] != "gpu" or not dev["name"] or not dev["power_limit"] \
            or dev["count"] < 1:
        fail(f"bench_path: the record's device {dev}")
    steps = record["steps"]
    if set(steps) != bench_mod.CURRENT_METRIC_KEYS | {bench_mod.HEADLINE} or \
            not all(s["equal_to_eager"] for s in steps.values()):
        fail(f"bench_path: steps {sorted(steps)} not each equal to its eager run")
    for key, got in record["describe"].items():
        if got != BENCH_DESCRIBE[int(got["poly_modulus_degree"])]:
            fail(f"bench_path: {key}: chain {got}")
    if len(record["describe"]) != 4:
        fail(f"bench_path: describe {sorted(record['describe'])}")
    for key in BENCH_LOGREG_32768:
        step = steps[key]
        if not step["max_abs_err"] <= BENCH_LOGREG_ATOL or not step["inspected"] \
                or step["graph_captures"] < 1:
            fail(f"bench_path: {key}: {step}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"bench_path never launched {name}")
    emit({"phase": "bench_path", "bench": record, "launches": launches,
          "graphs": graphs, "views_noted": len(views),
          "seconds": time.perf_counter() - t0})
    return launches, views


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
    """Milliseconds to build from nothing what a BFV benchmark's set-up
    builds on the card (``evaluator/behz.py:tables_for``): the NTT plan over
    q u Bsk, and the tables around it with the fused kernel's constants
    (its library already loaded)."""
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
    from reference_seal_backend_tpu_torch.utils import profile_operate, staging

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
        times (a first call, then two warm ones), and warm calls traced
        (``profile_operate.profile_run``).  Returns the loaded handle, the
        decoded JSON, per operate its NTT launches as the wrapper counted
        them, milliseconds and graph replays, and the traces' row."""
        h = abi("rsbtpu_encode", bid, json.dumps(
            [np.asarray(x).tolist() for x in inputs]).encode())
        loaded = abi("rsbtpu_load", bid, abi("rsbtpu_encrypt", bid, h))
        per_call, ms, replays = [], [], []
        for _ in range(3):
            before = sum(ntt_cuda.launches.values())
            replayed = staging.counts["replays"]
            t0 = time.perf_counter()
            out = abi("rsbtpu_operate", bid, loaded)
            ms.append((time.perf_counter() - t0) * 1e3)
            per_call.append(sum(ntt_cuda.launches.values()) - before)
            replays.append(staging.counts["replays"] - replayed)

        def warm_call():
            lib.rsbtpu_handle_destroy(abi("rsbtpu_operate", bid, loaded))
            torch.cuda.synchronize()

        traced = profile_operate.profile_run(warm_call)
        h = abi("rsbtpu_decrypt", bid, abi("rsbtpu_store", bid, out))
        return loaded, native.take_string(lib, abi("rsbtpu_decode", bid, h)), \
            per_call, ms, replays, traced

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
        want_launches = main_benchmarks[name]["ntt_launches_per_replay"]
        bid = abi("rsbtpu_benchmark_create", eid, name.encode(), b"")
        loaded, abi_json, per_call, _, replays, traced = seven_steps(bid, inputs)
        # the first call warms its stage up and captures it (the wrapper
        # counts both); every call replays, and a replay launches nothing
        # from Python: its kernels are counted in the traces
        if per_call[0] <= 0 or per_call[1:] != [0, 0] or not all(replays):
            fail(f"capi_path: {name}: NTT launches per rsbtpu_operate "
                 f"{per_call}, graph replays {replays}")
        if traced["ntt_launches"] != want_launches:
            fail(f"capi_path: {name}: a warm rsbtpu_operate ran "
                 f"{traced['ntt_launches_each']} NTT kernels (traces; pad "
                 f"records seen {traced['pads_seen_each']}), the main path's "
                 f"replay {want_launches}")
        if json.loads(abi_json) != py_json:
            fail(f"capi_path: {name}: the ABI decoded {abi_json[:200]}, the "
                 f"Python path {py_json}"[:600])
        err = cleartext_error(desc, json.loads(abi_json), truth())
        if err > tolerance(desc):
            fail(f"capi_path: {name}: result off the cleartext by {err}")
        registered[name] = {
            "ntt_launches_counted_per_operate": per_call,
            "graph_replays_per_operate": replays,
            "ntt_launches_traced_warm": traced["ntt_launches_each"],
            "main_path_ntt_launches_per_replay": want_launches,
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
            _, abi_json, per_call, ms, replays, traced = seven_steps(bid, inputs)
            if name == "bfv_eltwise_mult_latency":
                bfv_ctx = bench.ctx
            lib.rsbtpu_benchmark_destroy(bid)
            err = cleartext_error(desc, json.loads(abi_json), truth())
            if err > tolerance(desc):
                fail(f"capi_path: {name} at {params}: result off the "
                     f"cleartext by {err}")
            # the first call warms up and captures (logistic regression
            # also encodes its plaintext constants); the warm ones replay
            if per_call[1:] != [0, 0] or not all(replays[1:]):
                fail(f"capi_path: {name} at {params}: NTT launches per "
                     f"rsbtpu_operate {per_call}, graph replays {replays}: "
                     f"the warm calls did not only replay")
            ran = traced["ntt_launches"]
            if ran is None:
                fail(f"capi_path: {name} at {params}: no whole trace: pad "
                     f"records seen {traced['pads_seen_each']}")
            if "eltwise" not in name and ran <= 0:
                fail(f"capi_path: {name} at {params}: operate ran no NTT "
                     f"kernel")
            if "bfv_eltwise_mult" in name and ran != BEHZ_SWEEPS:
                fail(f"capi_path: {name}: {traced['ntt_launches_each']} NTT "
                     f"kernels per operate (traces), not the BEHZ multiply's "
                     f"{BEHZ_SWEEPS}")
            at_harness_sizes[name] = {
                "params": params, "samples": [b0, b1],
                "ntt_launches_counted_per_operate": per_call,
                "ntt_launches_traced_warm": traced["ntt_launches_each"],
                "graph_replays_per_operate": replays,
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
    from reference_seal_backend_tpu_torch.ops.cuda import behz as behz_cuda
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
    with ThreadPoolExecutor(3) as pool:
        nvcc = pool.submit(ntt_cuda.build)
        nvcc_behz = pool.submit(behz_cuda.build, BFV_K)
        gxx = pool.submit(native.build)
        seconds, behz_s, built = nvcc.result(), nvcc_behz.result(), gxx.result()
    emit({"phase": "build",
          "sources": ["reference_seal_backend_tpu_torch/csrc/ntt.cu",
                      "reference_seal_backend_tpu_torch/csrc/behz.cu",
                      "reference_seal_backend_tpu_torch/csrc/capi_shim.cpp",
                      "native/src/native_harness.cpp"],
          "specialised_log_n": list(ntt_cuda.KERNEL_LOG_NS),
          "seconds": {"ntt.cu": seconds, f"behz.cu (k = {BFV_K})": behz_s,
                      "capi_shim.cpp + native_harness.cpp": built.seconds,
                      "wall": time.perf_counter() - t0}})

    def behz_launched(phase, *args):
        """``phase(*args)`` and the fused BEHZ kernel's launches in it."""
        before = behz_cuda.launches["behz_floor_sk"]
        return phase(*args), behz_cuda.launches["behz_floor_sk"] - before

    worst = phase_kernels(device)
    worst["behz_floor_sk"] = phase_behz_checks(device)
    launches, views, main_benchmarks = phase_main_path(device)
    (sp_launches, sp_worst), sp_behz = behz_launched(phase_sp_path, device)
    (limb_launches, limb_views), limb_behz = behz_launched(phase_limb_path, device)
    (bench_launches, bench_views), bench_behz = behz_launched(phase_bench_path, device)
    (capi_launches, capi_views), capi_behz = behz_launched(
        phase_capi_path, built, device, main_benchmarks)
    on_path = phase_path_views({"main_path": views, "capi_path": capi_views,
                                "limb_path": limb_views,
                                "bench_path": bench_views}, device)
    worst.update({k: max(worst[k], on_path[k], sp_worst[k]) for k in on_path})
    timed = phase_kernel_times(device)
    behz_timed = phase_behz_times(device)

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
            "sp_path_launches": sp_launches[name],
            "limb_path_launches": limb_launches[name],
            "bench_path_launches": bench_launches[name],
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
    ] + [{
        "name": "behz_floor_sk",
        "route": "cuda",
        "source": "reference_seal_backend_tpu_torch/csrc/behz.cu",
        "replaces": "no TPU kernel: the JAX package runs these BEHZ steps as "
                    "XLA elementwise code (reference_seal_backend_tpu/"
                    "evaluator/behz.py)",
        "launches": launches["behz_floor_sk"],
        "sp_path_launches": sp_behz,
        "limb_path_launches": limb_behz,
        "bench_path_launches": bench_behz,
        "capi_path_launches": capi_behz,
        "max_abs_err": worst["behz_floor_sk"],
        "ms": behz_timed["ms"],
        "plain_ms": behz_timed["plain_ms"],
        "bound_ms": behz_timed["bound_ms"],
        "bound_by": behz_timed["bound_by"],
        "library_ms": None,  # no PyTorch call computes a BEHZ floor mod q
        "shape": behz_timed["shape"],
        "eager_ms": behz_timed["eager_ms"],
    }]})
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
