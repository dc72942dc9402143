"""The BFV matrix multiply of the default packing (MatMultVal) as a
benchmark cell (``perf_bench/configs/bfv_matmult_val_n8192.json``), on the
CPU at N = 2048 with 128-bit enforcement off and 2 x 3 . 3 x 2 matrices:
the port through the harness's own path (``perf_bench/system.py``) against
the numpy reference and the plain PyTorch model of the packing
(``plain_torch_matmult_val.py``), slot for slot; the counters of one
``operate`` (``utils/counters.py``), the hoisted ``rotate_sum`` among them,
and their crediting per replay; the least-time reckoning
(``perf_bench/rotate_roofline.py``); the NTT guard's transforms; one whole
run of the cell from files; and the ``rotate_sum`` note on the limb path.

No JAX and nothing of the JAX package.  At most seven test items (xdist's
``--dist loadfile`` hands files out largest test count first)."""

from __future__ import annotations

import json
import math
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import plain_torch_matmult_val as plain
from perf_bench import bfv_roofline, rotate_roofline, traffic
from perf_bench.conftest import HERE, TINY_N, make_root, run_cell
from perf_bench.references import matrix_multiply
from perf_bench.roofline import PEAK_BYTES_PER_S, PEAK_INT32_OPS_PER_S
from perf_bench.system import System, descriptor_name
from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
from reference_seal_backend_tpu_torch.utils import counters, staging

# at these sizes intra-op threads gain nothing, and beside the suite's
# other workers a thread pool per process oversubscribes the cores
torch.set_num_threads(1)

CONFIG = "bfv_matmult_val_n8192"
R0, C0, C1 = 2, 3, 2
SEED = 2147483789


def tiny_config() -> dict:
    config = json.loads((HERE / "configs" / f"{CONFIG}.json").read_text())
    config["params"] = dict(config["params"], rows_m0=R0, cols_m0=C0, cols_m1=C1,
                            poly_modulus_degree=TINY_N, sec_level=0)
    return config


@pytest.fixture(scope="module")
def val():
    """The tiny cell's system on the CPU, two input sets drawn by the
    traffic generator and loaded: ``(system, sets, loaded)``."""
    config = tiny_config()
    assert descriptor_name(config, "latency") == "bfv_matrix_multiply_latency"
    mix = {"category": "latency", "input_sets": 2}
    system = System("cpu", config, "latency", [1, 1], SEED)
    sets = traffic.input_sets(config, mix, SEED)
    return system, sets, [system.load(s) for s in sets]


def rotate_sum_key(ctx, R: int) -> tuple:
    """The note of one ``rotate_sum`` of ``R`` ciphertexts at the top level
    over steps 0 .. C0 - 1: C0 - 1 rotations and one identity."""
    k = ctx.L
    return ("rotate_sum", R, k, k, ctx.n, 4, C0 - 1, 1, ctx.n_special, ctx.dig_count(k))


def expected_steps(ctx) -> Counter:
    """One ``operate``'s counts, from the shapes: ``P`` = r0 x c1 products
    over ``k`` q limbs and ``kb`` Bsk primes, of ``D`` distinct operand
    polynomials (the r0 rows of M0 and the c1 columns of M1, two a
    ciphertext), ``P`` relinearizations, one rotate_sum over the ``P``."""
    P, k, n = R0 * C1, ctx.L, ctx.n
    D = 2 * (R0 + C1)
    kb = len(ctx.bsk_primes)
    return Counter({
        ("operate",): 1,
        ("bfv_multiply", P, k, k, n, 4): 1,
        ("behz.operand_polys", D, k, k, n, 8): 1,
        ("behz.to_coeff", D, k, k, n, 8): 1,
        ("behz.conv_q_bsk_mtilde", D, k, kb, n, 8): 1,
        ("behz.tensor_product", P, k + kb, k + kb, n, 8, D): 1,
        ("behz.floor_q_bsk", 3 * P, k, kb, n, 8): 1,
        ("behz.sk_bsk_q", 3 * P, kb, k, n, 8): 1,
        ("behz.to_ntt", 3 * P, k, k, n, 4): 1,
        ("relinearize", P, k, k, n, 4, ctx.n_special, ctx.dig_count(k)): 1,
        rotate_sum_key(ctx, P): 1,
    })


def test_val_equals_both_references_in_every_slot(val):
    system, sets, loaded = val
    bench = system.bench
    t, n = bench.ctx.t, bench.ctx.n
    for inputs, handle in zip(sets, loaded):
        m0, m1 = inputs
        # the traffic's draws sum far inside t / 2: no entry wraps
        assert np.abs(m0 @ m1).max() < t // 2
        result = system.block(system.operate(handle))
        got = system.answers(result)
        want = matrix_multiply.answers(inputs, "bfv")
        assert len(got) == 1 and want[0].shape == (R0, C1)
        np.testing.assert_array_equal(np.asarray(got[0]).astype(np.int64), want[0])
        np.testing.assert_array_equal(plain.answers(m0, m1, n, t).numpy(), want[0])
    # every slot of every decrypted output, not slot 0 alone: the rotation
    # direction, and the wrap at the end of each batching row of n / 2
    model = plain.slot_vectors(m0, m1, n, t)
    slots = list(bench.decrypt_each(bench.store(result).payload, (R0, C1)))
    assert len(slots) == R0 * C1
    for (i, j), vec in zip(np.ndindex(R0, C1), slots):
        np.testing.assert_array_equal(np.asarray(vec, dtype=np.int64), model[i, j].numpy())
    assert (model[..., n // 2 - C0 + 1: n // 2] != 0).any()  # the wrapped sums


def test_one_operate_counts_its_steps(val):
    system, _, loaded = val
    counters.reset()
    system.operate(loaded[0])
    assert counters.counts == expected_steps(system.bench.ctx)


class _NoGraph:
    """A captured graph's stand-in on the CPU: the replay launches nothing."""

    def replay(self):
        pass


def test_a_replay_credits_what_its_capture_noted(val):
    system, _, loaded = val
    stage = system.bench._op_graph
    m0, m1 = loaded[0].payload
    counters.reset()
    # the warm-up notes nothing; the capture notes one call's steps into
    # the graph's own counter, not into the registry
    staging._run_noting(stage.fn, (m0, m1), None, None)
    steps = Counter()
    out = staging._run_noting(stage.fn, (m0, m1), mesh_mod.zero_counts(), steps)
    assert not counters.counts
    outputs = []
    staging._walk(out, outputs, {})
    entry = staging._Entry(_NoGraph(), [], out, outputs, mesh_mod.zero_counts(), steps)
    stage._replay(entry)
    stage._replay(entry)
    want = expected_steps(system.bench.ctx)
    del want[("operate",)]
    assert steps == want
    assert counters.counts == Counter({k: 2 * v for k, v in want.items()})
    key = rotate_sum_key(system.bench.ctx, R0 * C1)
    assert [k for k in counters.counts if k[0] == "rotate_sum"] == [key]


def test_the_transforms_noted_are_those_run(val, monkeypatch):
    # the NTT guard (perf_bench/trace.py:ntt_disagreement) holds the
    # transforms noted in NttPlan.fwd / inv against the NTT kernels traced:
    # every transform the call runs, rotate_sum's lift and mod-down among
    # them, has to pass through them
    system, _, loaded = val
    ran = {"ntt_fwd": 0, "ntt_inv": 0}
    for name, plain_fn in (("ntt_fwd", "fwd_plain"), ("ntt_inv", "inv_plain")):
        def counted(plan, *args, _f=getattr(ntt_mod.NttPlan, plain_fn), _n=name, **kwargs):
            ran[_n] += 1
            return _f(plan, *args, **kwargs)
        monkeypatch.setattr(ntt_mod.NttPlan, plain_fn, counted)
    launched = dict(ntt_cuda.launches)
    with system.transforms() as noted, system.eager():
        system.operate(loaded[1])
    for name in ran:  # on a card the kernels launch; on the CPU the plain ones run
        ran[name] += ntt_cuda.launches[name] - launched[name]
    assert ran == {name: sum(t[0] == name for t in noted) for name in ran}
    # one special prime at this size: the multiply's two forward and two
    # inverse sweeps, the relinearization's lift (1 inverse, 2 forward) and
    # its mod-down of kb and of ka (1 + 1 each), rotate_sum's lift and its
    # one mod-down of both halves
    assert ran == {"ntt_fwd": 2 + 4 + 3, "ntt_inv": 2 + 3 + 2}


def test_the_least_time_is_the_hand_count(monkeypatch):
    n = 8
    fwd = n // 2 * 3 * 7 - n // 2 * 2 + 4 * n  # 108 instructions a transform
    inv = n // 2 * 3 * 7 + 5 * n               # 124
    # one ciphertext at level 2 over 1 special prime and 2 digits (3
    # targets), rotated twice, one identity step
    key = ("rotate_sum", 1, 2, 2, n, 4, 2, 1, 1, 2)
    work = {
        "rows": 8,                  # c0, c1 in (2 x 2 rows), 2 x 2 out
        "key_rows": 24,             # 2 rotations x (b, a) x 2 digits x 3 targets
        # the lift 2 + 2 x 3, 2 rotations x (b, a) x 2 digits x 3 targets,
        # the mod-down of b and a: 2 x (1 + 1 x 2 + 2 x 2)
        "products": 8 + 24 + 14,
        # the lift's group sums 0, the digit sums 2 x 2 x 1 x 3, the
        # accumulation 2 x 1 x 3, the rolled c0s 1 x 2, the mod-down's 2 x 2,
        # kb onto c0 2, the identity onto c0 and c1 2 x 2
        "sums": 0 + 12 + 6 + 2 + 4 + 2 + 4,
        "fwd": 6 + 4, "inv": 2 + 2,
    }
    assert rotate_roofline.step_work(key) == work
    ops = n * (46 * 5 + 30 * 3) + 10 * fwd + 4 * inv
    assert ops == 4136
    t_bytes, t_ops = 32 * n * 4 / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS_PER_S
    assert rotate_roofline.step_bound_ms(key) == pytest.approx(max(t_bytes, t_ops) * 1e3)
    # identity steps alone: the input summed, read and written once
    assert rotate_roofline.step_work(key[:6] + (0, 3) + key[8:]) == {
        "rows": 8, "key_rows": 0, "products": 0, "sums": 2 * 2 * 2, "fwd": 0, "inv": 0}
    assert rotate_roofline.step_work(("relinearize", 1, 2, 2, n, 4, 1, 2)) is None
    # one call: the BFV steps by bfv_roofline, the rotate_sum by this file
    relin = ("relinearize", 1, 2, 2, n, 4, 1, 2)
    counts = Counter({("operate",): 2, relin: 2, key: 2})
    both = bfv_roofline.step_bound_ms(relin) + rotate_roofline.step_bound_ms(key)
    assert rotate_roofline.call_bound_ms(counts) == pytest.approx(both)
    record = {"trace": {"calls": 4, "busy_s": 4 * 2 * both / 1e3}}
    monkeypatch.setattr(counters, "counts", counts)
    assert rotate_roofline.bfv_matmult_roofline(record) == pytest.approx(50.0)
    # a program that notes no rotate_sum (an older commit), or holds no
    # registry at all: nothing to read
    monkeypatch.setattr(counters, "counts", Counter({("operate",): 2, relin: 2}))
    assert rotate_roofline.bfv_matmult_roofline(record) is None
    monkeypatch.delitem(sys.modules, bfv_roofline.COUNTERS)
    assert rotate_roofline.bfv_matmult_roofline(record) is None


def test_the_cell_runs_from_files(tmp_path):
    root = make_root(tmp_path)
    config = dict(tiny_config(), name="tiny_val")
    (root / "pb_tiny" / "configs" / "tiny_val.json").write_text(json.dumps(config))
    (root / "pb_tiny" / "limits" / "tiny_val.latency.json").write_text(
        (HERE / "limits" / f"{CONFIG}.latency.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_val", "source": "tiny",
                             "file": "pb_tiny/configs/tiny_val.json",
                             "reduced": ["poly_modulus_degree"], "why": "CPU test"})
    bench["workloads"].append({"name": "tiny_val.latency", "config": "tiny_val",
                               "traffic": "latency", "chips": 1, "why": "CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, result, err = run_cell(["--workload", "tiny_val.latency", "--seed", str(SEED),
                                "--seconds", "0.2", "--device", "cpu", "--root", str(root)])
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["max_abs_gap"]["value"] == 0
    assert result["checks"]["answers_missing"]["value"] == 0
    assert {"operate_ms", "setup_s"} <= set(result["metrics"])
    assert math.isfinite(result["metrics"]["operate_ms"]["value"])


def test_the_limb_path_notes_the_same_rotate_sum(val):
    # one note a call, before the flat / limb dispatch: the same key for
    # the ciphertexts whole and in two limb blocks, and the same result
    system, _, loaded = val
    ev, ctx = system.bench.ev, system.bench.ctx
    ct = loaded[0].payload[0]  # the r0 rows of M0, [R0, 2, k, N]
    steps = list(range(C0))
    counters.reset()
    flat = ev.rotate_sum(ct, steps)
    flat_counts = Counter(counters.counts)
    mesh = mesh_mod.make_mesh(2, devices=[torch.device("cpu")] * 2)
    placed_ct = mesh_mod.shard_ct(ct, mesh, n_batch_axes=1, batch_axes=(None,),
                                  limb_axis="limb")
    counters.reset()
    placed = ev.rotate_sum(placed_ct, steps)
    assert counters.counts == flat_counts == Counter({rotate_sum_key(ctx, R0): 1})
    assert torch.equal(placed.data.gather(torch.device("cpu")), flat.data)
