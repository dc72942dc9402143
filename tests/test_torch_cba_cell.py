"""The BFV matrix multiply of the cipher-batch-axis packing as a benchmark
cell (``perf_bench/configs/bfv_matmult_cba_n8192.json``), on the CPU at
N = 2048 with 128-bit enforcement off and 2 x 3 . 3 x 2 matrices: the
port through the harness's own path (``perf_bench/system.py``) against the
plain reference, the counters of one ``operate`` (``utils/counters.py``)
and their crediting per replay, the least-time reckoning
(``perf_bench/bfv_roofline.py``), the NTT guard's transforms, one whole
run of the cell from files, and the multiply's plain steps on the CPU and
on the limb path (the fused kernel of ``ops/cuda/behz.py`` is the card's).

No JAX and nothing of the JAX package: the reference is the plain one of
the benchmark.  At most seven test items (xdist's ``--dist loadfile``
hands files out largest test count first)."""

from __future__ import annotations

import json
import math
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from perf_bench import bfv_roofline, cell as cell_mod, control, traffic
from perf_bench.conftest import HERE, TINY_N, make_root, run_cell
from perf_bench.references import matrix_multiply
from perf_bench.roofline import PEAK_BYTES_PER_S, PEAK_INT32_OPS_PER_S
from perf_bench.system import System
from reference_seal_backend_tpu_torch.evaluator import behz
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
from reference_seal_backend_tpu_torch.ops import modops, ntt as ntt_mod
from reference_seal_backend_tpu_torch.ops.cuda import behz as behz_cuda
from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext
from reference_seal_backend_tpu_torch.schemes.params import make_bfv_context
from reference_seal_backend_tpu_torch.utils import counters, staging

# at these sizes intra-op threads gain nothing, and beside the suite's
# other workers a thread pool per process oversubscribes the cores
torch.set_num_threads(1)

CONFIG = "bfv_matmult_cba_n8192"
R0, C0, C1 = 2, 3, 2
SEED = 2147483711
#: the polynomials the operand side runs on: the distinct operands' D = 24,
#: not the 4P = 48 of the operands broadcast to the products' shape
D_OPERANDS = 2 * (R0 * C0 + C0 * C1)


def tiny_config() -> dict:
    config = json.loads((HERE / "configs" / f"{CONFIG}.json").read_text())
    config["params"] = dict(config["params"], rows_m0=R0, cols_m0=C0, cols_m1=C1,
                            poly_modulus_degree=TINY_N, sec_level=0)
    return config


@pytest.fixture(scope="module")
def cba():
    """The tiny cell's system on the CPU, two input sets drawn by the
    traffic generator and loaded: ``(system, sets, loaded)``."""
    config = tiny_config()
    mix = {"category": "latency", "input_sets": 2}
    system = System("cpu", config, "latency", [1, 1], SEED)
    sets = traffic.input_sets(config, mix, SEED)
    return system, sets, [system.load(s) for s in sets]


def expected_steps(ctx) -> Counter:
    """One ``operate``'s counts, from the shapes: ``P`` products over ``k``
    q limbs and ``kb`` Bsk primes, of ``D`` distinct operand polynomials
    (two a ciphertext of M0 and of M1), on which the operand side runs,
    ``R`` relinearized outputs."""
    P, R, k, n = R0 * C0 * C1, R0 * C1, ctx.L, ctx.n
    D = D_OPERANDS
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
        ("relinearize", R, k, k, n, 4, ctx.n_special, ctx.dig_count(k)): 1,
    })


def operand_polys(counts: Counter) -> list:
    """The polynomials the operand side's inverse sweep received, one
    entry a noted run (``behz.operand_polys``)."""
    return [key[1] for key, v in counts.items()
            if key[0] == "behz.operand_polys" for _ in range(v)]


def test_cba_equals_the_plain_reference(cba):
    system, sets, loaded = cba
    for inputs, handle in zip(sets, loaded):
        m0, m1 = inputs
        # the traffic's draws sum far inside t / 2: no entry wraps
        assert np.abs(m0 @ m1).max() < system.bench.ctx.t // 2
        got = system.answers(system.block(system.operate(handle)))
        want = matrix_multiply.answers(inputs, "bfv")
        assert len(got) == 1 and want[0].shape == (R0, C1)
        np.testing.assert_array_equal(np.asarray(got[0]).astype(np.int64), want[0])


def test_one_operate_counts_its_steps(cba):
    system, _, loaded = cba
    counters.reset()
    system.operate(loaded[0])
    assert counters.counts == expected_steps(system.bench.ctx)
    assert operand_polys(counters.counts) == [D_OPERANDS]


class _NoGraph:
    """A captured graph's stand-in on the CPU: the replay launches nothing."""

    def replay(self):
        pass


def test_a_replay_credits_what_its_capture_noted(cba):
    system, _, loaded = cba
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
    assert counters.counts == Counter({k: 2 * v for k, v in want.items()})
    assert operand_polys(steps) == [D_OPERANDS]
    assert operand_polys(counters.counts) == [D_OPERANDS] * 2


def test_the_transforms_noted_are_those_run(cba, monkeypatch):
    # the NTT guard (perf_bench/trace.py:ntt_disagreement) holds the
    # transforms noted in NttPlan.fwd / inv against the NTT kernels traced:
    # every transform the call runs has to pass through them
    system, _, loaded = cba
    ran = {"ntt_fwd": 0, "ntt_inv": 0}
    for name, plain in (("ntt_fwd", "fwd_plain"), ("ntt_inv", "inv_plain")):
        def counted(plan, *args, _f=getattr(ntt_mod.NttPlan, plain), _n=name, **kwargs):
            ran[_n] += 1
            return _f(plan, *args, **kwargs)
        monkeypatch.setattr(ntt_mod.NttPlan, plain, counted)
    launched = dict(ntt_cuda.launches)
    with system.transforms() as noted, system.eager():
        system.operate(loaded[1])
    for name in ran:  # on a card the kernels launch; on the CPU the plain ones run
        ran[name] += ntt_cuda.launches[name] - launched[name]
    assert ran == {name: sum(t[0] == name for t in noted) for name in ran}
    # the four sweeps of the multiply, and the relinearization's
    assert ran["ntt_fwd"] >= 2 and ran["ntt_inv"] >= 2


def test_the_least_time_is_the_hand_count(monkeypatch):
    n = 8
    fwd = n // 2 * 3 * 7 - n // 2 * 2 + 4 * n  # 108 instructions a transform
    inv = n // 2 * 3 * 7 + 5 * n               # 124
    # the tensor product of 2 products (1 x 2 ciphertexts broadcast) over 3
    # rows: the 6 distinct operand polynomials' 18 rows read and forward,
    # 6 x 3 rows written and inverse; 3 products and 2 differences a
    # product row, 1 sum an operand ciphertext's row (3 of them)
    tensor = ("behz.tensor_product", 2, 3, 3, n, 8, 6)
    ops = n * (18 * 5 + (12 + 9) * 3) + 18 * fwd + 18 * inv
    assert ops == 5400
    t_bytes, t_ops = 36 * n * 4 / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS_PER_S
    assert bfv_roofline.step_bound_ms(tensor) == pytest.approx(max(t_bytes, t_ops) * 1e3)
    # the broadcast copies a program may make (4 polynomials a product)
    # are not the call's work: counted, they would raise the bound
    assert bfv_roofline.step_bound_ms(tensor[:6] + (8,)) > bfv_roofline.step_bound_ms(tensor)
    # a relinearization of 1 output at level 2 over 1 special prime and 2
    # digits: 3 targets; 5 rows of data and 2 x 2 x 3 of the key's
    key = ("relinearize", 1, 2, 2, n, 4, 1, 2)
    assert bfv_roofline.step_work(key) == {
        "rows": 10, "key_rows": 12, "products": 2 + 6 + 12 + 2 * (1 + 2 + 4),
        "sums": 0 + 6 + 2 * 2 + 2 * 2, "fwd": 6 + 4, "inv": 2 + 2}
    assert bfv_roofline.step_bound_ms(("bfv_multiply", 2, 3, 3, n, 4)) == 0.0
    # one call's bound from the registry, over its operate calls
    counts = Counter({("operate",): 2, tensor: 2, ("bfv_multiply", 2, 3, 3, n, 4): 2})
    assert bfv_roofline.call_bound_ms(counts) == pytest.approx(bfv_roofline.step_bound_ms(tensor))
    record = {"trace": {"calls": 4, "busy_s": 4 * 2 * bfv_roofline.step_bound_ms(tensor) / 1e3}}
    monkeypatch.setattr(counters, "counts", counts)
    assert bfv_roofline.bfv_mult_roofline(record) == pytest.approx(50.0)
    # a program without the registry (an older commit): nothing to read
    monkeypatch.delitem(sys.modules, bfv_roofline.COUNTERS)
    assert bfv_roofline.bfv_mult_roofline(record) is None


def test_the_cell_runs_from_files(tmp_path):
    root = make_root(tmp_path)
    config = dict(tiny_config(), name="tiny_cba")
    (root / "pb_tiny" / "configs" / "tiny_cba.json").write_text(json.dumps(config))
    (root / "pb_tiny" / "limits" / "tiny_cba.latency.json").write_text(
        (HERE / "limits" / f"{CONFIG}.latency.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_cba", "source": "tiny",
                             "file": "pb_tiny/configs/tiny_cba.json",
                             "reduced": ["poly_modulus_degree"], "why": "CPU test"})
    bench["workloads"].append({"name": "tiny_cba.latency", "config": "tiny_cba",
                               "traffic": "latency", "chips": 1, "why": "CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, result, err = run_cell(["--workload", "tiny_cba.latency", "--seed", str(SEED),
                                "--seconds", "0.2", "--device", "cpu", "--root", str(root)])
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["max_abs_gap"]["value"] == 0
    assert result["checks"]["answers_missing"]["value"] == 0
    assert {"operate_ms", "setup_s"} <= set(result["metrics"])
    # the control: the reference in float16 in the program's place
    out = control.control(cell_mod.load(root, "tiny_cba.latency"), SEED)
    assert out["dtype"] == "float16" and out["correct"] is False
    assert math.isfinite(result["metrics"]["operate_ms"]["value"])


def test_the_cpu_and_the_limb_path_run_the_plain_steps(monkeypatch):
    # the fused kernel is the card's: a CPU tensor, flat or in limb blocks,
    # takes the plain floor and Shenoy-Kumaresan steps and launches nothing
    ctx = make_bfv_context(TINY_N, sec_level=0, device="cpu")
    gen = torch.Generator().manual_seed(11)
    cols = [torch.randint(0, p, (2, 2, TINY_N), generator=gen, dtype=torch.int64)
            for p in ctx.data_primes]
    data = modops.narrow(torch.stack(cols, dim=-2))
    # b's one ciphertext broadcasts against a's two: the flat multiply and
    # the limb blocks convert the three distinct operands, not four copies
    a, b = (Ciphertext(data=d, level=ctx.L) for d in (data, data[1:]))

    def refused(*args):
        raise AssertionError("the fused BEHZ kernel was called off the card")

    ran = Counter()

    def counted(name, f):
        def run(*args, **kwargs):
            ran[name] += 1
            return f(*args, **kwargs)
        monkeypatch.setattr(behz, name, run)

    monkeypatch.setattr(behz_cuda, "floor_sk", refused)
    for name in ("_fbc_q_to_bsk", "_fbc_partial", "floor_bsk", "_sk_to_q"):
        counted(name, getattr(behz, name))
    launched = dict(behz_cuda.launches)
    counters.reset()
    flat = behz.bfv_multiply(ctx, a, b)
    assert ran == Counter(_fbc_q_to_bsk=1, _fbc_partial=1, floor_bsk=1, _sk_to_q=1)
    assert not any(key[0] == "behz.fused_floor_sk" for key in counters.counts)
    assert operand_polys(counters.counts) == [6]  # 2 x (2 + 1), not 4P = 8
    ran.clear()
    mesh = mesh_mod.make_mesh(2, devices=[torch.device("cpu")] * 2)
    place = lambda c: mesh_mod.shard_ct(c, mesh, n_batch_axes=1, batch_axes=(None,),
                                        limb_axis="limb")
    placed = Evaluator(ctx, None).multiply(place(a), place(b))
    assert ran == Counter(_fbc_partial=2, floor_bsk=2, _sk_to_q=2)  # one a block
    assert torch.equal(placed.data.gather(torch.device("cpu")), flat.data)
    assert behz_cuda.launches == launched
