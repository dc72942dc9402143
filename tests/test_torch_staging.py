"""The staging of ``operate`` (``utils/staging.py``, ``models/base.py:
graph_with_keys``), the port's counterpart of the JAX package's
``jit_with_keys``, on the CPU at N <= 2048: the cache key, every workload's
stages at the JAX package's ``jit_with_keys`` sites, a staged call on the CPU
equal to its function, the runner's ``after_timing`` on the benchmark it
timed, ``sp_shard`` never capturing, the capture guard, and the card as
``convert.py``'s default.  No JAX call: what ``operate`` computes is held against the JAX
package by the other ``test_torch_*`` files, which run through the same
stages.  The captures and replays themselves run on the card only
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

At most seven test items, so that xdist's ``--dist loadfile`` hands the
file out after the suite's long pole.  Cold wall time alone: CHANGES.md."""

import gc
import weakref
from dataclasses import replace

import numpy as np
import pytest
import torch

from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.engine import runner
from reference_seal_backend_tpu_torch.engine.registry import Engine
from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext
from reference_seal_backend_tpu_torch.utils import staging

import torch_port_util  # noqa: F401  (one PyTorch thread per worker)

SMALL = {"poly_modulus_degree": 1024, "sec_level": 0}
MATRICES = {"rows_m0": 2, "cols_m0": 3, "cols_m1": 2}
# (descriptor, params, samples of each operand): one of each workload
WORKLOADS = {
    "ckks_eltwise_mult_latency": (dict(SMALL, n=8), (1, 1)),
    "ckks_dot_product_offline": (dict(SMALL, n=8), (2, 2)),
    "bfv_eltwise_mult_latency": (dict(SMALL, n=8), (1, 1)),
    "ckks_matrix_multiply_latency": (dict(SMALL, **MATRICES), (1, 1)),
    "ckks_matrix_multiply_cipherbatchaxis_latency": (dict(SMALL, **MATRICES), (1, 1)),
    "ckks_matrix_multiply_row_latency": (dict(SMALL, **MATRICES), (1, 1)),
    # a batch of 5 in chunks of 3: the dots stage runs twice, on one shape
    "ckks_logistic_regression_poly_d3_offline": (
        dict(SMALL, batch_size=5, dots_chunk=3), (1, 5)),
}


@pytest.fixture(scope="module")
def built():
    """Each workload of ``WORKLOADS`` built on the CPU, its operands
    loaded: ``{name: (bench, loaded)}``."""
    engine, out = Engine("cpu"), {}
    for name, (params, (b0, b1)) in WORKLOADS.items():
        desc = engine.find(name)
        bench = engine.create_benchmark(desc, params)
        inputs, _ = runner.gen_inputs(
            desc, bench.params, np.random.default_rng(7), b0, b1)
        out[name] = (bench, bench.load(bench.encrypt(bench.encode(inputs))))
    return out


def test_signature_is_what_jit_keys_a_call_on():
    """Shape, dtype, strides, level, scale and ``is_ntt`` each give a new
    key; equal arguments the same key and their tensor leaves in order."""
    x = torch.zeros((2, 3, 8), dtype=torch.int32)
    ct = Ciphertext(x, level=3, scale=2.0 ** 40)
    key, leaves = staging.signature((ct, Plaintext(x[0], level=3), 5))
    assert staging.signature((Ciphertext(x.clone(), 3, 2.0 ** 40),
                              Plaintext(x[0].clone(), level=3), 5))[0] == key
    assert len(leaves) == 2 and leaves[0] is x
    changed = [
        replace(ct, data=torch.zeros((2, 3, 4), dtype=torch.int32)),  # shape
        replace(ct, data=x.to(torch.int64)),                           # dtype
        replace(ct, data=x.transpose(0, 1).contiguous().transpose(0, 1)),  # strides
        replace(ct, level=2),
        replace(ct, scale=2.0 ** 41),
        replace(ct, is_ntt=False),
    ]
    keys = {staging.signature((c, Plaintext(x[0], level=3), 5))[0] for c in changed}
    assert len(keys) == len(changed) and key not in keys
    assert staging.signature((ct, Plaintext(x[0], level=3), 6))[0] != key
    with pytest.raises(TypeError, match="staged call takes"):
        staging.signature((object(),))


def test_every_workload_operates_through_its_stages(built, monkeypatch):
    """``operate`` goes through ``StagedCall``s at the JAX package's
    ``jit_with_keys`` sites: one stage for element-wise, dot product and the
    three matrix-multiply packings, and for logistic regression the dots
    stage once per chunk, then collapse and sigmoid."""
    called = []
    plain_call = staging.StagedCall.__call__

    def spy(self, *args):
        called.append(self.name.split(".")[-1])
        return plain_call(self, *args)

    monkeypatch.setattr(staging.StagedCall, "__call__", spy)
    for name, (bench, loaded) in built.items():
        called.clear()
        bench.operate(loaded)
        stages = {k for k, v in vars(bench).items() if isinstance(v, staging.StagedCall)}
        if "logistic" in name:
            assert stages == {"_stage_dots", "_stage_collapse", "_stage_sigmoid"}
            assert bench.dots_chunks(5) == (3, 2)
            assert called == ["_dots_impl", "_dots_impl", "_collapse_impl",
                              "_sigmoid_impl"]
        else:
            assert stages == {"_op_graph"}, name
            assert called == ["_operate_impl"], name
        assert [s.name.split(".")[0] for s in bench._stages] == [name] * len(stages)


def test_a_staged_call_on_the_cpu_is_the_function(built):
    """On the CPU a stage runs its function directly: ``operate`` equals the
    eager stages' result integer for integer, no graph is captured or
    replayed, and the launch counters do not move."""
    staging.reset_counts()
    launched = dict(ntt_cuda.launches)
    for name, (bench, loaded) in built.items():
        got = bench.operate(loaded)
        with staging.eager(bench):
            assert not any(isinstance(v, staging.StagedCall) for v in vars(bench).values())
            want = bench.operate(loaded)
        assert isinstance(bench._stages[0], staging.StagedCall)
        ct, ref = got.payload, want.payload
        assert (ct.level, ct.scale, ct.is_ntt) == (ref.level, ref.scale, ref.is_ntt), name
        assert torch.equal(ct.data, ref.data), name
        assert bench.run_notes(loaded)["graph_captures"] == 0
    assert staging.counts == {"captures": 0, "replays": 0}
    assert ntt_cuda.launches == launched


def test_after_timing_sees_the_benchmark_the_runner_timed(monkeypatch):
    """The runner's ``after_timing`` is called once, after the timed loop,
    with the live benchmark, its loaded operands and the last timed result
    (which equals the eager stages' result); what it returns is the run's
    ``inspected``, and the graphs are released after it.  On the CPU no
    launch counter moves, in the warm-up or the timed loop."""
    seen, released = [], []

    def after_timing(bench, loaded, result):
        assert bench._stages and not released
        with staging.eager(bench):
            want = bench.operate(loaded)
        seen.append(torch.equal(result.payload.data, want.payload.data))
        return {"equal_to_eager": seen[-1]}

    monkeypatch.setattr("reference_seal_backend_tpu_torch.models.base."
                        "HEBenchmark.release_graphs",
                        lambda self: released.append(self.descriptor.name))
    res = runner.run_all(["ckks_dot_product_latency"], device="cpu", verbose=False,
                         params=dict(SMALL, n=8), min_test_time_ms=0.0,
                         after_timing=after_timing)
    assert res[0].passed, res[0].error
    assert seen == [True] and res[0].inspected == {"equal_to_eager": True}
    assert released == ["ckks_dot_product_latency"]
    assert (res[0].ntt_launches_warmup, res[0].ntt_launches_per_operate) == (0, 0)


def test_sp_shard_never_captures():
    """Under ``sp_shard`` the stages run eagerly by an explicit branch: no
    ``StagedCall`` exists, so nothing is ever captured.  Neither kind of
    benchmark forms a reference cycle with its stages: the last reference
    going frees it and its keys (and on the card its graphs)."""
    engine = Engine("cpu")
    desc = engine.find("ckks_eltwise_mult_latency")
    bench = engine.create_benchmark(desc, dict(SMALL, n=8, sp_shard=2))
    assert bench._stages == []
    assert not any(isinstance(v, staging.StagedCall) for v in vars(bench).values())
    inputs, truth = runner.gen_inputs(desc, bench.params, np.random.default_rng(3), 1, 1)
    staging.reset_counts()
    out = bench.decode(bench.decrypt(bench.store(
        bench.operate(bench.load(bench.encrypt(bench.encode(inputs)))))))
    np.testing.assert_allclose(out[0], truth()[0], atol=5e-5, rtol=0)
    assert staging.counts == {"captures": 0, "replays": 0}
    assert bench.run_notes(None)["graph_replays"] == 0
    flat = engine.create_benchmark(desc, dict(SMALL, n=8))
    refs = [weakref.ref(x) for x in (bench, bench.keys, flat, flat.keys)]
    gc.disable()
    try:
        del bench, flat
        assert [r() for r in refs] == [None] * 4
    finally:
        gc.enable()


def test_capture_guard_and_release(built):
    """A stage called while a capture of the same benchmark holds the guard
    raises (the JAX package's single-trace guard); ending the benchmark
    drops its graphs."""
    bench, loaded = built["ckks_dot_product_offline"]
    a, b = loaded.payload
    with bench._capture_guard:
        with pytest.raises(RuntimeError, match="one capture at a time"):
            bench._op_graph(a, b)
    bench._op_graph(a, b)  # released: runs again
    stage = bench._op_graph
    stage._entries["a signature"] = "its graph"
    bench.release_graphs()
    assert stage._entries == {}


def test_convert_puts_state_on_the_card_unless_asked_for_the_cpu(built):
    """``convert.py`` resolves ``device=None`` as every entry point does:
    the card, which raises where there is none; ``device="cpu"`` is the
    CPU."""
    bench, loaded = built["ckks_eltwise_mult_latency"]
    keys = convert.keyset_to_numpy(bench.keys)
    ct = loaded.payload[0]
    data = convert.to_numpy(ct)
    on_cpu = convert.keyset_from_numpy(keys, device="cpu")
    assert torch.equal(on_cpu.secret_ntt, bench.keys.secret_ntt)
    assert convert.ciphertext_from_numpy(data, ct.level, ct.scale, device="cpu").data.is_cpu
    calls = (lambda: convert.keyset_from_numpy(keys),
             lambda: convert.ciphertext_from_numpy(data, ct.level, ct.scale),
             lambda: convert.plaintext_from_numpy(data[0], ct.level, ct.scale),
             lambda: convert.switch_key_from_numpy(keys["relin"]))
    for call in calls:
        if torch.cuda.is_available():
            assert call() is not None
        else:
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                call()
