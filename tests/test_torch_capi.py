"""The port's C-ABI bridge (``reference_seal_backend_tpu_torch/engine/capi.py``)
against the JAX package's (``reference_seal_backend_tpu/engine/capi.py``),
in process, on the CPU: the same ids-and-JSON surface, the same seven steps
on the same seeded inputs, the same descriptors, the same error sentinels.

Tolerances: decoded BFV results and every residue of ``operate``'s result
exactly equal; decoded CKKS results within 1e-9 (the host float64 decode),
and against cleartext at the runner's 5e-5."""

import json

import numpy as np
import pytest
import torch

import torch_port_util as tpu  # noqa: F401  (one PyTorch thread per worker)
from reference_seal_backend_tpu.engine import capi as jcapi
from reference_seal_backend_tpu_torch.engine import capi as tcapi
from reference_seal_backend_tpu_torch.engine import runner as trunner
from reference_seal_backend_tpu_torch.engine.descriptor import Scheme

TINY = {"poly_modulus_degree": 2048, "n": 64, "sec_level": 0}


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv(tcapi.DEVICE_ENV, "cpu")


def _seven_steps(capi, eid, name, inputs_json):
    """Run the pipeline through ``capi``'s ids; (operate's result handle id,
    decoded JSON)."""
    bid = capi.benchmark_create(eid, name, json.dumps(TINY))
    assert bid > 0, capi.last_error()
    h = capi.benchmark_encode(bid, inputs_json)
    assert h > 0, capi.last_error()
    result = None
    for step in ("encrypt", "load", "operate", "store", "decrypt"):
        h = getattr(capi, f"benchmark_{step}")(bid, h)
        assert h > 0, (step, capi.last_error())
        if step == "operate":
            result = h
    decoded = capi.benchmark_decode(bid, h)
    assert decoded, capi.last_error()
    return result, decoded


@pytest.mark.parametrize("name", [
    "ckks_eltwise_mult_latency",
    "ckks_dot_product_latency",
    "bfv_eltwise_mult_latency",
])
def test_seven_steps_equal_the_jax_capi(on_cpu, name):
    jeid, teid = jcapi.engine_create(), tcapi.engine_create()
    assert jeid > 0 and teid > 0, (jcapi.last_error(), tcapi.last_error())
    engine = tcapi._engines[teid]
    assert engine.device == torch.device("cpu")
    desc = engine.find(name)
    inputs, truth = trunner.gen_inputs(
        desc, dict(desc.default_params, **TINY), np.random.default_rng(7), 1, 1)
    inputs_json = json.dumps([x.tolist() for x in inputs])

    jres, jout = _seven_steps(jcapi, jeid, name, inputs_json)
    tres, tout = _seven_steps(tcapi, teid, name, inputs_json)

    # operate's result: the same residues, level and scale
    tpu.assert_same_ct(tcapi._handles[tres].payload, jcapi._handles[jres].payload)
    got, want = json.loads(tout), json.loads(jout)
    assert len(got) == len(want) == 1
    exp = np.concatenate([np.ravel(t) for t in truth()]).astype(np.float64)
    if desc.scheme is Scheme.BFV:
        assert tout == jout  # byte-identical JSON
        np.testing.assert_array_equal(np.ravel(got[0])[: exp.size], exp)
    else:
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
        np.testing.assert_allclose(np.ravel(got[0])[: exp.size], exp,
                                   atol=5e-5, rtol=0)
    for capi, eid in ((jcapi, jeid), (tcapi, teid)):
        capi.engine_destroy(eid)


def test_descriptor_json_equal_for_all_20(on_cpu):
    jeid, teid = jcapi.engine_create(), tcapi.engine_create()
    assert tcapi.engine_benchmark_count(teid) == jcapi.engine_benchmark_count(jeid) == 20
    for i in range(20):
        assert tcapi.engine_benchmark_name(teid, i) == jcapi.engine_benchmark_name(jeid, i)
        t = tcapi.engine_benchmark_descriptor(teid, i)
        assert t and t == jcapi.engine_benchmark_descriptor(jeid, i)
    assert json.loads(t)["security"] == "128 bits"
    jcapi.engine_destroy(jeid)
    tcapi.engine_destroy(teid)


def test_error_sentinels(on_cpu):
    """As the JAX capi's (tests/test_capi_pipeline.py, tests/test_handles.py):
    unknown name, index out of range, a wrong handle surfaced by
    ``benchmark_operate`` as ``InvalidHandleError``, engine init data."""
    eid = tcapi.engine_create()
    assert tcapi.benchmark_create(eid, "no_such_benchmark", "") < 0
    assert "no_such_benchmark" in tcapi.last_error()
    assert tcapi.engine_benchmark_name(eid, 999) == ""
    assert tcapi.engine_benchmark_descriptor(eid, 999) == ""
    assert tcapi.engine_benchmark_count(987654) < 0
    assert "KeyError" in tcapi.last_error()

    bid = tcapi.benchmark_create(eid, "ckks_eltwise_add_latency", json.dumps(TINY))
    assert bid > 0, tcapi.last_error()
    rng = np.random.default_rng(3)
    pt = tcapi.benchmark_encode(bid, json.dumps(
        [[rng.uniform(-1, 1, 64).tolist()], [rng.uniform(-1, 1, 64).tolist()]]))
    assert pt > 0
    assert tcapi.benchmark_operate(bid, pt) < 0  # a pt handle, not a ct
    assert "InvalidHandleError" in tcapi.last_error()
    assert tcapi.benchmark_decode(bid, pt) == ""
    assert "InvalidHandleError" in tcapi.last_error()
    assert tcapi.benchmark_encode(bid, "not json") < 0
    tcapi.benchmark_destroy(bid)
    tcapi.engine_destroy(eid)

    eid = tcapi.engine_create(b"\x01\x02\x03")
    assert eid > 0
    assert tcapi._engines[eid].init_data == b"\x01\x02\x03"
    tcapi.engine_destroy(eid)
    assert tcapi.engine_create(12345) < 0
    assert "bytes" in tcapi.last_error()


def test_unset_device_means_the_card(monkeypatch):
    """``RSB_TORCH_DEVICE`` unset asks for ``cuda``; without a card that is
    a sentinel and a message, never a run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    monkeypatch.delenv(tcapi.DEVICE_ENV, raising=False)
    assert tcapi.engine_create() == -1
    assert "cuda" in tcapi.last_error()
    monkeypatch.setenv(tcapi.DEVICE_ENV, "cuda")
    assert tcapi.engine_create() == -1
    assert "cuda" in tcapi.last_error()


def test_unknown_device_refused(monkeypatch):
    for value in ("xla", "tpu", ""):
        monkeypatch.setenv(tcapi.DEVICE_ENV, value)
        assert tcapi.engine_create() == -1
        assert tcapi.last_error()
    monkeypatch.setenv(tcapi.DEVICE_ENV, "cpu")
    eid = tcapi.engine_create()
    assert eid > 0 and tcapi._engines[eid].device == torch.device("cpu")
    tcapi.engine_destroy(eid)
