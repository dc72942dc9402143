"""C-ABI bridge surface of the port: the flat functions the native shim calls.

Counterpart of ``reference_seal_backend_tpu/engine/capi.py``, with the same
function names, signatures, id tables and JSON.  The reference backend is
consumed as a shared library through the HEBench API Bridge C ABI (engine
create/destroy, benchmark lifecycle and the encode / encrypt / load /
operate / store / decrypt / decode pipeline; SURVEY.md §1 L1).  The port's
plugin library, ``librsb_torch_backend.so`` (``csrc/capi_shim.cpp``, built by
``engine/native.py``), embeds CPython and lands here; it exports the C ABI of
``native/include/rsb_tpu_backend.h`` unchanged.

* Objects cross the ABI as opaque int64 ids; cleartext crosses as JSON (only
  the untimed pipeline ends carry data, ``operate`` moves ids only).
* No exception crosses the ABI: every entry point returns a sentinel (< 0 or
  empty) and keeps the message for :func:`last_error`.
* The engine's device comes from the environment variable
  ``RSB_TORCH_DEVICE`` (``cuda`` when unset, or ``cpu``), resolved by
  ``utils/device.py:pick_device``: ``cuda`` without a card, or an unknown
  value, makes ``engine_create`` return -1 with the reason in
  :func:`last_error`.  Nothing carries on on the CPU by itself.
* ``benchmark_operate`` returns once the device work is done
  (``HEBenchmark.block``: ``torch.cuda.synchronize``), so a harness's host
  clock around ``rsbtpu_operate`` times the device work.
"""

from __future__ import annotations

import itertools
import json
import os
import traceback
from typing import Any, Dict

import numpy as np

#: environment variable naming the engine's device (``cuda`` or ``cpu``)
DEVICE_ENV = "RSB_TORCH_DEVICE"

_ids = itertools.count(1)
_engines: Dict[int, Any] = {}
_benchmarks: Dict[int, Any] = {}
_handles: Dict[int, Any] = {}
_last_error: str = ""


def last_error() -> str:
    return _last_error


def _fail(exc: BaseException) -> int:
    global _last_error
    _last_error = "".join(
        traceback.format_exception_only(type(exc), exc)
    ).strip()
    return -1


def engine_create(init_data: bytes = b"") -> int:
    """``init_data`` mirrors the API Bridge's ``createEngine(p_buffer,
    size)`` opaque init bytes: accepted and recorded but not interpreted, as
    the reference does."""
    try:
        if not isinstance(init_data, (bytes, bytearray, memoryview)):
            raise TypeError(
                f"engine init data must be bytes, got {type(init_data).__name__}"
            )
        from reference_seal_backend_tpu_torch.engine.registry import Engine

        eid = next(_ids)
        engine = Engine(device=os.environ.get(DEVICE_ENV))
        engine.init_data = bytes(init_data)
        _engines[eid] = engine
        return eid
    except BaseException as e:  # noqa: BLE001 — must not cross the ABI
        return _fail(e)


def engine_destroy(eid: int) -> int:
    _engines.pop(eid, None)
    return 0


def engine_benchmark_count(eid: int) -> int:
    try:
        return len(_engines[eid].descriptors)
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def engine_benchmark_name(eid: int, i: int) -> str:
    try:
        return _engines[eid].descriptors[i].name
    except BaseException:  # noqa: BLE001
        return ""


def engine_benchmark_descriptor(eid: int, i: int) -> str:
    """Full descriptor as JSON, the analogue of the reference's
    ``hebench::APIBridge::BenchmarkDescriptor`` that the harness reads
    through the C ABI: workload / category / scheme / security / other plus
    the registered ``cat_params`` (warmup_iterations_count,
    min_test_time_ms, offline data_count)."""
    try:
        d = _engines[eid].descriptors[i]
        return json.dumps(
            {
                "name": d.name,
                "workload": d.workload.value,
                "scheme": d.scheme.value,
                "category": d.category.value,
                "other": d.other,
                "data_type": d.data_type,
                "security": d.security,
                "default_params": dict(d.default_params),
                "cat_params": {
                    "warmup_iterations_count": d.warmup_iterations,
                    "min_test_time_ms": d.min_test_time_ms,
                    "data_count": list(d.default_data_count),
                },
            }
        )
    except BaseException:  # noqa: BLE001
        return ""


def benchmark_create(eid: int, name: str, params_json: str) -> int:
    try:
        engine = _engines[eid]
        params = json.loads(params_json) if params_json else None
        bench = engine.create_benchmark(engine.find(name), params)
        bid = next(_ids)
        _benchmarks[bid] = bench
        return bid
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def benchmark_destroy(bid: int) -> int:
    bench = _benchmarks.pop(bid, None)
    if bench is not None:
        bench.release_graphs()
    return 0


def handle_destroy(hid: int) -> int:
    _handles.pop(hid, None)
    return 0


def _store_handle(h) -> int:
    hid = next(_ids)
    _handles[hid] = h
    return hid


def _step(bid: int, hid: int, step: str) -> int:
    try:
        bench = _benchmarks[bid]
        out = getattr(bench, step)(_handles[hid])
        if step == "operate":
            bench.block(out)
        return _store_handle(out)
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def benchmark_encode(bid: int, inputs_json: str) -> int:
    try:
        bench = _benchmarks[bid]
        inputs = [np.asarray(x) for x in json.loads(inputs_json)]
        return _store_handle(bench.encode(inputs))
    except BaseException as e:  # noqa: BLE001
        return _fail(e)


def benchmark_encrypt(bid: int, hid: int) -> int:
    return _step(bid, hid, "encrypt")


def benchmark_load(bid: int, hid: int) -> int:
    return _step(bid, hid, "load")


def benchmark_operate(bid: int, hid: int) -> int:
    return _step(bid, hid, "operate")


def benchmark_store(bid: int, hid: int) -> int:
    return _step(bid, hid, "store")


def benchmark_decrypt(bid: int, hid: int) -> int:
    return _step(bid, hid, "decrypt")


def benchmark_decode(bid: int, hid: int) -> str:
    try:
        bench = _benchmarks[bid]
        outs = bench.decode(_handles[hid])
        return json.dumps(
            [np.asarray(np.real(o), dtype=np.float64).tolist() for o in outs]
        )
    except BaseException as e:  # noqa: BLE001
        _fail(e)
        return ""
