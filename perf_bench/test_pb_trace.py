"""The padded-trace arithmetic on plain records, and the readers of the
per-layer metrics that use it."""

from __future__ import annotations

import pytest

from perf_bench import trace
from perf_bench.cell import Cell
from perf_bench.conftest import HERE

PAD = ("spin_kernel", 0.0, 1.0)


def _pads(start):
    return [("spin_kernel", start + i, 0.5) for i in range(3)]


def _records():
    # two calls: kernels at 10-14 and 20-30 (overlapping copy 12-13),
    # an NTT at 40-44 and 50-52; host events around them
    device = _pads(0) + [
        ("elementwise", 10.0, 4.0), ("Memcpy DtoD", 12.0, 1.0), ("elementwise", 20.0, 10.0),
        ("ntt_fwd_kernel<13>", 40.0, 4.0), ("ntt_inv_kernel<13>", 50.0, 2.0),
    ] + _pads(100)
    host = [("cudaGraphLaunch", 5.0, 30.0), ("aten::clone", 35.0, 20.0),
            ("cudaMemcpyAsync", 44.0, 2.0)]
    return device, host


def test_summarize():
    device, host = _records()
    s = trace.summarize(device, host, window_s=60e-6)
    assert s["whole"] and s["pads_seen"] == [3, 3]
    assert s["ops"] == 5
    assert s["busy_s"] == pytest.approx(20e-6)  # 10-14, 20-30, 40-44, 50-52
    assert s["op_s"] == pytest.approx(21e-6)
    assert s["ntt_s"] == pytest.approx(6e-6)
    assert s["ntt_ops"] == {"ntt_fwd": 1, "ntt_inv": 1}
    assert s["device_ops"][0] == ["elementwise", pytest.approx(14e-6)]
    gaps = dict(s["idle_gaps"])
    # 14-20 under the graph launch; 30-40 under the clone (innermost at 35);
    # 44-50 under the copy (innermost at 47 is the clone: the copy ends at 46)
    assert gaps["cudaGraphLaunch"] == pytest.approx(6e-6)
    assert gaps["aten::clone"] == pytest.approx(16e-6)


def test_a_trace_that_lost_its_first_records_is_not_whole():
    device, host = _records()
    s = trace.summarize(device[3:], host, window_s=60e-6)
    assert not s["whole"] and s["pads_seen"][0] == 0


def test_readers_of_the_trace():
    device, host = _records()
    t = dict(trace.summarize(device, host, window_s=60e-6), calls=2)
    record = {"trace": t, "results_per_call": 4,
              "window": {"seconds": 1.0, "calls": 40000},
              "transforms": [("ntt_fwd", 7, 7, 8192), ("ntt_inv", 7, 7, 8192)],
              "spans": {"first_operate_s": 0.3, "context_keys_s": 2.0}, "setup_s": 9.0}
    cell = Cell("x", 1, {}, {}, {}, [], [], [HERE])
    read = {n: cell.reader(n)(record) for n in (
        "kernels_per_operate.latency", "chain_ms_per_result.offline",
        "device_idle_share.latency", "device_idle_share.offline",
        "ntt_roofline.latency", "first_operate_s", "context_keys_s", "setup_s",
        "operate_ms", "results_per_s")}
    assert read["kernels_per_operate.latency"] == 2.5
    assert read["chain_ms_per_result.offline"] == pytest.approx((21e-6 - 6e-6) / 2 / 4 * 1e3)
    # busy and wall of the same traced calls: 20 us busy in 60 us
    assert read["device_idle_share.latency"] == pytest.approx(100.0 * (1 - 20 / 60))
    assert read["device_idle_share.offline"] == read["device_idle_share.latency"]
    assert 0 < read["ntt_roofline.latency"] < 100
    assert read["first_operate_s"] == 0.3 and read["context_keys_s"] == 2.0
    assert read["setup_s"] == 9.0
    assert read["operate_ms"] == pytest.approx(0.025)
    assert read["results_per_s"] == pytest.approx(160000.0)
    # nothing to read: nothing returned, never 0
    bare = {"spans": {}, "setup_s": 1.0, "results_per_call": 1}
    for n in ("kernels_per_operate.latency", "ntt_roofline.offline",
              "device_idle_share.latency", "operate_ms", "results_per_s"):
        assert cell.reader(n)(bare) is None


NOTED = [("ntt_fwd", 7, 7, 8192), ("ntt_inv", 7, 7, 8192)]


@pytest.mark.parametrize("noted,renamed,agree", [
    (NOTED, False, True),
    (NOTED[:1], False, False),  # a transform done outside the traced kernels
    (NOTED + NOTED, False, False),  # kernels that carry two transforms each
    ([], False, False),  # no transform asked of NttPlan: it was bypassed
    (NOTED, True, False),  # the kernels renamed
])
def test_the_traced_run_fails_where_transforms_and_ntt_kernels_disagree(noted, renamed, agree):
    device, host = _records()
    if renamed:
        device = [(n.replace("ntt_", "fused_"), a, b) for n, a, b in device]
    t = dict(trace.summarize(device, host, window_s=60e-6), calls=1)
    said = trace.ntt_disagreement(t, noted)
    assert (said is None) == agree, said


def test_a_trace_that_lost_records_is_not_held_to_the_ntt_count():
    device, host = _records()
    t = dict(trace.summarize(device[3:-4], host, window_s=60e-6), calls=1)
    assert not t["whole"] and t["ntt_ops"] == {"ntt_fwd": 1, "ntt_inv": 0}
    assert trace.ntt_disagreement(t, NOTED) is None
    assert trace.ntt_disagreement(t, []) is not None
