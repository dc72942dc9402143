"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it finds its files."""

from __future__ import annotations

import json
import re

import pytest

from perf_bench import cell as cell_mod
from perf_bench.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape():
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert (REPO / p).is_dir()
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        config = json.loads((REPO / c["file"]).read_text())
        assert config["name"] == c["name"] and config["source"] == c["source"]
        files.add(c["file"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len(files) == len(BENCH["configs"])


def test_cells():
    assert 1 <= len(CELLS) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"]) and NAME.match(w["traffic"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert 0 < e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        for w in m["workloads"]:  # each cell listed reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_finds_its_files(workload):
    cell = cell_mod.load(REPO, workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert callable(cell.reference().answers)
    assert "max_abs_gap" in cell.limits
    assert cell.traffic["category"] in ("latency", "offline")
