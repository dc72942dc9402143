"""A cell of ``BENCHMARK.json``, and the files that define it, found by name.

``BENCHMARK.json`` lies at the root of the checkout.  A cell (an entry of
``workloads``) names a configuration, whose ``file`` lies under the
benchmark's ``paths``, and a traffic mix.  Every other piece is found by
its name in the directories of ``paths``, then in this package's own:

* ``traffic/<traffic>.json``: the category, samples per flexible operand,
  input sets, and how many calls are checked and traced;
* ``references/<reference>.py``: the configuration's plain reference;
* ``limits/<cell>.json``: the limit of each number the comparison reads;
* ``metrics/<metric>.py``: the reader of one metric, ``read(record)``.

So a cell, a traffic mix or a metric is added with files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    search: List[Path]

    def module(self, kind: str, name: str):
        path = _find(self.search, kind, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"perf_bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return self.module("metrics", metric).read

    def reference(self):
        return self.module("references", self.config["reference"])


def _find(search: List[Path], kind: str, name: str, suffix: str) -> Path:
    for d in search:
        path = d / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"{kind}/{name}{suffix} in none of {[str(d) for d in search]}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _one(entries: List[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def load(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = _one(bench["workloads"], workload, "workload")
    config = json.loads((root / _one(bench["configs"], entry["config"], "config")["file"]).read_text())
    search = [root / p for p in bench["paths"]] + [HERE]
    return Cell(workload, int(entry["chips"]), config,
                json.loads(_find(search, "traffic", entry["traffic"], ".json").read_text()),
                json.loads(_find(search, "limits", workload, ".json").read_text()),
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)], search)
