"""The control of a cell's comparison: the plain reference put in the
program's place and computed in a lower precision, judged as a run judges
the program (``judge.py``).  It has to come out as not correct.

    python3 -m perf_bench.control --workload <cell> --seeds <n> [<n> ...]

The lower precision is the nearest below the configuration's (float64 ->
float32 under CKKS).  Under BFV the configuration's answers are exact
integers, and int32 -- the integer type below int64 -- computes every
dot product the generator draws exactly (``|a.b|`` stays below 2^20), so
it cannot fail; the BFV control breaks the exactness the configuration
states instead: the dot products carried in float16.  Prints one JSON line
a seed: each number compared beside its limit, and ``correct``.  Imports
nothing of the program.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from perf_bench import cell as cell_mod
from perf_bench import judge, traffic

DTYPES = {"ckks": "float32", "bfv": "float16"}


def control(cell, seed: int) -> dict:
    """Every input set of ``seed`` answered by the reference in the
    scheme's lower precision (``DTYPES``), judged against the reference in
    the configuration's precision."""
    config = cell.config
    scheme = config["scheme"]
    dtype = DTYPES[scheme]
    reference = cell.reference()
    sets = traffic.input_sets(config, cell.traffic, seed)
    got = [judge.expected(reference.answers(s, scheme, np.dtype(dtype).type), scheme)
           for s in sets]
    want = [judge.expected(reference.answers(s, scheme), scheme) for s in sets]
    verdict = judge.compare(got, want, cell.limits)
    return {"workload": cell.name, "seed": seed, "dtype": dtype,
            "correct": verdict["correct"], "checks": verdict["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    cell = cell_mod.load(Path(args.root).resolve(), args.workload)
    for seed in args.seeds:
        print(json.dumps(control(cell, seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
