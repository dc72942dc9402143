"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

    python3 -m perf_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It measures ``reference_seal_backend_tpu_torch`` on one CUDA card.  What the
benchmark judges the program by lives here, where a change to the program
cannot move it: the seeded traffic (``traffic.py``), the plain cleartext
references (``references/``) and the comparison (``judge.py``), the padded
trace arithmetic (``trace.py``), the NTT bound (``roofline.py``), and one
reader per metric (``metrics/``).  Only ``system.py`` imports the program.
"""
