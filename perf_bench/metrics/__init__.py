"""One reader per metric of ``BENCHMARK.json``, found by the metric's name:
``read(record)`` returns the metric's value from the run's record
(``run.py``), or None where the record holds nothing to read it from."""
