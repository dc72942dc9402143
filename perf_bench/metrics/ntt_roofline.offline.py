"""The NTT kernels' share of their roofline, in %: the least time the card
could take for the transforms the traced calls ask for (``roofline.py``)
over the traced time of the NTT kernels."""

from perf_bench.roofline import ntt_roofline as read  # noqa: F401
