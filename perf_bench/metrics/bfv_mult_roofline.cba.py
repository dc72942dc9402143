"""The BFV multiply's and the relinearizations' share of their roofline, in
%: the least time the card could take for the steps one call ran, as the
program counts them (``bfv_roofline.py``), over one traced call's device
busy time."""

from perf_bench.bfv_roofline import bfv_mult_roofline as read  # noqa: F401
