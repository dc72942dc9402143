"""The BFV matrix multiply's share of its roofline in the default packing,
in %: the least time the card could take for the BFV multiply, the
relinearizations and the hoisted rotations one call ran, as the program
counts them (``bfv_roofline.py``, ``rotate_roofline.py``), over one traced
call's device busy time."""

from perf_bench.rotate_roofline import bfv_matmult_roofline as read  # noqa: F401
