"""Plain cleartext references, one module per HEBench workload, found by the
name a configuration's ``reference`` gives.  Each has
``answers(inputs, scheme, dtype)``: the answers of one input set in the
order the program returns them, computed in ``dtype`` (``None``: the
configuration's own precision, float64 under CKKS and exact int64 under
BFV; a lower one makes the control).  They import numpy alone."""
