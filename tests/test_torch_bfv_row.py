"""The BFV row packing of the port vs the JAX package's at N=1024,
``sec_level=0``, seed 1234: two M0 rows per ciphertext in the two batching
rows, at 3x4 times 4x2 (an odd ``rows_m0``: the last row beside zeros) and
4x4 times 4x2.  Inputs, ciphertexts and ``operate``'s result equal
(tolerance 0); decoded integers exactly equal to the JAX package's and to the
cleartext.

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import numpy as np
import pytest

from torch_port_util import pipeline_both

PARAMS = {"poly_modulus_degree": 1024, "sec_level": 0, "cols_m0": 4,
          "cols_m1": 2}


@pytest.mark.parametrize("rows", [3, 4], ids=["odd", "even"])
def test_row_packing_bit_exact(rows, monkeypatch):
    (tout,), (jout,), (want,), tb, _ = pipeline_both(
        "bfv_matrix_multiply_row_latency", dict(PARAMS, rows_m0=rows), 1,
        monkeypatch)
    assert (tb.blocks, tb.spacers) == (4, 128)
    assert tout.shape == want.shape == (rows, 2)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tout, want)
