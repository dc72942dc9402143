"""The BFV val and cipher-batch-axis matrix-multiply packings of the port vs
the JAX package's at N=1024, ``sec_level=0``, seed 1234, 3x4 times 4x2:
inputs, ciphertexts and ``operate``'s result equal (tolerance 0); decoded
integers exactly equal to the JAX package's and to the cleartext.  (The row
packing is in test_torch_bfv_row.py.)

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import numpy as np
import pytest

from torch_port_util import pipeline_both

PARAMS = {"poly_modulus_degree": 1024, "sec_level": 0, "rows_m0": 3,
          "cols_m0": 4, "cols_m1": 2}


@pytest.mark.parametrize("name", [
    "bfv_matrix_multiply_latency",
    "bfv_matrix_multiply_cipherbatchaxis_latency",
], ids=["val", "cba"])
def test_matmult_bit_exact(name, monkeypatch):
    (tout,), (jout,), (want,), _, _ = pipeline_both(name, PARAMS, 1, monkeypatch)
    assert tout.shape == want.shape == (3, 2)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tout, want)
