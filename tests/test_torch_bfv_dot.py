"""The two BFV dot-product descriptors of the port vs the JAX package's at
N=1024, ``sec_level=0``, seed 1234: Latency at its registered n=100 (summed
by baby and giant steps), Offline at two samples per operand and n=4 (one
hoisted rotation).  Inputs, ciphertexts and ``operate``'s result equal
(tolerance 0); decoded integers exactly equal to the JAX package's and to the
cleartext.  (The fold past N/2 is in test_torch_bfv_fold.py.)

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import numpy as np
import pytest

from torch_port_util import pipeline_both

PARAMS = {"poly_modulus_degree": 1024, "sec_level": 0}


@pytest.mark.parametrize("name,params,batch", [
    ("bfv_dot_product_latency", PARAMS, 1),
    ("bfv_dot_product_offline", dict(PARAMS, n=4), 2),
], ids=["latency", "offline"])
def test_pipeline_bit_exact(name, params, batch, monkeypatch):
    tout, jout, want, tb, _ = pipeline_both(name, params, batch, monkeypatch)
    assert not tb.needs_conjugation_key()
    assert len(tout) == len(jout) == len(want) == batch * batch
    for g, j, w in zip(tout, jout, want):
        assert g.dtype == np.int64 and g.shape == (1,)
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, np.asarray(w).reshape(-1))
