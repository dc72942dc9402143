"""The four BFV element-wise descriptors of the port vs the JAX package's at
N=1024 (BFV has N slots: n=1000 fits), ``sec_level=0``, seed 1234, two
samples per operand for the Offline ones: inputs, ciphertexts and
``operate``'s result equal (tolerance 0); decoded integers exactly equal to
the JAX package's and to the cleartext.  The JAX side runs through its own
jitted pipeline.

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import numpy as np
import pytest

from torch_port_util import pipeline_both

NAMES = (
    "bfv_eltwise_add_latency",
    "bfv_eltwise_mult_latency",
    "bfv_eltwise_add_offline",
    "bfv_eltwise_mult_offline",
)
PARAMS = {"poly_modulus_degree": 1024, "sec_level": 0}


@pytest.mark.parametrize("name", NAMES)
def test_pipeline_bit_exact(name, monkeypatch):
    batch = 2 if name.endswith("offline") else 1
    tout, jout, want, _, seen = pipeline_both(name, PARAMS, batch, monkeypatch)
    assert bool(seen) == ("mult" in name)  # the BEHZ multiply's sweeps
    assert len(tout) == len(jout) == len(want) == batch * batch
    for g, j, w in zip(tout, jout, want):
        assert g.dtype == np.int64 and g.shape == (1000,)
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, np.asarray(w).reshape(-1))
