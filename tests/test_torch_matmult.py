"""The three matrix-multiply packings of the port vs the JAX package's at
N=1024, 3x4 times 4x2, ``sec_level=0``, seed 1234: rotation steps, inputs,
encryptions and ``operate``'s ciphertext equal (tolerance 0); decoded product
``atol=1e-9`` against the JAX package's and 5e-5 against ``m0 @ m1``.  Every
tensor the port hands to a transform passes the CUDA wrapper's view rules.

Cold wall time alone (empty JAX cache, this CPU): see CHANGES.md."""

import numpy as np
import pytest

from reference_seal_backend_tpu_torch.engine.registry import Engine as TEngine

from torch_port_util import pipeline_both

SEED = 1234
NAMES = (
    "ckks_matrix_multiply_latency",
    "ckks_matrix_multiply_cipherbatchaxis_latency",
    "ckks_matrix_multiply_row_latency",
)
PARAMS = {"poly_modulus_degree": 1024, "sec_level": 0,
          "rows_m0": 3, "cols_m0": 4, "cols_m1": 2}


@pytest.mark.parametrize("name", NAMES)
def test_pipeline_bit_exact(name, monkeypatch):
    (tout,), (jout,), (want,), _, seen = pipeline_both(
        name, PARAMS, 1, monkeypatch, seed=SEED)
    assert seen
    assert tout.shape == want.shape == (3, 2)
    np.testing.assert_allclose(tout, jout, atol=1e-9, rtol=0)
    np.testing.assert_allclose(tout, want, atol=5e-5, rtol=0)


def test_shape_limits_are_refused():
    teng = TEngine("cpu")
    small = {"poly_modulus_degree": 1024, "sec_level": 0}
    with pytest.raises(ValueError, match="inner dim"):
        teng.create_benchmark(
            teng.find(NAMES[0]), dict(small, rows_m0=1, cols_m0=600, cols_m1=1))
    with pytest.raises(ValueError, match="spacer width"):
        teng.create_benchmark(
            teng.find(NAMES[2]), dict(small, rows_m0=1, cols_m0=4, cols_m1=200))


def test_row_packing_layout():
    teng = TEngine("cpu")
    tb = teng.create_benchmark(teng.find(NAMES[2]), PARAMS)
    assert (tb.blocks, tb.spacers) == (4, 128)
    vec = tb._pack(np.arange(1.0, 5.0))
    assert vec.shape == (512,)
    for j in range(4):
        assert (vec[128 * j : 128 * j + 2] == j + 1).all()
        assert (vec[128 * j + 2 : 128 * (j + 1)] == 0).all()
