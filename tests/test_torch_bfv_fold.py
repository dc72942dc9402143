"""BFV at N=1024, ``sec_level=0``, seed 1234, the port vs the JAX package's:
a dot product of 600 > N/2 elements, which folds the second batching row
with the conjugation key (rotate_columns).  Inputs, ciphertexts and ``operate``'s result equal
(tolerance 0); decoded integers exactly equal to the JAX package's.  Then the
port's ``run_all`` over the nine BFV descriptors reports ``Failed: 0``.

The fold's decoded sum is held to what the reference's accumulate computes,
which is not the cleartext dot product at this N: a full row of N/2 = 512
slots is summed by baby and giant steps of 23, whose 529-slot window wraps
around the row and counts its first 17 slots twice (ROADMAP.md Queue 3).

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import numpy as np

from reference_seal_backend_tpu_torch.engine import runner as trunner
from reference_seal_backend_tpu_torch.evaluator import composite

from torch_port_util import pipeline_both

N = 1024
SMALL = {"poly_modulus_degree": N, "sec_level": 0}
MATMULT = dict(SMALL, rows_m0=3, cols_m0=4, cols_m1=2)
NINE = (
    "bfv_eltwise_add_latency", "bfv_eltwise_mult_latency",
    "bfv_dot_product_latency", "bfv_eltwise_add_offline",
    "bfv_eltwise_mult_offline", "bfv_dot_product_offline",
    "bfv_matrix_multiply_latency",
    "bfv_matrix_multiply_cipherbatchaxis_latency",
    "bfv_matrix_multiply_row_latency",
)


def test_dot_product_folds_second_row(monkeypatch):
    n, half = 600, N // 2
    params = dict(SMALL, n=n)
    tout, jout, want, tb, _ = pipeline_both(
        "bfv_dot_product_latency", params, 1, monkeypatch)
    assert tb.needs_conjugation_key()
    assert 2 * N - 1 in tb.keys.galois
    np.testing.assert_array_equal(tout[0], jout[0])
    # the reference's window: baby * giant slots of each row, cyclically
    baby, giant = composite._bsgs_split(half)
    over = baby * giant - half
    assert (baby, giant, over) == (23, 23, 17)
    a, b = trunner.gen_inputs(tb.descriptor, tb.params,
                              np.random.default_rng(1234), 1, 1)[0]
    prod = np.zeros(N, dtype=np.int64)
    prod[:n] = a[0] * b[0]
    windowed = prod.sum() + prod[:over].sum() + prod[half:half + over].sum()
    t = tb.ctx.t
    centered = lambda x: (x + t // 2) % t - t // 2
    assert tout[0][0] == centered(windowed)
    assert windowed != int(np.asarray(want[0]).reshape(-1)[0])


def test_run_all_nine_failed_zero(tmp_path, capsys):
    per = {name: {"params": MATMULT if "matrix" in name else SMALL}
           for name in NINE}
    results = trunner.run_all(
        NINE, seed=1234, sample_size=2, report_dir=str(tmp_path),
        per_benchmark=per, min_test_time_ms=0, device="cpu",
    )
    out = capsys.readouterr().out
    assert "[ Info    ] Total: 9" in out and "[ Info    ] Failed: 0" in out
    assert all(r.passed for r in results), [r.error for r in results]
    assert all(r.description["plain_modulus"] for r in results)
