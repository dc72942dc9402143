"""The logistic-regression pipeline of the port vs the JAX package's, both
descriptors at their registered depth 6 and scale 50 but N=1024, n=16,
``sec_level=0``, seed 1234 (Offline: batch 5 with ``dots_chunk=2``, i.e. three
chunks of two with one padded row).  Inputs, encryptions, every stage's
ciphertext and ``operate``'s result: tolerance 0.  Decoded outputs:
``atol=1e-9`` against the JAX package's, 5e-5 against the cleartext truth.
Port only: chunked equals unchunked bit for bit, a second ``operate`` encodes
nothing on the host, and every tensor handed to a transform passes the CUDA
wrapper's view rules.

Cold wall time alone (empty JAX cache, this CPU): see CHANGES.md."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_seal_backend_tpu.engine import runner as jrunner
from reference_seal_backend_tpu.engine.registry import Engine as JEngine
from reference_seal_backend_tpu_torch.engine import runner as trunner
from reference_seal_backend_tpu_torch.engine.registry import Engine as TEngine
from reference_seal_backend_tpu_torch.schemes import ckks as tckks

from torch_port_util import assert_same_ct, check_ntt_views

SEED = 1234
LATENCY = "ckks_logistic_regression_poly_d3_latency"
OFFLINE = "ckks_logistic_regression_poly_d3_offline"
BATCH, CHUNK = 5, 2
PARAMS = {
    LATENCY: {"poly_modulus_degree": 1024, "sec_level": 0, "n": 16},
    OFFLINE: {"poly_modulus_degree": 1024, "sec_level": 0, "n": 16,
              "batch_size": BATCH, "dots_chunk": CHUNK},
}


def _jax_stages(jb, jct):
    """The JAX package's three stage graphs, chunked as its ``operate``
    chunks them (the same compiled programs, so no further compile)."""
    w, b, x = jct.payload
    batch = x.data.shape[0]
    if jb.dots_chunk and batch > jb.dots_chunk:
        n_chunks = -(-batch // jb.dots_chunk)
        chunk = -(-batch // n_chunks)
        pad = n_chunks * chunk - batch
        xd = jnp.concatenate([x.data, jnp.zeros_like(x.data[:pad])], axis=0)
        parts = [
            jb._stage_dots(w, replace(x, data=xd[i : i + chunk]))
            for i in range(0, n_chunks * chunk, chunk)
        ]
        dots = replace(
            parts[0], data=jnp.concatenate([p.data for p in parts], axis=0)[:batch]
        )
    else:
        dots = jb._stage_dots(w, x)
    collapsed = jb._stage_collapse(dots)
    return {"dots": dots, "collapse": collapsed,
            "sigmoid": jb._stage_sigmoid(collapsed, b)}


@pytest.fixture(scope="module", params=[LATENCY, OFFLINE], ids=["latency", "offline"])
def both(request):
    name = request.param
    jeng, teng = JEngine(), TEngine("cpu")
    jb = jeng.create_benchmark(jeng.find(name), PARAMS[name])
    tb = teng.create_benchmark(teng.find(name), PARAMS[name])
    b = BATCH if name == OFFLINE else 1
    jin, _ = jrunner._gen_inputs(jb.descriptor, jb.params, np.random.default_rng(SEED), 1, b)
    tin, truth = trunner.gen_inputs(tb.descriptor, tb.params, np.random.default_rng(SEED), 1, b)
    jct = jb.load(jb.encrypt(jb.encode(jin)))
    tct = tb.load(tb.encrypt(tb.encode(tin)))
    return {"name": name, "jb": jb, "tb": tb, "jin": jin, "tin": tin,
            "truth": truth, "jct": jct, "tct": tct,
            "jstages": _jax_stages(jb, jct)}


def test_same_setup(both):
    jb, tb = both["jb"], both["tb"]
    assert tb.batch == jb.batch == (BATCH if both["name"] == OFFLINE else 1)
    assert tb.rotation_steps() == jb.rotation_steps()
    assert tb.dots_chunk == jb.dots_chunk  # Latency: the automatic rule
    assert tb.describe() == jb.describe()
    assert tb.ctx.L == 14 and tb.describe()["scale_bits"] == "50"
    for x, y in zip(both["jin"], both["tin"]):
        np.testing.assert_array_equal(x, y)
    assert len(both["tct"].payload) == 3
    for j, t in zip(both["jct"].payload, both["tct"].payload):
        assert_same_ct(t, j)  # same keys, same encryption randomness


def test_stages_bit_exact(both, monkeypatch):
    """Each stage alone, fed the stage before it; the dots unchunked here
    against the JAX package's chunked ones."""
    tb, want = both["tb"], both["jstages"]
    w, b, x = both["tct"].payload
    seen = check_ntt_views(monkeypatch)
    dots = tb._dots_impl(w, x)
    assert_same_ct(dots, want["dots"])
    collapsed = tb._collapse_impl(dots)
    assert_same_ct(collapsed, want["collapse"])
    assert_same_ct(tb._sigmoid_impl(collapsed, b), want["sigmoid"])
    assert seen


def test_operate_bit_exact_and_right(both, monkeypatch):
    jb, tb = both["jb"], both["tb"]
    jres = jb.block(jb.operate(both["jct"]))
    check_ntt_views(monkeypatch)
    tres = tb.block(tb.operate(both["tct"]))
    assert_same_ct(tres.payload, jres.payload)
    assert_same_ct(tres.payload, both["jstages"]["sigmoid"])
    assert tres.tag == jres.tag == "logreg_result" and tres.meta == jres.meta
    (jout,) = jb.decode(jb.decrypt(jb.store(jres)))
    (tout,) = tb.decode(tb.decrypt(tb.store(tres)))
    (want,) = both["truth"]()
    assert tout.shape == want.shape == (tb.batch,)
    np.testing.assert_allclose(tout, jout, atol=1e-9, rtol=0)
    np.testing.assert_allclose(tout, want, atol=5e-5, rtol=0)


def test_chunked_equals_unchunked(both, monkeypatch):
    tb = both["tb"]
    if both["name"] != OFFLINE:
        assert tb.dots_chunks(1) == (1, 1)
        return
    assert tb.dots_chunks(BATCH) == (2, 3)  # one padded row
    chunked = tb.operate(both["tct"]).payload
    monkeypatch.setattr(tb, "dots_chunk", 0)
    assert tb.dots_chunks(BATCH) == (BATCH, 1)
    whole = tb.operate(both["tct"]).payload
    assert torch.equal(chunked.data, whole.data)
    assert (chunked.level, chunked.scale) == (whole.level, whole.scale)


def test_second_operate_encodes_nothing(both, monkeypatch):
    """The mask and the coefficients are encoded by the first (warm-up)
    ``operate`` only."""
    tb = both["tb"]
    first = tb.operate(both["tct"]).payload
    calls = []
    encode = tckks.CkksEncoder.encode
    monkeypatch.setattr(
        tckks.CkksEncoder, "encode",
        lambda self, *a, **k: calls.append(1) or encode(self, *a, **k),
    )
    again = tb.operate(both["tct"]).payload
    assert not calls
    assert torch.equal(first.data, again.data)
    tb.ev.plain_cache.clear()
    tb.operate(both["tct"])
    assert len(calls) == 5  # the mask and the polynomial's four coefficients


def test_operand_arity_is_checked(both):
    from reference_seal_backend_tpu_torch.models.base import Handle, InvalidHandleError

    with pytest.raises(InvalidHandleError):
        both["tb"].operate(Handle(tag="logreg_ct", payload=(1, 2)))
    with pytest.raises(InvalidHandleError):
        both["tb"].decrypt(both["tct"])  # a ct handle where a result belongs
