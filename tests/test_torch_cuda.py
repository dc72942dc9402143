"""The CUDA NTT kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; skips elsewhere.  Run on the GPU machine:

    python -m pytest tests/test_torch_cuda.py -q -m cuda -p no:cacheprovider

(`chip_smoke.py` makes the same comparisons, at more shapes.)"""

import pytest
import torch

from reference_seal_backend_tpu_torch.nums import primegen
from reference_seal_backend_tpu_torch.ops import modops as tmod
from reference_seal_backend_tpu_torch.ops import ntt as tntt
from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a CUDA kernel has no interpret mode")
    return torch.device("cuda", 0)


def _data(plan, lead, lo, nl, mult, device):
    gen = torch.Generator(device=device).manual_seed(3)
    cols = [
        torch.randint(0, mult * p, (*lead, plan.n), generator=gen,
                      dtype=torch.int64, device=device)
        for p in plan.primes[lo : lo + nl]
    ]
    return tmod.narrow(torch.stack(cols, dim=-2))


@pytest.mark.parametrize("n", [64, 2048, 8192, 16384, 32768])
@pytest.mark.parametrize("bits", [30, 31], ids=["lazy", "nonlazy"])
def test_kernels_equal_plain_versions(card, n, bits):
    primes = tuple(primegen.gen_ntt_primes(3, bits, 2 * n))
    plan = tntt.make_plan(n, primes, card)
    for lead, lo, nl, mult in (((5,), 0, 3, 1), ((1,), 2, 1, 1), ((3, 2), 1, 2, 2)):
        if mult == 2 and not plan.lazy:
            continue
        x = _data(plan, lead, lo, nl, mult, card)
        before = dict(ntt_cuda.launches)
        for epi in (True, False):
            assert torch.equal(plan.fwd(x, lo, epi), plan.fwd_plain(x, lo, epi))
        assert torch.equal(plan.inv(x, lo), plan.inv_plain(x, lo))
        assert ntt_cuda.launches["ntt_fwd"] == before["ntt_fwd"] + 2
        assert ntt_cuda.launches["ntt_inv"] == before["ntt_inv"] + 1
        if mult == 1:
            assert torch.equal(plan.inv(plan.fwd(x, lo), lo), x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [1024, 8192], ids=["generic", "specialised"])
@pytest.mark.parametrize("start,nl", [(1, 2), (2, 1), (0, 2)])
def test_limb_slice_view_goes_in_without_a_copy(card, n, start, nl):
    """A limb slice of a contiguous tensor is handed to the kernel as the
    view it is (same storage, one launch, no other kernel) and the result
    equals the plain version's on the slice's copy."""
    primes = tuple(primegen.gen_ntt_primes(3, 30, 2 * n))
    plan = tntt.make_plan(n, primes, card)
    whole = _data(plan, (4, 2), 0, 3, 1, card)
    part = whole[..., start : start + nl, :]
    assert not part.is_contiguous()
    assert part.data_ptr() == whole.data_ptr() + 4 * start * n
    assert ntt_cuda._row_layout(part, n) == (8, 3 * n)
    dense = part.contiguous()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    before = dict(ntt_cuda.launches)
    with torch.profiler.profile(activities=acts) as prof:
        got_f = plan.fwd(part, lo=start)
        got_i = plan.inv(part, lo=start)
        torch.cuda.synchronize()
    assert ntt_cuda.launches["ntt_fwd"] == before["ntt_fwd"] + 1
    assert ntt_cuda.launches["ntt_inv"] == before["ntt_inv"] + 1
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels and all("ntt_" in k for k in kernels), kernels
    assert got_f.is_contiguous() and got_i.is_contiguous()
    assert torch.equal(got_f, plan.fwd_plain(dense, lo=start))
    assert torch.equal(got_i, plan.inv_plain(dense, lo=start))


@pytest.mark.parametrize(
    "view",
    [lambda y: y[:, :2, :2], lambda y: y[..., ::2, :],
     lambda y: y.transpose(0, 1)[..., :2, :]],
    ids=["row_gap", "limb_gap", "transposed_rows"],
)
def test_view_the_kernel_does_not_take_raises(card, view):
    primes = tuple(primegen.gen_ntt_primes(3, 30, 2 * 1024))
    plan = tntt.make_plan(1024, primes, card)
    x = view(_data(plan, (4, 3), 0, 3, 1, card))
    assert x.shape[-2] == 2
    before = dict(ntt_cuda.launches)
    with pytest.raises(ValueError, match="CUDA NTT kernel takes"):
        plan.fwd(x, lo=0)
    with pytest.raises(ValueError, match="CUDA NTT kernel takes"):
        plan.inv(x, lo=0)
    assert ntt_cuda.launches == before


def test_runner_on_the_card(card):
    from reference_seal_backend_tpu_torch.engine.runner import run_all

    res = run_all(["ckks_dot_product_latency"], device="cuda", verbose=False,
                  params={"poly_modulus_degree": 2048, "sec_level": 0})
    assert res[0].passed and res[0].ntt_launches_per_operate > 0


def test_bfv_multiply_on_the_card_equals_the_cpu(card):
    """One BEHZ multiply at the registered N=8192 on the card: four NTT
    launches (the four sweeps) and the CPU's integers."""
    from reference_seal_backend_tpu_torch.evaluator import behz
    from reference_seal_backend_tpu_torch.schemes.core import Ciphertext
    from reference_seal_backend_tpu_torch.schemes.params import make_bfv_context

    out = {}
    for dev in ("cpu", "cuda"):
        ctx = make_bfv_context(device=dev)
        gen = torch.Generator().manual_seed(5)
        cols = [torch.randint(0, p, (3, 2, 2, 8192), generator=gen,
                              dtype=torch.int64) for p in ctx.data_primes]
        data = tmod.narrow(torch.stack(cols, dim=-2)).to(dev)
        a, b = (Ciphertext(data=d, level=ctx.L) for d in (data[:, :1], data[:1, 1:]))
        before = dict(ntt_cuda.launches)
        out[dev] = behz.bfv_multiply(ctx, a, b).data.cpu()
        launched = {k: ntt_cuda.launches[k] - before[k] for k in before}
        assert launched == ({"ntt_fwd": 0, "ntt_inv": 0} if dev == "cpu"
                            else {"ntt_fwd": 2, "ntt_inv": 2})
    assert out["cuda"].shape == (3, 1, 3, 4, 8192)
    assert torch.equal(out["cuda"], out["cpu"])


def test_capi_library_on_the_card(card, monkeypatch):
    """One dot product through the port's plugin library (loaded with
    ``ctypes.CDLL`` into this interpreter) on the card: ``rsbtpu_operate``
    launches the NTT kernels, the result matches the cleartext."""
    import json

    import numpy as np

    from reference_seal_backend_tpu_torch.engine import capi, native

    monkeypatch.setenv(capi.DEVICE_ENV, "cuda")
    lib = native.load_library()
    assert lib.rsbtpu_initialize() == 0
    eid = lib.rsbtpu_engine_create()
    assert eid > 0, native.take_string(lib, lib.rsbtpu_last_error())
    params = {"poly_modulus_degree": 2048, "n": 64, "sec_level": 0}
    bid = lib.rsbtpu_benchmark_create(eid, b"ckks_dot_product_latency",
                                      json.dumps(params).encode())
    assert bid > 0, native.take_string(lib, lib.rsbtpu_last_error())
    rng = np.random.default_rng(11)
    a, b = rng.uniform(-1, 1, (2, 1, 64))
    h = lib.rsbtpu_encode(bid, json.dumps([a.tolist(), b.tolist()]).encode())
    h = lib.rsbtpu_load(bid, lib.rsbtpu_encrypt(bid, h))
    assert h > 0, native.take_string(lib, lib.rsbtpu_last_error())
    before = sum(ntt_cuda.launches.values())
    h = lib.rsbtpu_operate(bid, h)
    assert h > 0 and sum(ntt_cuda.launches.values()) > before
    h = lib.rsbtpu_decrypt(bid, lib.rsbtpu_store(bid, h))
    out = json.loads(native.take_string(lib, lib.rsbtpu_decode(bid, h)))
    np.testing.assert_allclose(out[0][0], float(a[0] @ b[0]), atol=5e-5, rtol=0)
    lib.rsbtpu_benchmark_destroy(bid)
    lib.rsbtpu_engine_destroy(eid)
