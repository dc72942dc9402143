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


@pytest.mark.parametrize("plan_of", ["data", "behz"])
def test_sharded_transforms_equal_the_kernels(card, monkeypatch, plan_of):
    """The sharded four-step NTT over 4 virtual devices of the card against
    K1 (both epilogues, lazy input) and K2, on a registered N = 8192 plan:
    the CKKS data plan, or the BEHZ plan over q ∪ Bsk."""
    from reference_seal_backend_tpu_torch.evaluator import behz
    from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
    from reference_seal_backend_tpu_torch.parallel import sharded_ntt
    from reference_seal_backend_tpu_torch.schemes import params as tparams
    from reference_seal_backend_tpu_torch.utils.device import mesh_devices

    monkeypatch.setenv("RSB_TORCH_VIRTUAL_DEVICES", "4")
    if plan_of == "data":
        plan = tparams.make_ckks_context(8192, mult_depth=2, device=card).plan
    else:
        plan = behz.tables_for(tparams.make_bfv_context(8192, device=card)).mult_plan
    mesh = tmesh.make_mesh(4, ("sp",), shape=(4,), devices=mesh_devices(card, 4))
    assert mesh.devices.tolist() == [card] * 4
    x = _data(plan, (2,), 0, len(plan.primes), 2, card)
    xm = sharded_ntt.shard_matrix_view(plan, x, mesh)
    before = dict(ntt_cuda.launches)
    for epi in (True, False):
        got = sharded_ntt.fwd(plan, xm, mesh, epilogue=epi).gather()
        want = plan.fwd(x, 0, epi)
        assert torch.equal(got.transpose(-1, -2).reshape(x.shape), want)
    canon = plan.fwd(x)
    xt = tmesh.ShardedTensor.distribute(
        canon.reshape(2, -1, plan.n1, plan.n2).transpose(-1, -2), mesh,
        (None, None, None, "sp"))
    got = sharded_ntt.inv(plan, xt, mesh).gather().reshape(x.shape)
    assert torch.equal(got, plan.inv(canon))
    assert ntt_cuda.launches["ntt_fwd"] == before["ntt_fwd"] + 3
    assert ntt_cuda.launches["ntt_inv"] == before["ntt_inv"] + 1
    torch.cuda.synchronize()


def test_limb_blocks_launch_the_kernels_at_their_offsets(card, monkeypatch):
    """``parallel/limb.py``'s per-block transforms on a (dp=2, limb=2) mesh
    of four virtual devices of the card, registered N = 8192 plan: one K1
    / K2 launch per block, the top block's at limb 3, each block equal to
    the plain version at its limbs; the whole equal to K1 / K2 on the
    unsharded data.  A CUDA mesh of four without virtual devices raises on
    a one-card machine, never falling back to the CPU."""
    from reference_seal_backend_tpu_torch.parallel import limb
    from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
    from reference_seal_backend_tpu_torch.schemes import params as tparams
    from reference_seal_backend_tpu_torch.utils.device import mesh_devices

    plan = tparams.make_ckks_context(8192, mult_depth=2, device=card).plan
    x = _data(plan, (4,), 0, 6, 2, card)
    if torch.cuda.device_count() < 4:
        monkeypatch.delenv("RSB_TORCH_VIRTUAL_DEVICES", raising=False)
        with pytest.raises(ValueError, match="RSB_TORCH_VIRTUAL_DEVICES"):
            mesh_devices(card, 4)
    monkeypatch.setenv("RSB_TORCH_VIRTUAL_DEVICES", "4")
    mesh = tmesh.make_mesh(4, devices=[card] * 4)
    placed = tmesh.ShardedTensor.distribute(x, mesh, ("dp", "limb", None))
    before = dict(ntt_cuda.launches)
    tntt.call_log = {}
    try:
        for epi in (True, False):
            got = limb.fwd(plan, placed, epilogue=epi)
            assert torch.equal(got.gather(), plan.fwd(x, 0, epi))
            top = got.blocks[1, 1]
            assert torch.equal(top, plan.fwd_plain(x[2:, 3:], 3, epi))
        canon = limb.fwd(plan, placed)
        back = limb.inv(plan, canon)
        assert torch.equal(back.blocks[0, 1], plan.inv_plain(canon.blocks[0, 1], 3))
        assert torch.equal(back.gather(), plan.inv(canon.gather()))
        log = tntt.call_log
    finally:
        tntt.call_log = None
    # per block: 3 forward calls of 4 blocks, 1 inverse; flat: 2 and 1
    assert ntt_cuda.launches["ntt_fwd"] == before["ntt_fwd"] + 3 * 4 + 2
    assert ntt_cuda.launches["ntt_inv"] == before["ntt_inv"] + 4 + 1
    assert {k[5] for k in log} >= {0, 3}
    torch.cuda.synchronize()


def test_limb_blocks_on_two_devices_equal_flat(card):
    """A limb=2 mesh whose blocks lie on two devices, the card and the CPU:
    the block away from the context's device runs an evaluator of the same
    parameters there (``parallel/limb.py:on_device``: tables and keys
    copied once), the collectives copy between the devices, and
    relinearize -> rescale -> rotate_sum equals the flat evaluator's."""
    import numpy as np

    from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
    from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
    from reference_seal_backend_tpu_torch.schemes import ckks as tckks
    from reference_seal_backend_tpu_torch.schemes import keys as tkeys
    from reference_seal_backend_tpu_torch.schemes import params as tparams

    ctx = tparams.make_ckks_context(2048, mult_depth=2, sec_level=0, device=card)
    ks = tkeys.keygen(ctx, seed=5, galois_elts=[pow(5, s, 4096) for s in (1, 2, 3)],
                      need_relin=True)
    enc, er = tckks.CkksEncoder(ctx), tckks.CkksEncryptor(ctx, ks, seed=5)
    rng = np.random.default_rng(2)
    a = er.encrypt_pt(enc.encode(rng.uniform(-1, 1, ctx.slots)))
    ev = Evaluator(ctx, ks)

    def chain(x):
        return ev.rotate_sum(ev.rescale_to_next(ev.relinearize(ev.multiply(x, x))),
                             [0, 1, 2, 3])

    mesh = tmesh.make_mesh(2, devices=[card, torch.device("cpu")])
    placed = tmesh.shard_ct(a, mesh, limb_axis="limb")
    assert placed.data.blocks[0, 1].device.type == "cpu"
    got = chain(placed)
    assert got.data.blocks[0, 1].device.type == "cpu"
    assert torch.equal(got.data.gather(card), chain(a).data)
    assert list(ev.device_evs) == [torch.device("cpu")]


def test_bfv_limb_blocks_on_two_devices_equal_flat(card):
    """The BFV BEHZ multiply -> relinearize on a limb=2 mesh whose blocks
    lie on the card and on the CPU (``parallel/limb.py:bfv_multiply``: the
    CPU block's BEHZ tables those of the context there, the all-reduces
    copying between the devices), equal to the flat evaluator's; K1 and K2
    launched on the card."""
    import numpy as np

    from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
    from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
    from reference_seal_backend_tpu_torch.schemes import bfv as tbfv
    from reference_seal_backend_tpu_torch.schemes import keys as tkeys
    from reference_seal_backend_tpu_torch.schemes import params as tparams

    ctx = tparams.make_bfv_context(2048, sec_level=0, n_data_primes=6, digit_group=2,
                                   device=card)
    ks = tkeys.keygen(ctx, seed=5, need_relin=True)
    enc, er = tbfv.BfvBatchEncoder(ctx), tbfv.BfvEncryptor(ctx, ks, seed=5)
    rng = np.random.default_rng(2)
    vals = rng.integers(0, ctx.t, (2, ctx.n))
    a, b = (er.encrypt_pt(enc.encode(v)) for v in vals)
    ev = Evaluator(ctx, ks)
    want = ev.relinearize(ev.multiply(a, b))
    mesh = tmesh.make_mesh(2, devices=[card, torch.device("cpu")])
    place = lambda c: tmesh.shard_ct(c, mesh, limb_axis="limb")
    before = dict(ntt_cuda.launches)
    got = ev.relinearize(ev.multiply(place(a), place(b)))
    assert all(ntt_cuda.launches[k] > before[k] for k in before)
    assert got.data.blocks[0, 1].device.type == "cpu"
    assert torch.equal(got.data.gather(card), want.data)
    np.testing.assert_array_equal(
        tbfv.BfvDecryptor(ctx, ks).decrypt(want) % ctx.t, vals[0] * vals[1] % ctx.t)
    torch.cuda.synchronize()
