"""The CUDA NTT kernels against their plain PyTorch versions, and the CUDA
graphs of ``operate``'s stages against the eager stages, on the card.

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
    from reference_seal_backend_tpu_torch.utils import profile_operate

    dense = part.contiguous()
    torch.cuda.synchronize()
    before = dict(ntt_cuda.launches)
    got_f = plan.fwd(part, lo=start)
    got_i = plan.inv(part, lo=start)
    assert ntt_cuda.launches["ntt_fwd"] == before["ntt_fwd"] + 1
    assert ntt_cuda.launches["ntt_inv"] == before["ntt_inv"] + 1
    # traced again (a padded trace, whole at both ends): the two launches
    # are the only kernels, no copy of the view
    traced = profile_operate.profile_run(lambda: (
        plan.fwd(part, lo=start), plan.inv(part, lo=start), torch.cuda.synchronize()))
    assert traced["ntt_launches"] == traced["kernel_launches"] == 2, traced
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
    # the warm-up launches the kernels (eagerly, then into the graph); the
    # timed operates replay the graph and launch nothing from Python
    assert res[0].passed and res[0].ntt_launches_warmup > 0
    assert res[0].ntt_launches_per_operate == 0 and res[0].notes["graph_replays"] > 0


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


def _staged_bench(name, params, samples):
    import numpy as np

    from reference_seal_backend_tpu_torch.engine import runner
    from reference_seal_backend_tpu_torch.engine.registry import Engine

    engine = Engine("cuda")
    desc = engine.find(name)
    bench = engine.create_benchmark(desc, params)
    inputs, _ = runner.gen_inputs(desc, bench.params, np.random.default_rng(5),
                                  *samples)
    return bench, bench.load(bench.encrypt(bench.encode(inputs)))


@pytest.mark.parametrize("name,params,samples,replays", [
    ("ckks_dot_product_latency",
     {"poly_modulus_degree": 4096, "n": 100, "sec_level": 0}, (1, 1), 1),
    ("bfv_eltwise_mult_latency", {}, (1, 1), 1),  # registered: N = 8192
    # a batch of 10 in chunks of 4: three replays of the dots stage
    ("ckks_logistic_regression_poly_d3_offline",
     {"poly_modulus_degree": 8192, "sec_level": 0, "batch_size": 10,
      "dots_chunk": 4}, (1, 10), 3 + 2),
])
def test_replayed_operate_equals_eager(card, name, params, samples, replays):
    """Each stage of ``operate`` captured once and replayed: the first
    call's result equals the eager stages' integer for integer and outlives
    the later calls; a replay moves no launch counter, and its trace counts
    the NTT kernels the eager ``operate`` launches; releasing the graphs
    gives their memory back."""
    from reference_seal_backend_tpu_torch.utils import profile_operate, staging

    bench, loaded = _staged_bench(name, params, samples)
    staging.reset_counts()
    first = bench.operate(loaded)
    captured = staging.counts["captures"]
    assert captured == len(bench._stages)
    bench.operate(loaded)
    before, replayed = dict(ntt_cuda.launches), staging.counts["replays"]
    last = bench.operate(loaded)
    torch.cuda.synchronize()
    assert ntt_cuda.launches == before
    assert staging.counts["replays"] - replayed == replays
    assert staging.counts["captures"] == captured
    traced = profile_operate.profile_run(lambda: bench.block(bench.operate(loaded)))
    with staging.eager(bench):
        before = dict(ntt_cuda.launches)
        want = bench.operate(loaded)
        torch.cuda.synchronize()
        launched = sum(ntt_cuda.launches[k] - before[k] for k in before)
    assert traced["ntt_launches"] == launched > 0
    assert staging.counts["captures"] == captured
    for got in (first, last):
        ct, ref = got.payload, want.payload
        assert (ct.level, ct.scale, ct.is_ntt) == (ref.level, ref.scale, ref.is_ntt)
        assert torch.equal(ct.data, ref.data)
    assert first.payload.data.data_ptr() != last.payload.data.data_ptr()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    bench.release_graphs()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() < held
    assert torch.equal(first.payload.data, want.payload.data)


def test_a_capture_inside_a_capture_raises(card):
    """A stage that calls another stage of the same benchmark while it is
    being captured raises (one capture at a time); the guard is free
    afterwards."""
    bench, loaded = _staged_bench(
        "ckks_eltwise_add_latency",
        {"poly_modulus_degree": 2048, "n": 8, "sec_level": 0}, (1, 1))
    inner = bench.graph_with_keys(bench._operate_impl)
    outer = bench.graph_with_keys(lambda a, b: inner(a, b))
    with pytest.raises(RuntimeError, match="one capture at a time"):
        outer(*loaded.payload)
    assert not bench._capture_guard.locked()
    assert bench.operate(loaded).payload.data.is_cuda


def test_a_stage_that_cannot_be_captured_raises(card):
    """A stage that synchronises with the host cannot be captured: the call
    raises, naming the stage and the CUDA error, and nothing reruns it
    eagerly.  The failed capture is ended: the card is as it was, and the
    benchmark's own stage then captures and replays equal to its eager
    run."""
    from reference_seal_backend_tpu_torch.utils import staging

    bench, loaded = _staged_bench(
        "ckks_eltwise_add_latency",
        {"poly_modulus_degree": 2048, "n": 8, "sec_level": 0}, (1, 1))
    runs = []

    def syncs(a, b):
        runs.append(1)
        return float(a.data.sum().item())

    stage = bench.graph_with_keys(syncs)
    stream = torch.cuda.current_stream()
    with pytest.raises(RuntimeError, match="syncs: CUDA graph capture failed"):
        stage(*loaded.payload)
    assert len(runs) == 2  # the warm-up and the capture, no eager rerun
    assert stage.captures == 0 and not bench._capture_guard.locked()
    assert torch.cuda.current_stream() == stream
    assert not torch.cuda.is_current_stream_capturing()
    torch.cuda.synchronize()
    got = [bench.operate(loaded) for _ in range(2)]
    assert bench._op_graph.captures == 1 and bench._op_graph.replays == 2
    with staging.eager(bench):
        want = bench.operate(loaded)
    for out in got:
        assert torch.equal(out.payload.data, want.payload.data)


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


def _same_sp(got, want):
    """Two sp results equal integer for integer, block for block."""
    assert (got.level, got.scale) == (want.level, want.scale)
    assert got.data.spec == want.data.spec and got.data.mesh is want.data.mesh
    for x, y in zip(got.data.blocks.flat, want.data.blocks.flat):
        assert torch.equal(x, y)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name,params", [
    ("ckks_dot_product_latency", {"poly_modulus_degree": 4096, "n": 100, "sec_level": 0}),
    ("bfv_eltwise_mult_latency", {}),  # registered: N = 8192
])
def test_sp_replayed_operate_equals_eager(card, monkeypatch, name, params, k):
    """An sp benchmark on a mesh of one card (``k`` virtual devices): its
    stage captured once and replayed; the first result equals the eager
    stages' block for block and outlives the later calls; the collectives
    credited to a replay equal an eager ``operate``'s; releasing the graphs
    gives their memory back."""
    from reference_seal_backend_tpu_torch.parallel import sp_eval
    from reference_seal_backend_tpu_torch.utils import staging

    monkeypatch.setenv("RSB_TORCH_VIRTUAL_DEVICES", "2")
    bench, loaded = _staged_bench(name, dict(params, sp_shard=k), (1, 1))
    assert bench.ev.mesh.unique_devices() == [card]
    assert bench.run_notes(loaded)["stages"] == "staged"
    staging.reset_counts()
    first = bench.operate(loaded)
    assert staging.counts == {"captures": 1, "replays": 1}
    bench.operate(loaded)
    credited = sp_eval.collective_stats(lambda: bench.block(bench.operate(loaded)))
    last = bench.operate(loaded)
    torch.cuda.synchronize()
    assert staging.counts == {"captures": 1, "replays": 4}
    with staging.eager(bench):
        want = bench.operate(loaded)
        stats = sp_eval.collective_stats(lambda: bench.block(bench.operate(loaded)))
    assert credited == stats
    assert (stats["all-to-all"] > 0) == (k > 1)
    for got in (first, last):
        _same_sp(got.payload, want.payload)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    bench.release_graphs()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() < held
    _same_sp(first.payload, want.payload)


def test_placed_chain_replays_equal_eager(card, monkeypatch):
    """multiply -> relinearize -> rescale -> ``accumulate`` on a (dp=2,
    limb=2) mesh of four virtual devices of the card, staged: the replay
    equals the eager placed chain and the flat one, credits the eager
    chain's collectives, and the NTT kernels counted in its trace equal
    the eager chain's launches."""
    import dataclasses
    import threading

    import numpy as np

    from reference_seal_backend_tpu_torch.evaluator import composite
    from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
    from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
    from reference_seal_backend_tpu_torch.parallel import sp_eval
    from reference_seal_backend_tpu_torch.schemes import ckks as tckks
    from reference_seal_backend_tpu_torch.schemes import keys as tkeys
    from reference_seal_backend_tpu_torch.schemes import params as tparams
    from reference_seal_backend_tpu_torch.utils import profile_operate, staging
    from reference_seal_backend_tpu_torch.utils.device import mesh_devices

    monkeypatch.setenv("RSB_TORCH_VIRTUAL_DEVICES", "4")
    n = 4096
    ctx = tparams.make_ckks_context(n, mult_depth=2, sec_level=0, device=card)
    steps = composite.rotations_for_accumulate(8, ctx.slots)
    ks = tkeys.keygen(ctx, seed=5, galois_elts=[pow(5, s, 2 * n) for s in steps],
                      need_relin=True)
    enc, er = tckks.CkksEncoder(ctx), tckks.CkksEncryptor(ctx, ks, seed=5)
    rng = np.random.default_rng(2)
    a = er.encrypt_pt(enc.encode(rng.uniform(-1, 1, ctx.slots)))
    a = dataclasses.replace(a, data=torch.stack([a.data, a.data.flip(-1)]))
    ev = Evaluator(ctx, ks)

    def chain(x):
        return composite.accumulate(
            ev, ev.rescale_to_next(ev.relinearize(ev.multiply(x, x))), 8)

    mesh = tmesh.make_mesh(4, devices=mesh_devices(card, 4))
    placed = tmesh.shard_ct(a, mesh, n_batch_axes=1, limb_axis="limb")
    staged = staging.stage(chain, "chain", threading.Lock(), mesh)
    assert isinstance(staged, staging.StagedCall)
    flat = chain(a)
    first = staged(placed)
    torch.cuda.synchronize()
    before = dict(ntt_cuda.launches)
    eager = chain(placed)
    torch.cuda.synchronize()
    launched = sum(ntt_cuda.launches[k] - before[k] for k in before)
    credited = sp_eval.collective_stats(lambda: staged(placed))
    stats = sp_eval.collective_stats(lambda: chain(placed))
    assert credited == stats and stats["all-reduce"] > 0
    before = dict(ntt_cuda.launches)
    traced = profile_operate.profile_run(lambda: (staged(placed), torch.cuda.synchronize()))
    assert ntt_cuda.launches == before
    assert traced["ntt_launches"] == launched > 0
    assert staged.captures == 1 and staged.replays == 2 + len(traced["kernel_launches_each"])
    for got in (first, staged(placed), eager):
        assert torch.equal(got.data.gather(), flat.data)
        assert (got.level, got.scale) == (flat.level, flat.scale)


def test_mesh_over_card_and_cpu_runs_eagerly(card, monkeypatch):
    """A mesh whose blocks lie on the card and on the CPU is never
    captured: by ``staging.stage``'s branch, decided when the stage is
    built, an sp benchmark over it has no ``StagedCall`` and says so in its
    notes, and a placed chain over it is its function; both run eagerly,
    no capture attempted, and the benchmark's result is right."""
    import threading

    import numpy as np

    from reference_seal_backend_tpu_torch.engine import runner
    from reference_seal_backend_tpu_torch.engine.registry import Engine
    from reference_seal_backend_tpu_torch.models import base
    from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
    from reference_seal_backend_tpu_torch.utils import staging

    both = [card, torch.device("cpu")]
    monkeypatch.setattr(base, "mesh_devices", lambda device, k: both)
    engine = Engine("cuda")
    desc = engine.find("ckks_eltwise_mult_latency")
    bench = engine.create_benchmark(
        desc, {"poly_modulus_degree": 2048, "n": 8, "sec_level": 0, "sp_shard": 2})
    assert bench.ev.mesh.unique_devices() == both
    assert bench._stages == []
    assert not isinstance(bench._op_graph, staging.StagedCall)
    assert bench.run_notes(None)["stages"] == "eager: the sp mesh spans 2 devices"
    inputs, truth = runner.gen_inputs(desc, bench.params, np.random.default_rng(3), 1, 1)
    staging.reset_counts()
    out = bench.decode(bench.decrypt(bench.store(
        bench.operate(bench.load(bench.encrypt(bench.encode(inputs)))))))
    np.testing.assert_allclose(out[0], truth()[0], atol=5e-5, rtol=0)
    mesh = tmesh.make_mesh(2, devices=both)
    chain = staging.stage(lambda x: x, "identity", threading.Lock(), mesh)
    assert not isinstance(chain, staging.StagedCall)
    x = tmesh.ShardedTensor.distribute(torch.arange(8, device=card).reshape(2, 4),
                                       mesh, ("limb", None))
    assert chain(x) is x
    assert staging.counts == {"captures": 0, "replays": 0}


def test_bench_suite_gates_on_the_card(card):
    """The port's benchmark suite at ``bench.py``'s sizes: every gate holds,
    nothing is skipped, the headline and all ten metric keys, every staged
    step equal to its eager run, and logistic regression at N = 32768 on
    digit groups of 3 over three special primes."""
    import json

    from reference_seal_backend_tpu_torch import bench

    lines = []
    run = bench.Run("cuda", window_s=0.5, emit=lines.append)
    assert bench.run_suite(run) == 0
    record = json.loads(lines[-1])
    assert record["skipped"] == [] and record["value"] > 0
    assert set(record["extras"]) == bench.CURRENT_METRIC_KEYS
    assert all(s["equal_to_eager"] for s in record["steps"].values())
    assert record["device"]["platform"] == "gpu" and record["device"]["power_limit"]
    chain = record["describe"]["ckks_logreg_n32768_latency_ms"]
    assert (chain["key_switch_digit_group"], chain["special_modulus_bits"]) == ("3", "90")
    step = record["steps"]["ckks_logreg_offline_b100_samples_per_sec_n32768"]
    assert (step["dots_chunk"], step["dots_n_chunks"]) == (20, 5)


def test_logreg_n32768_through_the_runner(card, capsys):
    from reference_seal_backend_tpu_torch.engine import runner

    rc = runner.main([
        "--device", "cuda", "--poly_modulus_degree", "32768", "--benchmarks",
        "ckks_logistic_regression_poly_d3_latency",
        "ckks_logistic_regression_poly_d3_offline"])
    out = capsys.readouterr().out
    assert rc == 0 and "[ Info    ] Failed: 0" in out, out
