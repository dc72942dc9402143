"""The fused BEHZ kernel (``csrc/behz.cu`` via ``ops/cuda/behz.py``) against
the plain steps it replaces, ``evaluator/behz.py``'s ``_fbc_q_to_bsk`` ->
``floor_bsk`` -> ``_sk_to_q`` -> the Montgomery entry, on the card, bit for
bit: at the cipher-batch-axis cell's shapes, at every number of q limbs the
kernel takes, on edge inputs, through a whole multiply and relinearization,
and inside the captured stages of a benchmark.

Needs an NVIDIA GPU and ``nvcc``; skips elsewhere.  Run on the GPU machine:

    python -m pytest tests/test_torch_cuda_behz.py -q -m cuda -p no:cacheprovider
"""

import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from reference_seal_backend_tpu_torch.evaluator import behz
from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.ops.cuda import behz as behz_cuda
from reference_seal_backend_tpu_torch.schemes.params import make_bfv_context

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a CUDA kernel has no interpret mode")
    return torch.device("cuda", 0)


def products(ctx, lead, seed):
    """Canonical residues ``[*lead, k + kb, N]`` over q, then Bsk."""
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    cols = [torch.randint(0, p, (*lead, ctx.n), generator=gen, dtype=torch.int64,
                          device=ctx.device)
            for p in ctx.data_primes + ctx.bsk_primes]
    return modops.narrow(torch.stack(cols, dim=-2))


def fused_equals_plain(tb, prod):
    before = behz_cuda.launches["behz_floor_sk"]
    got = behz_cuda.floor_sk(prod, tb)
    launched = behz_cuda.launches["behz_floor_sk"] - before
    want = behz.floor_sk_plain(tb, prod)
    torch.cuda.synchronize()
    assert launched == 1
    assert got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, want)


def test_fused_equals_plain_at_the_cba_shapes(card):
    # the registered context (N = 8192, k = 4, kb = 6), 40 of the cell's 720
    # products: [40, 3, 10, 8192] in, as the inverse sweep leaves it
    ctx = make_bfv_context(device=card)
    tb = behz.tables_for(ctx)
    assert (ctx.n, ctx.L, len(ctx.bsk_primes)) == (8192, 4, 6)
    fused_equals_plain(tb, products(ctx, (40, 3), 1))


def test_fused_equals_plain_at_every_k(card):
    # the registry builds k = 4; a 128-bit context up to 28 (881 bits from
    # N = 32768: 29 primes of 30 bits, one special); one library a k, built
    # side by side first
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(behz_cuda.build, behz_cuda.KS))
    for k in behz_cuda.KS:
        ctx = make_bfv_context(2048, sec_level=0, n_data_primes=k, device=card)
        fused_equals_plain(behz.tables_for(ctx), products(ctx, (2, 3), k))


def test_fused_equals_plain_on_edge_inputs(card):
    """All zeros; p - 1 in every row; and products whose Shenoy-Kumaresan
    overflow alpha is half_msk, one above it (the centred branch), 0 and
    m_sk - 1, built by inverting the floor on chosen Bsk values."""
    ctx = make_bfv_context(device=card)
    tb = behz.tables_for(ctx)
    k, n = ctx.L, ctx.n
    qp, bp, aux = ctx.data_primes, ctx.bsk_primes, ctx.aux_primes
    ka, msk = len(aux), ctx.m_sk
    B = 1
    for b in aux:
        B *= b
    prod = products(ctx, (4,), 7).cpu().numpy().view(np.uint32).astype(np.int64)
    prod[0] = 0
    prod[1] = np.asarray(qp + bp)[:, None] - 1
    # rows 2 and 3: random q rows; Bsk rows chosen so that the floor gives
    # y with the wanted alpha in every column
    alphas = np.resize(np.array([tb.half_msk, tb.half_msk + 1, 0, msk - 1]), n)
    fbc = modops.wide(behz._fbc_q_to_bsk(
        tb, modops.wide(torch.from_numpy(prod[2:, :k]).to(card)), tb.t_qhinv)).cpu().numpy()
    rng = np.random.default_rng(3)
    y = np.stack([rng.integers(0, b, (2, n)) for b in aux], axis=-2)  # [2, ka, n]
    conv = np.zeros((2, n), dtype=np.int64)
    for i, b in enumerate(aux):
        bh = B // b
        yp = y[:, i] * pow(bh % b, -1, b) % b
        conv = (conv + yp * (bh % msk)) % msk
    y_msk = (conv - alphas * (B % msk)) % msk
    y = np.concatenate([y, y_msk[:, None]], axis=-2)  # [2, kb, n]
    for j, p in enumerate(bp):
        prod[2:, k + j] = (y[:, j] * (ctx.q % p) + fbc[:, j]) % p * pow(ctx.t, -1, p) % p
    storage = torch.from_numpy(prod.astype(np.uint32).view(np.int32)).to(card)
    # the floor gives the chosen y, so alpha is as chosen
    w = modops.wide(storage)
    floor = behz.floor_bsk(tb, w[2:, k:], modops.wide(torch.from_numpy(fbc).to(card)))
    assert torch.equal(floor.cpu(), torch.from_numpy(y))
    fused_equals_plain(tb, storage)


def test_multiply_and_relinearize_fused_equal_plain(card, monkeypatch):
    # the whole Evaluator.multiply + relinearize at the registered context,
    # fused against the plain steps on the same card, and decrypted
    from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
    from reference_seal_backend_tpu_torch.schemes import bfv, keys

    ctx = make_bfv_context(device=card)
    ks = keys.keygen(ctx, seed=5, need_relin=True)
    enc, er = bfv.BfvBatchEncoder(ctx), bfv.BfvEncryptor(ctx, ks, seed=5)
    vals = np.random.default_rng(2).integers(0, ctx.t, (2, ctx.n))
    a, b = (er.encrypt_pt(enc.encode(v)) for v in vals)
    ev = Evaluator(ctx, ks)
    before = behz_cuda.launches["behz_floor_sk"]
    got = ev.relinearize(ev.multiply(a, b))
    assert behz_cuda.launches["behz_floor_sk"] == before + 1
    monkeypatch.setattr(behz_cuda, "floor_sk", lambda prod, tb: behz.floor_sk_plain(tb, prod))
    want = ev.relinearize(ev.multiply(a, b))
    assert torch.equal(got.data, want.data)
    np.testing.assert_array_equal(
        bfv.BfvDecryptor(ctx, ks).decrypt(got) % ctx.t, vals[0] * vals[1] % ctx.t)


def test_captured_stages_run_the_fused_kernel(card):
    """The cipher-batch-axis matrix multiply through the runner at N = 2048:
    the kernel launches in the warm-up and the capture, and the timed
    operates replay it; every replay credits the fused step's note."""
    from reference_seal_backend_tpu_torch.engine.runner import run_all
    from reference_seal_backend_tpu_torch.utils import counters

    before = behz_cuda.launches["behz_floor_sk"]
    counters.reset()
    res = run_all(["bfv_matrix_multiply_cipherbatchaxis_latency"], device="cuda",
                  verbose=False, params={"poly_modulus_degree": 2048, "sec_level": 0})
    assert res[0].passed, res[0].error
    assert behz_cuda.launches["behz_floor_sk"] - before == 2  # warm-up, capture
    assert res[0].notes["graph_replays"] > 0
    fused = sum(v for key, v in counters.counts.items() if key[0] == "behz.fused_floor_sk")
    multiplies = sum(v for key, v in counters.counts.items() if key[0] == "bfv_multiply")
    assert fused == multiplies > 0


def test_what_the_kernel_does_not_take_raises(card):
    ctx = make_bfv_context(2048, sec_level=0, device=card)
    tb = behz.tables_for(ctx)
    prod = products(ctx, (2, 3), 4)
    before = dict(behz_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        behz_cuda.floor_sk(prod.cpu(), tb)
    with pytest.raises(ValueError, match="contiguous"):
        behz_cuda.floor_sk(prod.transpose(0, 1), tb)
    with pytest.raises(ValueError, match="expected"):
        behz_cuda.floor_sk(prod[..., 1:, :], tb)
    with pytest.raises(TypeError):
        behz_cuda.floor_sk(modops.wide(prod), tb)
    big = types.SimpleNamespace(ctx=types.SimpleNamespace(L=29, bsk_primes=(0,) * 31))
    wide = torch.zeros((1, 60, 2048), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="q limbs"):
        behz_cuda.floor_sk(wide, big)
    assert behz_cuda.launches == before
    # a context of more q limbs than the kernel takes is refused on the card
    # when its tables are made, not run by the plain steps
    ctx29 = make_bfv_context(2048, sec_level=0, n_data_primes=29, device=card)
    with pytest.raises(ValueError, match="q limbs"):
        behz.BehzTables(ctx29)
