"""The pass structure of the CUDA NTT kernels, on the CPU.

``NttPlan.fwd_blocked_plain`` / ``inv_blocked_plain`` run the transform in
the kernel's passes with the kernel's per-thread element sets (the index
maps ``pass_split`` / ``task_base`` / ``smem_index`` of ``ops/ntt.py``, which
``csrc/ntt.cu`` cites).  Held with tolerance 0 against the flat stage loop
``fwd_plain`` / ``inv_plain`` and against the JAX package's ``NttPlan``; the
index maps themselves are checked to partition the polynomial and to be free
of shared-memory bank conflicts; and the wrapper's view check is exercised
on CPU tensors (it only reads shapes and strides)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from reference_seal_backend_tpu.nums import primegen
from reference_seal_backend_tpu.ops import ntt as jntt
from reference_seal_backend_tpu_torch.ops import modops as tmod
from reference_seal_backend_tpu_torch.ops import ntt as tntt
from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda

import torch_port_util  # noqa: F401  (one CPU thread for PyTorch)

BITS = {"lazy": 29, "nonlazy": 31}


def _primes(n, kind, n_limbs=3):
    return tuple(primegen.gen_ntt_primes(n_limbs, BITS[kind], 2 * n))


def _data(primes, lead, n, seed, mult=1):
    """[*lead, len(primes), N] residues below mult * p per limb."""
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.integers(0, mult * p, (*lead, n), dtype=np.uint64).astype(np.uint32)
         for p in primes],
        axis=-2,
    )


@pytest.mark.parametrize("lo,nl", [(0, 3), (1, 2), (2, 1)])
@pytest.mark.parametrize(
    "kind,mult",
    [("lazy", 1), ("lazy", 2), ("nonlazy", 1)],  # below 2p: lazy contract only
    ids=["lazy-below_p", "lazy-below_2p", "nonlazy-below_p"],
)
@pytest.mark.parametrize(
    "n", [8, 64, 2048, 8192, pytest.param(16384, marks=pytest.mark.slow)]
)
def test_blocked_equals_flat_loop(n, kind, mult, lo, nl):
    primes = _primes(n, kind)
    plan = tntt.make_plan(n, primes, "cpu")
    assert plan.lazy == (kind == "lazy")
    x = tmod.from_numpy(_data(primes[lo : lo + nl], (2,), n, seed=n + lo, mult=mult))
    for epilogue in (True, False):
        assert torch.equal(
            plan.fwd_blocked_plain(x, lo, epilogue), plan.fwd_plain(x, lo, epilogue)
        )
    assert torch.equal(plan.inv_blocked_plain(x, lo), plan.inv_plain(x, lo))
    if mult == 1:
        assert torch.equal(plan.inv_blocked_plain(plan.fwd_blocked_plain(x, lo), lo), x)


@pytest.mark.parametrize("kind", ["lazy", "nonlazy"])
@pytest.mark.parametrize("n", [8, 64, 2048])
def test_blocked_equals_reference(n, kind):
    primes = _primes(n, kind)
    jp, tp = jntt.make_plan(n, primes), tntt.make_plan(n, primes, "cpu")
    x = _data(primes, (2,), n, seed=5 * n, mult=2 if tp.lazy else 1)
    xt, xj = tmod.from_numpy(x), jnp.asarray(x)
    want = jax.jit(lambda a: jp.fwd(a, epilogue=False))(xj)
    got = tp.fwd_blocked_plain(xt, epilogue=False)
    np.testing.assert_array_equal(tmod.to_numpy(got), np.asarray(want))
    want = jax.jit(lambda a: jp.inv(a))(xj)
    np.testing.assert_array_equal(
        tmod.to_numpy(tp.inv_blocked_plain(xt)), np.asarray(want)
    )


@pytest.mark.parametrize("n", [64, 2048])
def test_blocked_epilogue_and_limb_offset_equal_reference(n):
    primes = _primes(n, "lazy")
    jp, tp = jntt.make_plan(n, primes), tntt.make_plan(n, primes, "cpu")
    x = _data(primes[2:], (3,), n, seed=n + 1)
    want = jax.jit(lambda a: jp.fwd(a, lo=2))(jnp.asarray(x))
    got = tp.fwd_blocked_plain(tmod.from_numpy(x), lo=2)
    np.testing.assert_array_equal(tmod.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("log_n", range(1, 17))
def test_pass_split_covers_every_stage_once(log_n):
    split = tntt.pass_split(log_n)
    assert len(split) == -(-log_n // tntt.MAX_RADIX_LOG)
    stages = [s0 + r for s0, k in split for r in range(k)]
    assert stages == list(range(log_n))
    assert all(1 <= k <= tntt.MAX_RADIX_LOG for _, k in split)


@pytest.mark.parametrize("log_n", tntt.KERNEL_LOG_NS)
def test_tasks_partition_and_banks_do_not_conflict(log_n):
    """In every pass the tasks' element sets partition range(N), and the 32
    tasks of a warp (consecutive q) touch 32 different shared-memory banks for
    each of their element slots: no conflict on the write of one pass nor on
    the read of the next, which uses the next pass's map."""
    n = 1 << log_n
    for s0, k in tntt.pass_split(log_n):
        b = log_n - s0 - k
        base = tntt.task_base(log_n, s0, k, np.arange(n >> k, dtype=np.int64))
        elem = base[:, None] | (np.arange(1 << k, dtype=np.int64) << b)[None, :]
        np.testing.assert_array_equal(np.sort(elem.ravel()), np.arange(n))
        banks = (tntt.smem_index(elem) % 32).reshape(-1, 32, 1 << k)
        per_warp_slot = np.sort(banks, axis=1)
        np.testing.assert_array_equal(
            per_warp_slot,
            np.broadcast_to(np.arange(32)[None, :, None], per_warp_slot.shape),
        )
    assert tntt.smem_index(n - 1) < n + n // 32


def test_last_pass_holds_consecutive_elements():
    """The kernels move the last pass's tasks to and from device memory 16
    bytes at a time: a task there is 2**k >= 4 consecutive elements."""
    for log_n in tntt.KERNEL_LOG_NS:
        s0, k = tntt.pass_split(log_n)[-1]
        assert log_n - s0 - k == 0 and k >= 2
        q = np.arange((1 << log_n) >> k)
        np.testing.assert_array_equal(tntt.task_base(log_n, s0, k, q), q << k)


@pytest.mark.parametrize("n", [64, 2048])
@pytest.mark.parametrize("start,nl", [(0, 2), (1, 2), (2, 1), (0, 3)])
def test_limb_slice_view_equals_its_copy(n, start, nl):
    primes = _primes(n, "lazy")
    plan = tntt.make_plan(n, primes, "cpu")
    whole = tmod.from_numpy(_data(primes, (2, 3), n, seed=start + nl))
    view = whole[..., start : start + nl, :]
    copy = view.contiguous()
    for got, want in (
        (plan.fwd(view, lo=start), plan.fwd(copy, lo=start)),
        (plan.fwd(view, lo=start, epilogue=False),
         plan.fwd(copy, lo=start, epilogue=False)),
        (plan.inv(view, lo=start), plan.inv(copy, lo=start)),
    ):
        assert got.is_contiguous() and torch.equal(got, want)


def test_row_layout_of_views_the_kernels_take():
    n = 64
    y = torch.zeros(4, 3, 5, n, dtype=tmod.STORE)
    assert ntt_cuda._row_layout(y, n) == (12, 5 * n)
    assert ntt_cuda._row_layout(y[..., 1:3, :], n) == (12, 5 * n)
    assert ntt_cuda._row_layout(y[..., 4:, :], n) == (12, 5 * n)
    assert ntt_cuda._row_layout(y[:, 1:2], n) == (4, 15 * n)
    assert ntt_cuda._row_layout(y[0, 0], n) == (1, 5 * n)
    assert ntt_cuda._row_layout(y[1:2, 2:3, 1:4], n) == (1, 3 * n)


@pytest.mark.parametrize(
    "view",
    [
        lambda y: y[:, :2],            # rows not one stride apart
        lambda y: y[..., ::2, :],      # limbs 2 N words apart
        lambda y: y.transpose(0, 1),   # leading dimensions swapped
        lambda y: y.transpose(-1, -2)[..., :5, :],  # words not dense
    ],
    ids=["row_gap", "limb_gap", "transposed_rows", "strided_words"],
)
def test_row_layout_raises_on_other_views(view):
    n = 8
    y = torch.zeros(4, 3, 8, n, dtype=tmod.STORE)
    with pytest.raises(ValueError, match="CUDA NTT kernel takes"):
        ntt_cuda._row_layout(view(y), n)


def test_source_specialises_the_sizes_the_wrapper_names():
    """``KERNEL_LOG_NS`` (whose index maps the tests above check, and for
    which the wrapper demands 16-byte alignment) are the sizes the switch in
    ``csrc/ntt.cu`` sends to the specialised kernels."""
    import re

    cases = re.findall(r"case (\d+): return", ntt_cuda.SOURCE.read_text())
    assert tuple(int(c) for c in cases) == ntt_cuda.KERNEL_LOG_NS
