"""Wrapper of the fused BEHZ kernel (``csrc/behz.cu``): the BFV multiply's
chain from the tensor product's inverse transform to the output's forward
transform in one launch.

``floor_sk`` takes the product as the inverse transform leaves it,
``[..., 3, k + kb, N]`` int32 storage (the q rows, then Bsk), and returns
``[..., 3, k, N]``: the fast base conversion q -> Bsk times t, the floor by
q in Bsk, the exact Shenoy-Kumaresan conversion back to q and the entry
into Montgomery form, equal bit for bit to ``evaluator/behz.py``'s
``_fbc_q_to_bsk`` -> ``floor_bsk`` -> ``_sk_to_q`` -> ``to_ntt``'s
Montgomery entry, which stay the CPU's path and the kernel's oracle.  The
source is built at first use (``ops/cuda/nvcc.py``), never on import: one
library a number of q limbs k, ``_build/libbehz-k<k>-<digest>.so``, which
``evaluator/behz.py:BehzTables`` builds when a context on the card makes
its tables (:func:`prepare`).  :data:`KS` holds every k that a BFV context
within the HE standard's 128-bit bound has (30-bit primes and at least one
special prime: 28 at N = 32768); a context of more q limbs is refused on
the card.

There is no fallback: a tensor off the card, a layout or a number of q
limbs the kernel does not take, a build that fails or a launch that is
refused raises.  ``launches`` counts launches; a call adds one exactly
where it launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from reference_seal_backend_tpu_torch.ops.cuda import nvcc
from reference_seal_backend_tpu_torch.ops.modops import STORE

SOURCE = nvcc.CSRC / "behz.cu"

#: q limbs the kernel takes (``csrc/behz.cu``'s ``RSB_BEHZ_K``): 881 bits,
#: the bound from N = 32768 up, hold 29 primes of 30 bits, one of them special
KS = tuple(range(1, 29))

#: kernel launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"behz_floor_sk": 0}

#: the loaded library of each k
_libs: Dict[int, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build(k: int) -> float:
    """Build (if not built from this source yet) and load the library of
    ``k`` q limbs.  Returns the seconds spent compiling, 0.0 when none was."""
    if k in _libs:
        return 0.0
    if k not in KS:
        raise ValueError(f"the fused BEHZ kernel takes k in 1 .. {KS[-1]} q "
                         f"limbs, got {k}")
    lib, seconds = nvcc.load(SOURCE, f"behz-k{k}", (f"-DRSB_BEHZ_K={k}",))
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rsb_behz_floor_sk.argtypes = [vp, vp, ll, ci, ci, vp, vp]
    lib.rsb_behz_floor_sk.restype = ci
    lib.rsb_behz_k.restype = ci
    lib.rsb_behz_consts_words.restype = ci
    lib.rsb_behz_error_string.argtypes = [ci]
    lib.rsb_behz_error_string.restype = ctypes.c_char_p
    if lib.rsb_behz_k() != k:
        raise RuntimeError(f"{SOURCE.name} built for k = {lib.rsb_behz_k()}, not {k}")
    _libs[k] = lib
    return seconds


def prepare(tb) -> float:
    """Build the library of ``tb``'s q limbs and pack its constants (a host
    copy, so outside any graph capture).  Returns the seconds spent
    compiling."""
    seconds = build(tb.ctx.L)
    words = pack(tb)
    if len(words) != _libs[tb.ctx.L].rsb_behz_consts_words():
        raise RuntimeError("the BEHZ constants and csrc/behz.cu's Consts differ")
    return seconds


@functools.lru_cache(maxsize=None)
def pack(tb) -> np.ndarray:
    """The constants of the BEHZ tables ``tb`` (``evaluator/behz.py:
    BehzTables``) as host uint32 words, in the order of ``csrc/behz.cu``'s
    ``Consts``; Shoup pairs as all the ``w`` then all the ``ws``.  Read
    back from the tables once a context (a host copy: :func:`prepare`
    reads them when the tables are made)."""
    host = lambda t: np.asarray(t.cpu().numpy(), dtype=np.int64).reshape(-1)
    pair = lambda p: np.concatenate([host(p[0]), host(p[1])])
    words = np.concatenate([
        host(tb.q_p), host(tb.bsk_p),
        pair(tb.t_qhinv), pair(tb.qh_mod_bsk),
        pair(tb.t_mod_bsk), pair(tb.qinv_bsk),
        pair(tb.Bh_inv), pair(tb.Bh_mod_msk), np.asarray(tb.Binv_msk),
        pair(tb.Bh_mod_q), pair(tb.B_mod_q), host(tb.msk_B_mod_q),
        pair(tb.q_r1), np.asarray([tb.half_msk]),
    ])
    if words.min() < 0 or words.max() >= 1 << 32:
        raise ValueError("a BEHZ constant does not fit 32 bits")
    return np.ascontiguousarray(words.astype(np.uint32))


def floor_sk(prod: torch.Tensor, tb) -> torch.Tensor:
    """``prod [..., k + kb, N]`` int32 storage (canonical residues over the
    q rows, then Bsk) -> ``[..., k, N]`` in Montgomery form (module
    docstring).  Returns a new contiguous tensor."""
    k, kb = tb.ctx.L, len(tb.ctx.bsk_primes)
    if not prod.is_cuda:
        raise ValueError("the fused BEHZ kernel takes CUDA tensors only")
    if prod.dtype != STORE:
        raise TypeError(f"expected {STORE} residue storage, got {prod.dtype}")
    n = prod.shape[-1]
    if prod.dim() < 2 or prod.shape[-2] != k + kb or n < 32 or n & (n - 1):
        raise ValueError(
            f"expected [..., {k + kb}, N] with N a power of two from 32, got "
            f"{tuple(prod.shape)}")
    if not prod.is_contiguous():
        raise ValueError("the fused BEHZ kernel takes a contiguous tensor")
    if k not in KS or kb != k + 2:
        raise ValueError(f"the fused BEHZ kernel takes k in 1 .. {KS[-1]} q "
                         f"limbs and k + 2 Bsk primes, got {k} and {kb}")
    prepare(tb)
    lib, words = _libs[k], pack(tb)
    out = torch.empty((*prod.shape[:-2], k, n), dtype=STORE, device=prod.device)
    rows = prod.numel() // ((k + kb) * n)
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(prod.device).cuda_stream
    with torch.cuda.device(prod.device):
        code = lib.rsb_behz_floor_sk(
            prod.data_ptr(), out.data_ptr(), rows, k, n,
            words.ctypes.data, stream)
    if code != 0:
        msg = lib.rsb_behz_error_string(code).decode()
        raise RuntimeError(f"behz_floor_sk: CUDA error {code}: {msg}")
    launches["behz_floor_sk"] += 1
    return out
