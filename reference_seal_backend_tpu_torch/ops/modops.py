"""uint32 modular arithmetic core in plain PyTorch (Montgomery form, R = 2**32).

Counterpart of ``reference_seal_backend_tpu/ops/modops.py``: the same
functions with the same range contracts, giving the same integers.

**The format rule.**  A residue has one format at rest and one in work.

* *Storage* (:data:`STORE`): ``torch.int32`` holding the uint32 bit pattern
  (``torch.uint32`` is a storage-only dtype: no add, shift or compare).
  Everything at rest is storage: the data of every ``Ciphertext``,
  ``Plaintext`` and key, every NTT kernel's input and output, every graph
  input buffer.  :func:`from_numpy` / :func:`to_numpy` meet numpy there.
* *Working* (:data:`WIDE`): ``int64`` holding the uint32 value in
  ``[0, 2**32)``, masked wherever a uint32 would wrap.  Every function
  below takes and returns it.  The products that do not fit ``int64``
  (``umulhi32`` of two values up to ``2**32 - 1``) rely on the
  two's-complement wrap of the ``int64`` multiply: the low 64 bits of the
  product are exact, and an arithmetic shift plus a mask extracts the high
  word.

A chain of arithmetic computes in the working format and narrows once,
where it stores: before it hands a tensor to ``NttPlan.fwd/inv`` or puts
it in a ciphertext, plaintext or key.  :func:`wide` passes a working tensor
(or a Python int) through, so storage is accepted wherever a function
reads; :func:`wide`, :func:`narrow`, :func:`from_numpy` and :func:`to_numpy`
are the only conversions.  Constant tables that only chains read are held
wide on the device once (``schemes/params.py``, ``evaluator/behz.py``);
what a CUDA kernel reads keeps the kernel's format.

All residues are kept in Montgomery form (``x~ = x*R mod p``); every modulus
is odd and below ``2**31``.  Lazy values up to ``4p < 2**32`` are legal
inputs wherever the reference accepts them.
"""

from __future__ import annotations

import numpy as np
import torch

STORE = torch.int32
WIDE = torch.int64
MASK = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The format conversions.
# ---------------------------------------------------------------------------

def from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint32 array -> storage tensor (same bits) on ``device``."""
    a = np.array(arr, dtype=np.uint32, order="C")  # a copy the tensor owns
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Storage tensor -> numpy uint32 array (same bits), on the host."""
    check_store(x)
    return x.detach().cpu().contiguous().numpy().view(np.uint32)


def check_store(x) -> None:
    """Refuse anything but storage where the rule wants it (a transform's
    input, a container's data; a ``ShardedTensor`` through its ``dtype``)."""
    if x.dtype != STORE:
        raise TypeError(f"expected {STORE} residue storage, got {x.dtype}: "
                        f"a chain narrows where it stores")


def wide(x):
    """Storage tensor -> working tensor.  A working tensor, or a Python
    int, passes through."""
    if isinstance(x, int) or x.dtype == WIDE:
        return x
    return x.to(WIDE) & MASK


def narrow(v: torch.Tensor) -> torch.Tensor:
    """Working tensor -> storage tensor (keeps the low 32 bits).  A storage
    tensor passes through."""
    return v.to(STORE)


# ---------------------------------------------------------------------------
# Arithmetic (names and contracts of the reference), in the working format.
# ---------------------------------------------------------------------------

def _hi(a, b):
    return ((a * b) >> 32) & MASK


def umulhi32(a, b):
    """High 32 bits of the 64-bit product of two uint32 values."""
    return _hi(wide(a), wide(b))


def mont_mul(a, b, p, p_neg_inv):
    """Montgomery product ``a*b*R^-1 mod p``; ``p_neg_inv = -p^-1 mod 2**32``.
    Fully reduced for inputs below ``2p`` when ``4p < 2**32``."""
    a, b, p = wide(a), wide(b), wide(p)
    lo = (a * b) & MASK
    m = (lo * wide(p_neg_inv)) & MASK
    t = (_hi(a, b) + _hi(m, p) + (lo != 0)) & MASK
    return t - (t >= p) * p


def shoup_mul_lazy(x, w, ws, p):
    """Shoup product without the final correction: result in ``[0, 2p)``."""
    x = wide(x)
    return (x * wide(w) - _hi(x, wide(ws)) * wide(p)) & MASK


def shoup_mul(x, w, ws, p):
    """``x*w mod p`` for a precomputed constant ``w < p`` with companion
    ``ws = floor(w * 2**32 / p)``; exact for any uint32 ``x``."""
    p = wide(p)
    r = shoup_mul_lazy(x, w, ws, p)
    return r - (r >= p) * p


def reduce_2p(x, p2):
    """Conditional subtract of ``2p``: ``[0, 4p) -> [0, 2p)``."""
    x, p2 = wide(x), wide(p2)
    return x - (x >= p2) * p2


def reduce_4p_full(x, p):
    """Full reduction ``[0, 4p) -> [0, p)``."""
    x, p = wide(x), wide(p)
    p2 = p + p
    x = x - (x >= p2) * p2
    return x - (x >= p) * p


def add_raw(a, b):
    """uint32 sum with wraparound (no reduction): the lazy paths' raw add."""
    return (wide(a) + wide(b)) & MASK


def mod_add(a, b, p):
    """``(a + b) mod p`` for ``a, b`` in ``[0, p)``."""
    p = wide(p)
    s = (wide(a) + wide(b)) & MASK
    return s - (s >= p) * p


def mod_sub(a, b, p):
    """``(a - b) mod p`` for ``a, b`` in ``[0, p)``."""
    a, b = wide(a), wide(b)
    return (a - b + (a < b) * wide(p)) & MASK


def mod_neg(a, p):
    """``(-a) mod p`` for ``a`` in ``[0, p)``."""
    a = wide(a)
    return (a != 0) * ((wide(p) - a) & MASK)


def barrett_reduce_u32(v, p, mu):
    """``v mod p`` for any uint32 ``v``; ``mu = floor(2**32 / p)``."""
    v, p = wide(v), wide(p)
    r = (v - _hi(v, wide(mu)) * p) & MASK
    r = r - (r >= p) * p
    return r - (r >= p) * p


def barrett_reduce_u32_lazy(v, p, mu):
    """Barrett reduction to the lazy range ``[0, 2p)``."""
    v, p = wide(v), wide(p)
    r = (v - _hi(v, wide(mu)) * p) & MASK
    p2 = p + p
    return r - (r >= p2) * p2


def to_mont(x, p, p_neg_inv, r2):
    """Enter Montgomery form: ``x -> x*R mod p`` (``r2 = R^2 mod p``)."""
    return mont_mul(x, r2, p, p_neg_inv)


def from_mont(x, p, p_neg_inv):
    """Leave Montgomery form: ``x*R mod p -> x``."""
    return mont_mul(x, 1, p, p_neg_inv)


def ugt(a, b):
    """Unsigned ``a > b``, as 0/1."""
    return (wide(a) > wide(b)).to(WIDE)


# ---------------------------------------------------------------------------
# The modular sum tree.
# ---------------------------------------------------------------------------

def _tree(x, axis: int, add):
    """Reduction tree along ``axis`` in the reference's pairing: the first
    half plus the second, an odd last term carried, until one is left.
    The lazy sum's representatives depend on the pairing, so it is kept.
    Plain indexing and ``torch.cat`` only, so that a ``ShardedTensor``
    whose sharded dim is not ``axis`` sums block by block."""
    ax = axis % x.ndim
    part = lambda t, a, b: t[(slice(None),) * ax + (slice(a, b),)]
    n = x.shape[ax]
    while n > 1:
        half = n // 2
        s = add(part(x, 0, half), part(x, half, 2 * half))
        x = torch.cat([s, part(x, 2 * half, n)], dim=ax) if n % 2 else s
        n = half + n % 2
    return torch.squeeze(x, dim=ax)


def mod_sum(x, p, axis: int):
    """Modular sum along ``axis`` of canonical terms (result in ``[0, p)``)."""
    p = wide(p)
    return _tree(wide(x), axis, lambda a, b: mod_add(a, b, p))


def mod_sum_lazy(x, p, axis: int):
    """Sum along ``axis`` of lazy terms in ``[0, 2p)``; the result stays in
    ``[0, 2p)``.  Each level is a raw add (below ``4p < 2**32``: every
    prime below ``2**30``) and one conditional subtraction of ``2p``."""
    p2 = wide(p) * 2
    return _tree(wide(x), axis, lambda a, b: reduce_2p(a + b, p2))


# ---------------------------------------------------------------------------
# Host-side precomputation helpers (exact Python bignum / numpy uint64).
# ---------------------------------------------------------------------------
# Host-side precomputation helpers (exact Python bignum / numpy uint64).
# ---------------------------------------------------------------------------

def mont_consts(p: int) -> dict:
    """All per-modulus constants the device code needs, as numpy uint32."""
    if p >= 2**31 or p % 2 == 0:
        raise ValueError("modulus must be odd and < 2**31")
    r = 1 << 32
    p_inv = pow(p, -1, r)
    return {
        "p": np.uint32(p),
        "p_neg_inv": np.uint32((r - p_inv) % r),
        "mu": np.uint32(r // p),          # Barrett factor floor(2^32/p)
        "r2": np.uint32(r * r % p),       # R^2 mod p
        "r1": np.uint32(r % p),           # R mod p  (Montgomery form of 1)
    }


def host_to_mont(x: np.ndarray, p: int) -> np.ndarray:
    """Host conversion into Montgomery form (uint64-safe, p < 2**31)."""
    return ((x.astype(np.uint64) << 32) % np.uint64(p)).astype(np.uint32)


def host_from_mont(x: np.ndarray, p: int) -> np.ndarray:
    rinv = pow(1 << 32, -1, p)
    return (x.astype(np.uint64) * np.uint64(rinv) % np.uint64(p)).astype(
        np.uint32
    )
