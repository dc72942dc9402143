"""uint32 modular arithmetic core in plain PyTorch (Montgomery form, R = 2**32).

Counterpart of ``reference_seal_backend_tpu/ops/modops.py``: the same
functions with the same range contracts, giving the same integers.

**Storage.**  ``torch.uint32`` is a storage-only dtype (no add, shift or
compare), so residues are stored as ``torch.int32`` holding the uint32 bit
pattern (:data:`STORE`).  :func:`from_numpy` / :func:`to_numpy` are the only
places where the two views meet numpy.

**Arithmetic.**  Every function widens its operands to ``int64`` values in
``[0, 2**32)`` (:func:`wide`), computes there, masks each result that a
uint32 would have wrapped, and narrows back (:func:`narrow`).  The products
that do not fit ``int64`` (``umulhi32`` of two values up to ``2**32 - 1``)
rely on the two's-complement wrap of the ``int64`` multiply: the low 64 bits
of the product are exact, and an arithmetic shift plus a mask extracts the
high word.

The ``w_*`` functions take and return *wide* tensors, so a chain (an NTT
stage loop) converts once at each end.  The public functions take storage
or wide tensors and return storage tensors.

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
# Storage <-> value views.
# ---------------------------------------------------------------------------

def from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint32 array -> storage tensor (same bits) on ``device``."""
    a = np.array(arr, dtype=np.uint32, order="C")  # a copy the tensor owns
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Storage tensor -> numpy uint32 array (same bits), on the host."""
    if x.dtype != STORE:
        raise TypeError(f"expected a {STORE} storage tensor, got {x.dtype}")
    return x.detach().cpu().contiguous().numpy().view(np.uint32)


def wide(x: torch.Tensor) -> torch.Tensor:
    """Storage tensor -> int64 values in [0, 2**32).  A tensor that is
    already wide passes through."""
    if x.dtype == WIDE:
        return x
    return x.to(WIDE) & MASK


def narrow(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> storage tensor (keeps the low 32 bits)."""
    return v.to(STORE)


# ---------------------------------------------------------------------------
# Wide-domain arithmetic: int64 tensors holding uint32 values.
# ---------------------------------------------------------------------------

def w_umulhi32(a, b):
    """High 32 bits of the 64-bit product of two uint32 values."""
    return ((a * b) >> 32) & MASK


def w_mont_mul(a, b, p, p_neg_inv):
    lo = (a * b) & MASK
    hi = w_umulhi32(a, b)
    m = (lo * p_neg_inv) & MASK
    t = (hi + w_umulhi32(m, p) + (lo != 0)) & MASK
    return t - (t >= p) * p


def w_shoup_mul_lazy(x, w, ws, p):
    q = w_umulhi32(x, ws)
    return (x * w - q * p) & MASK


def w_shoup_mul(x, w, ws, p):
    r = w_shoup_mul_lazy(x, w, ws, p)
    return r - (r >= p) * p


def w_reduce_2p(x, p2):
    return x - (x >= p2) * p2


def w_reduce_4p_full(x, p):
    p2 = p + p
    x = x - (x >= p2) * p2
    return x - (x >= p) * p


def w_mod_add(a, b, p):
    s = (a + b) & MASK
    return s - (s >= p) * p


def w_mod_sub(a, b, p):
    return (a - b + (a < b) * p) & MASK


def w_mod_neg(a, p):
    return (a != 0) * ((p - a) & MASK)


def w_barrett_reduce_u32(v, p, mu):
    r = (v - w_umulhi32(v, mu) * p) & MASK
    r = r - (r >= p) * p
    return r - (r >= p) * p


def w_barrett_reduce_u32_lazy(v, p, mu):
    r = (v - w_umulhi32(v, mu) * p) & MASK
    p2 = p + p
    return r - (r >= p2) * p2


# ---------------------------------------------------------------------------
# Public functions on storage tensors (names and contracts of the reference).
# ---------------------------------------------------------------------------

def umulhi32(a, b):
    """High 32 bits of the 64-bit product of two uint32 tensors."""
    return narrow(w_umulhi32(wide(a), wide(b)))


def mont_mul(a, b, p, p_neg_inv):
    """Montgomery product ``a*b*R^-1 mod p``; ``p_neg_inv = -p^-1 mod 2**32``.
    Fully reduced for inputs below ``2p`` when ``4p < 2**32``."""
    return narrow(w_mont_mul(wide(a), wide(b), wide(p), wide(p_neg_inv)))


def shoup_mul(x, w, ws, p):
    """``x*w mod p`` for a precomputed constant ``w < p`` with companion
    ``ws = floor(w * 2**32 / p)``; exact for any uint32 ``x``."""
    return narrow(w_shoup_mul(wide(x), wide(w), wide(ws), wide(p)))


def shoup_mul_lazy(x, w, ws, p):
    """Shoup product without the final correction: result in ``[0, 2p)``."""
    return narrow(w_shoup_mul_lazy(wide(x), wide(w), wide(ws), wide(p)))


def reduce_2p(x, p2):
    """Conditional subtract of ``2p``: ``[0, 4p) -> [0, 2p)``."""
    return narrow(w_reduce_2p(wide(x), wide(p2)))


def reduce_4p_full(x, p):
    """Full reduction ``[0, 4p) -> [0, p)``."""
    return narrow(w_reduce_4p_full(wide(x), wide(p)))


def add_raw(a, b):
    """uint32 sum with wraparound (no reduction): the lazy paths' raw add."""
    return narrow((wide(a) + wide(b)) & MASK)


def mod_add(a, b, p):
    """``(a + b) mod p`` for ``a, b`` in ``[0, p)``."""
    return narrow(w_mod_add(wide(a), wide(b), wide(p)))


def mod_sub(a, b, p):
    """``(a - b) mod p`` for ``a, b`` in ``[0, p)``."""
    return narrow(w_mod_sub(wide(a), wide(b), wide(p)))


def mod_neg(a, p):
    """``(-a) mod p`` for ``a`` in ``[0, p)``."""
    return narrow(w_mod_neg(wide(a), wide(p)))


def barrett_reduce_u32(v, p, mu):
    """``v mod p`` for any uint32 ``v``; ``mu = floor(2**32 / p)``."""
    return narrow(w_barrett_reduce_u32(wide(v), wide(p), wide(mu)))


def barrett_reduce_u32_lazy(v, p, mu):
    """Barrett reduction to the lazy range ``[0, 2p)``."""
    return narrow(w_barrett_reduce_u32_lazy(wide(v), wide(p), wide(mu)))


def to_mont(x, p, p_neg_inv, r2):
    """Enter Montgomery form: ``x -> x*R mod p`` (``r2 = R^2 mod p``)."""
    return mont_mul(x, r2, p, p_neg_inv)


def from_mont(x, p, p_neg_inv):
    """Leave Montgomery form: ``x*R mod p -> x``."""
    xw = wide(x)
    one = torch.ones((), dtype=WIDE, device=xw.device)
    return narrow(w_mont_mul(xw, one, wide(p), wide(p_neg_inv)))


def ugt(a, b):
    """Unsigned ``a > b`` on storage tensors, as a 0/1 storage tensor."""
    return (wide(a) > wide(b)).to(STORE)


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
