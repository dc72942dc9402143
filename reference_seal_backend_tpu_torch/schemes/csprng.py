"""Cryptographic sampling: a seeded ChaCha20 stream behind a tiny
numpy-Generator-compatible facade.

The reference inherits SEAL's Blake2-based CSPRNG for every secret /
error / encryption-randomness draw (reference-seal-backend
src/engine/seal_context.cpp:46-70 -> seal::KeyGenerator / Encryptor use
seal::UniformRandomGeneratorFactory, a Blake2xb stream by default).  The
framework's keygen and encryptors draw from this module; numpy PCG64
remains only for benchmark *input* generation, which is harness-side data, not cryptographic material.

Design:

* ChaCha20 (RFC 8439) block function, vectorized over the 32-bit block
  counter with numpy uint32 ops — one ``_blocks`` call produces the whole
  requested keystream, so sampling a 2^23-word key array is a handful of
  wide vector sweeps, not a Python loop (keygen stays one-time cheap).
* Key = SHA-256 of the canonical seed encoding; the 96-bit nonce carries
  a caller-chosen stream id, so ("keygen", seed) and ("encrypt", seed)
  are independent streams of one seed — same reproducibility contract as
  the numpy SeedSequence scheme it replaces.
* All bounded draws are **rejection-sampled** (no modulo bias): uniform
  residues mod p are exact, matching SEAL's own rejection sampling for
  uniform polynomials.
* Gaussians are Box-Muller over 53-bit uniforms (rounded + clamped by the
  callers exactly as before), so the error distribution is unchanged.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Optional, Sequence, Union

import numpy as np

_U32 = np.uint32
_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=_U32
)  # "expand 32-byte k"


def _rotl(x: np.ndarray, k: int) -> np.ndarray:
    return (x << _U32(k)) | (x >> _U32(32 - k))


def _quarter(s: np.ndarray, a: int, b: int, c: int, d: int) -> None:
    """In-place quarter round on state columns (s is [n_blocks, 16])."""
    s[:, a] += s[:, b]
    s[:, d] = _rotl(s[:, d] ^ s[:, a], 16)
    s[:, c] += s[:, d]
    s[:, b] = _rotl(s[:, b] ^ s[:, c], 12)
    s[:, a] += s[:, b]
    s[:, d] = _rotl(s[:, d] ^ s[:, a], 8)
    s[:, c] += s[:, d]
    s[:, b] = _rotl(s[:, b] ^ s[:, c], 7)


def chacha_blocks(
    key_words: np.ndarray, nonce_words: np.ndarray, counter0: int, n_blocks: int
) -> np.ndarray:
    """RFC 8439 ChaCha20 block function for ``n_blocks`` consecutive
    counters, vectorized: returns [n_blocks, 16] uint32 keystream.

    The block counter is effectively 64-bit: bits >= 2^32 carry into the
    first nonce word, so a single logical stream never repeats (2^32
    blocks = 256 GiB was a silent wrap before; ChaChaRng reserves nonce
    word 0 as zero for exactly this carry).  Counters below 2^32 with a
    zero first nonce word are bit-identical to plain RFC 8439."""
    state = np.empty((n_blocks, 16), dtype=_U32)
    state[:, 0:4] = _CONSTANTS
    state[:, 4:12] = key_words
    ctr = np.arange(counter0, counter0 + n_blocks, dtype=np.uint64)
    state[:, 12] = (ctr & np.uint64(0xFFFFFFFF)).astype(_U32)
    state[:, 13:16] = nonce_words
    with np.errstate(over="ignore"):
        state[:, 13] += (ctr >> np.uint64(32)).astype(_U32)
    work = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):  # 20 rounds = 10 double rounds
            _quarter(work, 0, 4, 8, 12)
            _quarter(work, 1, 5, 9, 13)
            _quarter(work, 2, 6, 10, 14)
            _quarter(work, 3, 7, 11, 15)
            _quarter(work, 0, 5, 10, 15)
            _quarter(work, 1, 6, 11, 12)
            _quarter(work, 2, 7, 8, 13)
            _quarter(work, 3, 4, 9, 14)
        work += state
    return work


def _int_bytes(v: int) -> bytes:
    """Minimal-width signed little-endian encoding with a length prefix —
    unambiguous for arbitrary-magnitude ints (a fixed 32-byte field
    overflowed at |seed| >= 2^255)."""
    v = int(v)
    width = max(1, (v.bit_length() + 8) // 8)  # +8: room for the sign bit
    body = v.to_bytes(width, "little", signed=True)
    return len(body).to_bytes(4, "little") + body


def _seed_key(seed: Union[int, Sequence[int], bytes]) -> bytes:
    """Canonical 32-byte key from any seed shape the callers use.

    The three seed kinds are domain-separated by a type tag so e.g.
    ``ChaChaRng(5)`` and ``ChaChaRng([5])`` derive unrelated keys, and
    int entries are length-prefixed variable-width (no magnitude cap)."""
    if isinstance(seed, bytes):
        material = b"B" + seed
    elif isinstance(seed, (int, np.integer)):
        material = b"I" + _int_bytes(seed)
    else:
        material = b"S" + b"".join(_int_bytes(s) for s in seed)
    return hashlib.sha256(b"rsb-tpu-chacha20|" + material).digest()


class ChaChaRng:
    """Seeded ChaCha20 sampler exposing the numpy.Generator subset the
    scheme layer uses (``integers``; ``normal``), plus raw ``u32``.

    ``stream`` separates independent substreams of one seed (keygen vs
    encryption randomness), mirroring the SeedSequence([tag, seed])
    scheme this replaces."""

    def __init__(
        self, seed: Union[int, Sequence[int], bytes], stream: int = 0
    ):
        key = _seed_key(seed)
        self._key_words = np.frombuffer(key, dtype="<u4").astype(_U32)
        self._nonce = np.frombuffer(
            struct.pack("<IQ", 0, stream & 0xFFFFFFFFFFFFFFFF), dtype="<u4"
        ).astype(_U32)
        self._counter = 0
        self._buf = np.empty(0, dtype=_U32)

    # -- keystream ---------------------------------------------------------

    def u32(self, n: int) -> np.ndarray:
        """Next ``n`` uint32 keystream words."""
        if self._buf.size < n:
            need = n - self._buf.size
            blocks = (need + 15) // 16 + 1
            ks = chacha_blocks(
                self._key_words, self._nonce, self._counter, blocks
            ).reshape(-1)
            self._counter += blocks
            self._buf = np.concatenate([self._buf, ks])
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def u64(self, n: int) -> np.ndarray:
        w = self.u32(2 * n).astype(np.uint64)
        return (w[0::2] << np.uint64(32)) | w[1::2]

    # -- numpy.Generator-compatible subset ---------------------------------

    def integers(self, low: int, high: int, size=None, dtype=np.int64):
        """Uniform integers in [low, high) — REJECTION sampled, unbiased
        (the numpy.Generator signature the scheme layer uses)."""
        span = int(high) - int(low)
        if span <= 0:
            raise ValueError("high must exceed low")
        if span > (1 << 32):
            raise NotImplementedError("spans beyond 2^32 not needed here")
        n = 1 if size is None else int(np.prod(size))
        # largest multiple of span below 2^32: accept x < limit
        limit = (1 << 32) - ((1 << 32) % span)
        out = np.empty(n, dtype=np.uint64)
        filled = 0
        while filled < n:
            draw = self.u32(max(n - filled + 16, (n - filled) * 9 // 8))
            ok = draw < np.uint32(limit & 0xFFFFFFFF) if limit < (1 << 32) \
                else np.ones(draw.shape, dtype=bool)
            acc = draw[ok][: n - filled]
            out[filled : filled + acc.size] = acc.astype(np.uint64) % span
            filled += acc.size
        res = (out.astype(np.int64) + int(low)).astype(dtype)
        return res.reshape(size) if size is not None else res[0]

    def normal(self, loc: float = 0.0, scale: float = 1.0, size=None):
        """Gaussian via Box-Muller over 53-bit uniforms in (0, 1]."""
        n = 1 if size is None else int(np.prod(size))
        m = (n + 1) // 2
        u1 = ((self.u64(m) >> np.uint64(11)).astype(np.float64) + 1.0) / (
            1 << 53
        )  # (0, 1] — log never sees 0
        u2 = (self.u64(m) >> np.uint64(11)).astype(np.float64) / (1 << 53)
        r = np.sqrt(-2.0 * np.log(u1))
        theta = 2.0 * np.pi * u2
        z = np.concatenate([r * np.cos(theta), r * np.sin(theta)])[:n]
        res = loc + scale * z
        return res.reshape(size) if size is not None else float(res[0])
