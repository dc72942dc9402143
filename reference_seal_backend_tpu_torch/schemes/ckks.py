"""CKKS encoding and encryption.

Counterpart of ``reference_seal_backend_tpu/schemes/ckks.py``.  Encoder:
canonical embedding with the power-of-5 slot ordering, reduced to a
standard length-N complex FFT plus a twist — O(N log N) float64 on host
(the same numpy code as the reference, so encodings are identical).  Slot
j corresponds to evaluation at zeta^(5^j mod 2N), which makes the Galois
element 5^k a cyclic rotate-left by k and 2N-1 the conjugation.

Encode/decode are host-side (they sit outside the timed ``operate`` step);
encrypt/decrypt do their polynomial arithmetic on the context's device via
the NTT plan.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.schemes import core
from reference_seal_backend_tpu_torch.schemes.csprng import ChaChaRng
from reference_seal_backend_tpu_torch.schemes.keys import (
    KeySet,
    batched_enc_randomness,
    to_ntt_mont,
)
from reference_seal_backend_tpu_torch.schemes.params import CkksContext


class CkksEncoder:
    """values[slots] (complex or real) <-> integer polynomial coefficients."""

    def __init__(self, ctx: CkksContext):
        self.ctx = ctx
        n = ctx.n
        self.slots = n // 2
        two_n = 2 * n
        # k(j): evaluation index of slot j; 2k+1 = 5^j mod 2N.
        ks = np.empty(self.slots, dtype=np.int64)
        g = 1
        for j in range(self.slots):
            ks[j] = (g - 1) // 2
            g = g * 5 % two_n
        self.k_of_j = ks
        i = np.arange(n)
        self.twist = np.exp(1j * np.pi * i / n)  # ζ^i

    def embed_inverse(self, values: np.ndarray) -> np.ndarray:
        """Complex slot values -> real coefficient vector (unscaled)."""
        n = self.ctx.n
        z = np.asarray(values, dtype=np.complex128)
        if z.shape[-1] != self.slots:
            full = np.zeros(z.shape[:-1] + (self.slots,), dtype=np.complex128)
            full[..., : z.shape[-1]] = z
            z = full
        E = np.zeros(z.shape[:-1] + (n,), dtype=np.complex128)
        E[..., self.k_of_j] = z
        E[..., n - 1 - self.k_of_j] = np.conj(z)
        a = np.fft.fft(E, axis=-1) / n
        return (a * np.conj(self.twist)).real

    def embed(self, coeffs: np.ndarray) -> np.ndarray:
        """Real coefficient vector -> complex slot values (unscaled)."""
        a = np.asarray(coeffs, dtype=np.float64) * self.twist
        E = np.fft.ifft(a, axis=-1) * self.ctx.n
        return E[..., self.k_of_j]

    def encode(
        self, values: Sequence, scale: Optional[float] = None
    ) -> core.Plaintext:
        """Encode (real or complex) slot values at ``scale`` into an
        NTT-domain Montgomery plaintext at the top level."""
        ctx = self.ctx
        scale = float(scale if scale is not None else ctx.scale)
        mf = self.embed_inverse(np.asarray(values)) * scale
        if np.max(np.abs(mf)) >= 2**62:
            raise ValueError("encoded coefficients exceed int64 range")
        m = np.rint(mf).astype(np.int64)
        data = to_ntt_mont(ctx, m, slice(0, ctx.L))
        return core.Plaintext(data=data, level=ctx.L, scale=scale)

    def decode(
        self, coeffs_centered: np.ndarray, scale: float, slots: Optional[int] = None
    ) -> np.ndarray:
        """Centered bigint coefficient vector -> complex slot values."""
        vals = self.embed(coeffs_centered.astype(np.float64)) / scale
        return vals if slots is None else vals[..., :slots]


class CkksEncryptor:
    def __init__(
        self, ctx: CkksContext, keys: KeySet, seed: Optional[int] = None
    ):
        """``seed`` makes the encryption randomness stream reproducible
        (None draws fresh OS entropy — the production default).  Either
        way the draws come from the ChaCha20 CSPRNG (schemes/csprng.py)."""
        self.ctx = ctx
        self.keys = keys
        self._rng = ChaChaRng(
            seed if seed is not None else os.urandom(32), stream=0xE4C
        )

    def encrypt_pt(self, pt: core.Plaintext) -> core.Ciphertext:
        """Public-key encryption of an encoded plaintext.

        ``pt.data`` may carry leading batch axes ``[..., L, N]``; the
        ChaCha draw order matches a per-sample loop exactly, so results
        are bit-identical either way."""
        ctx = self.ctx
        L = pt.level
        pk = self.keys.public
        u_res, e0_res, e1_res = batched_enc_randomness(
            self._rng, ctx, ctx.primes[:L], pt.data.shape[:-2]
        )
        u = ctx.plan.fwd(u_res, lo=0)
        e0 = ctx.plan.fwd(e0_res, lo=0)
        e1 = ctx.plan.fwd(e1_res, lo=0)
        p, pni = ctx.consts(0, L)
        pt_data = pt.data.to(ctx.device)
        c0 = modops.mod_add(
            modops.mod_add(modops.mont_mul(pk.b[:L], u, p, pni), e0, p),
            pt_data,
            p,
        )
        c1 = modops.mod_add(modops.mont_mul(pk.a[:L], u, p, pni), e1, p)
        # dim=-3 keeps the ciphertext [..., size, L, N] layout under
        # leading batch axes
        return core.Ciphertext(
            data=modops.narrow(torch.stack([c0, c1], dim=-3)),
            level=L,
            scale=pt.scale,
            is_ntt=True,
        )

    def encrypt_zero(self, level: int, scale: float) -> core.Ciphertext:
        ctx = self.ctx
        pt = core.Plaintext(
            data=torch.zeros(
                (level, ctx.n), dtype=modops.STORE, device=ctx.device
            ),
            level=level,
            scale=scale,
        )
        return self.encrypt_pt(pt)


class CkksDecryptor:
    def __init__(self, ctx: CkksContext, keys: KeySet):
        self.ctx = ctx
        self.keys = keys

    def _device_coeffs(self, ct: core.Ciphertext) -> torch.Tensor:
        """sum_k c_k s^k (Horner) and the inverse NTT, on the device."""
        ctx, size, L = self.ctx, ct.size, ct.level
        data = ct.data.to(ctx.device)
        s = self.keys.secret_ntt[:L]
        p, pni = ctx.consts(0, L)
        acc = data[..., size - 1, :, :]
        for k in range(size - 2, -1, -1):
            acc = modops.mod_add(
                modops.mont_mul(acc, s, p, pni), data[..., k, :, :], p
            )
        return ctx.plan.inv(modops.narrow(acc), lo=0)

    def decrypt_to_coeffs(self, ct: core.Ciphertext) -> np.ndarray:
        """sum_k c_k s^k, iNTT, CRT-compose -> centered bigint coefficients."""
        ctx = self.ctx
        L = ct.level
        res = core.mont_to_rns(
            modops.to_numpy(self._device_coeffs(ct)), ctx.primes[:L]
        )
        return core.crt_compose_centered(res, ctx.primes[:L])

    def decrypt(self, ct: core.Ciphertext, slots: Optional[int] = None):
        """Leading batch axes on ``ct.data`` are decoded vectorized."""
        enc = encoder_for(self.ctx)
        return enc.decode(self.decrypt_to_coeffs(ct), ct.scale, slots)


@functools.lru_cache(maxsize=None)
def encoder_for(ctx: CkksContext) -> CkksEncoder:
    return CkksEncoder(ctx)
