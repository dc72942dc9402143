"""BFV (exact integer) scheme: batch encoder, encryptor, decryptor.

Counterpart of ``reference_seal_backend_tpu/schemes/bfv.py``.  Slot
semantics follow SEAL's 2 x (N/2) batching matrix: ``rotate_rows`` (Galois
5^k) cycles each row, ``rotate_columns`` (Galois 2N-1) swaps the rows.  The
encoder is built on the same power-of-5 evaluation ordering as the CKKS
encoder, so the same Galois machinery drives both schemes.

BFV ciphertexts are stored NTT-domain Montgomery at rest, exactly like
CKKS; only the BEHZ multiply (evaluator/behz.py) drops to the coefficient
domain.  Plaintexts are encoded mod t *unscaled*; the Delta = floor(q/t)
scaling is applied inside encrypt / add_plain.

Encode and decode are host-side numpy (mod-t NTT, the same code as the
reference); encrypt and the sum of c_k s^k before the inverse NTT run on
the context's device, the CRT composition and the t/q rounding on the host.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from reference_seal_backend_tpu_torch.nums import polyref, primegen
from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.schemes import core
from reference_seal_backend_tpu_torch.schemes.csprng import ChaChaRng
from reference_seal_backend_tpu_torch.schemes.keys import (
    KeySet,
    batched_enc_randomness,
    to_ntt_mont,
)
from reference_seal_backend_tpu_torch.schemes.params import BfvContext


class BfvBatchEncoder:
    """int64 slot vector [N] <-> plaintext polynomial mod t."""

    def __init__(self, ctx: BfvContext):
        self.ctx = ctx
        n = ctx.n
        self.slots = n
        self.row_size = n // 2
        two_n = 2 * n
        self.psi_t = primegen.min_root_of_unity(two_n, ctx.t)
        ks = np.empty(self.row_size, dtype=np.int64)
        g = 1
        for j in range(self.row_size):
            ks[j] = (g - 1) // 2
            g = g * 5 % two_n
        bits = n.bit_length() - 1
        brv = np.array(
            [polyref._bitrev(i, bits) for i in range(n)], dtype=np.int64
        )
        # storage index of row-0 slot j and row-1 slot j
        self.store0 = brv[ks]
        self.store1 = brv[n - 1 - ks]

    def encode(self, values: Sequence[int]) -> core.Plaintext:
        ctx = self.ctx
        v = np.asarray(values, dtype=np.int64) % ctx.t
        if v.shape[-1] > self.slots:
            raise ValueError("too many values for batching slots")
        full = np.zeros(self.slots, dtype=np.int64)
        full[: v.shape[-1]] = v
        store = np.empty(self.slots, dtype=np.uint32)
        store[self.store0] = full[: self.row_size]
        store[self.store1] = full[self.row_size :]
        m = polyref.host_intt(store, self.psi_t, ctx.t)  # poly mod t
        data = to_ntt_mont(ctx, m.astype(np.int64), slice(0, ctx.L))
        return core.Plaintext(data=data, level=ctx.L, scale=1.0)

    def decode_poly(self, m_mod_t: np.ndarray) -> np.ndarray:
        """Coefficient polynomial mod t -> int64 slot values (centered).
        Leading batch axes broadcast."""
        t = self.ctx.t
        store = polyref.host_ntt(m_mod_t.astype(np.uint32), self.psi_t, t)
        out = np.empty(store.shape[:-1] + (self.slots,), dtype=np.int64)
        out[..., : self.row_size] = store[..., self.store0]
        out[..., self.row_size :] = store[..., self.store1]
        return np.where(out > t // 2, out - t, out)


class BfvEncryptor:
    def __init__(
        self, ctx: BfvContext, keys: KeySet, seed: Optional[int] = None
    ):
        """``seed`` makes the encryption randomness stream reproducible
        (None draws fresh OS entropy — the production default).  Either
        way the draws come from the ChaCha20 CSPRNG (schemes/csprng.py),
        on the stream the reference's BFV encryptor uses."""
        self.ctx = ctx
        self.keys = keys
        self._rng = ChaChaRng(
            seed if seed is not None else os.urandom(32), stream=0xBF5
        )

    def encrypt_pt(self, pt: core.Plaintext) -> core.Ciphertext:
        """c = (Delta*m + pk_b*u + e0, pk_a*u + e1), NTT Montgomery at rest.

        ``pt.data`` may carry leading batch axes ``[..., L, N]``; the
        ChaCha draw order matches a per-sample loop exactly."""
        ctx = self.ctx
        L = ctx.L
        pk = self.keys.public
        u_res, e0_res, e1_res = batched_enc_randomness(
            self._rng, ctx, ctx.primes[:L], pt.data.shape[:-2]
        )
        u = ctx.plan.fwd(u_res, lo=0)
        e0 = ctx.plan.fwd(e0_res, lo=0)
        e1 = ctx.plan.fwd(e1_res, lo=0)
        p, pni = ctx.consts(0, L)
        dm = modops.shoup_mul(
            pt.data.to(ctx.device), ctx.delta_plain, ctx.delta_shoup, p
        )
        c0 = modops.mod_add(
            modops.mod_add(modops.mont_mul(pk.b[:L], u, p, pni), e0, p),
            dm,
            p,
        )
        c1 = modops.mod_add(modops.mont_mul(pk.a[:L], u, p, pni), e1, p)
        # dim=-3 keeps [..., size, L, N] under leading batch axes
        return core.Ciphertext(
            data=modops.narrow(torch.stack([c0, c1], dim=-3)), level=L, scale=1.0,
            is_ntt=True,
        )


class BfvDecryptor:
    def __init__(self, ctx: BfvContext, keys: KeySet):
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

    def _centered(self, ct: core.Ciphertext) -> np.ndarray:
        """[c(s)]_q as centered bigints (object array [..., N])."""
        primes = self.ctx.primes[: ct.level]
        res = core.mont_to_rns(
            modops.to_numpy(self._device_coeffs(ct)), primes
        )
        return core.crt_compose_centered(res, primes)

    def decrypt_poly(self, ct: core.Ciphertext) -> np.ndarray:
        """-> plaintext polynomial mod t: round(t*[c(s)]_q / q) mod t."""
        x = self._centered(ct)
        q = self.ctx.q_at_level(ct.level)
        t = self.ctx.t
        # round(t*x/q) = floor((2tx + q) / 2q), valid for negative x too
        # (Python floor division is exact on bigints).
        m = (x * (2 * t) + q) // (2 * q)
        return (m % t).astype(np.uint64).astype(np.uint32)

    def decrypt(self, ct: core.Ciphertext) -> np.ndarray:
        """Leading batch axes on ``ct.data`` decode vectorized."""
        return encoder_for(self.ctx).decode_poly(self.decrypt_poly(ct))

    def noise_budget_bits(self, ct: core.Ciphertext) -> float:
        """Remaining noise budget (diagnostic, like SEAL's
        invariant_noise_budget)."""
        x = self._centered(ct)
        q = self.ctx.q_at_level(ct.level)
        # v = t*x mod q centered: the invariant noise numerator
        v = (x * self.ctx.t) % q
        v = np.where(v > q // 2, v - q, v)
        vmax = int(np.abs(v).max())
        if vmax == 0:
            return float(q.bit_length())
        return max(0.0, (q // (2 * vmax)).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def encoder_for(ctx: BfvContext) -> BfvBatchEncoder:
    return BfvBatchEncoder(ctx)
