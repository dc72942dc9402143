"""Matrix-multiply workloads: the three packing strategies x two schemes.

Counterpart of ``reference_seal_backend_tpu/models/matmult.py``
(M0[r0×c0]·M1[c0×c1], Latency category), disambiguated by the descriptor's
algorithm-variant id ``descriptor.other``:

* **MatMultVal** (0x00) — one matrix *row* per ciphertext, M1 transposed at
  encode; each output element is a row·row dot product: multiply → relin →
  (CKKS: rescale) → accumulate; result in slot 0 of each of r0·c1 ciphertexts.  The
  r0×c1 output grid is two broadcast batch axes.

* **MatMultCipherBatchAxis** (0x01) — one scalar matrix *element* per
  ciphertext; broadcast elementwise multiply [r0,c0,1]×[1,c0,c1], a modular
  tree-sum over the inner batch axis in ciphertext space, then one batched
  relinearize (+ CKKS rescale) per output — no rotations, no Galois keys.

* **MatMultRow** (0x02) — spacer row packing: M0 row i is replicated
  across c0 blocks of stride ``spacers``, all of M1 packed into ONE
  ciphertext; per row one ct-ct multiply + relin, then the c0−1 rotations by
  multiples of ``spacers`` share ONE hoisted digit decomposition and ONE
  mod-down (Evaluator.rotate_sum).  BFV packs two M0 rows per ciphertext
  in its two batching rows (an odd last row paired with zeros) and rotates
  within rows, with M1 duplicated into both.

BFV never rescales; its results are exact integers.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import List, Sequence

import numpy as np

from reference_seal_backend_tpu_torch.engine.descriptor import BenchmarkDescriptor
from reference_seal_backend_tpu_torch.evaluator import composite
from reference_seal_backend_tpu_torch.evaluator.eval import _mod_sum
from reference_seal_backend_tpu_torch.models.base import Handle, HEBenchmark


class _MatMultBase(HEBenchmark):
    def __init__(self, descriptor: BenchmarkDescriptor, params=None, device=None):
        p = dict(descriptor.default_params)
        if params:
            p.update(params)
        self.r0 = p["rows_m0"]
        self.c0 = p["cols_m0"]
        self.c1 = p["cols_m1"]
        super().__init__(descriptor, params, device)
        self._op_graph = self.graph_with_keys(self._operate_impl)

    def encrypt(self, encoded: Handle) -> Handle:
        self.check_handle(encoded, "pt")
        cts = tuple(self.encrypt_batch(pt) for pt in encoded.payload)
        return self.handle("ct", cts)

    def operate(self, loaded: Handle) -> Handle:
        self.check_handle(loaded, "ct")
        m0, m1 = loaded.payload
        out = self._op_graph(m0, m1)
        return self.handle("result", out, meta=loaded.meta)

    def decrypt(self, stored: Handle) -> Handle:
        """One ciphertext per output element, its value in slot 0 (the val
        and cipher-batch-axis packings; the row packing overrides)."""
        self.check_handle(stored, "result")
        vals = [
            v[0]
            for v in self.decrypt_each(stored.payload, (self.r0, self.c1))
        ]
        mat = np.asarray(vals).reshape(self.r0, self.c1)
        return self.handle("clear", mat)

    def decode(self, decrypted: Handle) -> List[np.ndarray]:
        self.check_handle(decrypted, "clear")
        return [self.clean(decrypted.payload)]


class MatMultValBenchmark(_MatMultBase):
    """One matrix row per ciphertext; M1 transposed at encode."""

    tag_family = "matmultval"

    def __init__(self, descriptor, params=None, device=None):
        super().__init__(descriptor, params, device)
        if self.c0 > self.ctx.slots:
            raise ValueError(
                f"inner dim {self.c0} exceeds {self.ctx.slots} slots"
            )

    def rotation_steps(self) -> List[int]:
        # the CKKS slot count and the BFV batching row are both N/2
        slots = self.params["poly_modulus_degree"] // 2
        return composite.rotations_for_accumulate(self.c0, slots)

    def needs_conjugation_key(self) -> bool:
        return not self.is_ckks and self.c0 > self.ctx.n // 2

    def encode(self, inputs: Sequence[np.ndarray]) -> Handle:
        m0 = np.asarray(inputs[0]).reshape(self.r0, self.c0)
        m1 = np.asarray(inputs[1]).reshape(self.c0, self.c1)
        pt0 = self.encode_batch(m0)            # r0 cts: rows of M0
        pt1 = self.encode_batch(m1.T)          # c1 cts: columns of M1
        return self.handle("pt", (pt0, pt1))

    def _operate_impl(self, m0, m1):
        a = replace(m0, data=m0.data[:, None])   # [r0, 1, …]
        b = replace(m1, data=m1.data[None, :])   # [1, c1, …]
        prod = self.ev.relinearize(self.ev.multiply(a, b))
        if self.is_ckks:
            prod = self.ev.rescale_to_next(prod)
        return composite.accumulate(self.ev, prod, self.c0)


class MatMultCipherBatchAxisBenchmark(_MatMultBase):
    """One scalar element per ciphertext (column-major), no rotations."""

    tag_family = "matmultcba"

    def encode(self, inputs: Sequence[np.ndarray]) -> Handle:
        m0 = np.asarray(inputs[0]).reshape(self.r0, self.c0)
        m1 = np.asarray(inputs[1]).reshape(self.c0, self.c1)
        # one slot-0 scalar per plaintext: [r0*c0, 1] and [c0*c1, 1]
        pt0 = self.encode_batch(m0.reshape(-1, 1))
        pt1 = self.encode_batch(m1.reshape(-1, 1))
        return self.handle("pt", (pt0, pt1))

    def _operate_impl(self, m0, m1):
        a = m0.data.reshape((self.r0, self.c0) + m0.data.shape[1:])
        b = m1.data.reshape((self.c0, self.c1) + m1.data.shape[1:])
        a = replace(m0, data=a[:, :, None])        # [r0, c0, 1, …]
        b = replace(m1, data=b[None, :, :])        # [1,  c0, c1, …]
        prod = self.ev.multiply(a, b)               # size-3, [r0, c0, c1, …]
        # ciphertext-space accumulation over the inner dimension, then one
        # batched relinearize (+ rescale) per output.
        summed = replace(
            prod, data=_mod_sum(prod.data, self.ctx.p[: prod.level], axis=1)
        )
        out = self.ev.relinearize(summed)
        if self.is_ckks:
            out = self.ev.rescale_to_next(out)
        return out


class MatMultRowBenchmark(_MatMultBase):
    """Spacer row packing; M1 in one ciphertext; rotation accumulation."""

    tag_family = "matmultrow"

    def __init__(self, descriptor, params=None, device=None):
        p = dict(descriptor.default_params)
        if params:
            p.update(params)
        row = p["poly_modulus_degree"] // 2  # CKKS slots = BFV row size
        self.blocks = 1 << math.ceil(math.log2(max(p["cols_m0"], 1)))
        self.spacers = row // self.blocks
        super().__init__(descriptor, params, device)
        if self.c1 > self.spacers:
            raise ValueError(
                f"cols_m1 {self.c1} exceeds spacer width {self.spacers}"
            )

    def rotation_steps(self) -> List[int]:
        # Linear steps j·spacers, j ∈ [1, c0): with hoisted key switching
        # (Evaluator.rotate_sum) all of them share one digit decomposition
        # and one mod-down.  Blocks >= c0 hold zeros and are skipped.
        return [self.spacers * j for j in range(1, self.c0)]

    def _pack(self, block_vals) -> np.ndarray:
        """Slot vector whose block j holds ``block_vals[j]`` (a scalar of an
        M0 row, or row j of M1) in its first c1 slots."""
        vec = np.zeros(self.spacers * self.blocks)
        for j in range(self.c0):
            vec[self.spacers * j : self.spacers * j + self.c1] = block_vals[j]
        return vec

    def encode(self, inputs: Sequence[np.ndarray]) -> Handle:
        m0 = np.asarray(inputs[0]).reshape(self.r0, self.c0)
        m1 = np.asarray(inputs[1]).reshape(self.c0, self.c1)
        rows = np.stack([self._pack(m0[i]) for i in range(self.r0)])
        m1_vec = self._pack(m1)
        if self.is_ckks:
            pt0 = self.encode_batch(rows)
            pt1 = self.encode_batch(m1_vec[None])
        else:
            # two M0 rows per ciphertext via BFV's two batching rows, an odd
            # last row beside zeros; M1 duplicated into both rows
            if self.r0 % 2:
                rows = np.concatenate([rows, np.zeros_like(rows[:1])])
            pt0 = self.encode_batch(rows.reshape(-1, 2 * rows.shape[1]))
            pt1 = self.encode_batch(np.concatenate([m1_vec, m1_vec])[None])
        return self.handle("pt", (pt0, pt1))

    def _operate_impl(self, m0, m1):
        out = self.ev.relinearize(self.ev.multiply(m0, m1))
        # Block 0 of the result needs Σ_j rot(out, j·spacers) over the c0
        # live blocks; one hoisted key-switch covers every rotation.
        return self.ev.rotate_sum(out, [0] + self.rotation_steps())

    def decrypt(self, stored: Handle) -> Handle:
        self.check_handle(stored, "result")
        ct_rows = stored.payload.data.shape[0]
        mat = np.zeros((self.r0, self.c1))
        half = self.ctx.n // 2
        for i, v in enumerate(self.decrypt_each(stored.payload, (ct_rows,))):
            if self.is_ckks:
                mat[i] = np.real(v[: self.c1])
            else:
                mat[2 * i] = v[: self.c1]
                if 2 * i + 1 < self.r0:
                    mat[2 * i + 1] = v[half : half + self.c1]
        return self.handle("clear", mat)
