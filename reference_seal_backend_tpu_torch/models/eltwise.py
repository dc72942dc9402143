"""Element-wise add/multiply workloads (CKKS Float64 / BFV Int64).

Counterpart of ``reference_seal_backend_tpu/models/eltwise.py``: one whole
vector packed per ciphertext, Latency and Offline categories for both add
and multiply, both schemes.  The Offline batch0 x batch1 sample
cross product is two broadcast batch axes: ``[B0, 1, ...] op [1, B1, ...]``.

Multiply is the *bare* ct-ct product (no relinearization): the decryptor
handles 3-component ciphertexts.  Under BFV it is the BEHZ multiply
(evaluator/behz.py).
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Sequence

import numpy as np

from reference_seal_backend_tpu_torch.engine.descriptor import (
    BenchmarkDescriptor,
    Workload,
)
from reference_seal_backend_tpu_torch.models.base import Handle, HEBenchmark


class ElementWiseBenchmark(HEBenchmark):
    """EltwiseAdd / EltwiseMult, both schemes, both categories."""

    tag_family = "eltwise"
    n_operands = 2

    def __init__(self, descriptor: BenchmarkDescriptor, params=None, device=None):
        super().__init__(descriptor, params, device)
        self.n = self.params["n"]
        if self.n > self.ctx.slots:
            raise ValueError(
                f"vector size {self.n} exceeds slot count {self.ctx.slots}"
            )
        self.is_add = descriptor.workload is Workload.ELTWISE_ADD
        self._op_graph = self.graph_with_keys(self._operate_impl)

    # -- pipeline --------------------------------------------------------- #

    def encode(self, inputs: Sequence[np.ndarray]) -> Handle:
        """inputs = [samples0 [B0, n], samples1 [B1, n]]."""
        pts = [self.encode_batch(x) for x in inputs]
        return Handle(tag="eltwise_pt", payload=tuple(pts))

    def encrypt(self, encoded: Handle) -> Handle:
        self.check_handle(encoded, "pt")
        cts = tuple(self.encrypt_batch(pt) for pt in encoded.payload)
        return Handle(tag="eltwise_ct", payload=cts)

    def _operate_impl(self, a, b):
        a2 = replace(a, data=a.data[:, None])
        b2 = replace(b, data=b.data[None, :])
        if self.is_add:
            return self.ev.add(a2, b2)
        return self.ev.multiply(a2, b2)

    def operate(self, loaded: Handle) -> Handle:
        self.check_handle(loaded, "ct")
        a, b = loaded.payload
        out = self._op_graph(a, b)
        return Handle(
            tag="eltwise_result",
            payload=out,
            meta={"batch_shape": (a.data.shape[0], b.data.shape[0])},
        )

    def decrypt(self, stored: Handle) -> Handle:
        self.check_handle(stored, "result")
        shape = stored.meta["batch_shape"]
        vals = list(self.decrypt_each(stored.payload, shape))
        return Handle(tag="eltwise_clear", payload=vals, meta=stored.meta)

    def decode(self, decrypted: Handle) -> List[np.ndarray]:
        self.check_handle(decrypted, "clear")
        return [self.clean(v[: self.n]) for v in decrypted.payload]
