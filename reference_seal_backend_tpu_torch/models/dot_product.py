"""Dot product workloads (CKKS Float64 / BFV Int64).

Counterpart of ``reference_seal_backend_tpu/models/dot_product.py``: per
sample pair multiply -> relinearize -> (CKKS: rescale) ->
sum-across-slots (:func:`evaluator.composite.accumulate`), result read from
slot 0.  Offline batches are broadcast batch axes, so the entire
batch0 x batch1 cross product shares each key switch's NTT launches.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Sequence

import numpy as np

from reference_seal_backend_tpu_torch.engine.descriptor import BenchmarkDescriptor
from reference_seal_backend_tpu_torch.evaluator import composite
from reference_seal_backend_tpu_torch.models.base import Handle, HEBenchmark


class DotProductBenchmark(HEBenchmark):
    tag_family = "dot"
    n_operands = 2

    def __init__(self, descriptor: BenchmarkDescriptor, params=None, device=None):
        self.n = (params or {}).get("n", descriptor.default_params["n"])
        super().__init__(descriptor, params, device)
        if self.n > self.ctx.slots:
            raise ValueError(
                f"vector size {self.n} exceeds slot count {self.ctx.slots}"
            )
        self._op_graph = self.graph_with_keys(self._operate_impl)

    def rotation_steps(self) -> List[int]:
        # the CKKS slot count and the BFV batching row are both N/2
        slots = self.params["poly_modulus_degree"] // 2
        return composite.rotations_for_accumulate(self.n, slots)

    def needs_conjugation_key(self) -> bool:
        # BFV accumulate folds the second batching row via rotate_columns
        # when the vector spills past one row
        return not self.is_ckks and self.n > self.ctx.n // 2

    # -- pipeline --------------------------------------------------------- #

    def encode(self, inputs: Sequence[np.ndarray]) -> Handle:
        pts = [self.encode_batch(x) for x in inputs]
        return Handle(tag="dot_pt", payload=tuple(pts))

    def encrypt(self, encoded: Handle) -> Handle:
        self.check_handle(encoded, "pt")
        cts = tuple(self.encrypt_batch(pt) for pt in encoded.payload)
        return Handle(tag="dot_ct", payload=cts)

    def _operate_impl(self, a, b):
        a2 = replace(a, data=a.data[:, None])
        b2 = replace(b, data=b.data[None, :])
        prod = self.ev.relinearize(self.ev.multiply(a2, b2))
        if self.is_ckks:
            prod = self.ev.rescale_to_next(prod)
        return composite.accumulate(self.ev, prod, self.n)

    def _operate(self, loaded: Handle) -> Handle:
        a, b = loaded.payload
        out = self._op_graph(a, b)
        return Handle(
            tag="dot_result",
            payload=out,
            meta={"batch_shape": (a.data.shape[0], b.data.shape[0])},
        )

    def decrypt(self, stored: Handle) -> Handle:
        self.check_handle(stored, "result")
        shape = stored.meta["batch_shape"]
        vals = list(self.decrypt_each(stored.payload, shape))
        return Handle(tag="dot_clear", payload=vals, meta=stored.meta)

    def decode(self, decrypted: Handle) -> List[np.ndarray]:
        self.check_handle(decrypted, "clear")
        # result lives in slot 0
        return [self.clean(v[:1]) for v in decrypted.payload]
