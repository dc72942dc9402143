"""Logistic-regression inference workload (CKKS, PolyD3 sigmoid).

Counterpart of ``reference_seal_backend_tpu/models/logreg.py``:
``sigmoid(W·x + b)`` per input, sigmoid approximated by the degree-3
polynomial with coefficients {0.5, 0.15012, 0.0, -0.0015930078125}.

Pipeline per offline batch, three stages:
  1. dot products: W × X_i multiply → relinearize → rescale → accumulate,
     the whole batch as one broadcast axis;
  2. collapse the batch of slot-0 dots into one ciphertext, value i in
     slot i (the log2 doubling merge of evaluator/composite.py);
  3. bias add with level matching, then Horner evaluation of the sigmoid
     polynomial.

Operands arrive as the 3-tuple (W, b, X); Offline data counts are
{1, 1, batch}.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Sequence

import numpy as np
import torch

from reference_seal_backend_tpu_torch.engine.descriptor import BenchmarkDescriptor
from reference_seal_backend_tpu_torch.evaluator import composite
from reference_seal_backend_tpu_torch.models.base import Handle, HEBenchmark

SIGMOID_D3 = (0.5, 0.15012, 0.0, -0.0015930078125)
# The batch behind the FLEXIBLE (0) registration of the Offline descriptor.
DEFAULT_BATCH = 100


class LogRegBenchmark(HEBenchmark):
    tag_family = "logreg"
    n_operands = 3  # (W, b, X)

    def __init__(self, descriptor: BenchmarkDescriptor, params=None, device=None):
        p = dict(descriptor.default_params)
        if params:
            p.update(params)
        self.n = p["n"]
        self.batch = (
            (p.get("batch_size", 0) or DEFAULT_BATCH)
            if descriptor.category.value == "offline"
            else 1
        )
        super().__init__(descriptor, params, device)
        if self.n > self.ctx.slots:
            raise ValueError("feature count exceeds slot count")
        if self.batch > self.ctx.slots:
            raise ValueError("batch exceeds slot count")
        # Offline batches lift key-switch digits for every sample at once
        # inside the dots stage — [batch, 2, n_dig, l+ns, N] temporaries.  The
        # dots are independent across samples, so operate() runs the stage
        # in equal chunks sized by the reference's rule (512 MB of uint32
        # digit temporaries a chunk; the same chunks, so the same padded
        # shapes), then concatenates for the collapse stage.  Chunking does
        # not change a residue.  Override with the ``dots_chunk`` param
        # (0 = never chunk).
        ctx = self.ctx
        nd = ctx.dig_count(ctx.L)
        digit_row_bytes = 2 * nd * (ctx.L + ctx.n_special) * ctx.n * 4
        auto = max(1, (512 << 20) // digit_row_bytes)
        self.dots_chunk = int(p.get("dots_chunk", auto))
        # three stages, as the JAX package jits them; the dots stage is
        # replayed once per chunk (the chunks share one shape)
        self._stage_dots = self.graph_with_keys(self._dots_impl)
        self._stage_collapse = self.graph_with_keys(self._collapse_impl)
        self._stage_sigmoid = self.graph_with_keys(self._sigmoid_impl)

    def rotation_steps(self) -> List[int]:
        steps = composite.rotations_for_accumulate(self.n, self.ctx.slots)
        steps += composite.collapse_rotation_steps(self.batch)
        return steps

    # -- pipeline --------------------------------------------------------- #

    def encode(self, inputs: Sequence[np.ndarray]) -> Handle:
        """inputs = [W [n], b scalar, X [batch, n]]."""
        w = np.asarray(inputs[0]).reshape(self.n)
        b = float(np.asarray(inputs[1]).reshape(()))
        x = np.atleast_2d(np.asarray(inputs[2]))
        pt_w = self.encode_batch(w[None])
        # bias replicated across slots so it lands on every collapsed dot
        pt_b = self.encode_batch(np.full((1, self.ctx.slots), b))
        pt_x = self.encode_batch(x)
        return Handle(tag="logreg_pt", payload=(pt_w, pt_b, pt_x))

    def encrypt(self, encoded: Handle) -> Handle:
        self.check_handle(encoded, "pt")
        cts = tuple(self.encrypt_batch(pt) for pt in encoded.payload)
        return Handle(tag="logreg_ct", payload=cts)

    def _dots_impl(self, w, x):
        ev = self.ev
        # 1) batched dot products W·X_i  (w broadcasts over x's batch axis)
        w1 = replace(w, data=w.data[0])
        prod = ev.relinearize(ev.multiply(w1, x))
        prod = ev.rescale_to_next(prod)
        return composite.accumulate(ev, prod, self.n)

    def _collapse_impl(self, dots):
        # 2) collapse batch into slots of one ciphertext
        return composite.collapse(self.ev, dots, self.batch)

    def _sigmoid_impl(self, collapsed, b):
        ev = self.ev
        # 3) bias add at matched level and scale
        b1 = replace(b, data=b.data[0])
        b1 = ev.mod_switch_to(b1, collapsed.level)
        b1 = replace(b1, scale=collapsed.scale)  # |Δscale| < 2^-40 relative
        z = ev.add(collapsed, b1)
        # 4) sigmoid ≈ degree-3 Horner
        return composite.evaluate_polynomial(ev, z, SIGMOID_D3)

    def dots_chunks(self, batch: int):
        """(chunk size, number of chunks) of the dots stage for ``batch``
        samples; one chunk of ``batch`` where it is not split."""
        if self.dots_chunk and batch > self.dots_chunk:
            n_chunks = -(-batch // self.dots_chunk)
            return -(-batch // n_chunks), n_chunks  # equalized chunk size
        return batch, 1

    def run_notes(self, loaded: Handle):
        chunk, n_chunks = self.dots_chunks(loaded.payload[2].data.shape[0])
        return {**super().run_notes(loaded),
                "dots_chunk": chunk, "dots_n_chunks": n_chunks}

    def _operate(self, loaded: Handle) -> Handle:
        w, b, x = loaded.payload
        batch = x.data.shape[0]
        chunk, n_chunks = self.dots_chunks(batch)
        if n_chunks > 1:
            # pad to n_chunks*chunk so every chunk has one shape (zero rows
            # are trivial encryptions of 0, sliced away below)
            pad = n_chunks * chunk - batch
            xd = x.data
            if pad:
                xd = torch.cat([xd, torch.zeros_like(xd[:pad])], dim=0)
            parts = [
                self._stage_dots(w, replace(x, data=xd[i : i + chunk]))
                for i in range(0, n_chunks * chunk, chunk)
            ]
            dots = replace(
                parts[0],
                data=torch.cat([pt.data for pt in parts], dim=0)[:batch],
            )
        else:
            dots = self._stage_dots(w, x)
        out = self._stage_sigmoid(self._stage_collapse(dots), b)
        return Handle(tag="logreg_result", payload=out)

    def decrypt(self, stored: Handle) -> Handle:
        self.check_handle(stored, "result")
        vals = next(self.decrypt_each(stored.payload, ()))
        return Handle(tag="logreg_clear", payload=vals)

    def decode(self, decrypted: Handle) -> List[np.ndarray]:
        self.check_handle(decrypted, "clear")
        return [self.clamp_ckks(decrypted.payload[: self.batch])]
