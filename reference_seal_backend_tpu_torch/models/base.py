"""Benchmark base classes: the 7-step HEBench pipeline in PyTorch.

Counterpart of ``reference_seal_backend_tpu/models/base.py``.  Each
benchmark owns its own context + keys.  The pipeline steps map as:

  encode   host: cleartext -> RNS plaintexts (host FFT + lift, NTT)
  encrypt  device: public-key encryption
  load     host -> device placement (``.to(device)``)
  operate  the timed homomorphic computation on the device
  store    device -> host
  decrypt  device arithmetic + host CRT compose
  decode   host: coefficients -> cleartext, with the 5e-5 epsilon clamp
           for CKKS

Batch (Offline) semantics are broadcast batch axes inside one operate.
"""

from __future__ import annotations

import abc
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference_seal_backend_tpu_torch.engine.descriptor import (
    BenchmarkDescriptor,
    Category,
    Scheme,
)
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
from reference_seal_backend_tpu_torch.schemes import ckks as ckks_mod
from reference_seal_backend_tpu_torch.schemes import keys as keys_mod
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext
from reference_seal_backend_tpu_torch.schemes.params import make_ckks_context
from reference_seal_backend_tpu_torch.utils.device import pick_device

CKKS_EPS = 5e-5  # decode clamp, reference convention


@dataclass
class Handle:
    """Opaque pipeline handle: tagged payload.

    ``tag`` is ``"<family>_<stage>"`` (stage in pt/ct/result/clear) and is
    CHECKED at every pipeline entry via :meth:`HEBenchmark.check_handle`."""

    tag: str
    payload: Any
    meta: Dict[str, Any] = field(default_factory=dict)


class InvalidHandleError(TypeError):
    """A pipeline step received a handle of the wrong type or stage."""


def _map_payload(fn, payload):
    """Apply ``fn`` to every Ciphertext/Plaintext in a (nested tuple/list)
    payload; anything else passes through."""
    if isinstance(payload, (Ciphertext, Plaintext)):
        return fn(payload)
    if isinstance(payload, (tuple, list)):
        return type(payload)(_map_payload(fn, x) for x in payload)
    return payload


class HEBenchmark(abc.ABC):
    """One benchmark instance = context + keys + operate."""

    #: handle-tag family of this workload (subclasses override); stage
    #: suffixes pt/ct/result/clear complete the tag.
    tag_family: str = "bench"
    #: operand count of pt/ct payload tuples (0 = not tuple-structured)
    n_operands: int = 2

    def __init__(
        self,
        descriptor: BenchmarkDescriptor,
        params: Optional[Dict[str, int]] = None,
        device=None,
    ):
        if descriptor.scheme is not Scheme.CKKS:
            raise NotImplementedError(
                "only CKKS workloads are ported; BFV is ROADMAP.md Queue 1"
            )
        self.descriptor = descriptor
        self.device = pick_device(device)
        p = dict(descriptor.default_params)
        if params:
            p.update(params)
        self.params = p
        self.category = descriptor.category
        # NumThreads is ACCEPTED for positional-contract parity and
        # resolved like the reference (0 -> machine default, Latency
        # overridden to 1), but it only informs the description: sample
        # parallelism here is a batch axis, so it never gates execution.
        nt = int(p.get("num_threads", 0) or 0)
        if nt <= 0:
            nt = 1 if descriptor.category is Category.LATENCY else (
                os.cpu_count() or 1
            )
        elif descriptor.category is Category.LATENCY:
            nt = 1
        self.num_threads = p["num_threads"] = nt
        # every context is built with 128-bit HE-standard enforcement
        # unless the caller explicitly opts out for small test configs
        self.ctx = make_ckks_context(
            poly_modulus_degree=p["poly_modulus_degree"],
            mult_depth=p["mult_depth"],
            scale_bits=p.get("scale_bits", 52),
            sec_level=p.get("sec_level", 128),
            device=self.device,
        )
        self.encoder = ckks_mod.CkksEncoder(self.ctx)
        key_seed = p.get("key_seed", 1234)
        self.keys = keys_mod.keygen(
            self.ctx,
            seed=key_seed,
            galois_elts=self._galois_elements(),
            need_relin=True,
        )
        # Encryption randomness is seeded from the benchmark's key seed so
        # runs are reproducible end to end.
        self.encryptor = ckks_mod.CkksEncryptor(
            self.ctx, self.keys, seed=key_seed
        )
        self.decryptor = ckks_mod.CkksDecryptor(self.ctx, self.keys)
        self.ev = Evaluator(self.ctx, self.keys)

    # ------------------------------------------------------------------ #

    def check_handle(self, h, stage: str) -> "Handle":
        """Validate a pipeline-entry handle: right type, right family,
        right stage; tuple-structured stages also check operand arity.
        Feeding the wrong handle must die with a typed error, not an
        arbitrary AttributeError downstream."""
        if not isinstance(h, Handle):
            raise InvalidHandleError(
                f"{self.descriptor.name}: {stage} step expected a pipeline "
                f"Handle, got {type(h).__name__}"
            )
        want = f"{self.tag_family}_{stage}"
        if h.tag != want:
            raise InvalidHandleError(
                f"{self.descriptor.name}: step expected a '{want}' handle, "
                f"got '{h.tag}'"
            )
        if stage in ("pt", "ct") and self.n_operands:
            arity = len(h.payload) if isinstance(h.payload, tuple) else 1
            if arity != self.n_operands:
                raise InvalidHandleError(
                    f"{self.descriptor.name}: '{want}' handle carries "
                    f"{arity} operands, expected {self.n_operands}"
                )
        return h

    def rotation_steps(self) -> List[int]:
        """Rotation steps this workload needs Galois keys for."""
        return []

    def _galois_elements(self) -> List[int]:
        n = self.params["poly_modulus_degree"]
        two_n = 2 * n
        return [pow(5, s % (n // 2), two_n) for s in self.rotation_steps()]

    # -- pipeline ------------------------------------------------------- #

    @abc.abstractmethod
    def encode(self, inputs: Sequence[np.ndarray]) -> Handle:
        """Cleartext op parameters -> encoded plaintext handle."""

    @abc.abstractmethod
    def encrypt(self, encoded: Handle) -> Handle:
        ...

    def load(self, encrypted: Handle) -> Handle:
        """Host -> device placement of every array in the payload."""
        self.check_handle(encrypted, "ct")
        payload = _map_payload(lambda x: x.to(self.device), encrypted.payload)
        return Handle(tag=encrypted.tag, payload=payload, meta=encrypted.meta)

    @abc.abstractmethod
    def operate(self, loaded: Handle) -> Handle:
        """The timed homomorphic computation."""

    def store(self, result: Handle) -> Handle:
        """Device -> host readback of result arrays."""
        self.check_handle(result, "result")
        payload = _map_payload(lambda x: x.to("cpu"), result.payload)
        return Handle(tag=result.tag, payload=payload, meta=result.meta)

    @abc.abstractmethod
    def decrypt(self, stored: Handle) -> Handle:
        ...

    @abc.abstractmethod
    def decode(self, decrypted: Handle) -> List[np.ndarray]:
        """-> cleartext result arrays."""

    # -- helpers ---------------------------------------------------------- #

    def describe(self) -> Dict[str, str]:
        """Report fragments: encryption params, algorithm variant and the
        modulus-chain dump."""
        ctx = self.ctx
        chain = [q.bit_length() for q in ctx.data_primes]
        desc = {
            "scheme": self.descriptor.scheme.name,
            "workload": self.descriptor.workload.name,
            "category": self.descriptor.category.name,
            "algorithm_variant": f"0x{self.descriptor.other:02x}",
            "poly_modulus_degree": str(ctx.n),
            "slots": str(ctx.slots),
            "coeff_modulus_chain_bits": "|".join(map(str, chain)),
            "special_modulus_bits": str(
                sum(p.bit_length() for p in ctx.special_primes)
            ),
            "total_coeff_modulus_bits": str(ctx.total_coeff_bits),
            # Computed, never asserted: "128 bits" only when the full
            # modulus respects the HE-standard classical-128 bound.
            "security": (
                "128 bits"
                if ctx.secure_128
                else f"none (exceeds HE-standard 128-bit bound "
                f"{ctx.max_secure_bits} bits for N={ctx.n})"
            ),
        }
        desc["scale_bits"] = str(self.params.get("scale_bits", 52))
        desc["key_switch_digit_group"] = str(ctx.digit_group)
        desc["num_threads"] = str(self.num_threads)
        return desc

    def block(self, handle: Handle) -> Handle:
        """Block until device work queued so far has finished (used by the
        runner to time operate honestly)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return handle

    def clamp_ckks(self, arr: np.ndarray) -> np.ndarray:
        out = np.real(arr)
        out[np.abs(out) < CKKS_EPS] = 0.0
        return out

    # -- batched encode/encrypt/decrypt helpers --------------------------- #

    def encode_batch(self, samples: np.ndarray):
        """[B, n] cleartext -> Plaintext with leading batch axis [B, L, N]."""
        samples = np.atleast_2d(np.asarray(samples))
        pts = [self.encoder.encode(s) for s in samples]
        return replace(pts[0], data=torch.stack([p.data for p in pts]))

    def encrypt_batch(self, pt):
        """Plaintext [B, L, N] -> Ciphertext [B, 2, L, N] in one batched
        pass (encrypt_pt handles leading batch axes)."""
        return self.encryptor.encrypt_pt(pt)

    def decrypt_each(self, ct, batch_shape: Tuple[int, ...]):
        """Decrypt a ciphertext with leading batch axes; yields complex
        slot arrays in flat order.  The whole batch decrypts in ONE
        vectorized pass."""
        data = ct.data
        flat = data.reshape((-1,) + tuple(data.shape[len(batch_shape):]))
        vals = self.decryptor.decrypt(replace(ct, data=flat))
        for i in range(flat.shape[0]):
            yield vals[i]
