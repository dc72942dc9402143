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
           for CKKS (BFV results are exact integers)

Batch (Offline) semantics are broadcast batch axes inside one operate.

``sp_shard: k`` in the params runs the benchmark slot-parallel: every
polynomial's coefficient axis sharded over a k-device ``("sp",)`` mesh
(``parallel/sp_eval.py``; the devices from ``utils/device.py:mesh_devices``).
``load`` shards the ciphertexts, ``store`` gathers them back, and the
workload's ``operate`` graph is unchanged: the ``SpEvaluator`` stands in as
``self.ev``.

Each stage of a workload's ``operate`` runs through
:meth:`HEBenchmark.graph_with_keys` (``utils/staging.py``): on the card it is
captured once per input signature as a CUDA graph and replayed, at the sites
where the JAX package jits it (``jit_with_keys``), under ``sp_shard`` too
where the mesh lies on one device; on the CPU it runs as it is.
"""

from __future__ import annotations

import abc
import os
import threading
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference_seal_backend_tpu_torch.engine.descriptor import (
    BenchmarkDescriptor,
    Category,
    Scheme,
)
from reference_seal_backend_tpu_torch.evaluator import behz
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
from reference_seal_backend_tpu_torch.parallel import sp_eval
from reference_seal_backend_tpu_torch.schemes import bfv as bfv_mod
from reference_seal_backend_tpu_torch.schemes import ckks as ckks_mod
from reference_seal_backend_tpu_torch.schemes import keys as keys_mod
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext
from reference_seal_backend_tpu_torch.schemes.params import (
    make_bfv_context,
    make_ckks_context,
)
from reference_seal_backend_tpu_torch.utils import counters, staging
from reference_seal_backend_tpu_torch.utils.device import mesh_devices, pick_device

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


def _map_payload(fn, payload, types=(Ciphertext, Plaintext)):
    """Apply ``fn`` to every Ciphertext/Plaintext (or other ``types``) in a
    (nested tuple/list) payload; anything else passes through."""
    if isinstance(payload, types):
        return fn(payload)
    if isinstance(payload, (tuple, list)):
        return type(payload)(_map_payload(fn, x, types) for x in payload)
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
        self.descriptor = descriptor
        self.device = pick_device(device)
        # the stages of operate (graph_with_keys) and their capture guard
        self._stages: List[staging.StagedCall] = []
        self._capture_guard = threading.Lock()
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
        self.is_ckks = descriptor.scheme is Scheme.CKKS
        if self.is_ckks:
            self.ctx = make_ckks_context(
                poly_modulus_degree=p["poly_modulus_degree"],
                mult_depth=p["mult_depth"],
                scale_bits=p.get("scale_bits", 52),
                sec_level=p.get("sec_level", 128),
                device=self.device,
            )
            self.encoder = ckks_mod.CkksEncoder(self.ctx)
        else:
            self.ctx = make_bfv_context(
                poly_modulus_degree=p["poly_modulus_degree"],
                mult_depth=p["mult_depth"],
                plain_modulus_bits=p.get("plain_modulus_bits", 20),
                n_data_primes=p.get("n_data_primes", 4),
                sec_level=p.get("sec_level", 128),
                device=self.device,
            )
            self.encoder = bfv_mod.BfvBatchEncoder(self.ctx)
        key_seed = p.get("key_seed", 1234)
        self.keys = keys_mod.keygen(
            self.ctx,
            seed=key_seed,
            galois_elts=self._galois_elements(),
            need_relin=True,
        )
        # Encryption randomness is seeded from the benchmark's key seed so
        # runs are reproducible end to end.
        if self.is_ckks:
            self.encryptor = ckks_mod.CkksEncryptor(
                self.ctx, self.keys, seed=key_seed
            )
            self.decryptor = ckks_mod.CkksDecryptor(self.ctx, self.keys)
        else:
            self.encryptor = bfv_mod.BfvEncryptor(
                self.ctx, self.keys, seed=key_seed
            )
            self.decryptor = bfv_mod.BfvDecryptor(self.ctx, self.keys)
            if self.ctx.device.type == "cuda":
                # the BEHZ tables, and with them the fused kernel's library,
                # in set-up, as keygen builds the NTT kernels' library
                behz.tables_for(self.ctx)
        self.ev = Evaluator(self.ctx, self.keys)
        self.sp_shard = int(p.get("sp_shard", 0) or 0)
        if self.sp_shard:
            k = self.sp_shard
            sp_mesh = mesh_mod.make_mesh(
                k, ("sp",), shape=(k,), devices=mesh_devices(self.device, k))
            self.ev = sp_eval.SpEvaluator(self.ctx, self.keys, sp_mesh)

    # ------------------------------------------------------------------ #

    def graph_with_keys(self, fn):
        """``fn``, a stage of ``operate``, as a :class:`staging.StagedCall`:
        on the card captured once per input signature as a CUDA graph and
        replayed (the counterpart of the JAX package's ``jit_with_keys``).
        The keys are device tensors the graph reads in place, not
        arguments: they cannot grow a compile payload here.  A capture that
        starts while another capture of this benchmark runs raises (the JAX
        package's single-trace guard).

        Under ``sp_shard`` the stage runs over ``ShardedTensor`` blocks: it
        is staged where the mesh lies on one device (one card, or virtual
        devices of it), and runs eagerly on a mesh of several devices, by
        this branch (``staging.stage``) and never by a failed capture: one
        CUDA graph belongs to one device."""
        stage = staging.stage(
            fn, f"{self.descriptor.name}.{fn.__name__}", self._capture_guard,
            self.ev.mesh if self.sp_shard else None)
        if isinstance(stage, staging.StagedCall):
            self._stages.append(stage)
        return stage

    def release_graphs(self) -> None:
        """Drop every graph of this benchmark's stages, and their memory
        pools.  Called where a benchmark ends (the runner, the C ABI's
        ``benchmark_destroy``).  A graph reads ``self.keys`` (and what
        ``self.ev`` caches of them) in place: both are set once, in
        ``__init__``; code that replaced either would call this first."""
        for stage in self._stages:
            stage.release()

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

    def handle(self, stage: str, payload, meta: Optional[Dict] = None) -> Handle:
        """Construct a correctly-tagged handle for this workload family."""
        return Handle(
            tag=f"{self.tag_family}_{stage}", payload=payload, meta=meta or {}
        )

    def rotation_steps(self) -> List[int]:
        """Rotation steps this workload needs Galois keys for."""
        return []

    def needs_conjugation_key(self) -> bool:
        """Does ``operate`` fold BFV's second batching row (Galois 2N-1)?"""
        return False

    def _galois_elements(self) -> List[int]:
        n = self.params["poly_modulus_degree"]
        two_n = 2 * n
        elts = [pow(5, s % (n // 2), two_n) for s in self.rotation_steps()]
        if self.needs_conjugation_key():
            elts.append(two_n - 1)
        return elts

    # -- pipeline ------------------------------------------------------- #

    @abc.abstractmethod
    def encode(self, inputs: Sequence[np.ndarray]) -> Handle:
        """Cleartext op parameters -> encoded plaintext handle."""

    @abc.abstractmethod
    def encrypt(self, encoded: Handle) -> Handle:
        ...

    def load(self, encrypted: Handle) -> Handle:
        """Host -> device placement of every array in the payload; under
        ``sp_shard`` ciphertexts are sharded over the mesh (plaintexts stay
        flat: the SpEvaluator relayouts them where it reads them)."""
        self.check_handle(encrypted, "ct")

        def place(x):
            if self.sp_shard and isinstance(x, Ciphertext):
                return self.ev.shard(x)
            return x.to(self.device)

        payload = _map_payload(place, encrypted.payload)
        return Handle(tag=encrypted.tag, payload=payload, meta=encrypted.meta)

    def operate(self, loaded: Handle) -> Handle:
        """The timed homomorphic computation: the handle checked and the
        call counted (``("operate",)``, utils/counters.py) here, once for
        every workload, then the workload's :meth:`_operate`."""
        self.check_handle(loaded, "ct")
        counters.note("operate")
        return self._operate(loaded)

    @abc.abstractmethod
    def _operate(self, loaded: Handle) -> Handle:
        """The workload's own ``operate`` on a checked handle."""

    def store(self, result: Handle) -> Handle:
        """Device -> host readback of result arrays."""
        self.check_handle(result, "result")
        payload = result.payload
        if self.sp_shard:
            payload = _map_payload(self.ev.unshard, payload, (sp_eval.SpCiphertext,))
        payload = _map_payload(lambda x: x.to("cpu"), payload)
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
        if self.is_ckks:
            desc["scale_bits"] = str(self.params.get("scale_bits", 52))
        else:
            desc["plain_modulus"] = str(ctx.t)
        desc["key_switch_digit_group"] = str(ctx.digit_group)
        desc["num_threads"] = str(self.num_threads)
        if self.sp_shard:
            desc["sp_shard"] = str(self.sp_shard)
        return desc

    def run_notes(self, loaded: Handle) -> Dict[str, float]:
        """What the runner should report of how ``operate`` treats these
        operands, beyond its time: the graphs of its stages (captures,
        replays, seconds of the eager warm-ups and of the captures) and
        what a workload adds; ``stages`` says whether they are staged or, on
        a mesh of several devices, eager by ``graph_with_keys``' branch."""
        stages = self._stages
        mesh = self.ev.mesh if self.sp_shard else None
        return {
            "stages": "staged" if mesh is None or staging.one_device(mesh) else
            f"eager: the sp mesh spans {len(mesh.unique_devices())} devices",
            "graph_captures": sum(s.captures for s in stages),
            "graph_replays": sum(s.replays for s in stages),
            "graph_warmup_s": sum(s.warmup_s for s in stages),
            "graph_capture_s": sum(s.capture_s for s in stages),
        }

    def block(self, handle: Handle) -> Handle:
        """Block until device work queued so far has finished, on every
        device of the sp mesh too (used by the runner to time operate
        honestly)."""
        devices = self.ev.mesh.unique_devices() if self.sp_shard else [self.device]
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return handle

    def clamp_ckks(self, arr: np.ndarray) -> np.ndarray:
        out = np.real(arr)
        out[np.abs(out) < CKKS_EPS] = 0.0
        return out

    def clean(self, arr) -> np.ndarray:
        """Decoded values as the harness compares them: CKKS with the
        epsilon clamp, BFV's exact integers as they are."""
        arr = np.asarray(arr)
        return self.clamp_ckks(arr) if self.is_ckks else arr

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
        """Decrypt a ciphertext with leading batch axes; yields slot arrays
        in flat order (complex under CKKS, int64 under BFV).  The whole
        batch decrypts in ONE vectorized pass."""
        data = ct.data
        flat = data.reshape((-1,) + tuple(data.shape[len(batch_shape):]))
        vals = self.decryptor.decrypt(replace(ct, data=flat))
        for i in range(flat.shape[0]):
            yield vals[i]
