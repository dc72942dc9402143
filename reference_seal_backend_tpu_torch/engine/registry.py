"""Engine: benchmark registry + factory of the port.

Counterpart of ``reference_seal_backend_tpu/engine/registry.py``.  The
port's engine registers the descriptors whose workloads are ported — the
eleven CKKS ones so far: element-wise add/mult and dot product (Latency and
Offline), logistic regression (Latency and Offline) and the three
matrix-multiply packings — and grows to the reference's 20 with the BFV
slice (ROADMAP.md Queue 1).  ``create_benchmark`` on anything else raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from reference_seal_backend_tpu_torch.engine.descriptor import (
    MATMULT_CIPHERBATCHAXIS,
    MATMULT_ROW,
    MATMULT_VAL,
    BenchmarkDescriptor,
    Scheme,
    Workload,
    default_descriptors,
)
from reference_seal_backend_tpu_torch.models.base import HEBenchmark
from reference_seal_backend_tpu_torch.models.dot_product import DotProductBenchmark
from reference_seal_backend_tpu_torch.models.eltwise import ElementWiseBenchmark
from reference_seal_backend_tpu_torch.models.logreg import LogRegBenchmark
from reference_seal_backend_tpu_torch.models.matmult import (
    MatMultCipherBatchAxisBenchmark,
    MatMultRowBenchmark,
    MatMultValBenchmark,
)
from reference_seal_backend_tpu_torch.utils.device import pick_device

# matrix multiply: the packing is the descriptor's algorithm-variant id
_MATMULT = {
    MATMULT_VAL: MatMultValBenchmark,
    MATMULT_CIPHERBATCHAXIS: MatMultCipherBatchAxisBenchmark,
    MATMULT_ROW: MatMultRowBenchmark,
}


def _matmult(descriptor: BenchmarkDescriptor, params, device) -> HEBenchmark:
    return _MATMULT[descriptor.other](descriptor, params, device)


_PORTED = {
    Workload.ELTWISE_ADD: ElementWiseBenchmark,
    Workload.ELTWISE_MULT: ElementWiseBenchmark,
    Workload.DOT_PRODUCT: DotProductBenchmark,
    Workload.MATRIX_MULTIPLY: _matmult,
    Workload.LOGREG_POLY_D3: LogRegBenchmark,
}


def _is_ported(d: BenchmarkDescriptor) -> bool:
    return d.scheme is Scheme.CKKS and d.workload in _PORTED


class Engine:
    """Registry of the ported benchmark descriptors, bound to a device."""

    def __init__(self, device=None):
        self.device = pick_device(device)
        self.descriptors: Tuple[BenchmarkDescriptor, ...] = tuple(
            d for d in default_descriptors() if _is_ported(d)
        )
        self._by_name: Dict[str, BenchmarkDescriptor] = {
            d.name: d for d in self.descriptors
        }

    def find(self, name: str) -> BenchmarkDescriptor:
        return self._by_name[name]

    def names(self) -> Sequence[str]:
        return tuple(self._by_name)

    def create_benchmark(
        self,
        descriptor: BenchmarkDescriptor,
        params: Optional[Dict[str, int]] = None,
    ) -> HEBenchmark:
        if not _is_ported(descriptor):
            raise NotImplementedError(
                f"{descriptor.name} is not ported yet (ROADMAP.md Queue 1)"
            )
        return _PORTED[descriptor.workload](descriptor, params, self.device)
