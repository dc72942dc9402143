"""Engine: benchmark registry + factory of the port.

Counterpart of ``reference_seal_backend_tpu/engine/registry.py``.  The
port's engine registers all 20 of the reference's descriptors: under CKKS
and BFV element-wise add/mult and dot product (Latency and Offline) and the
three matrix-multiply packings, and CKKS logistic regression (Latency and
Offline).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from reference_seal_backend_tpu_torch.engine.descriptor import (
    MATMULT_CIPHERBATCHAXIS,
    MATMULT_ROW,
    MATMULT_VAL,
    BenchmarkDescriptor,
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


_WORKLOADS = {
    Workload.ELTWISE_ADD: ElementWiseBenchmark,
    Workload.ELTWISE_MULT: ElementWiseBenchmark,
    Workload.DOT_PRODUCT: DotProductBenchmark,
    Workload.MATRIX_MULTIPLY: _matmult,
    Workload.LOGREG_POLY_D3: LogRegBenchmark,
}


class Engine:
    """Registry of the benchmark descriptors, bound to a device."""

    def __init__(self, device=None):
        self.device = pick_device(device)
        self.descriptors: Tuple[BenchmarkDescriptor, ...] = default_descriptors()
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
        return _WORKLOADS[descriptor.workload](descriptor, params, self.device)
