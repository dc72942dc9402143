"""Benchmark descriptors: what the engine registry advertises.

Mirror of the reference's use of ``hebench::APIBridge::BenchmarkDescriptor``
(each ``*BenchmarkDescription`` fills workload / data type / category /
scheme / security / algorithm-variant ``other`` and default workload
params; see SURVEY.md §2.2).  Kept as a plain dataclass — this engine
has no C ABI to cross, but the registry surface (20 descriptors) matches
the reference's ``SEALEngine::init`` (reference-seal-backend
src/engine/seal_engine.cpp:93-152).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Tuple


class Workload(str, enum.Enum):
    ELTWISE_ADD = "eltwise_add"
    ELTWISE_MULT = "eltwise_mult"
    DOT_PRODUCT = "dot_product"
    MATRIX_MULTIPLY = "matrix_multiply"
    LOGREG_POLY_D3 = "logistic_regression_poly_d3"


class Category(str, enum.Enum):
    LATENCY = "latency"
    OFFLINE = "offline"


class Scheme(str, enum.Enum):
    CKKS = "ckks"
    BFV = "bfv"


# Algorithm-variant ids for MatrixMultiply (reference `descriptor.other`):
MATMULT_VAL = 0x00           # one matrix row per ciphertext
MATMULT_CIPHERBATCHAXIS = 0x01  # one scalar element per ciphertext
MATMULT_ROW = 0x02           # spacer row packing, M1 in one ciphertext

SECURITY_128 = "128 bits"


@dataclass(frozen=True)
class BenchmarkDescriptor:
    workload: Workload
    scheme: Scheme
    category: Category
    other: int = 0  # algorithm variant id
    data_type: str = ""  # float64 (ckks) / int64 (bfv), filled by registry
    security: str = SECURITY_128
    # Default workload parameters, overridable at benchmark creation —
    # the analogue of the reference's default + flexible named params
    # (PolyModulusDegree, MultiplicativeDepth, ..., NumThreads).
    default_params: Dict[str, int] = field(default_factory=dict)
    # Per-descriptor timing attributes, mirroring the reference's
    # ``cat_params`` registration (reference-seal-backend
    # src/benchmarks/ckks/seal_ckks_element_wise_benchmark.cpp:38-45):
    # Latency warmup count, minimum timed-loop duration, and the Offline
    # per-operand sample counts (0 = flexible, i.e. the harness's
    # default_sample_size decides — the reference CI seds it to 3).
    warmup_iterations: int = 1
    min_test_time_ms: int = 0
    default_data_count: Tuple[int, ...] = ()

    @property
    def name(self) -> str:
        variant = {
            MATMULT_VAL: "",
            MATMULT_CIPHERBATCHAXIS: "_cipherbatchaxis",
            MATMULT_ROW: "_row",
        }[self.other] if self.workload is Workload.MATRIX_MULTIPLY else ""
        return (
            f"{self.scheme.value}_{self.workload.value}{variant}"
            f"_{self.category.value}"
        )


def _d(**kw) -> Dict[str, int]:
    return dict(kw)


def default_descriptors() -> Tuple[BenchmarkDescriptor, ...]:
    """The 20 benchmark registrations of the reference engine
    (src/engine/seal_engine.cpp:108-151), with parameter defaults from
    SURVEY.md §2.2 mapped onto this framework's composite-scale contexts."""
    out = []
    # Offline categories get a non-zero min_test_time_ms (the reference
    # registers 0 everywhere and lets the harness decide; a 500 ms floor
    # makes the recorded throughput a multi-iteration average instead of
    # a single-dispatch sample — deviation noted in PARITY.md) and the
    # reference's flexible per-operand data_count.
    def _cat(cat, *data_count):
        if cat is Category.OFFLINE:
            return dict(
                min_test_time_ms=500, default_data_count=tuple(data_count)
            )
        return dict(warmup_iterations=1, min_test_time_ms=0)

    for cat in (Category.LATENCY, Category.OFFLINE):
        for wl in (Workload.ELTWISE_ADD, Workload.ELTWISE_MULT):
            out.append(
                BenchmarkDescriptor(
                    wl, Scheme.CKKS, cat, data_type="float64",
                    default_params=_d(
                        n=1000, poly_modulus_degree=8192, mult_depth=2
                    ),
                    **_cat(cat, 0, 0),
                )
            )
            out.append(
                BenchmarkDescriptor(
                    wl, Scheme.BFV, cat, data_type="int64",
                    default_params=_d(
                        n=1000, poly_modulus_degree=8192, mult_depth=2
                    ),
                    **_cat(cat, 0, 0),
                )
            )
        out.append(
            BenchmarkDescriptor(
                Workload.DOT_PRODUCT, Scheme.CKKS, cat, data_type="float64",
                default_params=_d(
                    n=100, poly_modulus_degree=8192, mult_depth=2
                ),
                **_cat(cat, 0, 0),
            )
        )
        out.append(
            BenchmarkDescriptor(
                Workload.DOT_PRODUCT, Scheme.BFV, cat, data_type="int64",
                default_params=_d(
                    n=100, poly_modulus_degree=8192, mult_depth=2
                ),
                **_cat(cat, 0, 0),
            )
        )
    # The reference registers cipherbatchaxis/row at MultDepth 3 because
    # its per-element algorithm burns three SEAL levels (SURVEY.md §2.2
    # defaults table); this framework's packings consume at most ONE
    # composite rescale (models/matmult.py), so their default chains carry
    # depth 2 (one spare level, like eltwise) — which also keeps the
    # N=8192 modulus inside the HE-standard 128-bit bound that every
    # default descriptor must satisfy (schemes/params.py
    # max_coeff_bits_128; a depth-3 composite chain at N=8192 is 251 bits
    # against the 218-bit cap and would be refused, exactly as SEAL
    # refuses oversized chains under tc128).
    for variant, depth in (
        (MATMULT_VAL, 2),
        (MATMULT_CIPHERBATCHAXIS, 2),
        (MATMULT_ROW, 2),
    ):
        for scheme, dt in ((Scheme.CKKS, "float64"), (Scheme.BFV, "int64")):
            out.append(
                BenchmarkDescriptor(
                    Workload.MATRIX_MULTIPLY, scheme, Category.LATENCY,
                    other=variant, data_type=dt,
                    default_params=_d(
                        rows_m0=10, cols_m0=9, cols_m1=8,
                        poly_modulus_degree=8192, mult_depth=depth,
                    ),
                    **_cat(Category.LATENCY),
                )
            )
    for cat in (Category.LATENCY, Category.OFFLINE):
        # LogReg offline data_count: W and b are single samples, X is
        # flexible (reference registers batch_size 0 = flexible with a
        # 100-sample default constant — src/engine/seal_engine.cpp:148-151,
        # seal_ckks_logreg_horner.cpp:38-45).
        out.append(
            BenchmarkDescriptor(
                Workload.LOGREG_POLY_D3, Scheme.CKKS, cat,
                data_type="float64",
                default_params=_d(
                    n=16, poly_modulus_degree=16384, mult_depth=6,
                    # 0 = flexible, exactly as the reference registers it
                    # (src/engine/seal_engine.cpp:151); the 100-sample
                    # default constant lives in the workload
                    # (models/logreg.py DEFAULT_BATCH), and the runner's
                    # offline data_count contract picks sample_size.
                    batch_size=0,
                    # scale 50 (2×25-bit composite) instead of the global
                    # 52: the depth-6 chain at 52 misses the HE-standard
                    # budget for the G=2 grouped key switch by one bit
                    # (439 > 438); at 50 it fits, halving the digit count
                    # of every key switch in the deepest workload (kept
                    # as the JAX package registers it).  The reference registers
                    # scale 45 here (seal_ckks_logreg_horner.h:57-61), so
                    # 50 still carries more precision than the original.
                    scale_bits=50,
                ),
                **_cat(cat, 1, 1, 0),
            )
        )
    assert len(out) == 20
    return tuple(out)
