"""NPU hardware model: core config (paper Table II), analytic
operator cost model, and workload trace generation.

This package replaces the paper's real-TPUv4 profiling step: traces
carry the exact schema the paper replays (per-operator ME/VE time,
HBM bytes, tensor shapes, tiling) but are derived analytically from
the model-zoo configs. See DESIGN.md §2.
"""
from repro_torch.npu.hw_config import NPUCoreConfig, DEFAULT_CORE
from repro_torch.npu.cost_model import (Operator, RequestPlan, decode_bucket,
                                  matmul_op, memory_op, vector_op)

__all__ = [
    "NPUCoreConfig",
    "DEFAULT_CORE",
    "Operator",
    "RequestPlan",
    "decode_bucket",
    "matmul_op",
    "vector_op",
    "memory_op",
]
