"""Distributed-training helpers of the port: gradient compression and
the straggler monitor. The sharding rules come with the distribution
slice."""
from repro_torch.distributed.compress import (
    compress_tree,
    decompress_tree,
    dequantize,
    init_residuals,
    quantize_ef,
)
from repro_torch.distributed.fault import StragglerMonitor

__all__ = ["quantize_ef", "dequantize", "compress_tree", "decompress_tree",
           "init_residuals", "StragglerMonitor"]
