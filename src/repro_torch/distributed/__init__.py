"""Distributed training of the port: the sharding rules (DTensor
placements over a ``DeviceMesh``), gradient compression and the
straggler monitor."""
from repro_torch.distributed.compress import (
    compress_tree,
    decompress_tree,
    dequantize,
    init_residuals,
    quantize_ef,
)
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.distributed.sharding import (
    batch_specs,
    cache_specs,
    dp_axes,
    param_specs,
    state_specs,
)

__all__ = ["param_specs", "batch_specs", "cache_specs", "state_specs",
           "dp_axes", "quantize_ef", "dequantize", "compress_tree",
           "decompress_tree", "init_residuals", "StragglerMonitor"]
