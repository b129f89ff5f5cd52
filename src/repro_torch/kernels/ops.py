"""Public kernel entry points, named as in the reference package's
``kernels/ops.py``. The port's wrappers take the model's natural
layout and mask ragged edges in the kernel, so nothing is padded here.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul

__all__ = ["flash_attention", "grouped_matmul"]
