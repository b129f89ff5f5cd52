"""PyTorch / CUDA port of the ``repro`` functional layer for NVIDIA Hopper.

The package mirrors ``repro``'s module names (``checkpoint``,
``configs``, ``core``, ``data``, ``distributed``, ``kernels``,
``launch``, ``models``, ``npu``, ``optim``, ``serve``, ``train``) and
imports neither ``jax`` nor ``repro``: it keeps its own copy of what it
needs. It serves every family of the reference's zoo end to end (dense,
moe, vlm, audio, the xLSTM ssm stack and the Zamba2 hybrid) and trains
each on one device. Two hand-written CUDA kernels, built with ``nvcc``
at first use, carry the serving hot spots: flash attention in prefill
(``kernels/csrc/flash_attention.cu``) and the MoE experts' grouped GEMMs
(``kernels/csrc/grouped_matmul.cu``). Neither has a backward, so
training takes the reference's own routes (masked or chunked attention,
einsum experts).

``npu`` (the simulated NPU core, cost model and workload traces),
``core`` (vNPUs, mapper, allocator, NeuISA compiler, scheduler policies,
the discrete-event simulator, fabric, faults and admission), the serving
control plane (``serve.session``, ``serve.vserve``), ``data.pipeline``
and ``distributed.fault`` are copies of the reference's jax-free
modules; ``core.sim_torch`` is the fluid fleet simulator rewritten in
PyTorch, and is not imported by ``core``.

Entry points (``ServeEngine``, ``build_model``, ``Model.init``,
``train.train``, the ``core.sim_torch`` functions) run on ``cuda``
unless the caller passes ``device="cpu"``. Without a card they raise;
they never drop to the CPU on their own.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


# Submodules import resolve_device from here, so they load after it.
from repro_torch.configs import ARCHS, SMOKES, ModelConfig, get_arch  # noqa: E402
from repro_torch.models.registry import Model, build_model  # noqa: E402
from repro_torch.serve.engine import GenerationResult, ServeEngine  # noqa: E402

__all__ = [
    "ARCHS",
    "SMOKES",
    "GenerationResult",
    "Model",
    "ModelConfig",
    "ServeEngine",
    "build_model",
    "get_arch",
    "resolve_device",
]
