"""Wrapper of the Hopper grouped-GEMM kernel (``csrc/grouped_matmul.cu``),
the port of the TPU kernel ``_gmm_kernel`` in the reference package's
``kernels/moe_gmm.py``.

A CPU tensor goes to the plain version (``ref.grouped_matmul_ref``). A
CUDA tensor goes to the kernel or raises: nothing falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul_ref

DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches in this process; callers reset it to 0 to count a run.
launches = 0
# The same launches by the kernel variant that ran (see the note in
# csrc/grouped_matmul.cu): gmm_small (C <= 32 in fp32, or in bf16 where
# TMA cannot copy; CUDA cores), gmm_wgmma (C > 32, fp32, 3xTF32 on the
# tensor cores), gmm_large (C > 32 where TMA cannot copy, on the CUDA
# cores), gmm_wgmma_bf16 (C > 32, bf16, on the tensor cores),
# gmm_decode_bf16 (C <= 32, bf16, on the tensor cores); callers reset
# them to 0 with ``launches``. The index is the kernel's route number.
ROUTES = ("gmm_small", "gmm_wgmma", "gmm_large", "gmm_wgmma_bf16",
          "gmm_decode_bf16")
route_launches = dict.fromkeys(ROUTES, 0)


def _check_shapes(x: torch.Tensor, w: torch.Tensor,
                  rows: Optional[torch.Tensor]) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"want x (E, C, d) and w (E, d, f); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if rows is None:
        return
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32; got {rows.dtype}")
    if rows.shape != x.shape[:1] or not rows.is_contiguous():
        raise ValueError(f"rows must be a contiguous ({x.shape[0]},) tensor; "
                         f"got {tuple(rows.shape)}")
    if rows.device != x.device:
        raise ValueError(f"rows must lie on x's device {x.device}; got "
                         f"{rows.device}")


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (E, C, d) @ w: (E, d, f) -> (E, C, f) in x's dtype, fp32
    accumulation. Ragged C, d and f are masked in the kernel.

    ``rows``, an (E,) int32 tensor on x's device, says that row r of
    expert e is zero for r >= rows[e]: those output rows are 0 and
    depend neither on x's rows there nor on w (the kernel reads none of
    w[e] when rows[e] is 0). It is read on the device, so passing it does
    not synchronise."""
    _check_shapes(x, w, rows)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return grouped_matmul_ref(x, w, rows)
    return _launch(x, w, rows)


def _launch(x: torch.Tensor, w: torch.Tensor,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    global launches
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "the grouped_matmul kernel has no backward; training takes "
            "the non-kernel expert route (the einsum path)")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"x and w must lie on one CUDA device; got "
                         f"{x.device}, {w.device}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"the kernel takes fp32 or bf16 x and w of one "
                        f"dtype; got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous x and w")
    e, c, d = x.shape
    f = w.shape[2]
    if min(e, c, d, f) == 0:
        raise ValueError(f"the kernel takes non-empty dimensions; got "
                         f"E={e} C={c} d={d} f={f}")
    lib = _build.load("grouped_matmul")
    o = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_grouped_matmul(
            x.data_ptr(), w.data_ptr(), o.data_ptr(),
            None if rows is None else rows.data_ptr(), e, c, d, f, bf16,
            stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"grouped_matmul kernel launch failed: "
                           f"cudaError {rc} ({msg})")
    launches += 1
    route_launches[ROUTES[lib.repro_grouped_matmul_route(
        x.data_ptr(), w.data_ptr(), o.data_ptr(), c, d, f, bf16)]] += 1
    return o
