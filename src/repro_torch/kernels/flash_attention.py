"""Wrapper of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``), the port of the TPU kernel
``_flash_kernel`` in the reference package's
``kernels/flash_attention.py``.

A CPU tensor goes to the plain version (``ref.gqa_attention_ref``). A
CUDA tensor goes to the kernel or raises: nothing falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gqa_attention_ref

HEAD_DIMS = (64, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches in this process; callers reset it to 0 to count a run.
launches = 0
# The same launches by the kernel variant that ran (see the note in
# csrc/flash_attention.cu): flash_wgmma in fp32 (3xTF32 on the tensor
# cores) and in bf16; callers reset them to 0 with ``launches``.
ROUTES = ("flash_wgmma_3xtf32", "flash_wgmma_bf16")
route_launches = dict.fromkeys(ROUTES, 0)


def variant(hd: int, dtype: torch.dtype) -> str:
    """The kernel variant a CUDA launch takes for head dim ``hd`` and
    ``dtype`` (the C library's ``repro_flash_attention_route``)."""
    if hd not in HEAD_DIMS or dtype not in DTYPES:
        raise ValueError(f"the kernel takes head dim {HEAD_DIMS} in "
                         f"{DTYPES}; got {hd}, {dtype}")
    return ROUTES[dtype == torch.bfloat16]


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,H,hd), k = v (B,Sk,Hkv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    bk, sk, hkv, hdk = k.shape
    if bk != b or hdk != hd or hkv == 0 or h % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}")
    if causal and sq > sk:
        raise ValueError(f"causal attention needs Sq <= Sk, got {sq} > {sk}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd) -> (B, Sq, H, hd) in
    q's dtype. Causal alignment is bottom-right (Sq <= Sk)."""
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return gqa_attention_ref(q, k, v, causal).contiguous()
    return _launch(q, k, v, causal)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash_attention kernel has no backward; training takes "
            "the non-kernel attention routes")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k and v must lie on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes fp32 or bf16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dim {HEAD_DIMS}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel takes 16-byte aligned q, k, v (its "
                         "TMA copies need it)")
    lib = _build.load("flash_attention")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, sk, h, hkv, hd, int(q.dtype == torch.bfloat16),
            int(causal), stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc} ({msg})")
    launches += 1
    route_launches[ROUTES[lib.repro_flash_attention_route(
        hd, int(q.dtype == torch.bfloat16))]] += 1
    return o
