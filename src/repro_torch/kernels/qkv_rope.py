"""Wrapper of K3, attention's q/k/v epilogue kernel
(``csrc/qkv_rope.cu``): the biases, qk-norm, RoPE and the KV-cache write
in one launch a layer. It replaces no TPU kernel (the reference leaves
the chain to XLA's fusion); its plain version is ``ref.qkv_rope_ref``.

``qkv_rope`` chooses the route, and nothing else does: the plain version
for DTensors, for inputs that need a gradient and for tensors off the
card (``plain_reason``), and where the caller asks for it (``kernel``
False: the model's training routes); the kernel otherwise, which runs or
raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.kernels.ref import qkv_rope_ref, rope_freqs

DTYPES = (torch.float32, torch.bfloat16)
# the C entry's code for arguments it refuses (cudaErrorInvalidValue)
CUDA_INVALID_VALUE = 1

# Kernel launches in this process; callers reset it to 0 to count a run.
launches = 0
# 1/theta^(2i/hd) by (hd, theta, device), built once by ``rope_freqs``
_freqs: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def plain_reason(*tensors: Optional[torch.Tensor]) -> Optional[str]:
    """Why the plain chain and not the kernel takes these tensors, or None
    where the kernel takes them: "dtensor" for a DTensor among them
    (sharded serving, a sequence-sharded cache), "grad" where one needs a
    gradient (the kernel has no backward), "not cuda" where one lies off
    the card."""
    ts = [t for t in tensors if t is not None]
    if any(isinstance(t, DTensor) for t in ts):
        return "dtensor"
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return "grad"
    if not all(t.is_cuda for t in ts):
        return "not cuda"
    return None


def freq_table(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    key = (hd, float(theta), device)
    if key not in _freqs:
        _freqs[key] = rope_freqs(hd, theta, device)
    return _freqs[key]


def qkv_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             positions: torch.Tensor, hd: int, theta: float,
             bq: Optional[torch.Tensor] = None,
             bk: Optional[torch.Tensor] = None,
             bv: Optional[torch.Tensor] = None,
             q_norm: Optional[torch.Tensor] = None,
             k_norm: Optional[torch.Tensor] = None, eps: float = 1e-6,
             cache: Optional[Sequence[torch.Tensor]] = None,
             cache_index: Optional[int] = None, kernel: bool = True):
    """q (B, S, H*hd), k and v (B, S, Hkv*hd) -> q (B, S, H, hd), k and v
    (B, S, Hkv, hd) in q's dtype: ``ref.qkv_rope_ref``'s function (bias,
    qk-norm, RoPE at ``positions``), with k and v written into ``cache``
    where one is given (at ``cache_index`` where S is 1, else rows
    0 .. S - 1). The kernel runs where ``kernel`` is set and
    ``plain_reason`` finds no reason against it; the plain chain runs
    otherwise."""
    if not kernel or plain_reason(q, k, v, bq, bk, bv, q_norm, k_norm,
                                  *(cache or ())) is not None:
        return qkv_rope_ref(q, k, v, positions, hd, theta, bq, bk, bv,
                            q_norm, k_norm, eps, cache, cache_index)
    return _launch(q, k, v, positions, hd, theta, bq, bk, bv, q_norm, k_norm,
                   eps, cache, cache_index)


def _check(q, k, v, positions, hd, bias, norms, cache) -> None:
    """The shapes behind the ints the C entry gets, which it cannot see;
    it checks the rest (an even hd up to 256, all biases or none, both
    scales or neither, the cache rows inside the cache)."""
    # dims compared as ints: a torch.Size comparison costs a microsecond,
    # and the decode step runs this once a layer
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"want q (B,S,H*hd), k = v (B,S,Hkv*hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, dq = q.shape
    dkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or v.shape[0] != B \
            or v.shape[1] != S or v.shape[2] != dkv:
        raise ValueError(f"want q (B,S,H*hd), k = v (B,S,Hkv*hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hd <= 0 or dq % hd or dkv % hd:
        raise ValueError(f"the head dim {hd} does not divide q's and k's "
                         f"widths {dq} and {dkv}")
    ps = positions.shape
    if positions.is_floating_point() or not (
            (len(ps) == 2 and ps[0] == B and ps[1] == S)
            or (len(ps) == 1 and ps[0] == S)):
        raise ValueError(f"want integer positions (B, S) or (S,); got "
                         f"{positions.dtype} {tuple(ps)}")
    for t, n in zip((*bias, *norms), (dq, dkv, dkv, hd, hd)):
        if t is not None and (t.dim() != 1 or t.shape[0] != n):
            raise ValueError(f"want a bias or scale of ({n},); got "
                             f"{tuple(t.shape)}")
    if cache is None:
        return
    kc, vc = cache
    want = (B, kc.shape[1], dkv // hd, hd)
    if tuple(kc.shape) != want or tuple(vc.shape) != want \
            or kc.dtype != vc.dtype:
        raise ValueError(f"want caches (B, T, Hkv, hd) = {want} of one "
                         f"dtype; got {tuple(kc.shape)} {kc.dtype}, "
                         f"{tuple(vc.shape)} {vc.dtype}")


def _launch(q, k, v, positions, hd, theta, bq, bk, bv, q_norm, k_norm, eps,
            cache, cache_index):
    global launches
    bias, norms = (bq, bk, bv), (q_norm, k_norm)
    ts = [t for t in (q, k, v, positions, *bias, *norms, *(cache or ()))
          if t is not None]
    dev = q.device
    if not all(t.device == dev for t in ts):
        raise ValueError("q, k, v, positions, the biases, scales and cache "
                         "must lie on one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes fp32 or bf16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if cache is not None and cache[0].dtype not in DTYPES:
        raise TypeError(f"the kernel writes an fp32 or bf16 cache; got "
                        f"{cache[0].dtype}")
    _check(q, k, v, positions, hd, bias, norms, cache)
    if not all(t.is_contiguous() for t in (q, k, v, *(cache or ()))):
        raise ValueError("the kernel takes contiguous q, k, v and caches")
    B, S = q.shape[:2]
    H, Hkv = q.shape[2] // hd, k.shape[2] // hd
    # the chain's casts of the biases and scales to q's dtype
    bias, norms = ([t if t is None or (t.dtype == q.dtype
                                       and t.is_contiguous())
                    else t.to(q.dtype).contiguous() for t in group]
                   for group in (bias, norms))
    if positions.dim() == 1:
        positions = positions[None].expand(B, S)
    if positions.dtype != torch.int32 or positions.stride(1) != 1:
        positions = positions.to(torch.int32).contiguous()
    freqs = freq_table(hd, theta, dev)
    qo = q.new_empty((B, S, H, hd))
    ko = k.new_empty((B, S, Hkv, hd))
    vo = None if bv is None else v.new_empty((B, S, Hkv, hd))
    kc, vc = cache if cache is not None else (None, None)
    off = cache_index if cache is not None and cache_index is not None \
        and S == 1 else 0
    bf16 = q.dtype == torch.bfloat16
    # 16-byte vectors where hd / 2 holds whole vectors and every tensor
    # read or written by vector is aligned
    by_vector = [t for t in (q, k, v, qo, ko, vo, *bias, *norms, kc, vc)
                 if t is not None]
    wide = (hd // 2) % (8 if bf16 else 4) == 0 and all(
        t.data_ptr() % 16 == 0 for t in by_vector)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load("qkv_rope")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.repro_qkv_rope(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qo.data_ptr(),
            ko.data_ptr(), ptr(vo), *map(ptr, bias), *map(ptr, norms),
            freqs.data_ptr(), positions.data_ptr(), ptr(kc), ptr(vc),
            B, S, H, Hkv, hd, positions.stride(0),
            0 if kc is None else kc.shape[1], off, int(bf16),
            int(kc is not None and kc.dtype == torch.bfloat16), int(wide),
            eps, 1.0 / hd, stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        rules = (" (it takes an even head dim up to 256, all three biases "
                 "or none, both qk-norm scales or neither, and cache rows "
                 "inside the cache)" if rc == CUDA_INVALID_VALUE else "")
        raise RuntimeError(f"qkv_rope kernel launch failed: cudaError {rc} "
                           f"({msg}){rules}")
    launches += 1
    return qo, ko, v.view(B, S, Hkv, hd) if vo is None else vo
