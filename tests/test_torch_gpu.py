"""Card-only tests of the PyTorch port: each CUDA kernel against its
plain PyTorch version on an NVIDIA Hopper GPU, and the served model on
the card against the port's CPU path.

Every test carries the ``gpu`` marker and skips where there is no
Hopper card; whether there is one is decided inside the fixture. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKES
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels.ref import gqa_attention_ref, grouped_matmul_ref
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU; no CUDA device here")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) GPU")
    return torch.device("cuda")


def _inputs(shape, dtype, seed=0):
    B, Sq, Sk, H, Hkv, hd = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", [
    ((1, 128, 128, 4, 4, 64), True),      # one tile, MHA
    ((2, 256, 256, 8, 2, 64), True),      # GQA, several tiles
    ((1, 384, 384, 8, 2, 128), True),     # wide head
    ((4, 500, 500, 16, 16, 128), True),   # qwen2-moe-a2.7b prefill
    ((2, 200, 200, 4, 1, 64), True),      # ragged S
    ((1, 1, 1, 2, 1, 64), True),          # a single position
    ((2, 128, 384, 14, 2, 64), True),     # Sq != Sk, bottom-right diagonal
    ((2, 200, 200, 8, 2, 64), False),     # non-causal ragged
    ((1, 70, 300, 4, 2, 128), False),     # non-causal Sq != Sk
])
def test_kernel_matches_plain(hopper, shape, causal, dtype):
    q, k, v = _inputs(shape, dtype)
    out = fa.flash_attention(q, k, v, causal=causal)
    want = gqa_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def test_kernel_counts_launches(hopper):
    q, k, v = _inputs((1, 64, 64, 2, 1, 64), torch.float32)
    before = fa.launches
    fa.flash_attention(q, k, v)
    fa.flash_attention(q, k, v)
    assert fa.launches == before + 2


def test_kernel_causality(hopper):
    """Output at position i must not depend on keys or values > i."""
    q, k, v = _inputs((1, 256, 256, 4, 2, 64), torch.float32)
    out1 = fa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:] = torch.randn_like(k2[:, 128:])
    v2[:, 128:] = 0
    out2 = fa.flash_attention(q, k2, v2)
    torch.testing.assert_close(out1[:, :128], out2[:, :128], rtol=0, atol=0)


def test_kernel_rejects_what_it_cannot_run(hopper):
    q, k, v = _inputs((1, 64, 64, 2, 1, 64), torch.float32)
    before = fa.launches
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        fa.flash_attention(q, k[:, :32].contiguous(), v[:, :32].contiguous())
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention(q, k.cpu(), v)
    assert fa.launches == before


def test_engine_card_matches_cpu(hopper):
    """A small dense model (d_head 64, so the kernel takes it) greedy-
    decodes the same tokens on the card as on the CPU path."""
    cfg = SMOKES["qwen2-0.5b"].replace(d_model=256, n_heads=4, n_kv_heads=2,
                                       d_ff=512, d_head=64)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 140))
    gpu = ServeEngine(cfg, max_seq=160, device="cuda")
    cpu = ServeEngine(cfg, max_seq=160, device="cpu")
    before = fa.launches
    a = gpu.generate(prompt, n_new=8)
    assert fa.launches == before + cfg.n_layers
    b = cpu.generate(prompt, n_new=8)
    np.testing.assert_array_equal(a.tokens, b.tokens)


# ----------------------------------------------------------------------
# K2, the grouped GEMM of the MoE experts
def _gmm_inputs(shape, dtype, seed=0):
    """x ~ N(0, 1), w ~ N(0, 1/d): the scale of the model's experts."""
    E, C, d, f = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((E, C, d), generator=g, device="cuda")
    w = torch.randn((E, d, f), generator=g, device="cuda") / math.sqrt(d)
    return x.to(dtype), w.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (4, 128, 256, 128),      # the reference's sweep
    (2, 64, 512, 96),
    (6, 100, 300, 130),      # ragged C, d and f
    (1, 1, 1, 1),
    (60, 192, 2048, 1408),   # qwen2-moe-a2.7b prefill: gate and up
    (60, 192, 1408, 2048),   # prefill: down
    (60, 32, 2048, 1408),    # decode at B = 4
])
def test_grouped_matmul_matches_plain(hopper, shape, dtype):
    x, w = _gmm_inputs(shape, dtype)
    out = gm.grouped_matmul(x, w)
    want = grouped_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (shape[0], shape[1], shape[3])
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def test_grouped_matmul_counts_launches(hopper):
    x, w = _gmm_inputs((2, 16, 32, 8), torch.float32)
    before = gm.launches
    gm.grouped_matmul(x, w)
    gm.grouped_matmul(x, w)
    assert gm.launches == before + 2


def test_grouped_matmul_rejects_what_it_cannot_run(hopper):
    x, w = _gmm_inputs((2, 16, 32, 8), torch.float32)
    before = gm.launches
    with pytest.raises(TypeError):
        gm.grouped_matmul(x.half(), w.half())
    with pytest.raises(TypeError):
        gm.grouped_matmul(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        gm.grouped_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="one CUDA device"):
        gm.grouped_matmul(x, w.cpu())
    with pytest.raises(ValueError, match="non-empty"):
        gm.grouped_matmul(x[:, :0].contiguous(), w)
    assert gm.launches == before


def test_moe_engine_card_matches_cpu(hopper):
    """A small moe model (d_head 64, so K1 takes it) greedy-decodes the
    same tokens on the card as on the CPU path, its expert GEMMs through
    K2: three launches per layer per forward."""
    cfg = SMOKES["qwen2-moe-a2.7b"].replace(
        d_model=256, n_heads=4, n_kv_heads=4, d_head=64, d_ff=128,
        d_expert=128)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 140))
    gpu = ServeEngine(cfg, max_seq=160, device="cuda")
    cpu = ServeEngine(cfg, max_seq=160, device="cpu")
    before_fa, before_gm = fa.launches, gm.launches
    a = gpu.generate(prompt, n_new=8)
    assert fa.launches == before_fa + cfg.n_layers
    assert gm.launches == before_gm + 3 * cfg.n_layers * (1 + 8)
    b = cpu.generate(prompt, n_new=8)
    np.testing.assert_array_equal(a.tokens, b.tokens)
