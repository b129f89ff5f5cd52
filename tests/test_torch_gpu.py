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
    # S off every query (16 a warp, 64 a block) and key (32, 64) tile
    ((1, 17, 17, 4, 4, 128), True),
    ((2, 127, 127, 7, 1, 64), True),      # GQA group 7
    ((1, 129, 129, 8, 1, 128), True),     # GQA group 8
    ((4, 500, 500, 14, 2, 64), True),     # qwen2-0.5b prefill
    ((1, 1, 129, 4, 4, 128), False),
    ((2, 129, 127, 8, 8, 64), False),
    # Sq < Sk, causal, Sq off the tiles
    ((1, 17, 129, 8, 8, 64), True),
    ((2, 127, 500, 7, 1, 128), True),
    ((1, 1, 500, 8, 1, 64), True),
    # hd 112: zamba2-7b's shared attention block, then ragged S, off the
    # tiles, Sq < Sk and non-causal
    ((4, 500, 500, 32, 32, 112), True),
    ((2, 200, 200, 4, 1, 112), True),
    ((1, 17, 17, 4, 4, 112), True),
    ((2, 127, 500, 7, 1, 112), True),
    ((1, 300, 300, 2, 2, 112), True),
    ((1, 70, 300, 4, 2, 112), False),
    ((2, 129, 127, 8, 8, 112), False),
])
def test_kernel_matches_plain(hopper, shape, causal, dtype):
    q, k, v = _inputs(shape, dtype)
    out = fa.flash_attention(q, k, v, causal=causal)
    want = gqa_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape,causal", [
    ((4, 500, 500, 16, 16, 128), True),   # qwen2-moe-a2.7b prefill
    ((4, 500, 500, 14, 2, 64), True),     # qwen2-0.5b prefill
    ((1, 200, 200, 2, 2, 128), True),     # the CPU emulation's cut
    ((1, 129, 500, 8, 1, 128), True),
    ((1, 70, 300, 4, 2, 128), False),
    ((4, 500, 500, 32, 32, 112), True),   # zamba2-7b prefill
    ((1, 129, 500, 8, 1, 112), True),
    ((1, 70, 300, 4, 2, 112), False),
])
def test_kernel_matches_plain_peaked(hopper, shape, causal, seed):
    """fp32 with q scaled by 8 (logits x8, a peaked softmax): plain TF32
    is 1e-2 off here, so the small parts of 3xTF32 decide the result.
    The plain version in fp32 is itself up to 2.6e-5 off the exact
    result here (its q k^T is an fp32 sum of logits x8), so the kernel
    is held to the plain version computed in float64 on the same
    inputs. (In bf16 the plain version rounds the scores themselves to
    bf16, 1 in a logit of 300, so no kernel that keeps them in fp32 can
    match it.)"""
    q, k, v = _inputs(shape, torch.float32, seed)
    q = q * 8
    out = fa.flash_attention(q, k, v, causal=causal)
    want = gqa_attention_ref(q.double(), k.double(), v.double(),
                             causal=causal).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(hopper, dtype):
    """The same inputs give the same bits (no atomics, fixed order)."""
    q, k, v = _inputs((4, 500, 500, 16, 16, 128), dtype)
    a = fa.flash_attention(q, k, v)
    b = fa.flash_attention(q, k, v)
    assert torch.equal(a, b)


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
    for hd in (32, 96):
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention(*_inputs((1, 64, 64, 2, 1, hd), torch.float32))
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(shifted, k, v)
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
    (60, 32, 2048, 1408),    # decode at B = 4: gate and up
    (60, 32, 1408, 2048),    # decode: down
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


def _rows(kind, E, C, seed=0):
    """(E,) int32 rows on the card: "decode" gives 15 experts 1-4 rows and
    the rest 0, as a decode step of B = 4 at top-4 does; "ragged" draws
    from [0, C] with rows[0] = 0 and rows[-1] = C; "zero" and "full" are
    all 0 and all C."""
    rng = np.random.default_rng(seed)
    if kind == "decode":
        r = np.zeros(E, np.int32)
        r[rng.choice(E, size=min(15, E), replace=False)] = rng.integers(
            1, min(4, C) + 1, min(15, E))
    elif kind == "ragged":
        r = rng.integers(0, C + 1, E).astype(np.int32)
        r[0], r[-1] = 0, C
    else:
        r = np.full(E, 0 if kind == "zero" else C, np.int32)
    return torch.from_numpy(r).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kind", [
    ((60, 32, 2048, 1408), "decode"),    # the decode step's gate and up
    ((60, 32, 1408, 2048), "decode"),    # and its down
    ((60, 192, 2048, 1408), "ragged"),   # the prefill's gate and up
    ((60, 192, 1408, 2048), "ragged"),   # and its down
    ((60, 32, 2048, 1408), "zero"),
    ((60, 192, 1408, 2048), "zero"),
    ((60, 32, 2048, 1408), "full"),
    ((60, 192, 2048, 1408), "full"),
    ((4, 128, 256, 128), "ragged"),      # the reference's sweep
    ((2, 64, 512, 96), "ragged"),
    ((6, 100, 300, 130), "ragged"),
    ((6, 20, 300, 130), "ragged"),       # ragged, decode variant
    ((2, 1, 1, 1), "ragged"),
])
def test_grouped_matmul_rows_matches_plain(hopper, shape, kind, dtype):
    """With ``rows``: the occupied rows equal the plain version, and the
    rest are exactly 0."""
    x, w = _gmm_inputs(shape, dtype)
    rows = _rows(kind, shape[0], shape[1])
    live = torch.arange(shape[1], device="cuda") < rows[:, None]
    x = torch.where(live[..., None], x, 0)
    out = gm.grouped_matmul(x, w, rows)
    want = grouped_matmul_ref(x, w, rows)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (shape[0], shape[1], shape[3])
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert not out[~live].any()


@pytest.mark.parametrize("shape", [(8, 32, 256, 192), (8, 192, 256, 192)])
def test_grouped_matmul_rows_reads_nothing_past_them(hopper, shape):
    """NaN in every row of x past rows[e] and in the weights of experts
    with rows[e] = 0 reaches no output: the kernel never reads them."""
    x, w = _gmm_inputs(shape, torch.float32)
    rows = torch.tensor([0, 1, 3, 0, 4, shape[1], 70, 0],
                        dtype=torch.int32, device="cuda").clamp(max=shape[1])
    live = torch.arange(shape[1], device="cuda") < rows[:, None]
    want = grouped_matmul_ref(torch.where(live[..., None], x, 0), w, rows)
    x = torch.where(live[..., None], x, float("nan"))
    w[rows == 0] = float("nan")
    out = gm.grouped_matmul(x, w, rows)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


def test_grouped_matmul_rejects_bad_rows(hopper):
    x, w = _gmm_inputs((4, 16, 32, 8), torch.float32)
    rows = torch.full((4,), 16, dtype=torch.int32, device="cuda")
    before = gm.launches
    with pytest.raises(TypeError, match="rows"):
        gm.grouped_matmul(x, w, rows.long())
    with pytest.raises(ValueError, match="rows"):
        gm.grouped_matmul(x, w, rows[:3].contiguous())
    with pytest.raises(ValueError, match="rows"):
        gm.grouped_matmul(x, w, torch.full((8,), 16, dtype=torch.int32,
                                           device="cuda")[::2])
    with pytest.raises(ValueError, match="rows"):
        gm.grouped_matmul(x, w, rows.cpu())
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


def test_zamba2_engine_card_matches_cpu(hopper):
    """A small Zamba2 (d_head 112, so K1 runs its hd-112 instantiation;
    the smoke config's 16 is no kernel shape) greedy-decodes the same
    tokens on the card as on the CPU path: one K1 launch per application
    of the shared block in prefill, none in decode. The 140-token prompt
    spans five SSD chunks of 32."""
    cfg = SMOKES["zamba2-7b"].replace(d_model=448, n_heads=4, n_kv_heads=4,
                                      d_head=112, d_ff=512, ssm_heads=14,
                                      ssm_head_dim=64)
    assert cfg.d_head == 112 and cfg.n_layers == 4
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 140))
    gpu = ServeEngine(cfg, max_seq=160, device="cuda")
    cpu = ServeEngine(cfg, max_seq=160, device="cpu")
    before = fa.launches
    a = gpu.generate(prompt, n_new=8)
    assert fa.launches == before + cfg.n_layers // cfg.hybrid_attn_every
    b = cpu.generate(prompt, n_new=8)
    np.testing.assert_array_equal(a.tokens, b.tokens)
