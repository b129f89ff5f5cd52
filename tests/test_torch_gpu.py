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
    # hd 112 with Sk off every key tile and Sq != Sk (its last TMA box of
    # hd reads 0 past 112, its last key tile 0 past Sk)
    ((2, 77, 203, 4, 2, 112), True),
    ((1, 33, 97, 2, 1, 112), False),
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


@pytest.mark.parametrize("kind", ["nan", "large"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_stays_within_its_sequence(hopper, hd, dtype, causal, kind):
    """B = 2 with Sk = 77, off every key tile: the last key tile of the
    first sequence runs past Sk, where the copies must read 0 and not the
    second sequence's keys and values. Those are NaN ("nan": a read would
    reach the output through 0 * NaN) or scaled by 1e4 ("large"); the
    first sequence's output must equal the plain version on it alone."""
    q, k, v = _inputs((2, 45, 77, 4, 2, hd), dtype, seed=5)
    if kind == "nan":
        k[1], v[1] = float("nan"), float("nan")
    else:
        k[1], v[1] = k[1] * 1e4, v[1] * 1e4
    out = fa.flash_attention(q, k, v, causal=causal)
    want = gqa_attention_ref(q[:1], k[:1], v[:1], causal=causal)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    torch.testing.assert_close(out[:1].float(), want.float(), rtol=tol,
                               atol=tol)
    if kind == "large":
        assert bool(torch.isfinite(out[1]).all())


# The prefill shapes of the served models: qwen2-0.5b, qwen2-moe-a2.7b,
# zamba2-7b's shared block, internvl2-1b (S = 756 with its patches),
# musicgen-large, qwen3-14b (GQA groups of 5 at hd 128) and minicpm-2b.
MAIN_PATH_SHAPES = [(4, 500, 500, 14, 2, 64), (4, 500, 500, 16, 16, 128),
                    (4, 500, 500, 32, 32, 112), (4, 756, 756, 14, 2, 64),
                    (4, 500, 500, 32, 32, 64), (4, 500, 500, 40, 8, 128),
                    (4, 500, 500, 36, 36, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES)
def test_main_path_shapes_run_flash_wgmma(hopper, shape, dtype):
    """Each served model's prefill shape goes through flash_wgmma, the
    variant of its dtype (3xTF32 in fp32), and holds its tolerance."""
    q, k, v = _inputs(shape, dtype, seed=23)
    before = dict(fa.route_launches)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ran = {r: n - before[r] for r, n in fa.route_launches.items()
           if n != before[r]}
    assert ran == {fa.variant(shape[-1], dtype): 1}
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), gqa_attention_ref(
        q, k, v).float(), rtol=tol, atol=tol)


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


PREFILL_SHAPES = [(60, 192, 2048, 1408), (60, 192, 1408, 2048)]


def _routes_of(fn):
    """(fn's result, the K2 variants it launched, by name)."""
    before = dict(gm.route_launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in gm.route_launches.items()
                 if n != before[k]}


@pytest.mark.parametrize("case", ["dense", "ragged", "full", "zero", "x8",
                                  "nan"])
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_grouped_matmul_prefill_runs_3xtf32_wgmma(hopper, shape, case):
    """The moe prefill's two K2 shapes at full width go through the
    tensor-core variant (gmm_wgmma) and hold 2e-5 against the plain
    version: dense, with rows "ragged", "full" and "zero", with x scaled
    by 8, and with NaN in x past rows[e] and in the weights of experts
    with no row. The plain version computed in float64 holds them at 2e-5
    too; with x scaled by 8 it is the one held to (the fp32 plain version
    is itself up to 8.5e-5 off float64 there, the kernel 2.4e-5)."""
    E, C, d, f = shape
    x, w = _gmm_inputs(shape, torch.float32, seed=22)
    rows = None
    if case in ("ragged", "full", "zero"):
        rows = _rows(case, E, C, seed=22)
    elif case == "nan":
        rows = _rows("ragged", E, C, seed=23)
    if case == "x8":
        x = x * 8
    live = torch.ones(E, C, dtype=torch.bool, device="cuda")
    if rows is not None:
        live = torch.arange(C, device="cuda") < rows[:, None]
        x = torch.where(live[..., None], x, 0)
    want = grouped_matmul_ref(x, w, rows)
    exact = torch.where(live[..., None], torch.einsum(
        "ecd,edf->ecf", x.double(), w.double()), 0)
    if case == "nan":
        x = torch.where(live[..., None], x, float("nan"))
        w[rows == 0] = float("nan")
    out, routes = _routes_of(lambda: gm.grouped_matmul(x, w, rows))
    assert routes == {"gmm_wgmma": 1}
    assert bool(torch.isfinite(out).all()) and not out[~live].any()
    torch.testing.assert_close(out.double(), exact, rtol=2e-5, atol=2e-5)
    if case != "x8":
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["dense", "decode", "ragged", "zero",
                                  "full", "nan"])
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_grouped_matmul_prefill_runs_bf16_wgmma(hopper, shape, case):
    """The moe prefill's two K2 shapes at full width in bf16 go through
    the bf16 tensor-core variant (gmm_wgmma_bf16) and hold 2e-2 against
    the plain version: dense, with rows "decode" (15 experts of 1-4
    rows: one live n-tile), "ragged", "zero" and "full", and with NaN in
    x past rows[e] and in the weights of experts with no row, which reach
    no output. Rows past rows[e] come out exactly 0."""
    E, C, d, f = shape
    x, w = _gmm_inputs(shape, torch.bfloat16, seed=24)
    rows = None
    if case in ("decode", "ragged", "zero", "full"):
        rows = _rows(case, E, C, seed=24)
    elif case == "nan":
        rows = _rows("ragged", E, C, seed=25)
    live = torch.ones(E, C, dtype=torch.bool, device="cuda")
    if rows is not None:
        live = torch.arange(C, device="cuda") < rows[:, None]
        x = torch.where(live[..., None], x, 0)
    want = grouped_matmul_ref(x, w, rows)
    if case == "nan":
        x = torch.where(live[..., None], x, float("nan"))
        w[rows == 0] = float("nan")
    out, routes = _routes_of(lambda: gm.grouped_matmul(x, w, rows))
    assert routes == {"gmm_wgmma_bf16": 1}
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all()) and not out[~live].any()
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


DECODE_SHAPES = [(60, 32, 2048, 1408), (60, 32, 1408, 2048)]
DECODE_CASES = ["dense", "decode", "zero", "full", "nan",
                "n1", "n7", "n8", "n9", "n17", "n32"]


def _decode_rows(case, E, C, seed):
    """rows of a decode case: "decode", "zero", "full" as ``_rows``;
    "nan" the "decode" rows; "n<k>" k rows in the even experts and none
    in the odd ones (k = 1, 7, 8, 9, 17, 32: one to four n-tiles of 8
    rows, full or not); "dense" none."""
    if case == "dense":
        return None
    if case.startswith("n") and case != "nan":
        r = torch.zeros(E, dtype=torch.int32)
        r[::2] = int(case[1:])
        return r.cuda()
    return _rows("decode" if case == "nan" else case, E, C, seed=seed)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_grouped_matmul_decode_runs_bf16_wgmma(hopper, shape, case):
    """The moe decode step's two K2 shapes at full width in bf16 go
    through the tensor-core decode variant (gmm_decode_bf16) and hold
    2e-2 against the plain version: dense, with rows "decode" (15
    experts of 1-4 rows), "zero", "full" and n rows in half the experts
    for n in {1, 7, 8, 9, 17, 32}, and with NaN in x past rows[e] and in
    the weights of experts with no row, which reach no output. Rows past
    rows[e] come out exactly 0, and a second launch gives the same bits
    (no atomics)."""
    E, C, d, f = shape
    x, w = _gmm_inputs(shape, torch.bfloat16, seed=25)
    rows = _decode_rows(case, E, C, seed=25)
    live = torch.ones(E, C, dtype=torch.bool, device="cuda")
    if rows is not None:
        live = torch.arange(C, device="cuda") < rows[:, None]
        x = torch.where(live[..., None], x, 0)
    want = grouped_matmul_ref(x, w, rows)
    if case == "nan":
        x = torch.where(live[..., None], x, float("nan"))
        w[rows == 0] = float("nan")
    out, routes = _routes_of(lambda: gm.grouped_matmul(x, w, rows))
    assert routes == {"gmm_decode_bf16": 1}
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all()) and not out[~live].any()
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(out, gm.grouped_matmul(x, w, rows))


@pytest.mark.parametrize("kind", ["dense", "ragged"])
@pytest.mark.parametrize("shape", [
    (1, 1, 64, 64),      # E = 1, C = 1
    (5, 8, 64, 128),     # one full n-tile
    (3, 24, 192, 72),    # f off the 64-column slice
    (2, 17, 40, 24),     # d and f below one TMA box, C off the n-tiles
    (4, 32, 200, 136),   # d off the 64-deep stage
    (300, 4, 64, 64),    # more experts than the rank's shared cache
])
def test_grouped_matmul_decode_edges(hopper, shape, kind):
    """Small and ragged bf16 shapes at C <= 32 that TMA can copy take
    gmm_decode_bf16 (the boxes past d, f and C read 0) and hold 2e-2
    against the plain version, rows past rows[e] exactly 0; 300 experts
    rank their rows from device memory (``RANK_CACHE`` holds 256)."""
    E, C, d, f = shape
    x, w = _gmm_inputs(shape, torch.bfloat16, seed=26)
    rows = _rows(kind, E, C, seed=26) if kind != "dense" else None
    live = torch.ones(E, C, dtype=torch.bool, device="cuda")
    if rows is not None:
        live = torch.arange(C, device="cuda") < rows[:, None]
        x = torch.where(live[..., None], x, 0)
    out, routes = _routes_of(lambda: gm.grouped_matmul(x, w, rows))
    assert routes == {"gmm_decode_bf16": 1}
    assert not out[~live].any()
    torch.testing.assert_close(out.float(),
                               grouped_matmul_ref(x, w, rows).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", ["fp32", "fp32_rows", "bf16_f132",
                                  "bf16_unaligned", "one"])
def test_grouped_matmul_decode_keeps_cuda_cores(hopper, case):
    """C <= 32 stays on the CUDA-core variant (gmm_small) in fp32, and in
    bf16 where TMA cannot copy: f = 132 (not a multiple of 8), an x 4
    bytes past 16-byte alignment, and E = C = d = f = 1; right all the
    same."""
    shape, dtype = {"fp32": ((60, 32, 2048, 1408), torch.float32),
                    "fp32_rows": ((60, 32, 1408, 2048), torch.float32),
                    "bf16_f132": ((6, 20, 304, 132), torch.bfloat16),
                    "bf16_unaligned": ((4, 32, 256, 128), torch.bfloat16),
                    "one": ((1, 1, 1, 1), torch.bfloat16)}[case]
    x, w = _gmm_inputs(shape, dtype)
    if case == "bf16_unaligned":
        x = torch.cat([x.new_zeros(2), x.flatten()])[2:].view(shape[:3])
    rows = _rows("decode", shape[0], shape[1]) if case == "fp32_rows" \
        else None
    if rows is not None:
        live = torch.arange(shape[1], device="cuda") < rows[:, None]
        x = torch.where(live[..., None], x, 0)
    out, routes = _routes_of(lambda: gm.grouped_matmul(x, w, rows))
    assert routes == {"gmm_small": 1}
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(),
                               grouped_matmul_ref(x, w, rows).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["f_off", "d_off", "bf16", "unaligned",
                                  "bf16_unaligned"])
def test_grouped_matmul_takes_cuda_cores_where_tma_cannot(hopper, case):
    """What TMA cannot copy takes the CUDA-core variant (gmm_large), right
    all the same: f or d not a multiple of 16 bytes' worth of elements
    (4 fp32, 8 bf16: "bf16" has an f of 132, which fp32 would copy), or
    an x whose pointer is 4 bytes past 16-byte alignment."""
    shape, dtype = {"f_off": ((6, 100, 300, 130), torch.float32),
                    "d_off": ((6, 100, 302, 128), torch.float32),
                    "bf16": ((6, 100, 304, 132), torch.bfloat16),
                    "unaligned": ((4, 64, 256, 128), torch.float32),
                    "bf16_unaligned": ((4, 64, 256, 128), torch.bfloat16)
                    }[case]
    x, w = _gmm_inputs(shape, dtype)
    if case.endswith("unaligned"):
        pad = 4 // x.element_size()
        x = torch.cat([x.new_zeros(pad), x.flatten()])[pad:].view(shape[:3])
    out, routes = _routes_of(lambda: gm.grouped_matmul(x, w))
    assert routes == {"gmm_large": 1}
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), grouped_matmul_ref(x, w).float(),
                               rtol=tol, atol=tol)


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


# Small models of each family at head dims K1 takes, served in bf16
BF16_FAMILIES = {
    "hybrid": SMOKES["zamba2-7b"].replace(
        d_model=448, n_heads=4, n_kv_heads=4, d_head=112, d_ff=512,
        ssm_heads=14, ssm_head_dim=64),
    "ssm": SMOKES["xlstm-350m"],
    "audio": SMOKES["musicgen-large"].replace(
        d_model=256, n_heads=4, n_kv_heads=4, d_head=64, d_ff=512),
    "vlm": SMOKES["internvl2-1b"].replace(
        d_model=256, n_heads=4, n_kv_heads=2, d_head=64, d_ff=512),
    "gqa5_hd128": SMOKES["qwen3-14b"].replace(
        d_model=640, n_heads=5, n_kv_heads=1, d_head=128, d_ff=512),
}


def _chip_smoke():
    """``chip_smoke.py`` as a module: its card-vs-CPU rule."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family", list(BF16_FAMILIES))
def test_bf16_engine_card_matches_cpu(hopper, family):
    """A small bf16 model of each family served on the card against the
    CPU path from the same weights, under chip_smoke.py's rule: the
    last-position prefill logits within 2^-5 of the largest |logit|, and
    the tokens of each of 16 prompts equal up to that row's first CPU
    near-tie, with at least one step compared (the prompt seed changes,
    at most 3 times, while none is). Every prefill attention on K1's
    bf16 variant."""
    from repro_torch import build_model
    from repro_torch.models.stacks import n_attn_applications

    cs = _chip_smoke()
    cfg = BF16_FAMILIES[family]
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                     device="cpu")
    gpu = type(cpu)(cfg, torch.bfloat16, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    _, prompt, c_trace = cs.cpu_prompt(
        cfg, 140, torch.bfloat16,
        lambda p: cs.greedy_trace(model, cpu, p, 8, "cpu"))
    before = dict(fa.route_launches)
    g_trace = cs.greedy_trace(model, gpu, prompt, 8, "cuda")
    ran = {r: n - before[r] for r, n in fa.route_launches.items()
           if n != before[r]}
    attn = {"hybrid": n_attn_applications(cfg), "ssm": 0}.get(
        cfg.family, cfg.n_layers)
    assert ran == ({"flash_wgmma_bf16": attn} if attn else {})
    out = cs.compare_card_cpu(g_trace, c_trace, torch.bfloat16)
    assert sum(out["compared"]) > 0


def _train(cfg, device, **kw):
    from repro_torch.train import TrainConfig, train

    tc = dict(steps=3, batch=2, seq=64, peak_lr=1e-3, warmup=1,
              log_every=100)
    tc.update(kw)
    return train(cfg, TrainConfig(device=device, **tc),
                 log_fn=lambda *_: None)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_train_step_card_matches_cpu(hopper, arch):
    """Three training steps on the card match the CPU path from the same
    weights (drawn from a CPU generator), with no K1 or K2 launch: the
    training routes are the reference's masked attention and einsum
    experts. At 1e-5: chip_smoke.py's full-width 2-layer run measures
    8.0e-8 and holds it to 1e-6."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = fa.launches, gm.launches
        card = _train(SMOKES[arch], "cuda")
        assert (fa.launches, gm.launches) == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = _train(SMOKES[arch], "cpu")
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-5)
    assert card["state"]["params"].embed.device.type == "cuda"


def test_train_resume_on_card_is_exact(hopper, tmp_path):
    """train(6) == train(3) + checkpoint + resume(3) on the card, to the
    reference's rtol 1e-5."""
    cfg = SMOKES["qwen2-0.5b"]
    full = _train(cfg, "cuda", steps=6)
    d = str(tmp_path / "ck")
    _train(cfg, "cuda", steps=3, ckpt_dir=d, ckpt_every=3)
    resumed = _train(cfg, "cuda", steps=6, ckpt_dir=d, ckpt_every=3)
    np.testing.assert_allclose(full["losses"][3:], resumed["losses"],
                               rtol=1e-5)


@pytest.mark.parametrize("route", [False, "cp"], ids=["masked", "cp"])
def test_sharded_train_step_on_a_one_rank_nccl_mesh(hopper, route):
    """A smoke config's train step, its state placed by the sharding
    rules on a world-size-1 nccl group's (1, 1) mesh, equals the plain
    step on the card from the same weights (S = 256: "cp" takes the
    chunked route); the group is gone afterwards."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint.elastic import reshard_state
    from repro_torch.distributed.sharding import (batch_specs, param_specs,
                                                  placements, state_specs)
    from repro_torch.launch.mesh import make_local_mesh, process_group
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.registry import build_model

    cfg = SMOKES["qwen2-0.5b"]
    model = build_model(cfg, use_flash=route)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 256), generator=g)
             .to("cuda") for k in ("tokens", "targets")}
    step = make_train_step(model, peak_lr=1e-3, warmup=1)

    def state():
        return init_train_state(model, torch.Generator().manual_seed(0),
                                device="cuda")

    plain, m = step(state(), batch)
    with process_group("nccl"):
        mesh = make_local_mesh()
        st = reshard_state(state(), mesh, state_specs(
            cfg, mesh, param_specs(cfg, plain["params"], mesh)))
        bs = batch_specs(cfg, "train", mesh)
        placed = {k: distribute_tensor(v, mesh, placements(bs[k], mesh))
                  for k, v in batch.items()}
        st, ms = step(st, placed)
        loss = float(ms["loss"].full_tensor())
        got = {k: v.full_tensor() for k, v in st["params"].named_parameters()}
    assert not dist.is_initialized()
    assert loss == pytest.approx(float(m["loss"]), rel=1e-6)
    for k, v in plain["params"].named_parameters():
        torch.testing.assert_close(got[k], v.detach(), rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# K3, attention's q/k/v epilogue (bias, qk-norm, RoPE, the cache write)
# (H, Hkv, hd, bias, qk-norm) of every served model's attention, then
# shapes that take the kernel's other paths: qk-norm with bias at hd 112;
# hd 80 (5 bf16 vectors a half: idle lanes); hd 72 (36 values a half: one
# value at a time in bf16)
K3_HEADS = {
    "qwen2-0.5b": (14, 2, 64, True, False),      # and internvl2-1b
    "qwen2-moe-a2.7b": (16, 16, 128, True, False),
    "qwen3-14b": (40, 8, 128, False, True),
    "zamba2-7b": (32, 32, 112, False, False),
    "minicpm-2b": (36, 36, 64, False, False),    # musicgen-large: 32/32
    "bias+norm hd112": (6, 3, 112, True, True),
    "hd80": (5, 1, 80, True, True),
    "hd72": (4, 2, 72, False, True),
}
# (B, S, cache index): prefill at S up to 4096, ragged, and decode steps
K3_MODES = {"prefill 1x4096": (1, 4096, None), "prefill 3x1001": (3, 1001, None),
            "decode at 4095": (16, 1, 4095), "decode at 17": (16, 1, 17)}
K3_T = 4097


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(K3_MODES))
@pytest.mark.parametrize("case", list(K3_HEADS))
def test_qkv_rope_matches_the_plain_chain(hopper, case, mode, dtype):
    """K3 against ``ref.qkv_rope_ref`` on the card at every served
    model's heads, prefill and decode, under chip_smoke.py's rule
    (``k3_held``): q and k within 1 bf16 ulp (2e-6 of a head's largest
    value in fp32), or the other rounding where qk-norm's rsqrt factor is
    a near-tie; v equal bit for bit; the cache rows the kernel's own k
    and v; every other cache row left as it was."""
    from repro_torch.kernels import qkv_rope as k3
    from repro_torch.kernels.ref import qkv_rope_ref

    cs = _chip_smoke()
    heads = K3_HEADS[case]
    B, S, index = K3_MODES[mode]
    args = cs.k3_inputs(heads, B, S, index, dtype)
    caches = [cs.k3_caches(B, K3_T, heads[1], heads[2]) for _ in range(2)]
    before = k3.launches
    got = k3.qkv_rope(*args, cache=caches[0], cache_index=index)
    want = qkv_rope_ref(*args, cache=caches[1], cache_index=index)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    assert [t.shape for t in got] == [t.shape for t in want]
    assert all(t.dtype == dtype for t in got)
    held = cs.k3_held(got, want, args, dtype, caches[0], index)
    print(held)
    assert cs.k3_ok(held), held
    assert set(held) >= {"cache_rows_own", "cache_rest_kept"}
    assert ("near_ties" in held) == (dtype == torch.bfloat16 and heads[4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qkv_rope_without_cache_or_bias_writes_q_and_k(hopper, dtype):
    """No cache: q and k come back, v is the projection itself; a bf16
    cache under fp32 inputs takes the rounded k and v."""
    from repro_torch.kernels import qkv_rope as k3
    from repro_torch.kernels.ref import qkv_rope_ref

    cs = _chip_smoke()
    args = cs.k3_inputs((8, 2, 128, False, False), 2, 300, None, dtype)
    q, k, v = k3.qkv_rope(*args)
    wq, wk, wv = qkv_rope_ref(*args)
    assert v.data_ptr() == args[2].data_ptr()
    assert cs.k3_held((q, k, v), (wq, wk, wv), args, dtype)["heads_off"] \
        == [0, 0]
    cache = tuple(torch.zeros(2, 300, 2, 128, dtype=torch.bfloat16,
                              device="cuda") for _ in "kv")
    k3.qkv_rope(*args, cache=cache)
    assert torch.equal(cache[0], k.to(torch.bfloat16))
    assert torch.equal(cache[1], wv.to(torch.bfloat16))


def test_qkv_rope_rejects_what_it_cannot_run(hopper):
    """What the kernel cannot take raises before a launch (a dtype,
    strides, arguments its C entry refuses); inputs that need a gradient
    and tensors off the card take the plain chain instead."""
    from repro_torch.kernels import qkv_rope as k3

    cs = _chip_smoke()
    args = cs.k3_inputs((4, 2, 64, True, False), 2, 8, None, torch.float32)
    before = k3.launches
    with pytest.raises(TypeError):
        k3.qkv_rope(*(a.half() if isinstance(a, torch.Tensor)
                      and a.is_floating_point() else a for a in args))
    with pytest.raises(ValueError, match="contiguous"):
        k3.qkv_rope(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                    *args[1:])
    with pytest.raises(RuntimeError, match="biases or none"):
        k3.qkv_rope(*args[:6], args[6], None, args[8], *args[9:])
    big = cs.k3_inputs((2, 1, 258, False, False), 1, 4, None, torch.float32)
    with pytest.raises(RuntimeError, match="head dim up to 256"):
        k3.qkv_rope(*big)
    cache = cs.k3_caches(2, 8, 2, 64)
    with pytest.raises(RuntimeError, match="inside the cache"):
        k3.qkv_rope(*(a[:, :1].contiguous() if i < 4 else a
                      for i, a in enumerate(args)), cache=cache, cache_index=8)
    with pytest.raises(RuntimeError):     # the plain chain's device check
        k3.qkv_rope(args[0], args[1].cpu(), *args[2:])
    with torch.enable_grad():
        q, _, _ = k3.qkv_rope(args[0].requires_grad_(True), *args[1:])
    assert q.grad_fn is not None
    assert k3.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen2-moe-a2.7b"])
def test_engine_runs_k3_once_a_layer_and_matches_the_plain_chain(
        hopper, arch, dtype):
    """A 2-layer full-width model served on the card: every attention
    layer of every forward runs K3 once and the plain chain never runs on
    CUDA tensors; with K3 turned off the same engine serves the same
    greedy tokens (bf16: up to each row's first step with a top-2 margin
    below chip_smoke.py's near-tie)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import qkv_rope as k3

    cs = _chip_smoke()
    cfg = ARCHS[arch].replace(n_layers=2)
    eng = ServeEngine(cfg, params=cs.draw_on_card(cfg, dtype), max_seq=300,
                      device="cuda")
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (cs.CARD_CPU_ROWS[dtype], 256))
    plain_cuda = []
    real = k3.qkv_rope_ref

    def spy(q, *a, **kw):
        if q.is_cuda:
            plain_cuda.append(q.shape)
        return real(q, *a, **kw)

    n_new, real_reason = 8, k3.plain_reason
    forwards = cfg.n_layers * (1 + n_new)
    try:
        k3.qkv_rope_ref = spy
        before = k3.launches
        fused = cs.greedy_trace(eng.model, eng.params, prompt, n_new, "cuda")
        assert k3.launches - before == forwards and plain_cuda == []
        k3.plain_reason = lambda *a: "off"
        plain = cs.greedy_trace(eng.model, eng.params, prompt, n_new, "cuda")
        assert k3.launches - before == forwards
        assert len(plain_cuda) == forwards
    finally:
        k3.qkv_rope_ref = real
        k3.plain_reason = real_reason
    out = cs.compare_card_cpu(fused, plain, dtype)
    assert sum(out["compared"]) > 0
