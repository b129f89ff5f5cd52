"""Parity of the port's flash-attention entry point with the reference
package's, on the CPU.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` runs the
kernel's plain version; it is held against the reference's Pallas
kernel (interpret mode) and its oracle on the same numpy inputs. The
CUDA kernel itself is tested on the card in ``test_torch_gpu.py``; its
fp32 arithmetic (3xTF32 on the tensor cores) is emulated here in plain
torch and held to the oracle too.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, q_shape, kv_shape, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (1, 128, 4, 64),    # minimal blocks
    (2, 256, 8, 64),    # multi-block
    (1, 384, 8, 128),   # 3 blocks, big head
    (2, 200, 4, 64),    # padding path
])
@pytest.mark.parametrize("group", ["mha", "gqa"])
def test_flash_attention_matches_reference(shape, dtype, group):
    B, S, H, hd = shape
    hkv = H if group == "mha" else max(H // 4, 1)
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, (B, S, H, hd), (B, S, hkv, hd), dtype)
    out = tops.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == TDT[dtype] and out.shape == (B, S, H, hd)
    np.testing.assert_allclose(
        _np(out), _np(jops.flash_attention(jq, jk, jv, causal=True)),
        **_tol(dtype))
    np.testing.assert_allclose(
        _np(out), _np(jref.gqa_attention_ref(jq, jk, jv, causal=True)),
        **_tol(dtype))


def test_flash_attention_causality():
    """Output at position i must not depend on tokens > i."""
    B, S, H, hd = 1, 256, 4, 64
    rng = np.random.default_rng(1)
    q, k, v, k_late = (torch.from_numpy(
        rng.standard_normal((B, S, H, hd)).astype(np.float32))
        for _ in range(4))
    out1 = tops.flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, S // 2:] = k_late[:, S // 2:]
    v2[:, S // 2:] = 0.0
    out2 = tops.flash_attention(q, k2, v2, causal=True)
    np.testing.assert_allclose(_np(out1[:, :S // 2]), _np(out2[:, :S // 2]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,sk", [(128, 384), (1, 200), (70, 71)])
def test_flash_attention_bottom_right_when_sq_ne_sk(sq, sk):
    """Sq != Sk: the diagonal is aligned bottom-right, as the reference
    oracle aligns it (the reference Pallas kernel aligns it top-left and
    its wrapper never reaches this case, so only the oracle is used)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        2, (2, sq, 8, 64), (2, sk, 2, 64), "float32")
    out = tops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(
        _np(out), _np(jref.gqa_attention_ref(jq, jk, jv, causal=True)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [200, 77])
def test_flash_attention_non_causal_ragged(s, dtype):
    """Non-causal with S off the 128 grid: no padded key enters the
    softmax (held against the oracle, never against the reference
    wrapper, which lets zero-padded keys in)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(3, (2, s, 8, 64), (2, s, 2, 64),
                                         dtype)
    out = tops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(
        _np(out), _np(jref.gqa_attention_ref(jq, jk, jv, causal=False)),
        **_tol(dtype))


def test_attention_ref_matches_reference_oracle():
    """The plain version itself, (BH, Sq, hd) layout, causal and not."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(4, (6, 96, 64), (6, 160, 64),
                                         "float32")
    for causal in (True, False):
        np.testing.assert_allclose(
            _np(tref.attention_ref(tq, tk, tv, causal)),
            _np(jref.attention_ref(jq, jk, jv, causal)),
            rtol=2e-5, atol=2e-5)


def test_flash_attention_cpu_path_never_launches():
    _, (tq, tk, tv) = _inputs(5, (1, 64, 2, 64), (1, 64, 1, 64), "float32")
    before = fa.launches
    tops.flash_attention(tq, tk, tv)
    assert fa.launches == before


@pytest.mark.parametrize("bad", ["rank", "group", "batch", "causal_sq_gt_sk"])
def test_flash_attention_rejects_bad_shapes(bad):
    q = torch.zeros(1, 64, 4, 64)
    k = v = torch.zeros(1, 64, 2, 64)
    if bad == "rank":
        q = q[0]
    elif bad == "group":
        k = v = torch.zeros(1, 64, 3, 64)
    elif bad == "batch":
        k = v = torch.zeros(2, 64, 2, 64)
    else:
        k = v = torch.zeros(1, 32, 2, 64)
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v, causal=True)


def test_build_command_targets_hopper(monkeypatch, tmp_path):
    """The nvcc line builds sm_90a with a plain C interface; the library
    name follows the sources' hash; no nvcc raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: "/x/nvcc")
    cmd = _build.nvcc_command("flash_attention", tmp_path / "f.so")
    assert cmd[0] == "/x/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/flash_attention.cu")
    path = _build.library_path("flash_attention")
    assert path.parent == _build.BUILD_DIR
    assert _build.source_digest() in path.name
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").touch()
    assert _build.nvcc_path() == str(tmp_path / "bin" / "nvcc")


def _tf32(x):
    """x rounded to tf32: a 10-bit mantissa, to nearest, ties away from
    zero (on the bits: add half an ulp, clear the low 13 bits)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc_tf32(x):
    """x's top 19 bits: what the tensor cores read of an fp32 operand."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _kernel_constant(name):
    """A ``constexpr int`` of the CUDA source, as the kernel builds it."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _chunk_of(steps, c):
    """The kernel's chunk_of: the deepest count up to c dividing steps."""
    return c if steps % c == 0 else _chunk_of(steps, c - 1)


def _matmul_3xtf32(a, b, chunk, a_in_registers):
    """a @ b as the CUDA kernel computes it in fp32: each operand split
    into a big and a small tf32 part and small*big + big*small + big*big
    summed over chunks of ``chunk`` 8-deep steps (or fewer, as
    ``_chunk_of`` picks), each chunk then added to the fp32 sum. An
    operand in shared memory (b; a unless ``a_in_registers``) is read as
    its top 19 bits, with its small part x - trunc(x) rounded to tf32; one
    in registers (P) is rounded, and its rest rounded too."""
    def split(x, in_registers):
        big = _tf32(x) if in_registers else _trunc_tf32(x)
        return big, _tf32(x - big)

    (ab, as_), (bb, bs) = split(a, a_in_registers), split(b, False)
    depth = 8 * _chunk_of(a.shape[-1] // 8, chunk)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], depth):
        c = slice(k0, k0 + depth)
        out = out + (as_[..., c] @ bb[..., c, :] + ab[..., c] @ bs[..., c, :]
                     + ab[..., c] @ bb[..., c, :])
    return out


def _attention_emulated(q, k, v, qk, pv):
    """Causal attention with its products through ``qk`` and ``pv``, the
    softmax in fp32 as the plain version takes it."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[2]
    scores = qk(q, k.transpose(1, 2)) / hd ** 0.5
    mask = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
    w = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return pv(w, v)


@pytest.mark.parametrize("hd", [128, 112])
@pytest.mark.parametrize("q_scale", [1, 8])
def test_3xtf32_scheme_meets_fp32_tolerance(q_scale, hd):
    """The kernel's fp32 route (3xTF32 on wgmma, with the source's chunk
    depths F32_QK_CHUNK and F32_PV_CHUNK; P V's chunks run over the keys,
    here over 32 at a time, a tile at hd 112 and 128), emulated in plain
    torch at a cut of the qwen2-moe-a2.7b (hd 128) and zamba2-7b (hd 112,
    14 steps of 8) prefills (B=1, S=200, H=2), holds 2e-5 against the
    reference package's oracle; with q scaled by 8 (logits x8, a peaked
    softmax) as well. Plain TF32, the big parts alone, misses by more than
    ten times the tolerance."""
    rng = np.random.default_rng(14)
    q, k, v = (rng.standard_normal((2, 200, hd)).astype(np.float32)
               for _ in range(3))
    q *= q_scale
    want = _np(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    qk_chunk = _kernel_constant("F32_QK_CHUNK")
    pv_chunk = _kernel_constant("F32_PV_CHUNK")

    def pv(w, v):   # over key tiles of 32, zero-padded to whole tiles
        pad = -w.shape[-1] % 32
        wp = torch.nn.functional.pad(w, (0, pad))
        vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
        return sum(_matmul_3xtf32(wp[..., t:t + 32], vp[:, t:t + 32],
                                  pv_chunk, True)
                   for t in range(0, wp.shape[-1], 32))

    got = _attention_emulated(
        tq, tk, tv, lambda a, b: _matmul_3xtf32(a, b, qk_chunk, False), pv)
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)
    tf32_only = _attention_emulated(tq, tk, tv,
                                    lambda a, b: _tf32(a) @ _tf32(b),
                                    lambda a, b: _tf32(a) @ _tf32(b))
    assert np.abs(_np(tf32_only) - want).max() > 10 * 2e-5


def test_flash_attention_variant_follows_dtype():
    """The wrapper's variant is a function of head dim and dtype alone:
    3xTF32 flash_wgmma for fp32, the bf16 one for bf16; other head dims
    and dtypes have none. A CPU call launches none."""
    for hd in fa.HEAD_DIMS:
        assert fa.variant(hd, torch.float32) == "flash_wgmma_3xtf32"
        assert fa.variant(hd, torch.bfloat16) == "flash_wgmma_bf16"
    assert set(fa.ROUTES) == set(fa.route_launches)
    for hd, dtype in ((96, torch.float32), (64, torch.float16)):
        with pytest.raises(ValueError):
            fa.variant(hd, dtype)
    _, (tq, tk, tv) = _inputs(5, (1, 64, 2, 64), (1, 64, 1, 64), "float32")
    before = dict(fa.route_launches)
    tops.flash_attention(tq, tk, tv)
    assert fa.route_launches == before
