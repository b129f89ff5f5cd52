"""Parity of the port's flash-attention entry point with the reference
package's, on the CPU.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` runs the
kernel's plain version; it is held against the reference's Pallas
kernel (interpret mode) and its oracle on the same numpy inputs. The
CUDA kernel itself is tested on the card in ``test_torch_gpu.py``; its
fp32 arithmetic (3xTF32 on the tensor cores) is emulated here in plain
torch and held to the oracle too.
"""
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


def _matmul_3xtf32(a, b):
    """a @ b as the CUDA kernel computes it in fp32: each operand split
    into big = tf32(x) and small = x - big, which the tensor cores
    truncate to tf32; small*big + big*small + big*big summed in fp32 over
    16-deep chunks, each chunk then added to the fp32 accumulator."""
    def split(x):
        big = _tf32(x)
        small = (x - big).view(torch.int32) & ~0x1FFF
        return big, small.view(torch.float32)

    (ab, as_), (bb, bs) = split(a), split(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 16):
        c = slice(k0, k0 + 16)
        out = out + (as_[..., c] @ bb[..., c, :] + ab[..., c] @ bs[..., c, :]
                     + ab[..., c] @ bb[..., c, :])
    return out


def _attention_emulated(q, k, v, matmul):
    """Causal attention with both products through ``matmul``, the
    softmax in fp32 as the plain version takes it."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[2]
    scores = matmul(q, k.transpose(1, 2)) / hd ** 0.5
    mask = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
    w = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return matmul(w, v)


@pytest.mark.parametrize("q_scale", [1, 8])
def test_3xtf32_scheme_meets_fp32_tolerance(q_scale):
    """The kernel's fp32 route (3xTF32 on the tensor cores), emulated in
    plain torch at a cut of the qwen2-moe-a2.7b prefill (B=1, S=200,
    H=2, hd=128), holds 2e-5 against the reference package's oracle; with
    q scaled by 8 (logits x8, a peaked softmax) as well. Plain TF32, the
    big parts alone, misses by more than ten times the tolerance."""
    rng = np.random.default_rng(14)
    q, k, v = (rng.standard_normal((2, 200, 128)).astype(np.float32)
               for _ in range(3))
    q *= q_scale
    want = _np(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = _attention_emulated(tq, tk, tv, _matmul_3xtf32)
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)
    tf32_only = _attention_emulated(tq, tk, tv,
                                    lambda a, b: _tf32(a) @ _tf32(b))
    assert np.abs(_np(tf32_only) - want).max() > 10 * 2e-5
