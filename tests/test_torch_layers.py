"""Parity of the port's configs and model layers with the reference
package's, on the CPU, from the same numpy inputs and the same weights
(the reference's init, converted). fp32 at 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SMOKES as J_SMOKES
from repro.models import layers as JL
from repro_torch.configs import ARCHS, SMOKES, get_arch
from repro_torch.convert import load_
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfg(**kw):
    return SMOKES["qwen2-0.5b"].replace(**kw)


def _attn_pair(cfg, seed=0):
    """Reference attention params and the port's module holding them.
    (The reference functions read the config's fields only, so they take
    the port's copy.)"""
    p = JL.attention_init(cfg, jax.random.PRNGKey(seed))
    # non-zero biases and norm scales, so that a dropped term shows
    rng = np.random.default_rng(seed + 1)
    p = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(
        np.float32) if a.ndim == 1 else a, p)
    return p, load_(TL.Attention(cfg, device="cpu"), p)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("table", ["arch", "smoke"])
def test_config_copy_matches_reference(table):
    """The port's own ModelConfig copy agrees field for field."""
    mine, ref = (ARCHS, J_ARCHS) if table == "arch" else (SMOKES, J_SMOKES)
    assert list(mine) == list(ref)
    for arch_id, cfg in mine.items():
        want = ref[arch_id]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert (cfg.d_q, cfg.d_kv, cfg.vocab_padded) == \
            (want.d_q, want.d_kv, want.vocab_padded)
        assert cfg.param_count() == want.param_count()
    assert get_arch("qwen2-0.5b", smoke=table == "smoke") is \
        mine["qwen2-0.5b"]


def test_full_width_qwen2_is_the_published_config():
    c = ARCHS["qwen2-0.5b"]
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_head,
            c.d_ff, c.vocab_size) == (24, 896, 14, 2, 64, 4864, 151936)
    assert c.qkv_bias and c.tie_embeddings
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", dict(rtol=1e-2, atol=1e-2))])
def test_rmsnorm(dtype, tol):
    x = _rand(0, 2, 5, 64) * 3.0
    scale = 1.0 + 0.1 * _rand(1, 64)
    want = JL.rmsnorm({"scale": jnp.asarray(scale, dtype)},
                      jnp.asarray(x, dtype), 1e-6)
    p = TL.RMSNorm(64, device="cpu")
    with torch.no_grad():
        p.scale.copy_(torch.from_numpy(scale))
    got = TL.rmsnorm(p, torch.from_numpy(x).to(getattr(torch, dtype)), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("hd,theta", [(16, 1e6), (64, 1e4), (128, 1e6)])
@pytest.mark.parametrize("pos_rank", [1, 2])
def test_apply_rope(hd, theta, pos_rank):
    x = _rand(2, 2, 9, 3, hd)
    pos = np.arange(9, dtype=np.int32) + 5
    if pos_rank == 2:
        pos = np.stack([pos, pos + 40])
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(TL.rope_freqs(hd, theta)),
                               _np(JL.rope_freqs(hd, theta)), rtol=1e-6)


ATTN_CFGS = {
    "bias": dict(qkv_bias=True),
    "bias+qknorm": dict(qkv_bias=True, qk_norm=True),
    "plain": dict(qkv_bias=False),
}


@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
def test_attention_prefill_fills_cache(name):
    cfg = _cfg(**ATTN_CFGS[name])
    jp, tp = _attn_pair(cfg)
    B, S, T = 2, 12, 20
    x = _rand(3, B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    shape = (B, T, cfg.n_kv_heads, cfg.d_head)
    j_cache = (jnp.zeros(shape), jnp.zeros(shape))
    want, (jk, jv) = JL.attention_apply(jp, cfg, jnp.asarray(x),
                                        jnp.asarray(pos), cache=j_cache)
    t_cache = (torch.zeros(shape), torch.zeros(shape))
    got, (tk, tv) = TL.attention_apply(tp, cfg, torch.from_numpy(x),
                                       torch.from_numpy(pos), cache=t_cache)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)
    assert tk is t_cache[0]          # written in place
    # no cache: same output, no cache returned
    got2, none = TL.attention_apply(tp, cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos))
    assert none is None
    np.testing.assert_allclose(_np(got2), _np(want), **TOL)


@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
@pytest.mark.parametrize("index", [0, 7, 19])
def test_attention_decode_step(name, index):
    cfg = _cfg(**ATTN_CFGS[name])
    jp, tp = _attn_pair(cfg, seed=4)
    B, T = 2, 20
    shape = (B, T, cfg.n_kv_heads, cfg.d_head)
    kc, vc = _rand(5, *shape), _rand(6, *shape)
    x = _rand(7, B, 1, cfg.d_model)
    pos = np.full((B, 1), index, np.int32)
    want, (jk, jv) = JL.attention_apply(
        jp, cfg, jnp.asarray(x), jnp.asarray(pos),
        cache=(jnp.asarray(kc), jnp.asarray(vc)),
        cache_index=jnp.asarray(index, jnp.int32))
    got, (tk, tv) = TL.attention_apply(
        tp, cfg, torch.from_numpy(x), torch.from_numpy(pos),
        cache=(torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())),
        cache_index=index)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)


@pytest.mark.parametrize("S", [128, 160])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_matches_reference_pallas_path(S, qk_norm):
    """The reference's flash path (use_flash="pallas", S >= 128, kernel
    in interpret mode) against the port's, which always takes its
    kernel entry point for full-sequence causal attention."""
    cfg = _cfg(d_model=128, n_heads=4, n_kv_heads=2, qkv_bias=True,
               qk_norm=qk_norm)
    jp, tp = _attn_pair(cfg, seed=8)
    x = _rand(9, 1, S, cfg.d_model)
    pos = np.arange(S, dtype=np.int32)[None]
    want, _ = JL.attention_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                 use_flash="pallas")
    got, _ = TL.attention_apply(tp, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_attention_non_causal_uses_sdpa():
    cfg = _cfg()
    jp, tp = _attn_pair(cfg, seed=10)
    x = _rand(11, 2, 10, cfg.d_model)
    pos = np.arange(10, dtype=np.int32)
    want, _ = JL.attention_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                 causal=False)
    got, _ = TL.attention_apply(tp, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos), causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    cfg = _cfg(mlp_gated=gated)
    jp = JL.mlp_init(cfg, jax.random.PRNGKey(12))
    tp = load_(TL.MLP(cfg, device="cpu"), jp)
    x = _rand(13, 2, 7, cfg.d_model)
    np.testing.assert_allclose(
        _np(TL.mlp_apply(tp, cfg, torch.from_numpy(x))),
        _np(JL.mlp_apply(jp, cfg, jnp.asarray(x))), **TOL)


def test_sdpa_masked_rows():
    """The decode mask fill is -1e30 (finite), as in the reference."""
    q, k, v = _rand(14, 1, 1, 4, 16), _rand(15, 1, 6, 2, 16), \
        _rand(16, 1, 6, 2, 16)
    mask = np.arange(6) <= 2
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask)[None, None, None, None])
    got = TL._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_load_rejects_mismatched_tree():
    cfg = _cfg()
    jp, _ = _attn_pair(cfg)
    with pytest.raises(ValueError, match="no counterpart"):
        load_(TL.Attention(cfg, device="cpu"),
              dict(jp, extra=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        load_(TL.Attention(cfg, device="cpu"),
              dict(jp, wq=np.zeros((3, 3), np.float32)))
