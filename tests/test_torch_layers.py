"""Parity of the port's configs and model layers with the reference
package's, on the CPU, from the same numpy inputs and the same weights
(the reference's init, converted). fp32 at 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SMOKES as J_SMOKES
from repro.models import layers as JL
from repro_torch.configs import ARCHS, SMOKES, get_arch
from repro_torch.convert import load_
from repro_torch.kernels import ref as TR
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
    got = TR.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(TR.rope_freqs(hd, theta)),
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


# ---------------------------------------------------------------- K3's chain
def _chain_of_layers(q, k, v, pos, hd, theta, bias, norms, eps, cache,
                     index):
    """The q/k/v epilogue composed as ``_project_qkv`` and
    ``attention_apply`` composed it before K3: bias, reshape, ``rmsnorm``
    per head, ``apply_rope``, then the cache write."""
    B, S = q.shape[:2]
    if bias is not None:
        q, k, v = (t + b.to(q.dtype) for t, b in zip((q, k, v), bias))
    q, k, v = (t.reshape(B, S, t.shape[-1] // hd, hd) for t in (q, k, v))
    if norms is not None:
        mods = [TL.RMSNorm(hd, device="cpu") for _ in norms]
        with torch.no_grad():
            for m, s in zip(mods, norms):
                m.scale.copy_(s)
        q, k = TL.rmsnorm(mods[0], q, eps), TL.rmsnorm(mods[1], k, eps)
    q, k = TR.apply_rope(q, pos, theta), TR.apply_rope(k, pos, theta)
    if cache is not None:
        for c, t in zip(cache, (k, v)):
            if index is not None and S == 1:
                c[:, index:index + 1] = t.to(c.dtype)
            else:
                c[:, :S] = t.to(c.dtype)
    return q, k, v


def _qkv_case(hd, H, Hkv, B, S, dtype, bias, qk_norm, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dtype)

    q, k, v = r(B, S, H * hd, scale=3.0), r(B, S, Hkv * hd), r(B, S, Hkv * hd)
    b = (r(H * hd), r(Hkv * hd), r(Hkv * hd)) if bias else None
    n = (1 + r(hd, scale=0.2), 1 + r(hd, scale=0.2)) if qk_norm else None
    return q, k, v, b, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "prefill+cache", "decode+cache",
                                  "positions (S,)"])
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_qkv_rope_ref_is_the_chain_of_rmsnorm_and_rope(bias, qk_norm, hd,
                                                       mode, dtype):
    """``ref.qkv_rope_ref``, K3's plain version, is bit for bit the chain
    the model ran before it: with and without bias and qk-norm, at the
    served head dims, prefill and decode positions, writing the cache."""
    dt = getattr(torch, dtype)
    B, H, Hkv, T, theta = 2, 4, 2, 40, 1e6
    S, index = (1, 33) if mode.startswith("decode") else (9, None)
    q, k, v, b, n = _qkv_case(hd, H, Hkv, B, S, dt, bias, qk_norm)
    if mode == "positions (S,)":
        pos = torch.arange(S, dtype=torch.int32) + 5
    elif index is None:
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    else:
        pos = torch.full((B, 1), index, dtype=torch.int32)
    caches = []
    if mode.endswith("cache"):
        caches = [tuple(torch.full((B, T, Hkv, hd), 7.0) for _ in "kv")
                  for _ in range(2)]
    got = TR.qkv_rope_ref(q, k, v, pos, hd, theta, *(b or (None,) * 3),
                            *(n or (None,) * 2), 1e-6,
                            caches[0] if caches else None, index)
    want = _chain_of_layers(q, k, v, pos, hd, theta, b, n, 1e-6,
                            caches[1] if caches else None, index)
    for x, y in zip(got, want):
        assert x.dtype == dt and torch.equal(x, y)
    if caches:
        for x, y in zip(*caches):
            assert torch.equal(x, y)
        rows = torch.zeros(T, dtype=torch.bool)
        rows[slice(index, index + 1) if index is not None else slice(0, S)] = 1
        assert (caches[0][0][:, ~rows] == 7.0).all()   # no other row


@pytest.mark.parametrize("cache", [False, True])
def test_qkv_rope_wrapper_runs_the_plain_chain_on_cpu(cache):
    """``kops.qkv_rope`` on CPU tensors is ``ref.qkv_rope_ref`` and
    launches nothing."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import qkv_rope as k3

    q, k, v, b, n = _qkv_case(64, 4, 2, 2, 5, torch.bfloat16, True, True)
    pos = torch.arange(5, dtype=torch.int32)[None].expand(2, 5)
    cs = [tuple(torch.zeros(2, 8, 2, 64) for _ in "kv") if cache else None
          for _ in range(2)]
    before = k3.launches
    got = kops.qkv_rope(q, k, v, pos, 64, 1e4, *b, *n, 1e-6, cs[0])
    want = TR.qkv_rope_ref(q, k, v, pos, 64, 1e4, *b, *n, 1e-6, cs[1])
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    if cache:
        assert all(torch.equal(x, y) for x, y in zip(cs[0], cs[1]))
    assert k3.launches == before


@pytest.mark.parametrize("reason", ["not cuda", "grad", "dtensor"])
def test_qkv_route_takes_the_plain_chain(reason, monkeypatch):
    """``kops.qkv_rope`` runs K3 only on plain CUDA tensors that need no
    gradient (``qkv_rope.plain_reason``): CPU tensors, inputs that need a
    gradient and DTensors take the plain chain, which writes the cache
    inside the ``attn.qkv`` span."""
    from repro_torch import obs
    from repro_torch.kernels import qkv_rope as k3

    if reason == "dtensor":
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.launch.mesh import process_group

        with process_group("gloo"):
            mesh = init_device_mesh("cpu", (1,))
            x = distribute_tensor(torch.zeros(2, 3, 8), mesh)
            assert k3.plain_reason(x, torch.zeros(3)) == "dtensor"
        return

    def kernel(*a, **kw):
        raise AssertionError("the kernel route was taken")

    monkeypatch.setattr(k3, "_launch", kernel)
    cfg = _cfg(qkv_bias=True, qk_norm=True)
    _, tp = _attn_pair(cfg, seed=2)
    B, S, T = 2, 6, 10
    x = torch.from_numpy(_rand(3, B, S, cfg.d_model))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    cache = tuple(torch.zeros(B, T, cfg.n_kv_heads, cfg.d_head)
                  for _ in "kv")
    if reason == "grad":
        x.requires_grad_(True)
    with torch.set_grad_enabled(reason == "grad"):
        assert k3.plain_reason(x, tp.wq, *cache) == reason
    rec = obs.Recorder()
    monkeypatch.setattr(obs, "RECORDER", rec)
    with torch.set_grad_enabled(reason == "grad"), profile(
            activities=[ProfilerActivity.CPU]):
        out, _ = TL.attention_apply(tp, cfg, x, pos, cache=cache)
    assert (out.grad_fn is not None) == (reason == "grad")
    assert [s.name for s in rec.spans] == ["attn.qkv", "attn.core"]
    assert cache[0][:, :S].abs().sum() > 0 and (cache[0][:, S:] == 0).all()


@pytest.mark.parametrize("bad", ["rank", "batch", "width", "positions",
                                 "bias shape", "cache shape"])
def test_qkv_rope_rejects_what_the_kernel_cannot_take(bad):
    """The wrapper's checks of the shapes behind the ints the kernel's C
    entry gets, run before any launch (here on CPU tensors, which never
    reach the kernel otherwise)."""
    from repro_torch.kernels import qkv_rope as k3

    B, S, H, Hkv, hd = 2, 3, 4, 2, 64
    q, k = torch.zeros(B, S, H * hd), torch.zeros(B, S, Hkv * hd)
    pos = torch.zeros(B, S, dtype=torch.int32)
    bias, norms, cache = (None,) * 3, (None,) * 2, None
    if bad == "rank":
        q = q[None]
    elif bad == "batch":
        k = torch.zeros(B + 1, S, Hkv * hd)
    elif bad == "width":
        k = torch.zeros(B, S, 100)
    elif bad == "positions":
        pos = pos.float()
    elif bad == "bias shape":
        bias = (torch.zeros(H * hd), torch.zeros(hd), torch.zeros(Hkv * hd))
    else:
        cache = (torch.zeros(B, 8, H, hd), torch.zeros(B, 8, H, hd))
    with pytest.raises(ValueError):
        k3._check(q, k, k, pos, hd, bias, norms, cache)


def test_qkv_rope_builds_its_frequency_table_once():
    from repro_torch.kernels import qkv_rope as k3

    dev = torch.device("cpu")
    t = k3.freq_table(112, 1e6, dev)
    assert k3.freq_table(112, 1e6, dev) is t
    assert torch.equal(t, TR.rope_freqs(112, 1e6, dev))
