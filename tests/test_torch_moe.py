"""The port's moe family against the reference package's, on the CPU.

Same numpy inputs and the same weights (the reference's init,
converted): the grouped-matmul entry point (kernel K2's plain version
on CPU tensors) against the reference's Pallas kernel in interpret mode
and its oracle; ``moe_apply`` (output and aux loss) with and without
token drops; and the moe smoke engine's logits and greedy tokens. The
CUDA kernel itself is tested on the card in ``test_torch_gpu.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.moe import _n_groups as j_n_groups
from repro.models.moe import capacity as j_capacity
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.moe import moe_init as j_moe_init
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import build_model
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.convert import load_, params_from_jax
from repro_torch.kernels import _build
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

ARCH = "qwen2-moe-a2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _gmm_inputs(shape, dtype, seed=0):
    """x ~ N(0, 1) and w ~ N(0, 1/d), the scale of the model's expert
    weights, as numpy, and both frameworks' copies in ``dtype``."""
    E, C, d, f = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) / math.sqrt(d)).astype(np.float32)
    return ((jnp.asarray(x, JDT[dtype]), jnp.asarray(w, JDT[dtype])),
            (torch.from_numpy(x).to(TDT[dtype]),
             torch.from_numpy(w).to(TDT[dtype])))


# ----------------------------------------------------------------------
# K2's entry point and plain version
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (4, 128, 256, 128),
    (2, 64, 512, 96),     # ragged f
    (6, 100, 300, 130),   # ragged everywhere
    (1, 1, 1, 1),
])
def test_grouped_matmul_matches_reference(shape, dtype):
    (jx, jw), (tx, tw) = _gmm_inputs(shape, dtype)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)
    want_kernel = _np(jops.grouped_matmul(jx, jw))   # Pallas, interpret
    want_ref = _np(jref.grouped_matmul_ref(jx, jw))
    for out in (tops.grouped_matmul(tx, tw), tref.grouped_matmul_ref(tx, tw)):
        assert out.dtype == TDT[dtype]
        assert out.shape == (shape[0], shape[1], shape[3])
        np.testing.assert_allclose(_np(out), want_kernel, **tol)
        np.testing.assert_allclose(_np(out), want_ref, **tol)


def test_grouped_matmul_cpu_path_never_launches():
    _, (x, w) = _gmm_inputs((2, 8, 16, 8), "float32")
    before = gm.launches
    tops.grouped_matmul(x, w)
    assert gm.launches == before


@pytest.mark.parametrize("bad", ["rank", "experts", "depth"])
def test_grouped_matmul_rejects_bad_shapes(bad):
    x, w = torch.zeros(2, 8, 16), torch.zeros(2, 16, 4)
    if bad == "rank":
        x = x[0]
    elif bad == "experts":
        w = torch.zeros(3, 16, 4)
    else:
        w = torch.zeros(2, 12, 4)
    with pytest.raises(ValueError):
        tops.grouped_matmul(x, w)


def test_grouped_matmul_off_the_cpu_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel's checks, which
    refuse anything but one CUDA device; nothing drops to the plain
    version."""
    x, w = torch.zeros(2, 8, 16), torch.zeros(2, 16, 4, device="meta")
    before = gm.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        tops.grouped_matmul(x, w)
    assert gm.launches == before


def test_build_command_covers_grouped_matmul(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: "/x/nvcc")
    cmd = _build.nvcc_command("grouped_matmul", tmp_path / "g.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/grouped_matmul.cu")
    assert set(_build.SIGNATURES) == {"flash_attention", "grouped_matmul"}
    assert _build.library_path("grouped_matmul").parent == _build.BUILD_DIR


# ----------------------------------------------------------------------
# moe_apply
@pytest.fixture(scope="module")
def moe_pair():
    jp = j_moe_init(J_SMOKES[ARCH], jax.random.PRNGKey(0))
    return jp, load_(TM.MoE(SMOKES[ARCH], device="cpu"),
                     jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("B,S,factor", [
    (2, 16, 1.25),    # dropless: Tg = 16 <= 128
    (2, 160, 1.25),   # Tg = 160 > 128: capacity from the factor
    (2, 160, 0.25),   # forced drops
])
def test_moe_apply_matches_reference(moe_pair, B, S, factor):
    jp, tp = moe_pair
    cfg = SMOKES[ARCH]
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jy, jaux = j_moe_apply(jp, J_SMOKES[ARCH], jnp.asarray(x),
                           capacity_factor=factor)
    ty, taux = TM.moe_apply(tp, cfg, torch.from_numpy(x),
                            capacity_factor=factor)
    assert ty.shape == x.shape and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    if factor < 1:
        # drops did happen: the output differs from a dropless run
        roomy, _ = TM.moe_apply(tp, cfg, torch.from_numpy(x),
                                capacity_factor=100.0)
        assert not torch.allclose(ty, roomy, **TOL)


def test_moe_experts_run_through_grouped_matmul(moe_pair, monkeypatch):
    """The three expert GEMMs go through the kernel's entry point, on
    the expert-major (E, G*C, .) buffers."""
    _, tp = moe_pair
    cfg = SMOKES[ARCH]
    calls = []
    real = tops.grouped_matmul

    def counting(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    monkeypatch.setattr(tops, "grouped_matmul", counting)
    B, S = 4, 1   # decode at B = 4: G = 4, Tg = 1, C = 8
    TM.moe_apply(tp, cfg, torch.zeros(B, S, cfg.d_model))
    E, d, d_e = cfg.n_experts, cfg.d_model, cfg.d_expert
    assert calls == [((E, 32, d), (E, d, d_e)), ((E, 32, d), (E, d, d_e)),
                     ((E, 32, d_e), (E, d_e, d))]


def test_capacity_and_groups_are_the_reference_s():
    for B in (1, 2, 3, 4, 6, 8, 96, 128, 192):
        assert TM._n_groups(B) == j_n_groups(B)
    for cfg in (SMOKES[ARCH], ARCHS[ARCH]):
        for n in (1, 16, 128, 129, 500, 4096):
            for f in (0.25, 1.0, 1.25):
                assert TM.capacity(cfg, n, f) == j_capacity(cfg, n, f)
    # the serving shapes of the full-width config: prefill 4 x 500, decode
    assert TM.capacity(ARCHS[ARCH], 500) == 48
    assert TM.capacity(ARCHS[ARCH], 1) == 8


@pytest.mark.parametrize("B,S", [(4, 1), (2, 16), (3, 10)])
def test_topk_gap_matches_reference_routing(moe_pair, B, S):
    """topk_gap reads the router probabilities over the reference's
    routing groups: the gap between the k-th and (k+1)-th of them."""
    jp, tp = moe_pair
    cfg = SMOKES[ARCH]
    x = np.random.default_rng(B + S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    G, k = j_n_groups(B), cfg.n_experts_per_tok
    logits = jnp.asarray(x).reshape(G, B * S // G, -1) @ jp["router"]
    top = np.sort(np.asarray(jax.nn.softmax(logits.astype(jnp.float32))),
                  axis=-1)[..., ::-1]
    want = float((top[..., k - 1] - top[..., k]).min())
    assert TM.topk_gap(tp, cfg, torch.from_numpy(x)) == pytest.approx(
        want, abs=1e-6)


# ----------------------------------------------------------------------
# the moe smoke engine
@pytest.fixture(scope="module")
def engines():
    j = JServeEngine(J_SMOKES[ARCH], max_seq=192)
    p = params_from_jax(SMOKES[ARCH], jax.tree.map(np.asarray, j.params),
                        device="cpu")
    return j, ServeEngine(SMOKES[ARCH], params=p, max_seq=192, device="cpu")


def _prompt(seed, B=2, S=16):
    return np.random.default_rng(seed).integers(
        0, SMOKES[ARCH].vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("B,S", [(2, 20), (1, 150)])
def test_prefill_and_decode_logits_match(engines, B, S):
    j, t = engines
    prompt = _prompt(0, B, S)
    j_logits, j_cache = j.model.prefill(j.params, {"tokens": prompt},
                                        j.model.init_cache(B, 192))
    t_cache = t.model.init_cache(B, 192, device="cpu")
    t_logits, t_cache = t.model.prefill(
        t.params, {"tokens": torch.from_numpy(prompt).long()}, t_cache)
    assert t_logits.shape == (B, S, SMOKES[ARCH].vocab_size)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)
    for a, b in zip(t_cache, j_cache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    nxt = np.asarray(jnp.argmax(j_logits[:, -1:], -1), np.int32)
    for i in range(4):
        j_logits, j_cache = j.model.decode_step(
            j.params, j_cache, {"tokens": nxt, "cache_index": S + i})
        t_logits, t_cache = t.model.decode_step(
            t.params, t_cache,
            {"tokens": torch.tensor(nxt, dtype=torch.long),
             "cache_index": S + i})
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   **TOL)
        nxt = np.asarray(jnp.argmax(j_logits, -1), np.int32)


@pytest.mark.parametrize("seed,B,S,n_new", [(1, 2, 16, 8), (2, 1, 150, 6),
                                             (3, 3, 5, 12)])
def test_greedy_tokens_identical(engines, seed, B, S, n_new):
    j, t = engines
    prompt = _prompt(seed, B, S)
    want = j.generate(prompt, n_new=n_new).tokens
    got = t.generate(prompt, n_new=n_new)
    assert got.tokens.shape == (B, n_new)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.tokens_per_s == pytest.approx(B * n_new / got.decode_s)


# ----------------------------------------------------------------------
# params and init
def test_moe_param_count():
    cfg = SMOKES[ARCH]
    p = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert sum(x.numel() for x in p.parameters()) == cfg.param_count()
    names = {n for n, _ in p.named_parameters()}
    for leaf in ("router", "w_gate", "w_up", "w_down", "shared.w_gate",
                 "shared.w_up", "shared.w_down"):
        assert f"layers.1.moe.{leaf}" in names
    assert not any(".mlp." in n for n in names)
    # the full-width config is the published one, counted on the meta
    # device (no memory)
    c = ARCHS[ARCH]
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_head,
            c.n_experts, c.n_experts_per_tok, c.n_shared_experts,
            c.d_expert, c.vocab_size) == (24, 2048, 16, 16, 128, 60, 4, 4,
                                          1408, 151936)
    assert c.qkv_bias and not c.tie_embeddings
    full = T.Transformer(c, device="meta")
    n_full = sum(x.numel() for x in full.parameters())
    assert n_full == ARCHS[ARCH].param_count() == 14_315_735_040


def test_moe_init_scales():
    cfg = SMOKES[ARCH]
    blk = build_model(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu").layers[0].moe
    d, d_e = cfg.d_model, cfg.d_expert
    assert float(blk.w_gate.std()) == pytest.approx(1 / math.sqrt(d), rel=0.05)
    assert float(blk.w_down.std()) == pytest.approx(1 / math.sqrt(d_e),
                                                    rel=0.05)
    assert float(blk.router.std()) == pytest.approx(1 / math.sqrt(d), rel=0.1)


@pytest.mark.parametrize("shape", [(5, 7), (3, 5, 7)])
def test_dense_init_cpu_draw_unchanged(shape):
    """Drawing on the generator's own device changes no CPU draw: the
    weights are exactly randn(shape) / sqrt(d_in)."""
    w = torch.empty(shape)
    TL.dense_init_(w, torch.Generator().manual_seed(3))
    want = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(w, want / math.sqrt(shape[-2]))
