"""The families the port serves besides dense and moe (the xLSTM and
Zamba2 stacks, the vlm and audio transformers) and the serving engine
of every smoke config, against the reference package on the CPU, from
the reference's init converted. Logits agree to 1e-5 in fp32 and greedy
tokens exactly.

vlm: the reference engine decodes at ``S + i`` although its prefill
filled ``n_patches + S`` positions; the port's engine decodes at
``n_patches + S + i``, as the reference model's own test does. So the
port's vlm engine is held to the reference model driven at those
positions, and a test records the reference engine's difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.models import stacks as j_stacks
from repro.models.registry import build_model as j_build_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import build_model
from repro_torch.configs import SMOKES
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.models import stacks
from repro_torch.serve.engine import ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
# Zamba2's prefill sums its chunked SSD's 32 x 32 decay-weighted products
# in another order than XLA (tests/test_torch_ssm.py): 8 of 40960 prefill
# logits miss 1e-5, by 1.7e-5 at most (max |Δ| 3.5e-5 on logits up to
# 5), so Zamba2's prefill is held to the reference's own 2e-4
# (test_models.py, test_decode_matches_prefill).
SSD_TOL = dict(rtol=2e-4, atol=2e-4)


def _pair(arch, seed=0):
    """The reference model and params, the port's model and the same
    params converted."""
    jm = j_build_model(J_SMOKES[arch], remat=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(SMOKES[arch], jax.tree.map(np.asarray, jp),
                         device="cpu")
    return jm, jp, build_model(SMOKES[arch]), tp


def _tokens(arch, seed, B, S):
    cfg = SMOKES[arch]
    shape = (B, cfg.n_codebooks, S) if cfg.family == "audio" else (B, S)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def _close_tree(got, want, **tol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close_tree(got[k], want[k], **tol)
    elif isinstance(want, tuple):
        for g, w in zip(got, want):
            _close_tree(g, w, **tol)
    else:
        _close(got, want, **tol)


# ----------------------------------------------------------------------
# Prefill into a cache/state, then decode steps: logits, and the state
# after each. S = 40 is past the smoke Zamba2's SSD chunk of 32, so its
# chunk loop pads. vlm with random patch embeddings.
FORWARD_ARCHS = ["xlstm-350m", "zamba2-7b", "internvl2-1b", "musicgen-large"]


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    cfg = SMOKES[arch]
    jm, jp, tm, tp = _pair(arch)
    B, S = 2, 40
    toks = _tokens(arch, 1, B, S + 3)
    batch = {"tokens": toks[..., :S]}
    tbatch = {"tokens": torch.from_numpy(toks[..., :S]).long()}
    n_prefix = 0
    if cfg.family == "vlm":
        pe = np.random.default_rng(2).standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        batch["patch_embeds"], tbatch["patch_embeds"] = pe, torch.from_numpy(pe)
        n_prefix = cfg.n_patches
    j_st = jm.init_cache(B, 64)
    t_st = tm.init_cache(B, 64, device="cpu")
    j_lg, j_st = jm.prefill(jp, batch, j_st)
    t_lg, t_st = tm.prefill(tp, tbatch, t_st)
    want_shape = ((B, n_prefix + S, cfg.n_codebooks, cfg.vocab_size)
                  if cfg.family == "audio" else (B, n_prefix + S,
                                                 cfg.vocab_size))
    assert t_lg.shape == want_shape
    tol = SSD_TOL if arch == "zamba2-7b" else TOL
    _close(t_lg, j_lg, **tol)
    _close_tree(t_st, j_st, **tol)
    for i in range(3):
        nxt = toks[..., S + i:S + i + 1]
        idx = n_prefix + S + i
        j_lg, j_st = jm.decode_step(jp, j_st, {"tokens": nxt,
                                               "cache_index": idx})
        t_lg, t_st = tm.decode_step(
            tp, t_st, {"tokens": torch.from_numpy(nxt).long(),
                       "cache_index": idx})
        _close(t_lg, j_lg, **tol)
    _close_tree(t_st, j_st, **tol)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_stack_forward_without_state_matches_reference(arch):
    """The stateless forward (training's path in the reference)."""
    _, jp, _, tp = _pair(arch, seed=3)
    toks = _tokens(arch, 4, 2, 37)
    name = {"xlstm-350m": "xlstm_forward", "zamba2-7b": "zamba2_forward"}[arch]
    want, _, _ = getattr(j_stacks, name)(J_SMOKES[arch], jp, jnp.asarray(toks))
    got, st = getattr(stacks, name)(SMOKES[arch], tp,
                                    torch.from_numpy(toks).long())
    assert st is None
    _close(got, want)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_decode_from_converted_state(arch):
    """A state filled by the reference continues in the port."""
    jm, jp, tm, tp = _pair(arch, seed=5)
    toks = _tokens(arch, 6, 2, 21)
    j_lg, j_st = jm.prefill(jp, {"tokens": toks[:, :20]},
                            jm.init_cache(2, 32))
    step = {"tokens": toks[:, 20:], "cache_index": 20}
    want, _ = jm.decode_step(jp, j_st, step)
    got, _ = tm.decode_step(tp, state_from_jax(j_st, "cpu"),
                            dict(step, tokens=torch.from_numpy(toks[:, 20:])
                                 .long()))
    _close(got, want)


def test_zamba2_shares_one_attention_block():
    """One shared block, applied after every hybrid_attn_every-th Mamba2
    layer, each application with its own KV cache."""
    cfg = SMOKES["zamba2-7b"]
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert stacks.n_attn_applications(cfg) == 2
    assert stacks.n_attn_applications(
        cfg.replace(n_layers=81, hybrid_attn_every=6)) == 13
    st = tm.init_cache(2, 24, device="cpu")
    assert st["kv_k"].shape == (2, 2, 24, cfg.n_kv_heads, cfg.d_head)
    toks = torch.from_numpy(_tokens("zamba2-7b", 7, 2, 10)).long()
    tm.prefill(tp, {"tokens": toks}, st)
    # both applications wrote their first 10 positions, differently
    assert bool(st["kv_k"][:, :, :10].abs().sum(-1).gt(0).all())
    assert not bool(st["kv_k"][:, :, 10:].any())
    assert not torch.equal(st["kv_k"][0], st["kv_k"][1])


# ----------------------------------------------------------------------
# The serving engine of every smoke config but the vlm: greedy tokens
# equal the reference engine's, on the reference's weights.
ENGINE_ARCHS = sorted(a for a in SMOKES if SMOKES[a].family != "vlm")


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_matches_reference_engine(arch):
    cfg = SMOKES[arch]
    j = JServeEngine(J_SMOKES[arch], max_seq=48)
    t = ServeEngine(cfg, params=params_from_jax(
        cfg, jax.tree.map(np.asarray, j.params), device="cpu"),
        max_seq=48, device="cpu")
    B, S, n_new = 2, 19, 6
    prompt = _tokens(arch, 8, B, S)
    want = j.generate(prompt, n_new=n_new).tokens
    got = t.generate(prompt, n_new=n_new)
    shape = (B, cfg.n_codebooks, n_new) if cfg.family == "audio" \
        else (B, n_new)
    assert got.tokens.shape == shape
    np.testing.assert_array_equal(got.tokens, want)
    # tokens/s counts timesteps, not an audio step's K codebook tokens
    assert got.tokens_per_s == pytest.approx(B * n_new / got.decode_s)


def _vlm_engines():
    cfg = SMOKES["internvl2-1b"]
    j = JServeEngine(J_SMOKES["internvl2-1b"], max_seq=64)
    t = ServeEngine(cfg, params=params_from_jax(
        cfg, jax.tree.map(np.asarray, j.params), device="cpu"),
        max_seq=64, device="cpu")
    return j, t


def _reference_vlm_greedy(j, prompt, n_new):
    """The reference model's prefill/decode_step, zero patch embeddings
    as its engine gives them, decoded at n_patches + S + i."""
    cfg = j.cfg
    B, S = prompt.shape
    batch = {"tokens": jnp.asarray(prompt),
             "patch_embeds": jnp.zeros((B, cfg.n_patches, cfg.d_model))}
    logits, cache = j._prefill(j.params, batch,
                               j.model.init_cache(B, j.max_seq))
    last, outs = logits[:, -1:], []
    for i in range(n_new):
        nxt = jnp.argmax(last, -1).astype(jnp.int32)
        outs.append(np.asarray(nxt))
        last, cache = j._decode(j.params, cache, {
            "tokens": nxt,
            "cache_index": jnp.asarray(cfg.n_patches + S + i, jnp.int32)})
    return np.concatenate(outs, -1)


@pytest.mark.parametrize("seed,B,S,n_new", [(0, 2, 16, 6), (9, 3, 11, 8)])
def test_vlm_engine_decodes_after_the_patches(seed, B, S, n_new):
    j, t = _vlm_engines()
    prompt = np.random.default_rng(seed).integers(
        0, SMOKES["internvl2-1b"].vocab_size, (B, S)).astype(np.int32)
    got = t.generate(prompt, n_new=n_new).tokens
    np.testing.assert_array_equal(got, _reference_vlm_greedy(j, prompt, n_new))
    # the first token comes from the prefill, before any decode position
    np.testing.assert_array_equal(got[:, 0], j.generate(prompt, 1).tokens[:, 0])


def test_reference_vlm_engine_decodes_over_the_patches():
    """F5, recorded: the reference engine decodes at S + i, overwriting
    prefilled keys; its tokens differ from its own model decoded at
    n_patches + S + i, which the port's engine matches."""
    j, t = _vlm_engines()
    prompt = np.random.default_rng(0).integers(
        0, SMOKES["internvl2-1b"].vocab_size, (2, 16)).astype(np.int32)
    want = _reference_vlm_greedy(j, prompt, 6)
    assert not np.array_equal(j.generate(prompt, 6).tokens, want)
    np.testing.assert_array_equal(t.generate(prompt, 6).tokens, want)
    with pytest.raises(ValueError, match="max_seq"):
        t.generate(prompt[:, :10], n_new=64 - 10 - 8 + 1)  # 8 patches


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_param_count_matches_config(arch):
    """The port's modules hold exactly ``param_count()`` parameters, as
    the reference's init does (``test_models.py``)."""
    cfg = SMOKES[arch]
    p = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert sum(x.numel() for x in p.parameters()) == cfg.param_count()
