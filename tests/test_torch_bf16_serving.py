"""Serving in bf16, the port against the reference on the CPU: one
config of each family at smoke size (dense ``qwen2-0.5b``, moe, hybrid
``zamba2-7b``, ssm ``xlstm-350m``, audio ``musicgen-large`` and vlm
``internvl2-1b``), the dense ``qwen3-14b`` (qk-norm) and ``minicpm-2b``
(tied embeddings), and two narrow cuts at head layouts the card serves
(``CUTS``: qwen3-14b's GQA groups of 5 at hd 128 with qk-norm, Zamba2's
hd 112), each served by the port's ``ServeEngine`` from
``params_from_jax`` of the reference's bf16 weights, against
``ServeEngine(dtype=jnp.bfloat16)`` of the reference.

The limits follow from bf16's 8-bit mantissa, which rounds every
activation by up to 2^-9 of itself, in another order in the two
packages: the last-position prefill logits agree within ``REL`` = 2^-5
of the reference's largest |logit|, and the greedy tokens are equal up
to the first reference step whose top-2 logit margin is below ``REL`` of
that step's largest |logit| (a near-tie that rounding can flip). The
prefill logits of the six configs differ by 0.8-1.9% of their largest
|logit|; xLSTM's tokens part at a step-0 margin of 0.75% and Zamba2's at
step 7, after a margin of 2.6% at step 3.

vlm: the reference engine decodes over its patches (ROADMAP F5), so the
port's engine is held to the reference model driven after them, as
``tests/test_torch_families.py`` does in fp32.

The KV cache and the recurrent states stay fp32 in both engines whatever
the weights' dtype; decode casts the cache to the query's dtype.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import SMOKES
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import ServeEngine

# Smoke configs widened to a head layout of a full-width model, as the
# card serves it: (smoke config, fields replaced in both packages)
CUTS = {
    "qwen3-14b-gqa5-hd128": ("qwen3-14b", dict(
        d_model=640, n_heads=10, n_kv_heads=2, d_head=128, d_ff=512)),
    "zamba2-7b-hd112": ("zamba2-7b", dict(
        d_model=448, n_heads=4, n_kv_heads=4, d_head=112, d_ff=512,
        ssm_heads=14, ssm_head_dim=64)),
}
ARCHS = ["qwen2-0.5b", "qwen2-moe-a2.7b", "zamba2-7b", "xlstm-350m",
         "musicgen-large", "internvl2-1b", "qwen3-14b", "minicpm-2b",
         *CUTS]
REL = 2.0 ** -5
B, S, N_NEW, MAX_SEQ = 2, 40, 8, 64


def _configs(arch):
    """The port's config and the reference's of a case of ``ARCHS``."""
    name, fields = CUTS.get(arch, (arch, {}))
    return (SMOKES[name].replace(**fields),
            J_SMOKES[name].replace(**fields))


@functools.lru_cache(maxsize=None)
def _engines(arch):
    """The reference's bf16 engine and the port's on its weights."""
    cfg, j_cfg = _configs(arch)
    j = JServeEngine(j_cfg, max_seq=MAX_SEQ, dtype=jnp.bfloat16)
    t = ServeEngine(cfg, params=params_from_jax(
        cfg, jax.tree.map(np.asarray, j.params), device="cpu"),
        max_seq=MAX_SEQ, device="cpu")
    return j, t


def _prompt(arch, seed=0):
    cfg = _configs(arch)[0]
    K = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, *K, S)).astype(np.int32)


def _prefix_batch(cfg, tokens, zeros):
    """The prefill batch as the engines build it: a vlm's zero patch
    embeddings come first."""
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patch_embeds"] = zeros((B, cfg.n_patches, cfg.d_model))
    return batch


def _reference_trace(j, prompt):
    """The reference model's greedy run as its engine drives it, decoding
    at n_patches + S + i: the last-position prefill logits (fp32), the
    tokens, and each step's top-2 margin and largest |logit| (the least
    margin over the batch and an audio step's codebooks)."""
    cfg = j.cfg
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    batch = _prefix_batch(cfg, jnp.asarray(prompt), jnp.zeros)
    logits, cache = j._prefill(j.params, batch,
                               j.model.init_cache(B, j.max_seq))
    first = np.asarray(logits[:, -1].astype(jnp.float32))
    last, toks, margins, peaks = logits[:, -1:], [], [], []
    for i in range(N_NEW):
        lg = np.asarray(last.astype(jnp.float32))
        top2 = np.sort(lg, axis=-1)[..., -2:]
        margins.append(float((top2[..., 1] - top2[..., 0]).min()))
        peaks.append(float(np.abs(lg).max()))
        nxt = jnp.argmax(last, -1).astype(jnp.int32)     # (B,1) | (B,1,K)
        if cfg.family == "audio":
            nxt = jnp.moveaxis(nxt, -1, 1)                # (B,K,1)
        toks.append(np.asarray(nxt))
        last, cache = j._decode(j.params, cache, {
            "tokens": nxt,
            "cache_index": jnp.asarray(n_prefix + S + i, jnp.int32)})
    return first, np.concatenate(toks, -1), margins, peaks


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_engine_matches_reference_engine(arch):
    cfg = _configs(arch)[0]
    j, t = _engines(arch)
    # bf16, apart from what the reference keeps in fp32 (Mamba2's A_log,
    # D and dt_bias)
    assert {str(p.dtype).removeprefix("torch.") for p in
            t.params.parameters()} == {str(x.dtype) for x in
                                       jax.tree.leaves(j.params)}
    assert next(t.params.parameters()).dtype == torch.bfloat16
    prompt = _prompt(arch)
    first, want, margins, peaks = _reference_trace(j, prompt)
    if cfg.family != "vlm":   # F5: the reference engine decodes elsewhere
        np.testing.assert_array_equal(j.generate(prompt, N_NEW).tokens, want)

    batch = _prefix_batch(cfg, torch.from_numpy(prompt).long(), torch.zeros)
    with torch.inference_mode():
        logits, _ = t.model.prefill(
            t.params, batch, t.model.init_cache(B, MAX_SEQ, device="cpu"))
    assert logits.dtype == torch.bfloat16
    err = np.abs(logits[:, -1].float().numpy() - first).max()
    limit = REL * np.abs(first).max()
    assert err <= limit, f"{arch}: prefill logits {err:.4g} apart, limit " \
                         f"{limit:.4g}"

    got = t.generate(prompt, n_new=N_NEW).tokens
    assert got.shape == want.shape
    near = next((i for i in range(N_NEW) if margins[i] < REL * peaks[i]),
                N_NEW)
    same = next((i for i in range(N_NEW)
                 if not np.array_equal(got[..., i], want[..., i])), N_NEW)
    assert same >= near, f"{arch}: tokens part at step {same}, before the " \
                         f"first near-tie at step {near}"


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in (tree.values() if isinstance(tree, dict) else tree)
            for t in _leaves(v)]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_engine_keeps_an_fp32_cache(arch):
    """The cache (KV cache, Zamba2's and xLSTM's states) that the port's
    bf16 engine builds, fills and decodes over is fp32, as the reference
    engine's is."""
    j, t = _engines(arch)
    want = {np.dtype(x.dtype) for x in jax.tree.leaves(
        j.model.init_cache(B, j.max_seq))}
    assert want == {np.dtype(np.float32)}
    caches = []
    prefill, decode = t.model.prefill, t.model.decode_step

    def spy_prefill(params, batch, cache):
        caches.append(cache)
        return prefill(params, batch, cache)

    def spy_decode(params, cache, batch):
        caches.append(cache)
        return decode(params, cache, batch)

    t.model.prefill, t.model.decode_step = spy_prefill, spy_decode
    try:
        t.generate(_prompt(arch, seed=1), n_new=2)
    finally:
        del t.model.prefill, t.model.decode_step
    assert len(caches) == 3
    for cache in caches:
        assert {x.dtype for x in _leaves(cache)} == {torch.float32}
