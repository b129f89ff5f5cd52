"""The port's training step against the reference's on the CPU, from
the same weights (the reference's init carried across by
``convert.py``) and the same batches: step-0 loss, ``ce`` and ``aux``
and every gradient for each ``SMOKES`` family on both attention routes
(``use_flash`` False: the masked ``_sdpa``; True: ``_sdpa_chunked`` at
S = 300), then a 3-step loss curve. The reference runs jitted, as its
trainer does.

Tolerances (fp32):
- loss, ``ce``, ``aux``: 1e-5 (measured: at most 2.4e-6);
- gradients, leaf for leaf: within 1e-5 of the leaf's largest |g|
  (measured: at most 3.6e-6 of it). Zamba2's chunked SSD sums its chunk
  products in another order than XLA, so it is held to the reference's
  own 2e-4 (measured: 3.9e-5 of it);
- the loss curve: ``CURVE_RTOL``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch.steps import init_train_state as j_init_train_state
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models.registry import build_model as j_build_model
from repro_torch.configs import SMOKES
from repro_torch.convert import _flatten, _restack, load_state_, params_from_jax
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.registry import build_model

ARCHS = list(SMOKES)
TOL = 1e-5
SSD_TOL = 2e-4
# measured: the port's losses differ from the reference's by at most
# 6.9e-8 relative over the three steps (qwen2-moe-a2.7b smoke)
CURVE_RTOL = 1e-6


def _batch(arch, B, S, seed=3, ref=False):
    b = JData(J_SMOKES[arch], B, S, seed=seed).sample(0)
    if ref:
        return {k: jnp.asarray(v) for k, v in b.items()}
    return {k: torch.from_numpy(v).long() if k != "patch_embeds"
            else torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _loss_and_grads(arch, use_flash):
    """Step-0 loss, metrics and gradients of both packages from the same
    weights and batch. With ``use_flash`` S = 300, past the chunked
    attention's 256 threshold."""
    S = 300 if use_flash else 32
    jm = j_build_model(J_SMOKES[arch], use_flash=use_flash)
    jp = jm.init(jax.random.PRNGKey(1))
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, _batch(arch, 2, S, ref=True))
    tm = build_model(SMOKES[arch], use_flash=use_flash)
    tp = params_from_jax(SMOKES[arch], jax.tree.map(np.asarray, jp),
                         device="cpu").requires_grad_(True)
    tl, tmet = tm.loss(tp, _batch(arch, 2, S))
    named = dict(tp.named_parameters())
    tg = torch.autograd.grad(tl, list(named.values()))
    return ((float(jl), {k: float(v) for k, v in jmet.items()},
             _flatten(jax.tree.map(np.asarray, jg))),
            (float(tl.detach()), {k: float(v.detach()) for k, v in tmet.items()},
             {k: v.numpy() for k, v in
              _flatten(_restack(tp, dict(zip(named, tg)))).items()}))


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["sdpa", "sdpa_chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_matches_reference(arch, use_flash):
    (jl, jmet, _), (tl, tmet, _) = _loss_and_grads(arch, use_flash)
    assert tl == pytest.approx(jl, rel=TOL, abs=TOL)
    assert tmet.keys() == jmet.keys() == {"ce", "aux"}
    for k in jmet:
        assert tmet[k] == pytest.approx(jmet[k], rel=TOL, abs=TOL)
    if SMOKES[arch].family == "moe":
        assert tmet["aux"] > 0


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["sdpa", "sdpa_chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, use_flash):
    (_, _, jg), (_, _, tg) = _loss_and_grads(arch, use_flash)
    assert tg.keys() == jg.keys()
    tol = SSD_TOL if arch == "zamba2-7b" else TOL
    for k, want in jg.items():
        assert tg[k].shape == want.shape, k
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(tg[k], want, rtol=0, atol=tol * scale,
                                   err_msg=k)


def test_loss_curve_matches_reference():
    """Three steps of the reference's jitted train step against the
    port's, from the same weights and batches."""
    arch = "qwen2-moe-a2.7b"
    jm = j_build_model(J_SMOKES[arch])
    js = j_init_train_state(jm, jax.random.PRNGKey(1))
    tm = build_model(SMOKES[arch])
    ts = load_state_(init_train_state(tm, torch.Generator().manual_seed(9),
                                      device="cpu"),
                     jax.tree.map(np.asarray, js))
    j_step = jax.jit(j_make_train_step(jm, peak_lr=1e-3, warmup=1,
                                       stable=1, decay=2))
    t_step = make_train_step(tm, peak_lr=1e-3, warmup=1, stable=1, decay=2)
    data = JData(J_SMOKES[arch], 2, 32, seed=4)
    jl, tl = [], []
    for step in range(3):
        b = data.sample(step)
        js, jmet = j_step(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = t_step(ts, {k: torch.from_numpy(v).long()
                               for k, v in b.items()})
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=CURVE_RTOL)
    assert jl[0] != jl[-1]
