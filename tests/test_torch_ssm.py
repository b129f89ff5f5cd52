"""The port's SSD core, Mamba2, mLSTM and sLSTM blocks against the
reference package's, on the CPU, from the same numpy inputs and the
same weights (the reference's init, converted).

Tolerances: fp32 at 1e-5 (rtol and atol), except where the chunked
SSD's quadratic sums are taken in another order than XLA takes them.
There both packages are as far from a float64 recurrence as from each
other, and the test states the max |Δ| measured and a tolerance no
looser than the reference's own 2e-4 (``test_models.py``,
``test_decode_matches_prefill``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.configs import SMOKES
from repro_torch.convert import load_, state_from_jax
from repro_torch.models import ssm as TS

TOL = dict(rtol=1e-5, atol=1e-5)
ZAMBA = SMOKES["zamba2-7b"]
XLSTM = SMOKES["xlstm-350m"]


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _ssd_inputs(seed, b, s, h, p, g, n):
    x = _rand(seed, b, s, h, p)
    a = -np.abs(_rand(seed + 1, b, s, h)) * 0.5
    B = _rand(seed + 2, b, s, g, n)
    C = _rand(seed + 3, b, s, g, n)
    h0 = _rand(seed + 4, b, h, n, p)
    return x, a, B, C, h0


# ----------------------------------------------------------------------
# The SSD core. (s, chunk): a multiple of the chunk, two chunks with
# padding, one short chunk (L = s), and 300 over chunks of 256 (the
# shape of Zamba2's SSD in chip_smoke's card-vs-CPU prompt). y reaches
# 50 here. All hold 1e-5 but y over chunks of 256: max |Δ| 1.9e-4 there
# (g = 1; 1.5e-4 at g = h), where a 256 x 256 decay-weighted sum is
# taken in another order; the reference is itself 1.4e-4 from a float64
# recurrence on such inputs, the port 1.9e-4.
SSD_CASES = {
    "multiple": (64, 32),
    "padded": (40, 32),
    "short": (10, 32),
    "two_long_chunks": (300, 256),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
@pytest.mark.parametrize("groups", ["g1", "gh"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(case, groups, with_h0):
    s, chunk = SSD_CASES[case]
    h = 4
    g = 1 if groups == "g1" else h
    x, a, B, C, h0 = _ssd_inputs(len(case) + s, 2, s, h, 8, g, 16)
    j_h0 = jnp.asarray(h0) if with_h0 else None
    t_h0 = _t(h0) if with_h0 else None
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, a, B, C)), chunk, j_h0)
    ty, ts = TS.ssd_chunked(*map(_t, (x, a, B, C)), chunk, t_h0)
    assert ty.shape == (2, s, h, 8) and ts.shape == (2, h, 16, 8)
    assert ts.dtype == torch.float32
    # the chunk's quadratic sums: see the note above SSD_CASES
    _close(ty, jy, **(dict(rtol=2e-4, atol=2e-4) if chunk == 256 else TOL))
    _close(ts, js)


def test_ssd_chunked_padding_keeps_state():
    """Padded steps (zero input, zero log decay) leave the state as it
    is: the final state of 40 steps in chunks of 32 equals that of the
    40 steps in one chunk."""
    x, a, B, C, h0 = _ssd_inputs(7, 1, 40, 4, 8, 1, 16)
    args = tuple(map(_t, (x, a, B, C)))
    _, s32 = TS.ssd_chunked(*args, 32, _t(h0))
    _, s64 = TS.ssd_chunked(*args, 64, _t(h0))
    torch.testing.assert_close(s32, s64, **TOL)


@pytest.mark.parametrize("groups", ["g1", "gh"])
def test_ssd_step_matches_reference(groups):
    h = 4
    g = 1 if groups == "g1" else h
    x, a, B, C, h0 = _ssd_inputs(11, 2, 1, h, 8, g, 16)
    args = (x[:, 0], a[:, 0], B[:, 0], C[:, 0], h0)
    jy, js = JS.ssd_step(*map(jnp.asarray, args))
    ty, ts = TS.ssd_step(*map(_t, args))
    _close(ty, jy)
    _close(ts, js)


def test_ssd_step_continues_ssd_chunked():
    """One recurrent step after a chunked prefill equals the chunked
    form over one more step."""
    x, a, B, C, h0 = _ssd_inputs(13, 2, 21, 4, 8, 1, 16)
    args = tuple(map(_t, (x, a, B, C)))
    y_all, s_all = TS.ssd_chunked(*args, 8, _t(h0))
    _, s_pre = TS.ssd_chunked(*(t[:, :20] for t in args), 8, _t(h0))
    y1, s1 = TS.ssd_step(*(t[:, 20] for t in args), s_pre)
    torch.testing.assert_close(y1, y_all[:, 20], **TOL)
    torch.testing.assert_close(s1, s_all, **TOL)


# ----------------------------------------------------------------------
# the blocks: prefill with no state, prefill from a state, decode
def _noisy(p, seed):
    """Non-zero biases, norm scales and D, so that a dropped term shows."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32) if np.ndim(a) == 1 else np.asarray(a), p)


def _state(state_fn, cfg, seed, **fixed):
    """A reference state with random entries (scaled like a live one)."""
    st = state_fn(cfg, 2)
    rng = np.random.default_rng(seed)
    return {k: fixed.get(k, (rng.standard_normal(v.shape) * 0.5).astype(
        np.float32)) for k, v in st.items()}


BLOCKS = {
    "mamba2": (ZAMBA, JS.mamba2_init, JS.mamba2_apply, JS.mamba2_state,
               TS.Mamba2, TS.mamba2_apply),
    "mlstm": (XLSTM, JS.mlstm_init, JS.mlstm_apply, JS.mlstm_state,
              TS.MLSTM, TS.mlstm_apply),
    "slstm": (XLSTM, JS.slstm_init, JS.slstm_apply, JS.slstm_state,
              TS.SLSTM, TS.slstm_apply),
}


def _block(name, seed=0):
    cfg, j_init, j_apply, j_state, T_mod, t_apply = BLOCKS[name]
    jp = _noisy(j_init(cfg, jax.random.PRNGKey(seed)), seed)
    return cfg, jp, j_apply, j_state, load_(T_mod(cfg, device="cpu"), jp), \
        t_apply


def _live_state(name, j_state, cfg):
    # sLSTM's normalizer n stays >= its initial 1 in a live state
    fixed = {}
    if name == "slstm":
        fixed["n"] = 1.0 + np.abs(_rand(5, 2, int(2 * cfg.d_model)))
    return _state(j_state, cfg, 3, **fixed)


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("mode", ["prefill", "prefill_from_state", "decode"])
def test_block_matches_reference(name, mode):
    cfg, jp, j_apply, j_state, tp, t_apply = _block(name)
    S = 1 if mode == "decode" else 45   # 45 > the smoke chunk of 32
    x = _rand(1, 2, S, cfg.d_model)
    j_st = None if mode == "prefill" else _live_state(name, j_state, cfg)
    t_st = None if j_st is None else state_from_jax(j_st, "cpu")
    decode = mode == "decode"
    jy, j_new = j_apply(jp, cfg, jnp.asarray(x), j_st, decode)
    ty, t_new = t_apply(tp, cfg, _t(x), t_st, decode)
    _close(ty, jy)
    assert (t_new is None) == (j_new is None)
    if j_new is not None:
        assert sorted(t_new) == sorted(j_new)
        for k in j_new:
            _close(t_new[k], j_new[k])


@pytest.mark.parametrize("name", ["mamba2", "mlstm"])
def test_block_decode_continues_prefill(name):
    """Prefill of S tokens then one decode step gives the output the
    prefill of S + 1 tokens gives at its last position."""
    cfg, _, _, j_state, tp, t_apply = _block(name, seed=4)
    x = _t(_rand(6, 2, 34, cfg.d_model))
    st = state_from_jax(j_state(cfg, 2), "cpu")
    _, st = t_apply(tp, cfg, x[:, :33], st, False)
    y1, _ = t_apply(tp, cfg, x[:, 33:], st, True)
    y_all, _ = t_apply(tp, cfg, x, None, False)
    torch.testing.assert_close(y1[:, 0], y_all[:, 33], **TOL)


def test_causal_conv_carries_state():
    """The conv over a split sequence, carrying its state, equals the
    conv over the whole sequence."""
    w, b = _t(_rand(8, 4, 6)), _t(_rand(9, 6))
    x = _t(_rand(10, 2, 11, 6))
    whole, st_whole = TS._causal_conv(w, b, x, None)
    a, st = TS._causal_conv(w, b, x[:, :7], None)
    c, st2 = TS._causal_conv(w, b, x[:, 7:], st)
    torch.testing.assert_close(torch.cat([a, c], 1), whole, rtol=0, atol=0)
    torch.testing.assert_close(st2, st_whole, rtol=0, atol=0)
    jy, js = JS._causal_conv(jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                             jnp.asarray(x.numpy()), None)
    _close(whole, jy)
    _close(st_whole, js)


def test_block_inits_draw_as_the_reference():
    """Init scales of the port's Mamba2: projections N(0, 1/d_in), conv
    kernels N(0, 1/k), A_log = log(linspace(1, 16)), D = 1, dt_bias = 0;
    w_z and out_proj drawn apart (the reference reuses one key)."""
    cfg = ZAMBA.replace(d_model=256, ssm_heads=32, ssm_head_dim=16)
    p = TS.Mamba2(cfg, device="cpu")
    p.reset_parameters(torch.Generator().manual_seed(0))
    assert float(p.w_x.std()) == pytest.approx(256 ** -0.5, rel=0.05)
    assert float(p.out_proj.std()) == pytest.approx(512 ** -0.5, rel=0.05)
    assert float(p.conv_w.std()) == pytest.approx(0.5, rel=0.05)
    jp = JS.mamba2_init(cfg, jax.random.PRNGKey(0))
    for k in ("A_log", "D", "dt_bias", "conv_b", "conv_b_bc"):
        _close(getattr(p, k), jp[k], rtol=1e-6, atol=0)
    assert not torch.equal(p.w_z[:, :256], p.out_proj[:256].t())
