"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM /
sLSTM).

Port of the reference package's ``models/ssm.py``. The SSD chunked
algorithm is shared: mLSTM is SSD with per-head B=k, C=q, x=v and a
sigmoid forget-gate log-decay, its normalizer obtained by augmenting x
with a ones-channel (the denominator state n·q falls out of the same
recurrence).

Prefill uses the chunked parallel form (a loop over chunks, quadratic
within a chunk); decode is the O(1) recurrent step. Both take and
return an explicit state dict with the reference's keys; the stacks copy
it into their stacked buffers in place. The recurrences run in fp32, as
in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

State = Dict[str, torch.Tensor]


# ======================================================================
# SSD core (shared by Mamba2 and mLSTM)
# ======================================================================
def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(..., g, n) -> (..., h, n): group g serves heads g*h/g.. (h/g)."""
    g = t.shape[-2]
    return t if g == h else t.repeat_interleave(h // g, dim=-2)


def ssd_chunked(
    x: torch.Tensor,      # (b, s, h, p)   already includes dt/input gate
    a: torch.Tensor,      # (b, s, h)      per-step log decay (<= 0)
    B: torch.Tensor,      # (b, s, g, n)   g in {1, h}
    C: torch.Tensor,      # (b, s, g, n)
    chunk: int,
    h_init: Optional[torch.Tensor] = None,   # (b, h, n, p)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b,s,h,p), final_state (b,h,n,p) fp32). s is padded to a
    multiple of L = min(chunk, s); padded steps have zero input and zero
    log decay, so they leave the state as it is."""
    b, s, h, p = x.shape
    n = B.shape[3]
    Lc = min(chunk, s)
    pad = (-s) % Lc
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // Lc

    def to_chunks(t):  # (b, sp, ...) -> (b, nc, L, ...)
        return t.reshape(b, nc, Lc, *t.shape[2:])

    xc = to_chunks(x).float()
    a_cs = to_chunks(a).float().cumsum(dim=2)            # (b,nc,L,h)
    Bh = _heads(to_chunks(B).float(), h)                  # (b,nc,L,h,n)
    Ch = _heads(to_chunks(C).float(), h)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h_init is None else h_init.float())
    causal = torch.ones((Lc, Lc), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    ys = []
    for c in range(nc):
        acs, xcc, Bcc, Ccc = a_cs[:, c], xc[:, c], Bh[:, c], Ch[:, c]
        asum = acs[:, -1]                                 # (b,h)
        # inter-chunk: y_l += exp(a_cs[l]) * C_l . S_prev
        y_inter = torch.einsum("blhn,bhnp->blhp",
                               Ccc * acs.exp()[..., None], state)
        # intra-chunk (causal, decay-weighted). Mask BEFORE exp: the
        # anti-causal deltas are positive and overflow to inf.
        delta = acs[:, :, None, :] - acs[:, None, :, :]   # (b,L,L,h)
        dmat = torch.where(causal, delta, float("-inf")).exp()
        W = torch.einsum("blhn,bmhn->blmh", Ccc, Bcc) * dmat
        y_intra = torch.einsum("blmh,bmhp->blhp", W, xcc)
        # chunk-local state + carry update
        decay_out = (asum[:, None, :] - acs).exp()        # (b,L,h)
        S_loc = torch.einsum("blhn,blhp->bhnp",
                             Bcc, decay_out[..., None] * xcc)
        state = asum.exp()[..., None, None] * state + S_loc
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(b, nc * Lc, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_step(
    x: torch.Tensor,      # (b, h, p)
    a: torch.Tensor,      # (b, h) log decay
    B: torch.Tensor,      # (b, g, n)
    C: torch.Tensor,      # (b, g, n)
    state: torch.Tensor,  # (b, h, n, p) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x.shape[1]
    B, C = _heads(B, h).float(), _heads(C, h).float()
    decay = a.float().exp()[..., None, None]
    state = decay * state + torch.einsum("bhn,bhp->bhnp", B, x.float())
    y = torch.einsum("bhn,bhnp->bhp", C, state)
    return y.to(x.dtype), state


# ======================================================================
# Mamba2 block
# ======================================================================
class Mamba2(nn.Module):
    """One Mamba2 layer with the reference's param names. Projections
    stay separate (``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``); ``A_log``,
    ``D`` and ``dt_bias`` are fp32 whatever the dtype."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        nh, st, k = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
        self.norm = L.RMSNorm(d, dtype, device)
        self.w_z = L._param((d, d_in), dtype, device)
        self.w_x = L._param((d, d_in), dtype, device)
        self.w_B = L._param((d, st), dtype, device)
        self.w_C = L._param((d, st), dtype, device)
        self.w_dt = L._param((d, nh), dtype, device)
        self.conv_w = L._param((k, d_in), dtype, device)
        self.conv_b = L._param((d_in,), dtype, device, fill=0.0)
        self.conv_w_bc = L._param((k, 2 * st), dtype, device)
        self.conv_b_bc = L._param((2 * st,), dtype, device, fill=0.0)
        self.A_log = L._param((nh,), torch.float32, device)
        with torch.no_grad():
            self.A_log.copy_(torch.linspace(1.0, 16.0, nh).log())
        self.D = L._param((nh,), torch.float32, device, fill=1.0)
        self.dt_bias = L._param((nh,), torch.float32, device, fill=0.0)
        self.gate_norm = L.RMSNorm(d_in, dtype, device)
        self.out_proj = L._param((d_in, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Projections N(0, 1/d_in), conv kernels N(0, 1/k): each drawn
        on its own (the reference's init reuses one key for ``w_z`` and
        ``out_proj``)."""
        for w in (self.w_z, self.w_x, self.w_B, self.w_C, self.w_dt,
                  self.conv_w, self.conv_w_bc, self.out_proj):
            L.dense_init_(w, generator)


def mamba2_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                 device=None) -> State:
    d_in = cfg.ssm_expand * cfg.d_model
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype,
                            device=device),
        "conv_bc": torch.zeros((batch, cfg.ssm_conv - 1, 2 * cfg.ssm_state),
                               dtype=dtype, device=device),
    }


def _causal_conv(w: torch.Tensor, bias: torch.Tensor, xc: torch.Tensor,
                 conv_state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, kernel k, carrying the last k-1 inputs.
    xc: (b, s, ch)."""
    k, s = w.shape[0], xc.shape[1]
    if conv_state is None:
        conv_state = xc.new_zeros((xc.shape[0], k - 1, xc.shape[2]))
    xx = torch.cat([conv_state.to(xc.dtype), xc], dim=1)
    new_state = xx[:, -(k - 1):, :]
    out = torch.zeros_like(xc)
    for i in range(k):
        out = out + xx[:, i:i + s, :] * w[i]
    return F.silu(out + bias.to(out.dtype)), new_state


def mamba2_apply(
    p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
    state: Optional[State] = None, decode: bool = False,
) -> Tuple[torch.Tensor, Optional[State]]:
    """x: (b, s, d). decode=True requires s == 1 and a state."""
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    nh, st, hd = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    res = x
    x = L.rmsnorm(p.norm, x, cfg.norm_eps)
    z = x @ p.w_z
    x_c = x @ p.w_x
    bc = torch.cat([x @ p.w_B, x @ p.w_C], dim=-1)
    dt_raw = x @ p.w_dt
    x_c, new_conv = _causal_conv(p.conv_w, p.conv_b, x_c,
                                 None if state is None else state["conv"])
    bc, new_conv_bc = _causal_conv(p.conv_w_bc, p.conv_b_bc, bc,
                                   None if state is None else state["conv_bc"])
    x_ssm = x_c.reshape(b, s, nh, hd)
    Bmat = bc[..., :st].reshape(b, s, 1, st)
    Cmat = bc[..., st:].reshape(b, s, 1, st)
    dt = F.softplus(dt_raw.float() + p.dt_bias)                  # (b,s,nh)
    a_log = dt * -torch.exp(p.A_log)
    x_in = x_ssm * dt.to(x_ssm.dtype)[..., None]
    if decode:
        y, new_ssm = ssd_step(x_in[:, 0], a_log[:, 0], Bmat[:, 0],
                              Cmat[:, 0], state["ssm"])
        y = y[:, None]
    else:
        h0 = None if state is None else state["ssm"]
        y, new_ssm = ssd_chunked(x_in, a_log, Bmat, Cmat, cfg.ssm_chunk, h0)
    y = y + x_ssm * p.D.to(x_ssm.dtype)[:, None]
    y = y.reshape(b, s, d_in)
    y = L.rmsnorm(p.gate_norm, y * F.silu(z), cfg.norm_eps)
    out = res + y @ p.out_proj
    new_state = None
    if state is not None or decode:
        new_state = {"ssm": new_ssm, "conv": new_conv,
                     "conv_bc": new_conv_bc}
    return out, new_state


# ======================================================================
# xLSTM blocks
# ======================================================================
def _up(cfg: ModelConfig) -> int:
    return int(cfg.xlstm_proj_factor * cfg.d_model)


class MLSTM(nn.Module):
    """q/k/v and the two up-projections kept separate, as the reference
    names them."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        d, up = cfg.d_model, _up(cfg)
        self.norm = L.RMSNorm(d, dtype, device)
        self.w_u = L._param((d, up), dtype, device)
        self.w_z = L._param((d, up), dtype, device)
        self.wq = L._param((up, up), dtype, device)
        self.wk = L._param((up, up), dtype, device)
        self.wv = L._param((up, up), dtype, device)
        self.w_if = L._param((up, 2 * cfg.n_heads), dtype, device)
        self.out_norm = L.RMSNorm(up, dtype, device)
        self.w_down = L._param((up, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_u, self.w_z, self.wq, self.wk, self.wv, self.w_if,
                  self.w_down):
            L.dense_init_(w, generator)


def mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                device=None) -> State:
    H = cfg.n_heads
    hd = _up(cfg) // H
    return {"C": torch.zeros((batch, H, hd, hd + 1), device=device)}


def mlstm_apply(
    p: MLSTM, cfg: ModelConfig, x: torch.Tensor,
    state: Optional[State] = None, decode: bool = False,
) -> Tuple[torch.Tensor, Optional[State]]:
    b, s, d = x.shape
    up = _up(cfg)
    H = cfg.n_heads
    hd = up // H
    res = x
    x = L.rmsnorm(p.norm, x, cfg.norm_eps)
    u = x @ p.w_u
    z = x @ p.w_z
    q = (u @ p.wq).reshape(b, s, H, hd) / math.sqrt(hd)
    k = (u @ p.wk).reshape(b, s, H, hd)
    v = (u @ p.wv).reshape(b, s, H, hd)
    gates = (u @ p.w_if).float()
    i_g = torch.sigmoid(gates[..., :H])                       # (b,s,H)
    f_g = torch.sigmoid(gates[..., H:]) * 0.999 + 1e-4
    a_log = torch.log(f_g)
    # augment v with a ones channel -> numerator & normalizer together
    v_aug = torch.cat([v, v.new_ones((b, s, H, 1))], dim=-1)
    x_in = v_aug * i_g.to(v.dtype)[..., None]
    if decode:
        y_aug, newC = ssd_step(x_in[:, 0], a_log[:, 0], k[:, 0], q[:, 0],
                               state["C"])
        y_aug = y_aug[:, None]
    else:
        h0 = None if state is None else state["C"]
        y_aug, newC = ssd_chunked(x_in, a_log, k, q,
                                  min(cfg.ssm_chunk or 128, 128), h0)
    num, den = y_aug[..., :hd], y_aug[..., hd:]
    y = num / den.abs().clamp_min(1.0).to(num.dtype)
    y = y.reshape(b, s, up)
    y = L.rmsnorm(p.out_norm, y, cfg.norm_eps) * F.silu(z)
    out = res + y @ p.w_down
    new_state = {"C": newC} if (state is not None or decode) else None
    return out, new_state


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> None:
        super().__init__()
        d, up, H = cfg.d_model, _up(cfg), cfg.n_heads
        hd = up // H
        self.norm = L.RMSNorm(d, dtype, device)
        self.w_up = L._param((d, up), dtype, device)
        self.w_gates = L._param((up, 4 * up), dtype, device)
        self.r_gates = L._param((H, hd, 4 * hd), dtype, device)
        self.out_norm = L.RMSNorm(up, dtype, device)
        self.w_down = L._param((up, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Dense weights N(0, 1/d_in); the recurrent ``r_gates`` N(0, 1/hd)."""
        for w in (self.w_up, self.w_gates, self.r_gates, self.w_down):
            L.dense_init_(w, generator)


def slstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                device=None) -> State:
    up = _up(cfg)
    return {
        "c": torch.zeros((batch, up), device=device),
        "n": torch.ones((batch, up), device=device),
        "h": torch.zeros((batch, up), device=device),
    }


def _slstm_cell(p: SLSTM, cfg: ModelConfig, xg: torch.Tensor,
                st: State) -> State:
    """xg: (b, 4*up) pre-activation from the input path."""
    H = cfg.n_heads
    b = xg.shape[0]
    up = xg.shape[1] // 4
    hd = up // H
    h_prev = st["h"].reshape(b, H, hd).to(p.r_gates.dtype)
    rec = torch.einsum("bhd,hdk->bhk", h_prev, p.r_gates).reshape(b, 4 * up)
    z_t, i_t, f_t, o_t = (xg + rec).float().chunk(4, dim=-1)
    z_t = torch.tanh(z_t)
    i_t = torch.sigmoid(i_t)
    f_t = torch.sigmoid(f_t)
    o_t = torch.sigmoid(o_t)
    c = f_t * st["c"] + i_t * z_t
    n = f_t * st["n"] + i_t
    h = o_t * c / n.clamp_min(1.0)
    return {"c": c, "n": n, "h": h}


def slstm_apply(
    p: SLSTM, cfg: ModelConfig, x: torch.Tensor,
    state: Optional[State] = None, decode: bool = False,
) -> Tuple[torch.Tensor, Optional[State]]:
    """The cell runs step by step over the sequence (it is not
    associative: the recurrent gates read h)."""
    b, s, d = x.shape
    res = x
    x = L.rmsnorm(p.norm, x, cfg.norm_eps)
    xg = (x @ p.w_up) @ p.w_gates                        # (b, s, 4*up)
    st = state if state is not None else slstm_state(cfg, b,
                                                     device=x.device)
    if decode:
        st = _slstm_cell(p, cfg, xg[:, 0], st)
        y = st["h"][:, None].to(x.dtype)
        new_state: Optional[State] = st
    else:
        hs = []
        for t in range(s):
            st = _slstm_cell(p, cfg, xg[:, t], st)
            hs.append(st["h"])
        y = torch.stack(hs, dim=1).to(x.dtype)
        new_state = st if state is not None else None
    y = L.rmsnorm(p.out_norm, y, cfg.norm_eps)
    out = res + y @ p.w_down
    return out, new_state
