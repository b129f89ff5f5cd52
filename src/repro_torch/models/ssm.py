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
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (MODEL_AX, MODEL_HD,
                                              MODEL_HEADS, P, fit,
                                              gather_features, head_whole,
                                              maybe_constrain, merge_heads,
                                              model_group, model_rank,
                                              on_shards, pin_batch, project,
                                              reshape, residual_add,
                                              split_heads, splits_model)
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
    log decay, so they leave the state as it is.

    On DTensors the chunk loop runs on each device's shards
    (``_on_head_shards``), so no collective runs inside it."""
    return _on_head_shards(lambda *t: _ssd_chunked(*t[:4], chunk, t[4]),
                           x, a, B, C, h_init)


def _on_head_shards(fn, x, a, B, C, state):
    """``fn(x, a, B, C, state)``, an SSD over x (b, [s,] h, p), on each
    device's shards in the rules' layout of the SSM state
    (``cache_specs``' "ssm"): the batch over (`pod`, `data`), the heads
    over `model` where their count divides it (B and C with them when
    they have a head each). Heads and batch rows are independent.
    Where the heads are split and B and C are shared by all of them
    (one group), each device reads B and C with its own heads only, so
    their local gradients are partial sums over `model`.

    On a mesh whose `model` is split over the heads (an mLSTM whose
    heads span several devices) it runs on (head, n) shards instead, as
    GSPMD runs the reference's: B, C and the state on their head and
    their slice of n, x (v with its ones channel) and the decays whole
    within the head. Each device's y is then its slice of n's share, a
    partial sum over ``MODEL_HD``, and so are the local gradients of x
    and of the decays."""
    if not isinstance(x, DTensor):
        return fn(x, a, B, C, state)
    dp = fit(x, 0, ("pod", "data"))
    seq = (None,) * (x.dim() - 3)
    if splits_model(x.device_mesh):
        hn = (MODEL_HEADS, MODEL_HD)
        return on_shards(
            fn, (x, a, B, C, state),
            (P(dp, *seq, MODEL_HEADS, None), P(dp, *seq, MODEL_HEADS),
             P(dp, *seq, *hn), P(dp, *seq, *hn), P(dp, *hn, None)),
            [P(dp, *seq, MODEL_HEADS, None), P(dp, *hn, None)],
            {0: MODEL_HD, 1: MODEL_HD}, partial_out=[MODEL_HD, None])
    hs = fit(x, x.dim() - 2, "model")
    gs = hs if B.shape[-2] == x.shape[-2] else None
    partial = {2: "model", 3: "model"} if hs and not gs else None
    return on_shards(
        fn, (x, a, B, C, state),
        (P(dp, *seq, hs, None), P(dp, *seq, hs), P(dp, *seq, gs, None),
         P(dp, *seq, gs, None), P(dp, hs, None, None)),
        [P(dp, *seq, hs, None), P(dp, hs, None, None)], partial)


def _ssd_chunked(x, a, B, C, chunk, h_init):
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
        return reshape(t, b, nc, Lc, *t.shape[2:])

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
    y = reshape(torch.stack(ys, dim=1), b, nc * Lc, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_step(
    x: torch.Tensor,      # (b, h, p)
    a: torch.Tensor,      # (b, h) log decay
    B: torch.Tensor,      # (b, g, n)
    C: torch.Tensor,      # (b, g, n)
    state: torch.Tensor,  # (b, h, n, p) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: (y (b,h,p), the new state). On DTensors it
    runs on each device's shards (``_on_head_shards``)."""
    return _on_head_shards(_ssd_step, x, a, B, C, state)


def _ssd_step(x, a, B, C, state):
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


def _inner(t: torch.Tensor) -> torch.Tensor:
    """A (b, s, d_in) tensor of the Mamba2 block in the rules' layout:
    the batch over (`pod`, `data`), d_in over `model` (``w_z`` and
    ``w_x`` are column-parallel), its gradient too."""
    if not isinstance(t, DTensor):
        return t
    return maybe_constrain(t, ("pod", "data"), None, fit(t, 2, "model"))


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
    z = _inner(x @ p.w_z)
    x_c = _inner(x @ p.w_x)
    bc = torch.cat([x @ p.w_B, x @ p.w_C], dim=-1)
    # the rules shard dt_bias over the heads: so is this product
    dt_raw = project(x, p.w_dt, out_like=p.dt_bias)
    x_c, new_conv = _causal_conv(p.conv_w, p.conv_b, x_c,
                                 None if state is None else state["conv"])
    x_c = _inner(x_c)
    bc, new_conv_bc = _causal_conv(p.conv_w_bc, p.conv_b_bc, bc,
                                   None if state is None else state["conv_bc"])
    x_ssm = reshape(x_c, b, s, nh, hd)
    Bmat = reshape(bc[..., :st], b, s, 1, st)
    Cmat = reshape(bc[..., st:], b, s, 1, st)
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
    y = reshape(y, b, s, d_in)
    y = L.rmsnorm(p.gate_norm, _inner(y * F.silu(z)), cfg.norm_eps)
    out = residual_add(res, y @ p.out_proj)
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
    """On DTensors q, k and v stay in the rules' layout, features over
    `model` (``split_heads``): each device's are whole heads, or, on a
    mesh whose `model` is split over the heads, its slice of one head's
    dims, and the matrix memory runs on (head, n) shards
    (``_on_head_shards``)."""
    b, s, d = x.shape
    up = _up(cfg)
    H = cfg.n_heads
    hd = up // H
    res = x
    x = L.rmsnorm(p.norm, x, cfg.norm_eps)
    u = x @ p.w_u
    z = x @ p.w_z
    # u is whole on every device (``w_u`` is replicated); each product
    # pins it on its own, so its gradient's partial sums over `model`
    # are all-reduced one product at a time, as the reference reduces
    # them, whatever the DTensor release does with a sum of partials
    q = split_heads(pin_batch(u) @ p.wq, H) / math.sqrt(hd)
    k = split_heads(pin_batch(u) @ p.wk, H)
    v = head_whole(split_heads(pin_batch(u) @ p.wv, H))
    gates = (pin_batch(u) @ p.w_if).float()
    i_g = torch.sigmoid(gates[..., :H])                       # (b,s,H)
    f_g = torch.sigmoid(gates[..., H:]) * 0.999 + 1e-4
    a_log = torch.log(f_g)
    # augment v with a ones channel -> numerator & normalizer together
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    x_in = v_aug * i_g.to(v.dtype)[..., None]
    if decode:
        y_aug, newC = ssd_step(x_in[:, 0], a_log[:, 0], k[:, 0], q[:, 0],
                               state["C"])
        y_aug = y_aug[:, None]
    else:
        h0 = None if state is None else state["C"]
        y_aug, newC = ssd_chunked(x_in, a_log, k, q,
                                  min(cfg.ssm_chunk or 128, 128), h0)
    y_aug = head_whole(y_aug)             # the partial sums over n reduced
    num, den = y_aug[..., :hd], y_aug[..., hd:]
    # whole within its head, its gradient too (gathered from the
    # devices' slices of hd), before each device keeps its slice
    y = merge_heads(head_whole(num / den.abs().clamp_min(1.0).to(num.dtype)))
    y = L.rmsnorm(p.out_norm, y, cfg.norm_eps) * F.silu(z)
    out = residual_add(res, y @ p.w_down)
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


def _slstm_cell(r_gates: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor,
                st: State) -> State:
    """xg: (b, 4*up) pre-activation from the input path; ``r_gates`` the
    block's recurrent weights."""
    H = cfg.n_heads
    b = xg.shape[0]
    up = xg.shape[1] // 4
    hd = up // H
    h_prev = reshape(st["h"], b, H, hd).to(r_gates.dtype)
    rec = reshape(torch.einsum("bhd,hdk->bhk", h_prev, r_gates), b, 4 * up)
    z_t, i_t, f_t, o_t = (xg + rec).float().chunk(4, dim=-1)
    z_t = torch.tanh(z_t)
    i_t = torch.sigmoid(i_t)
    f_t = torch.sigmoid(f_t)
    o_t = torch.sigmoid(o_t)
    c = f_t * st["c"] + i_t * z_t
    n = f_t * st["n"] + i_t
    h = o_t * c / n.clamp_min(1.0)
    return {"c": c, "n": n, "h": h}


def _slstm_scan(p: SLSTM, cfg: ModelConfig, xg: torch.Tensor, st: State
                ) -> Tuple[torch.Tensor, State]:
    """The cell over every step of xg (b, s, 4*up): (h of each step
    (b, s, up), the last state). On DTensors it runs on each device's
    shards (``_slstm_on_units``)."""
    def scan(xg, r_gates, c, n, h):
        st = {"c": c, "n": n, "h": h}
        hs = []
        for t in range(xg.shape[1]):
            st = _slstm_cell(r_gates, cfg, xg[:, t], st)
            hs.append(st["h"])
        return torch.stack(hs, dim=1), st["c"], st["n"], st["h"]

    args = (xg, p.r_gates, st["c"], st["n"], st["h"])
    if not any(isinstance(t, DTensor) for t in args):
        y, c, n, h = scan(*args)
    else:
        y, c, n, h = _slstm_on_units(cfg, *args)
    return y, {"c": c, "n": n, "h": h}


def _slstm_on_units(cfg: ModelConfig, xg, r_gates, c, n, h):
    """The sLSTM scan on each device's shards, as GSPMD runs the
    reference's: the batch over (`pod`, `data`); the pre-activations
    xg (b, s, 4*up) on their column blocks over `model` (``w_gates`` is
    column-parallel), and h, c and n on their units (up / `model` of
    them). Each step a device adds its block's recurrent product (its
    heads' h, gathered within a head whose units span several devices,
    against its columns of ``r_gates``), trades the block by all-to-all
    for the four gates of its own units, and runs the cell on them.
    Returns (h of each step on its units, the last c, n and h on their
    units). The reference trades the gates with collective-permutes.

    The gradient: an all-to-all's is an all-to-all, a gather's a
    reduce-scatter (each device reads its head's h with its own
    columns), and each device reads its columns of ``r_gates``, so their
    local gradients are partial sums over `model`."""
    mesh = xg.device_mesh
    r, M = model_rank(mesh)
    H = cfg.n_heads
    up = xg.shape[-1] // 4
    hd = up // H
    uw = up // M                              # units a device holds
    if up % M or (uw % hd and hd % uw):
        raise ValueError(f"sLSTM: {H} heads of {hd} units do not split "
                         f"over `model` {M}")
    if uw < hd and not splits_model(mesh):
        raise ValueError(f"sLSTM: a head of {hd} units spans {hd // uw} "
                         f"devices of `model`: place it on a mesh whose "
                         f"`model` is split over the {H} heads")
    order, sends, recvs = _unit_exchange(r, M, up)
    grad = torch.is_grad_enabled()
    # (torch 2.11 lacks the ``_single`` names, 2.13 deprecates the others)
    gather = (getattr(funcol, "all_gather_single_autograd",
                      funcol.all_gather_tensor_autograd) if grad else
              getattr(funcol, "all_gather_single", funcol.all_gather_tensor))
    trade = funcol.all_to_all_single_autograd if grad else \
        funcol.all_to_all_single
    hd_dim = (mesh, mesh.mesh_dim_names.index(MODEL_HD)) if uw < hd else None

    def recurrent(rg):
        """(the device's heads' h (b, uw) or (b, hd)) -> its columns of
        the recurrent product (b, 4*uw)."""
        if uw >= hd:
            h0, kh = r * uw // hd, uw // hd
            w = rg[h0:h0 + kh]
            return lambda hh: torch.einsum(
                "bhd,hdk->bhk", hh.reshape(hh.shape[0], kh, hd),
                w).reshape(hh.shape[0], 4 * uw)
        k0 = r % (hd // uw) * 4 * uw
        w = rg[r * uw // hd, :, k0:k0 + 4 * uw]
        return lambda hh: hh @ w

    def scan(xg_l, rg, c_l, n_l, h_l):
        rec = recurrent(rg)
        b = xg_l.shape[0]
        hs = []
        for t in range(xg_l.shape[1]):
            hh = h_l if hd_dim is None else gather(h_l, 1, hd_dim)
            pre = (xg_l[:, t] + rec(hh.to(rg.dtype))).float()
            blk = pre.reshape(b, 4, uw)[:, order].transpose(0, 1)
            if M > 1:
                blk = trade(blk.contiguous(), recvs, sends, model_group(mesh))
            z_t, i_t, f_t, o_t = blk
            z_t = torch.tanh(z_t)
            i_t = torch.sigmoid(i_t)
            f_t = torch.sigmoid(f_t)
            o_t = torch.sigmoid(o_t)
            c_l = f_t * c_l + i_t * z_t
            n_l = f_t * n_l + i_t
            h_l = o_t * c_l / n_l.clamp_min(1.0)
            hs.append(h_l)
        return torch.stack(hs, dim=1), c_l, n_l, h_l

    dp = fit(xg, 0, ("pod", "data"))
    units = P(dp, MODEL_AX)
    return on_shards(scan, (xg, r_gates, c, n, h),
                     (P(dp, None, MODEL_AX), P(None, None, None), units,
                      units, units),
                     [P(dp, None, MODEL_AX), units, units, units],
                     {1: ("pod", "data", MODEL_AX) if dp else MODEL_AX})


def _unit_exchange(r: int, M: int, up: int):
    """The all-to-all that trades device ``r``'s column block of the
    pre-activations (4 * up / ``M`` of the flat (gate, unit) columns) for
    the four gates of its own units: (the order of the block's chunks of
    up / ``M`` columns, sorted by the device that holds their units; the
    chunks sent to each device; the chunks received from each, which
    arrive gate by gate)."""
    uw, width = up // M, 4 * up // M
    first = [r * width + j * uw for j in range(4)]
    dest = [f % up // uw for f in first]
    order = sorted(range(4), key=lambda j: (dest[j], first[j]))
    sends = [dest.count(i) for i in range(M)]
    srcs = [(g * up + r * uw) // width for g in range(4)]
    recvs = [srcs.count(i) for i in range(M)]
    return order, sends, recvs


def slstm_apply(
    p: SLSTM, cfg: ModelConfig, x: torch.Tensor,
    state: Optional[State] = None, decode: bool = False,
) -> Tuple[torch.Tensor, Optional[State]]:
    """The cell runs step by step over the sequence (it is not
    associative: the recurrent gates read h)."""
    b, s, d = x.shape
    res = x
    x = L.rmsnorm(p.norm, x, cfg.norm_eps)
    # the input path whole before the column-parallel ``w_gates``, as
    # GSPMD gathers it
    xg = gather_features(x @ p.w_up) @ p.w_gates         # (b, s, 4*up)
    st = state if state is not None else slstm_state(cfg, b,
                                                     device=x.device)
    y, st = _slstm_scan(p, cfg, xg, st)
    y = y.to(x.dtype)
    new_state = st if (state is not None or decode) else None
    y = L.rmsnorm(p.out_norm, y, cfg.norm_eps)
    out = residual_add(res, y @ p.w_down)
    return out, new_state
