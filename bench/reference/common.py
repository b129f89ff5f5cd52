"""The pieces of a decoder forward that every family's reference
shares, in plain PyTorch and float32 (TF32 off), or with every linear
layer, q, k and v rounded to float8 e4m3 (``precision="fp8"``: the
control, the next precision below the configurations' bfloat16).

A forward runs layer by layer over "blocks": rows of equal length whose
logits are wanted at some positions. Each layer's weights are made
float32 once and applied to every block, so the reference holds one
layer in float32 at a time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # the largest finite float8 e4m3 value
QUERY_CHUNK = 512        # queries a step of the attention loop
VOCAB_CHUNK = 32768      # unembedding columns a step

Spec = Tuple[str, Tuple[int, ...], Tuple[str, float]]


@dataclass
class Block:
    """Rows of one length: ``tokens`` (R, T) int64 on the device;
    ``judged`` the positions whose next-token logits are wanted;
    ``prompt`` the length of the prompt the program prefilled (the
    positions after it were decode steps); ``group_rows`` the rows that
    share one routing group of the program's batch."""
    tokens: torch.Tensor
    judged: List[int]
    prompt: int
    group_rows: int = 1


def dims(cfg: dict) -> Dict[str, int]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // h
    return {"L": cfg["num_hidden_layers"], "d": d, "H": h,
            "Hkv": cfg["num_key_value_heads"], "hd": hd,
            "dq": h * hd, "dkv": cfg["num_key_value_heads"] * hd,
            "V": cfg["vocab_size"]}


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest |value| maps to 448), back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def weight(w: torch.Tensor, precision: str) -> torch.Tensor:
    """A (…, d_in, d_out) weight in float32; in fp8 one scale per output
    column."""
    w = w.float()
    return fp8(w, -2) if precision == "fp8" else w


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (…, d_in) @ w (d_in, d_out), w from ``weight``; in fp8 x takes
    one scale per token."""
    return (fp8(x, -1) if precision == "fp8" else x) @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x (R, T, heads, hd) at positions
    0..T-1, angles in float32 (the published models' convention)."""
    T, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of q (R, T, H, hd) over k, v (R, T, Hkv, hd),
    each query seeing the keys up to its own position; query head h
    reads kv head h // (H / Hkv). Returns (R, T, H, hd)."""
    R, T, H, hd = q.shape
    g = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    out = torch.empty_like(q)
    for c0 in range(0, T, QUERY_CHUNK):
        c1 = min(T, c0 + QUERY_CHUNK)
        s = q[:, :, c0:c1] @ k[:, :, :c1].transpose(-1, -2) / math.sqrt(hd)
        qi = torch.arange(c0, c1, device=q.device)[:, None]
        ki = torch.arange(c1, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
        out[:, :, c0:c1] = torch.softmax(s, dim=-1) @ v[:, :, :c1]
    return out.transpose(1, 2)


def attention_specs(cfg: dict, p: str) -> List[Spec]:
    """One layer's attention parameters: names, shapes (x @ W layout) and
    init (N(0, 1/d_in) weights, zero biases, unit norms)."""
    m = dims(cfg)
    d, dq, dkv, hd = m["d"], m["dq"], m["dkv"], m["hd"]
    out: List[Spec] = [
        (f"{p}.attn_norm.scale", (d,), ("const", 1.0)),
        (f"{p}.attn.wq", (d, dq), ("normal", d ** -0.5)),
        (f"{p}.attn.wk", (d, dkv), ("normal", d ** -0.5)),
        (f"{p}.attn.wv", (d, dkv), ("normal", d ** -0.5)),
        (f"{p}.attn.wo", (dq, d), ("normal", dq ** -0.5)),
    ]
    if cfg["attention_bias"]:
        out += [(f"{p}.attn.b{n}", (w,), ("const", 0.0))
                for n, w in (("q", dq), ("k", dkv), ("v", dkv))]
    if cfg["qk_norm"]:
        out += [(f"{p}.attn.{n}_norm.scale", (hd,), ("const", 1.0))
                for n in ("q", "k")]
    out.append((f"{p}.mlp_norm.scale", (d,), ("const", 1.0)))
    return out


def swiglu_specs(p: str, d: int, f: int) -> List[Spec]:
    return [(f"{p}.w_gate", (d, f), ("normal", d ** -0.5)),
            (f"{p}.w_up", (d, f), ("normal", d ** -0.5)),
            (f"{p}.w_down", (f, d), ("normal", f ** -0.5))]


def model_specs(cfg: dict, ffn_specs: Callable[[str], List[Spec]]
                ) -> List[Spec]:
    m = dims(cfg)
    d, V = m["d"], m["V"]
    specs: List[Spec] = [("embed", (V, d), ("normal", 0.02))]
    for i in range(m["L"]):
        specs += attention_specs(cfg, f"layers.{i}") + ffn_specs(
            f"layers.{i}")
    specs.append(("final_norm.scale", (d,), ("const", 1.0)))
    if not cfg["tie_word_embeddings"]:
        specs.append(("lm_head", (d, V), ("normal", d ** -0.5)))
    return specs


def layer_weights(W: Dict[str, torch.Tensor], p: str,
                  precision: str) -> Dict[str, torch.Tensor]:
    """Layer ``p``'s tensors in float32 by their names after ``p.``;
    matrices (two or more dims) as ``weight`` gives them."""
    n = len(p) + 1
    return {k[n:]: (weight(v, precision) if v.dim() >= 2 else v.float())
            for k, v in W.items() if k.startswith(p + ".")}


def attention(cfg: dict, lw: Dict[str, torch.Tensor], x: torch.Tensor,
              precision: str) -> torch.Tensor:
    m = dims(cfg)
    R, T, _ = x.shape
    eps = cfg["rms_norm_eps"]
    h = rmsnorm(x, lw["attn_norm.scale"], eps)
    q, k, v = (linear(h, lw[f"attn.w{n}"], precision) for n in "qkv")
    if cfg["attention_bias"]:
        q, k, v = q + lw["attn.bq"], k + lw["attn.bk"], v + lw["attn.bv"]
    q = q.view(R, T, m["H"], m["hd"])
    k = k.view(R, T, m["Hkv"], m["hd"])
    v = v.view(R, T, m["Hkv"], m["hd"])
    if cfg["qk_norm"]:
        q = rmsnorm(q, lw["attn.q_norm.scale"], eps)
        k = rmsnorm(k, lw["attn.k_norm.scale"], eps)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    if precision == "fp8":
        q, k, v = fp8(q, -1), fp8(k, -1), fp8(v, -1)
    o = causal_attention(q, k, v).reshape(R, T, m["dq"])
    return linear(o, lw["attn.wo"], precision)


def swiglu(h: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, precision: str) -> torch.Tensor:
    return linear(F.silu(linear(h, gate, precision))
                  * linear(h, up, precision), down, precision)


FFN = Callable[[dict, Dict[str, torch.Tensor], torch.Tensor, Block, str],
               torch.Tensor]


@torch.no_grad()
def forward_logits(cfg: dict, W: Dict[str, torch.Tensor],
                   blocks: List[Block], ffn: FFN,
                   precision: str = "fp32") -> List[torch.Tensor]:
    """Each block's logits at its judged positions, (R, J, V) float32.
    ``ffn(cfg, lw, h, block, precision)`` is the family's feed-forward
    on the normed residual h."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg["rms_norm_eps"]
    xs = [W["embed"][b.tokens].float() for b in blocks]
    for i in range(cfg["num_hidden_layers"]):
        lw = layer_weights(W, f"layers.{i}", precision)
        for j, b in enumerate(blocks):
            x = xs[j] + attention(cfg, lw, xs[j], precision)
            h = rmsnorm(x, lw["mlp_norm.scale"], eps)
            xs[j] = x + ffn(cfg, lw, h, b, precision)
        del lw
    head = W["embed"].t() if cfg["tie_word_embeddings"] else W["lm_head"]
    outs = []
    for x, b in zip(xs, blocks):
        h = rmsnorm(x[:, b.judged], W["final_norm.scale"], eps)
        outs.append(torch.cat([
            linear(h, weight(head[:, c:c + VOCAB_CHUNK], precision),
                   precision)
            for c in range(0, head.shape[1], VOCAB_CHUNK)], dim=-1))
    return outs
