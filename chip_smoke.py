#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA Hopper GPU.

Run from the repository root, with nothing else on the command line:

    python3 chip_smoke.py

1. Setup: needs CUDA, turns TF32 off, prints the card, builds every
   CUDA kernel of the port from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once).
2. Kernels: holds each kernel against its plain PyTorch version on the
   card: flash attention (K1) at every serving path's prefill shape
   (head dims 64, 112 and 128) and at ragged, wide-head, Sq != Sk,
   non-causal, off-tile and GQA-group cases, in fp32 and bf16, and in
   fp32 with q scaled by 8 (a peaked softmax) at the qwen2, moe and
   Zamba2 prefill shapes; the grouped GEMM (K2) at the moe path's
   shapes, the reference's sweep and (1,1,1,1), densely and with
   ``rows`` (occupied rows per expert) as the moe path passes them.
3. Dense engine: serves full-width qwen2-0.5b (random weights drawn on
   the card from a seed) through ``ServeEngine.generate``, checks that
   every layer's prefill attention went through K1 (each launch's device
   time read from CUDA events around it), and holds the card against the
   port's CPU path at full depth on weights drawn on the CPU.
4. Moe engine: serves full-width, 24-layer qwen2-moe-a2.7b in fp32
   (14.3 B parameters, 57 GB, drawn on the card from a CUDA generator)
   through ``ServeEngine.generate``, checks that every prefill
   attention went through K1 and every expert GEMM through K2 (counted
   by kernel, phase and shape, each launch's device time read from CUDA
   events around it, K2's ``rows`` read after the run), then holds the
   card against the CPU path at full width and 2 layers.
5. Zamba2 engine: serves zamba2-7b at its full
   width and depth in fp32 (81 Mamba2 layers and 13 applications of the
   shared attention block, 6.75 B parameters, 27 GB, drawn on the card)
   through ``ServeEngine.generate``, checks 13 K1 launches per prefill
   at hd 112 and none in decode, then holds the card against the CPU
   path at full width and 12 layers (two shared-block applications) on
   a 300-token prompt (two SSD chunks).
6. The other families at full width, each through
   ``ServeEngine.generate`` (4 x 500 tokens, 16 new): internvl2-1b (256
   zero patch embeddings before the text; K1 at S = 756), musicgen-large
   (four codebook streams) and xlstm-350m (no attention, so no K1); each
   also held against the CPU path at 2 layers.
7. Training: trains full-width qwen2-0.5b (494,032,768 parameters,
   not cut) on the card through ``train()``: fp32, TF32 off, remat on,
   8 x 256 tokens of ``SyntheticLMData``, 10 steps; checks that the loss
   falls and that neither kernel was launched (training takes the
   reference's routes), prints ms per step, tokens/s, peak memory, the
   6·N·T and 8·N·T FLOP bounds and a ``torch.profiler`` trace of one more
   step; then, cut to 2 layers, holds 3 steps on the card to 3 on the
   CPU from the same weights and 6 steps to 3 + checkpoint + resume + 3.
8. Control plane: the serving session (the NPU simulated on the host):
   qwen3-14b decode next to qwen2-0.5b prefill in closed loop under
   every policy, then open loop with a mid-run register, SLO autoscale
   and deregister; checks that every submitted request finished and
   that the autoscaler grew the budget.
9. Fleet sweep: the port's fluid fleet simulator
   (``repro_torch.core.sim_torch``, no kernel of its own) runs the whole
   collocation grid on the card: all 78 pairs of the 12 workloads x the
   49 EU splits of an 8 ME / 8 VE core x 5 HBM bandwidths, harvest off
   and on (2 x 19110 cells, 4 requests each). The card is held to the
   same call on the CPU (equal events in every cell, floats within
   ``SIM_REL_TOL``) and, at the half split of three pairs, to the port's
   discrete-event simulator in the bands of ``tests/test_sim_jax.py``;
   prints the card's grid time (median and spread of 3 calls after a
   warm-up), the CPU's, the discrete simulator's time per cell over the
   nine paper pairs, the loop's iterations and the largest event count.
10. Timing: times each kernel at each of its main-path shapes, its plain
    version and the PyTorch library call that computes the same
    function (with the kernels that call ran, from torch.profiler),
    beside the least time the card could take for the same work, and
    beside its device time per launch inside the main run; K1 also in
    bf16; K2 also with the ``rows`` of the main run, beside the least
    time for what those rows need.

Prints the card's name and power limit and a ``{"kernels": [...]}``
line before the last line, which is ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, if there is no CUDA device or any phase
fails.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

H100_FP32_FLOPS = 67e12      # non-tensor fp32, SXM, 700 W (data sheet)
H100_TF32_FLOPS = 494.7e12   # dense tensor-core tf32
H100_BF16_FLOPS = 989e12     # dense tensor-core bf16
H100_BYTES_PER_S = 3.35e12   # HBM3

# Training, card against the port's CPU path: the largest relative
# difference of a loss over 3 steps of the 2-layer cut of qwen2-0.5b
# (4 x 128 tokens, lr 1e-3) that the check allows. Measured on an H100
# 80GB HBM3 at 700 W: 8.0e-8 (the fp32 GEMMs sum in another order).
TRAIN_CARD_CPU_RTOL = 1e-6
# Resume: the reference's own bound (tests/test_train.py).
RESUME_RTOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd),
                               (B, Sk, Hkv, hd)))


def attention_bound(B, Sq, Sk, H, Hkv, hd, causal, dtype):
    """{"bound_ms", "bound_by", ...}: the least time an H100 could take.
    Operations are the multiply-adds of q k^T and p v over the (query,
    key) pairs these shapes leave unmasked; bytes read q, k, v once and
    write o once. bf16: operations at the bf16 tensor-core peak. fp32:
    the lesser of two bounds, both given: operations at the fp32 peak of
    the CUDA cores, and 3xTF32's three tf32 products per operation at the
    tf32 tensor-core peak (the route K1 takes), each beside the bytes."""
    if causal:
        pairs = sum(min(Sk, r + Sk - Sq + 1) for r in range(Sq))
    else:
        pairs = Sq * Sk
    ops = 4 * B * H * hd * pairs
    elt = torch.finfo(dtype).bits // 8
    t_bytes = elt * (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd) \
        / H100_BYTES_PER_S * 1e3

    def bound(t_ops):
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    if dtype != torch.float32:
        ms, by = bound(ops / H100_BF16_FLOPS * 1e3)
        return {"bound_ms": ms, "bound_by": by}
    fp32, tf32x3 = (bound(ops / H100_FP32_FLOPS * 1e3),
                    bound(3 * ops / H100_TF32_FLOPS * 1e3))
    ms, by = min(fp32, tf32x3)
    return {"bound_ms": ms, "bound_by": by,
            "bound_fp32_ms": fp32[0], "bound_fp32_by": fp32[1],
            "bound_3xtf32_ms": tf32x3[0], "bound_3xtf32_by": tf32x3[1]}


def gmm_inputs(E, C, d, f, dtype, seed):
    """x ~ N(0, 1) and w ~ N(0, 1/d): the scale of the activations the
    moe path feeds K2 and of its expert weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((E, C, d), generator=g, device="cuda")
    w = torch.randn((E, d, f), generator=g, device="cuda") / math.sqrt(d)
    return x.to(dtype), w.to(dtype)


def gmm_bound(E, C, d, f, dtype):
    """(ms, "bytes" | "operations"): the least time an H100 could take
    for (E, C, d) x (E, d, f). Operations are every slot's multiply-adds
    (the moe path computes every capacity slot, empty or not); bytes read
    x and w once and write the output once."""
    ops = 2 * E * C * d * f
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * E * (C * d + d * f + C * f)
    peak = H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def gmm_rows_bound(rows: torch.Tensor, C, d, f, dtype):
    """(bytes ms, operations ms) an H100 needs at least for one K2 launch
    with ``rows`` (E,): the weights of the experts with rows[e] > 0,
    x's rows below rows[e], all of o written once; 2 rows[e] d f
    operations per expert."""
    r = rows.clamp(0, C).double()
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * ((r > 0).sum() * d * f + r.sum() * d + r.numel() * C * f)
    peak = H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    return (float(nbytes) / H100_BYTES_PER_S * 1e3,
            float(2 * r.sum() * d * f) / peak * 1e3)


def gmm_rows(kind, E, C, seed=0):
    """(E,) int32 rows on the card: "decode" gives 15 experts 1-4 rows
    and the rest 0, as a decode step of 4 tokens at top-4 does; "ragged"
    draws from [0, C] with rows[0] = 0 and rows[-1] = C; "zero" and
    "full" are all 0 and all C."""
    g = torch.Generator().manual_seed(seed)
    if kind == "decode":
        r = torch.zeros(E, dtype=torch.int32)
        m = min(15, E)
        r[torch.randperm(E, generator=g)[:m]] = torch.randint(
            1, min(4, C) + 1, (m,), generator=g, dtype=torch.int32)
    elif kind == "ragged":
        r = torch.randint(0, C + 1, (E,), generator=g, dtype=torch.int32)
        r[0], r[-1] = 0, C
    else:
        r = torch.full((E,), 0 if kind == "zero" else C, dtype=torch.int32)
    return r.cuda()


def moe_rows(cfg, B, S):
    """Rows G*C of K2's (E, G*C, d) operands in a prefill of B x S
    tokens (S = 1: a decode step), as ``moe_apply`` sizes them."""
    from repro_torch.models.moe import _n_groups, capacity

    G = _n_groups(B)
    return G * capacity(cfg, B * S // G)


def tensors(tree) -> list:
    """The tensors of a cache or state: a tensor, or a tuple or dict of
    them, nested."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in (tree.values() if isinstance(tree, dict) else tree)
            for t in tensors(v)]


def prefill_attention(cfg, B=4, S=500):
    """K1's (B, Sq, Sk, H, Hkv, hd, causal) in a prefill of B x S text
    tokens (a vlm's patch embeddings come first)."""
    S += cfg.n_patches if cfg.family == "vlm" else 0
    return (B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, True)


def attention_layers(cfg) -> int:
    """Full-sequence attentions per forward: one a layer, Zamba2's shared
    block once per application, none in xLSTM."""
    from repro_torch.models.stacks import n_attn_applications

    return {"hybrid": n_attn_applications(cfg), "ssm": 0}.get(
        cfg.family, cfg.n_layers)


def engine_bounds(cfg, B, S, max_seq):
    """Least fp32 times for the full-width engine run: the prefill's
    multiply-adds at the fp32 peak, and one decode step's bytes at HBM
    rate: every weight and the whole KV cache or recurrent state read
    once, but of an untied embedding table only the rows the step
    gathers (a tied table is read whole by the unembed).

    The prefill counts every weight but the embedding once per position
    (Zamba2's shared block once per application; a vlm's patches are
    positions), the unembed, and causal attention; not the SSD's
    quadratic chunk sums. For the moe family the routed experts count as
    the path computes them, over all G*C capacity slots, empty or not;
    ``prefill_active_bound_ms`` counts them at top-k per token instead."""
    from repro_torch import build_model

    V, d, L = cfg.vocab_padded, cfg.d_model, cfg.n_layers
    K = cfg.n_codebooks if cfg.family == "audio" else 1
    body = cfg.param_count() - K * V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "hybrid":   # the shared block runs once per application
        shared = cfg.param_count() - cfg.replace(
            hybrid_attn_every=0).param_count()
        body += (attention_layers(cfg) - 1) * shared
    T = prefill_attention(cfg, B, S)[1]
    attn = (4 * B * cfg.n_heads * cfg.d_head * T * (T + 1) // 2
            * attention_layers(cfg))
    cache = sum(x.numel() for x in tensors(
        build_model(cfg).init_cache(B, max_seq, device="meta")))
    out = {}
    if cfg.family == "moe":
        expert = 3 * d * cfg.d_expert
        dense = body - L * cfg.n_experts * expert
        prefill_ops = (2 * B * S * (dense + d * V) + attn
                       + 2 * L * cfg.n_experts * moe_rows(cfg, B, S) * expert)
        active_ops = (2 * B * S * (dense + L * cfg.n_experts_per_tok * expert
                                   + d * V) + attn)
        out["prefill_active_bound_ms"] = active_ops / H100_FP32_FLOPS * 1e3
    else:
        prefill_ops = 2 * B * T * (body + K * d * V) + attn
    out["prefill_bound_ms"] = prefill_ops / H100_FP32_FLOPS * 1e3
    weights = cfg.param_count() - (0 if cfg.tie_embeddings
                                   else K * (V - B) * d)
    out["decode_step_bound_ms"] = (4 * (weights + cache)
                                   / H100_BYTES_PER_S * 1e3)
    return out


def kernel_phase(fa, gm, ref, cfgs) -> None:
    """K1 and K2 against their plain versions; ``cfgs`` maps each served
    config's name to it (their prefill shapes are K1's cases)."""
    moe_cfg, zamba_cfg = cfgs["qwen2-moe-a2.7b"], cfgs["zamba2-7b"]
    # (B, Sq, Sk, H, Hkv, hd, causal): serving shape, ragged, the moe
    # prefill's shape, wide head, Sq != Sk (bottom-right diagonal),
    # non-causal ragged; then S off every query and key tile, Sq < Sk
    # off the tiles, GQA groups 1, 7 and 8; then Zamba2's prefill (hd
    # 112) and hd 112 off the tiles, Sq < Sk and non-causal; then the
    # internvl2-1b and musicgen-large prefills
    cases = [
        (4, 512, 512, 14, 2, 64, True),
        (4, 500, 500, 14, 2, 64, True),
        prefill_attention(moe_cfg),
        (2, 384, 384, 8, 2, 128, True),
        (2, 128, 384, 14, 2, 64, True),
        (2, 200, 200, 8, 2, 64, False),
        (1, 17, 17, 4, 4, 128, True),
        (2, 127, 127, 7, 1, 64, True),
        (1, 129, 129, 8, 1, 128, True),
        (2, 129, 127, 8, 8, 64, False),
        (2, 127, 500, 7, 1, 128, True),
        (1, 1, 500, 8, 1, 64, True),
        prefill_attention(zamba_cfg),
        (1, 17, 17, 4, 4, 112, True),
        (2, 127, 500, 7, 1, 112, True),
        (2, 129, 127, 8, 8, 112, False),
        prefill_attention(cfgs["internvl2-1b"]),
        prefill_attention(cfgs["musicgen-large"]),
    ]
    checks = [(c, dtype, tol, 1) for c in cases for dtype, tol in
              ((torch.float32, 2e-5), (torch.bfloat16, 2e-2))]
    # q scaled by 8 (logits x8, a peaked softmax), fp32 at the dense, moe
    # and Zamba2 prefill shapes: plain TF32 is 1e-2 off here, so the
    # small parts of 3xTF32 decide. The plain version in fp32 is itself
    # up to 2.6e-5 off the exact result here (its q k^T is an fp32 sum of
    # logits x8), so K1 is held to the plain version computed in float64
    # on the same inputs; its distance to the fp32 plain version is
    # printed beside. (In bf16 the plain version rounds the scores to
    # bf16.)
    checks += [(c, torch.float32, 2e-5, 8) for c in
               (cases[1], cases[2], prefill_attention(zamba_cfg))]
    for i, ((B, Sq, Sk, H, Hkv, hd, causal), dtype, tol, scale) in \
            enumerate(checks):
        q, k, v = attention_inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed=i)
        q = q * scale
        out = fa.flash_attention(q, k, v, causal=causal).float()
        want = ref.gqa_attention_ref(q, k, v, causal=causal).float()
        note = ""
        if scale != 1:
            fp32 = want
            want = ref.gqa_attention_ref(q.double(), k.double(), v.double(),
                                         causal=causal).float()
            note = (f" q x{scale}, held to the plain version in float64; "
                    f"to the fp32 plain version "
                    f"{(out - fp32).abs().max().item():.3e}, which is "
                    f"{(fp32 - want).abs().max().item():.3e} from float64")
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        ok = torch.allclose(out, want, rtol=tol, atol=tol)
        print(f"kernel flash_attention B={B} Sq={Sq} Sk={Sk} H={H} "
              f"Hkv={Hkv} hd={hd} causal={causal} {dtype}: "
              f"max|d|={err:.3e} tol={tol:g}{note} {'ok' if ok else 'FAIL'}")
        check(bool(torch.isfinite(out).all()) and ok,
              f"flash_attention disagrees with its plain version "
              f"(case {i}, {dtype}, q x{scale})")

    # (E, C, d, f): the moe path's prefill gate/up and down and its
    # decode step, the reference's sweep (ragged edges), one element
    E, d, d_e = moe_cfg.n_experts, moe_cfg.d_model, moe_cfg.d_expert
    pre, dec = moe_rows(moe_cfg, 4, 500), moe_rows(moe_cfg, 4, 1)
    cases = [(E, pre, d, d_e), (E, pre, d_e, d), (E, dec, d, d_e),
             (4, 128, 256, 128), (2, 64, 512, 96), (6, 100, 300, 130),
             (1, 1, 1, 1)]
    for i, (E_, C, d_, f) in enumerate(cases):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            x, w = gmm_inputs(E_, C, d_, f, dtype, seed=100 + i)
            out = gm.grouped_matmul(x, w)
            want = ref.grouped_matmul_ref(x, w)
            torch.cuda.synchronize()
            out, want = out.float(), want.float()
            err = (out - want).abs().max().item()
            ok = out.shape == (E_, C, f) and torch.allclose(
                out, want, rtol=tol, atol=tol)
            print(f"kernel grouped_matmul E={E_} C={C} d={d_} f={f} {dtype}: "
                  f"max|d|={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
            check(bool(torch.isfinite(out).all()) and ok,
                  f"grouped_matmul disagrees with its plain version "
                  f"(case {i}, {dtype})")

    # the same with rows: x zero past rows[e], as the moe path packs it;
    # the rows past rows[e] must come out exactly 0
    cases = [((E, dec, d, d_e), "decode"), ((E, dec, d_e, d), "decode"),
             ((E, pre, d, d_e), "ragged"), ((E, pre, d_e, d), "ragged"),
             ((E, dec, d, d_e), "zero"), ((E, pre, d_e, d), "zero"),
             ((E, dec, d, d_e), "full"), ((E, pre, d, d_e), "full"),
             ((4, 128, 256, 128), "ragged"), ((2, 64, 512, 96), "ragged"),
             ((6, 100, 300, 130), "ragged"), ((6, 20, 300, 130), "ragged"),
             ((2, 1, 1, 1), "ragged")]
    for i, ((E_, C, d_, f), kind) in enumerate(cases):
        rows = gmm_rows(kind, E_, C, seed=i)
        live = torch.arange(C, device="cuda") < rows[:, None]
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            x, w = gmm_inputs(E_, C, d_, f, dtype, seed=200 + i)
            x = torch.where(live[..., None], x, 0)
            out = gm.grouped_matmul(x, w, rows)
            want = ref.grouped_matmul_ref(x, w, rows)
            torch.cuda.synchronize()
            out, want = out.float(), want.float()
            err = (out - want).abs().max().item()
            ok = out.shape == (E_, C, f) and torch.allclose(
                out, want, rtol=tol, atol=tol) and not out[~live].any()
            print(f"kernel grouped_matmul E={E_} C={C} d={d_} f={f} rows="
                  f"{kind} (sum {int(rows.sum())}, {int((rows > 0).sum())} "
                  f"experts) {dtype}: max|d|={err:.3e} tol={tol:g} "
                  f"{'ok' if ok else 'FAIL'}")
            check(bool(torch.isfinite(out).all()) and ok,
                  f"grouped_matmul with rows disagrees with its plain "
                  f"version (case {i}, {kind}, {dtype})")


@torch.inference_mode()
def greedy_trace(model, params, prompt: np.ndarray, n: int, device: str):
    """Last-position prefill logits, greedy tokens and each step's top-2
    logit margin (the least over an audio step's codebooks), through the
    model API, as ``ServeEngine`` drives it (a vlm with zero patch
    embeddings, decoding after them)."""
    cfg = model.cfg
    toks = torch.as_tensor(prompt, dtype=torch.long, device=device)
    S = toks.shape[-1]
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    batch = {"tokens": toks}
    if n_prefix:
        batch["patch_embeds"] = torch.zeros((1, n_prefix, cfg.d_model),
                                            device=device)
    cache = model.init_cache(1, n_prefix + S + n, device=device)
    logits, cache = model.prefill(params, batch, cache)
    first = logits[0, -1].float().cpu()
    last = logits[:, -1:]
    out, margins = [], []
    for i in range(n):
        top2 = last[0, 0].float().topk(2, dim=-1).values
        margins.append(float((top2[..., 0] - top2[..., 1]).min()))
        nxt = last.argmax(dim=-1)               # (1, 1) | (1, 1, K)
        if cfg.family == "audio":
            nxt = nxt.movedim(-1, 1)            # (1, K, 1)
        out.append(nxt.flatten().tolist())
        last, cache = model.decode_step(
            params, cache, {"tokens": nxt, "cache_index": n_prefix + S + i})
    return first, out, margins


def compare_card_cpu(g_trace, c_trace, n: int) -> None:
    """Last-position prefill logits to 1e-3; greedy tokens equal up to
    the first CPU step whose top-2 logit margin is below 1e-4."""
    (g_first, g_toks, _), (c_first, c_toks, margins) = g_trace, c_trace
    err = (g_first - c_first).abs().max().item()
    print(f"prefill last-position logits, card vs CPU: max|d|={err:.3e} "
          f"(limit 1e-3)")
    check(math.isfinite(err) and err <= 1e-3,
          "card and CPU prefill logits disagree")
    close = next((i for i, m in enumerate(margins) if m < 1e-4), n)
    matched = next((i for i in range(n) if g_toks[i] != c_toks[i]), n)
    print(f"greedy tokens, card vs CPU: {matched}/{n} steps match; first "
          f"CPU top-2 margin < 1e-4 at step {close}")
    check(matched >= close, "greedy tokens diverge before a near-tie")


def serve(eng, cfg, counters, watch=contextlib.nullcontext(), n_new=64):
    """The main path: warm up, then 4 prompts x 500 tokens (an audio
    model's 4 x K x 500) and ``n_new`` greedy tokens through
    ``ServeEngine.generate`` inside ``watch``, every kernel's launch count
    set to 0 just before and read just after. Returns the prompts, the
    counts by kernel and the engine's numbers."""
    rng = np.random.default_rng(0)
    K = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    eng.generate(rng.integers(0, cfg.vocab_size, (1, *K, 16)), n_new=2)
    prompts = rng.integers(0, cfg.vocab_size, (4, *K, 500))
    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.launches = 0
    with watch:
        res = eng.generate(prompts, n_new=n_new)
    launches = {mod.__name__.rsplit(".", 1)[-1]: mod.launches
                for mod in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{cfg.name} main path kernel launches: {json.dumps(launches)} "
          f"(n_layers={cfg.n_layers})")
    check(res.tokens.shape == (4, *K, n_new) and res.tokens.min() >= 0
          and res.tokens.max() < cfg.vocab_size, "generated tokens malformed")
    engine = {"model": cfg.name, "batch": 4, "prompt": 500, "n_new": n_new,
              "prefill_ms": res.prefill_s * 1e3,
              "decode_tokens_per_s": res.tokens_per_s,
              "decode_step_ms": res.decode_s / n_new * 1e3,
              "peak_device_gb": peak_gb,
              **engine_bounds(cfg, 4, 500, 1024)}
    return prompts, launches, engine


@contextlib.contextmanager
def in_path(fa, gm, model, tally: dict):
    """While active, K1's and K2's launches are tallied by kernel, phase
    and shape in ``tally[(kernel, phase, shape)] = [launches, device ms,
    rows]``: the phase is "prefill" until ``model``'s first
    ``decode_step`` and "decode" after it; K1's shape is (B, Sq, Sk, H,
    Hkv, hd), K2's (E, C, d, f). A launch's device time is read from CUDA
    events recorded on the stream just before and just after it, and
    ``rows`` stacks each K2 launch's ``rows`` (read after the run, not
    during it; None for K1). The wrappers' own counts are left as they
    are."""
    real_fa, real_gm = fa._launch, gm._launch
    phase, events = ["prefill"], []

    def timed(name, shape, rows, run):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        o = run()
        end.record()
        events.append((name, phase[0], shape, start, end, rows))
        return o

    def fa_launch(q, k, v, causal):
        shape = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3])
        return timed("flash_attention", shape, None,
                     lambda: real_fa(q, k, v, causal))

    def gm_launch(x, w, rows=None):
        return timed("grouped_matmul", (*x.shape, w.shape[2]), rows,
                     lambda: real_gm(x, w, rows))

    def decode_step(*args, **kw):
        phase[0] = "decode"
        return type(model).decode_step(model, *args, **kw)

    fa._launch, gm._launch, model.decode_step = fa_launch, gm_launch, \
        decode_step
    try:
        yield
    finally:
        fa._launch, gm._launch = real_fa, real_gm
        del model.decode_step
    torch.cuda.synchronize()
    rows_by_key: dict = {}
    for name, ph, shape, start, end, rows in events:
        key = (name, ph, shape)
        n_ms = tally.setdefault(key, [0, 0.0, None])
        n_ms[0] += 1
        n_ms[1] += start.elapsed_time(end)
        if name == "grouped_matmul":
            rows_by_key.setdefault(key, []).append(rows)
    for key, rows in rows_by_key.items():
        check(all(r is not None for r in rows),
              f"a moe K2 launch at {key} had no rows")
        tally[key][2] = torch.stack(rows).cpu()


def check_k1_in_path(cfg, tally: dict) -> None:
    """One K1 launch per full-sequence attention (``attention_layers``),
    all in the prefill, at its serving shape; none without attention."""
    n = attention_layers(cfg)
    want = {("flash_attention", "prefill", prefill_attention(cfg)[:6]): n
            } if n else {}
    got = {k: n for k, (n, _, _) in tally.items() if k[0] == "flash_attention"}
    check(got == want, f"{cfg.name} K1 launches by phase and shape {got}, "
          f"want {want}")


def draw_on_card(cfg):
    """Random fp32 weights drawn on the card from a CUDA generator seeded
    0 (the host draws billions of parameters too slowly)."""
    from repro_torch import build_model

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name} init (full width, {cfg.n_layers} layers, {n_params} "
          f"params, fp32, drawn on the card): "
          f"{time.perf_counter() - t0:.1f} s")
    return params


def moe_engine_phase(fa, gm, cfg):
    """Full-width, full-depth moe serving on the card, weights drawn on
    the card. Returns K1's and K2's launches and in-path device time by
    phase and shape, and the engine's numbers, all from the main path's
    run."""
    from repro_torch import ServeEngine

    eng = ServeEngine(cfg, params=draw_on_card(cfg), max_seq=1024,
                      device="cuda")
    tally: dict = {}
    _, launches, engine = serve(eng, cfg, (fa, gm),
                                in_path(fa, gm, eng.model, tally))
    L, want = cfg.n_layers, 3 * cfg.n_layers * (1 + 64)
    check(launches["flash_attention"] == L,
          f"moe prefill made {launches['flash_attention']} flash_attention "
          f"launches, want {L}")
    check(launches["grouped_matmul"] == want,
          f"moe generate made {launches['grouped_matmul']} grouped_matmul "
          f"launches, want 3 * {L} * (1 + 64) = {want}")
    check_k1_in_path(cfg, tally)
    # gate and up run at (E, G*C, d) x (E, d, d_e), down at
    # (E, G*C, d_e) x (E, d_e, d), once per layer per forward
    E, d, d_e = cfg.n_experts, cfg.d_model, cfg.d_expert
    want_tally = {}
    for phase, C, steps in (("prefill", moe_rows(cfg, 4, 500), 1),
                            ("decode", moe_rows(cfg, 4, 1), 64)):
        want_tally[(phase, (E, C, d, d_e))] = 2 * L * steps
        want_tally[(phase, (E, C, d_e, d))] = L * steps
    k2 = {(ph, s): v for (name, ph, s), v in tally.items()
          if name == "grouped_matmul"}
    got = {k: n for k, (n, _, _) in k2.items()}
    print("moe main path K2 launches by phase and (E, C, d, f): "
          + json.dumps({f"{ph} {list(s)}": n for (ph, s), n in got.items()}))
    check(got == want_tally, f"moe K2 launches by phase and shape {got}, "
          f"want {want_tally}")
    engine["k2_in_path_ms"] = {
        phase: sum(ms for (ph, _), (_, ms, _) in k2.items() if ph == phase)
        for phase in ("prefill", "decode")}
    for (ph, shape), (_, _, rows) in k2.items():
        active = (rows > 0).sum(dim=1).double()
        print(f"moe {ph} K2 {list(shape)} rows per launch: mean active "
              f"experts {float(active.mean()):.4f} (max {int(active.max())}),"
              f" mean occupied rows {float(rows.sum(dim=1).double().mean()):.4f}"
              f" of {shape[0] * shape[1]}")
        if ph == "decode":
            check(int(active.max()) <= 16,
                  "a decode K2 launch had more than 16 active experts")
    print("moe engine: " + json.dumps(engine))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return tally, engine


def family_engine_phase(fa, gm, cfg, n_new: int):
    """Full-width, full-depth serving of a model without experts on the
    card, weights drawn on the card: one K1 launch per full-sequence
    attention of the prefill (one a layer, 13 for Zamba2's shared block,
    none for xLSTM), none in decode, no K2. Returns K1's launches and
    in-path device time by phase and shape, and the engine's numbers, all
    from the main path's run."""
    from repro_torch import ServeEngine

    eng = ServeEngine(cfg, params=draw_on_card(cfg), max_seq=1024,
                      device="cuda")
    tally: dict = {}
    _, launches, engine = serve(eng, cfg, (fa, gm),
                                in_path(fa, gm, eng.model, tally), n_new)
    n = attention_layers(cfg)
    check(launches["flash_attention"] == n,
          f"{cfg.name} prefill made {launches['flash_attention']} "
          f"flash_attention launches, want {n}")
    check(launches["grouped_matmul"] == 0, f"the {cfg.name} path ran K2")
    check_k1_in_path(cfg, tally)
    engine["k1_in_path_ms"] = sum(ms for (name, _, _), (_, ms, _)
                                  in tally.items() if name == "flash_attention")
    print(f"{cfg.name} engine: " + json.dumps(engine))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return tally, engine


def card_vs_cpu(cfg, cut: dict, S: int, n: int = 16) -> None:
    """The path on the card against the port's CPU path at full width,
    cut to ``cut`` (fewer layers, or nothing), on one set of weights drawn
    from a CPU generator and copied: a 1 x S prompt (an audio model's
    1 x K x S) and ``n`` greedy tokens."""
    from repro_torch import build_model

    cfg = cfg.replace(**cut)
    model = build_model(cfg)
    t0 = time.perf_counter()
    cpu_params = model.init(torch.Generator().manual_seed(0), device="cpu")
    gpu_params = type(cpu_params)(cfg, device="cuda")
    gpu_params.load_state_dict(cpu_params.state_dict())
    n_params = sum(p.numel() for p in cpu_params.parameters())
    print(f"{cfg.name} card vs CPU: {cfg.n_layers} layers, {n_params} params "
          f"drawn on the CPU and copied: {time.perf_counter() - t0:.1f} s")
    K = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, *K, S))
    compare_card_cpu(greedy_trace(model, gpu_params, prompt, n, "cuda"),
                     greedy_trace(model, cpu_params, prompt, n, "cpu"), n)
    del gpu_params
    torch.cuda.empty_cache()


@contextlib.contextmanager
def router_gaps(gaps: list):
    """While active, every moe layer appends the smallest gap between
    its tokens' k-th and (k+1)-th router probabilities to ``gaps``: a
    gap near 0 is a top-k choice that rounding can flip."""
    from repro_torch.models import moe, transformer

    real = transformer.moe_apply

    def recording(p, cfg, x, *args, **kw):
        gaps.append(moe.topk_gap(p, cfg, x))
        return real(p, cfg, x, *args, **kw)

    transformer.moe_apply = recording
    try:
        yield
    finally:
        transformer.moe_apply = real


def moe_card_vs_cpu(cfg, n_layers: int = 2, n: int = 16) -> None:
    """The moe path on the card against the port's CPU path at full
    width and ``n_layers`` layers, on one set of weights drawn from a
    CPU generator. A 1 x 256 prompt (Tg = 256 > 128, so tokens can drop)
    and ``n`` greedy tokens; a prompt whose CPU routing has a top-k gap
    below 1e-6 is swapped for the next seed (at most 3)."""
    from repro_torch import build_model
    from repro_torch.models import transformer

    cfg = cfg.replace(n_layers=n_layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    cpu_params = model.init(torch.Generator().manual_seed(0), device="cpu")
    gpu_params = transformer.Transformer(cfg, device="cuda")
    gpu_params.load_state_dict(cpu_params.state_dict())
    n_params = sum(p.numel() for p in cpu_params.parameters())
    print(f"moe card vs CPU: {n_layers} layers, {n_params} params drawn on "
          f"the CPU and copied: {time.perf_counter() - t0:.1f} s")
    for seed in range(3):
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (1, 256))
        gaps: list = []
        with router_gaps(gaps):
            c_trace = greedy_trace(model, cpu_params, prompt, n, "cpu")
        print(f"prompt seed {seed}: smallest CPU router gap between choices "
              f"k and k+1 over {len(gaps)} layer calls: {min(gaps):.3e}")
        if min(gaps) >= 1e-6:
            break
    print(f"moe card vs CPU holds prompt seed {seed}")
    compare_card_cpu(greedy_trace(model, gpu_params, prompt, n, "cuda"),
                     c_trace, n)
    del gpu_params
    torch.cuda.empty_cache()


def device_kernels(fn, top: int = 3) -> dict:
    """The kernels one call of ``fn`` runs on the card, from a
    torch.profiler trace of it: how many, and the names of the ``top``
    longest (or why there is no trace)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as err:   # the trace is a label, not a check
        return {"count": None, "longest": [f"not traced: {err}"]}
    ran = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.time_range.elapsed_us())
    return {"count": len(ran), "longest": [e.name[:120] for e in ran[:top]]}


def k1_row(fa, ref, model, shape, dtype, tally=None):
    """K1 timed at (B, Sq, Sk, H, Hkv, hd, causal) in ``dtype`` beside its
    bounds, its plain version and SDPA (with the kernels SDPA ran), and
    its launches and device time per launch in the main run's ``tally``
    (0 launches without one)."""
    import torch.nn.functional as F

    B, Sq, Sk, H, Hkv, hd, causal = shape
    q, k, v = attention_inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed=99)
    err = (fa.flash_attention(q, k, v, causal=causal).float()
           - ref.gqa_attention_ref(q, k, v, causal=causal).float()
           ).abs().max().item()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    launches, in_path_ms = (tally or {}).get(
        ("flash_attention", "prefill", shape[:6]), (0, 0.0, None))[:2]
    row = {
        "name": "flash_attention",
        "model": model,
        "shape": list(shape[:6]),
        "dtype": str(dtype).replace("torch.", ""),
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "products": ("3xTF32 mma.sync" if dtype == torch.float32
                     else "bf16 mma.sync"),
        "launches": launches,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
        "plain_ms": cuda_ms(
            lambda: ref.gqa_attention_ref(q, k, v, causal=causal)),
        **attention_bound(*shape, dtype),
        "library_ms": cuda_ms(sdpa),
        "library_kernels": device_kernels(sdpa),
    }
    if launches:
        row["in_path_ms"] = in_path_ms / launches
    return row


def timing_phase(fa, gm, ref, tallies, cfgs):
    """The ``kernels`` line: K1 at the prefill shape of every served model
    that has attention (qwen2-0.5b, qwen2-moe-a2.7b, zamba2-7b,
    internvl2-1b, musicgen-large) and K2 at each of the moe path's four
    shapes, fp32 (the main paths' dtype), each with its launches on its
    model's main path and its device time per launch in that run
    (``in_path_ms``). K2's ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are the dense product (no rows), like for like with
    ``torch.bmm``. A K2 row also carries, per launch of the main run: its
    time alone with the run's rows (``in_path_alone_ms``), the least time
    those rows need (``in_path_bound_ms``), and the mean active experts
    and rows. K1 in bf16 (no launch on the main path) is printed on
    lines of its own."""
    moe_cfg = cfgs["qwen2-moe-a2.7b"]
    moe_tally = tallies[moe_cfg.name]
    kernels = [k1_row(fa, ref, name, prefill_attention(cfgs[name]),
                      torch.float32, tallies[name])
               for name in ("qwen2-0.5b", moe_cfg.name, "zamba2-7b",
                            "internvl2-1b", "musicgen-large")]
    for name in ("qwen2-0.5b", moe_cfg.name, "zamba2-7b"):
        print("kernel timing, bf16 (not the main path's dtype): "
              + json.dumps(k1_row(fa, ref, name, prefill_attention(cfgs[name]),
                                  torch.bfloat16)))

    for (kernel, phase, shape), (n, in_path_ms, rows) in moe_tally.items():
        if kernel != "grouped_matmul":
            continue
        E, C, d, f = shape
        x, w = gmm_inputs(E, C, d, f, torch.float32, seed=98)
        err = (gm.grouped_matmul(x, w)
               - ref.grouped_matmul_ref(x, w)).abs().max().item()
        bound_ms, bound_by = gmm_bound(E, C, d, f, torch.float32)
        # the main run's rows: each launch's bound, and K2 alone cycling
        # through the first 50 launches' rows
        per_launch = [gmm_rows_bound(r, C, d, f, torch.float32) for r in rows]
        t_bytes = sum(b for b, _ in per_launch) / n
        t_ops = sum(o for _, o in per_launch) / n
        some = itertools.cycle([r.cuda() for r in rows[:50]])
        kernels.append({
            "name": "grouped_matmul",
            "model": moe_cfg.name,
            "phase": phase,
            "shape": [E, C, d, f],
            "dtype": "float32",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:21",
            "launches": n,
            "in_path_ms": in_path_ms / n,
            "in_path_alone_ms": cuda_ms(
                lambda: gm.grouped_matmul(x, w, next(some))),
            "in_path_bound_ms": sum(max(b, o) for b, o in per_launch) / n,
            "in_path_bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "mean_active_experts": float((rows > 0).sum(dim=1).double().mean()),
            "mean_rows": float(rows.sum(dim=1).double().mean()),
            "max_abs_err": err,
            "ms": cuda_ms(lambda: gm.grouped_matmul(x, w)),
            "plain_ms": cuda_ms(lambda: ref.grouped_matmul_ref(x, w)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": cuda_ms(lambda: torch.bmm(x, w)),
        })
    return kernels


# The fluid simulator on the card against the same call on the CPU: the
# relative tolerance of tests/test_torch_sim.py (REL_TOL), where the port
# equals the reference bit for bit.
SIM_REL_TOL = 0.0
# Events per cell of the fleet phase's traced warm-up call.
TRACE_EVENTS = 128


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def train_step_trace(cfg, state, B: int, S: int) -> dict:
    """One more training step of ``state``, traced by ``torch.profiler``
    after an untraced one: host ms, device busy ms, idle share, kernels
    and the longest kernels by name."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from profile_engine import traced
    from repro_torch import build_model
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step

    step = make_train_step(build_model(cfg), peak_lr=1e-3, warmup=2)
    data = SyntheticLMData(cfg, B, S, seed=1)
    batches = [{k: torch.from_numpy(v).to("cuda", torch.long)
                for k, v in data.sample(i).items()} for i in range(2)]
    step(state, batches[0])
    torch.cuda.synchronize()
    return traced(lambda: step(state, batches[1]))


def train_phase(fa, gm, cfg) -> dict:
    """Trains full-width ``cfg`` (qwen2-0.5b) on the card through
    ``train()``: fp32, TF32 off, remat on, batch 8 x 256 tokens of
    ``SyntheticLMData``, 10 steps with a 2-step warm-up. Checks that the
    loss falls and that no K1 or K2 launch happened (training takes the
    reference's routes: the kernels have no backward). Then, at the
    same width cut to 2 layers: 3 steps on the card against 3 on the
    CPU from the same weights (a CPU generator), and 6 steps against 3 +
    checkpoint + resume + 3 on the card."""
    from repro_torch.train import TrainConfig, train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, steps = 8, 256, 10
    fa.launches = gm.launches = 0
    out = train(cfg, TrainConfig(steps=steps, batch=B, seq=S, peak_lr=1e-3,
                                 warmup=2, log_every=1, device="cuda"))
    launches = {"flash_attention": fa.launches,
                "grouped_matmul": gm.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = sum(p.numel() for p in out["state"]["params"].parameters())
    losses = out["losses"]
    check(launches == {"flash_attention": 0, "grouped_matmul": 0},
          f"training launched a kernel: {launches}")
    check(np.isfinite(losses).all(), f"non-finite training loss {losses}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.1,
          f"the loss did not fall: {losses}")
    ms = 1e3 * np.array(out["step_s"][1:])
    T = B * S
    trace = train_step_trace(cfg, out["state"], B, S)
    report = {
        "model": cfg.name, "params": n, "batch": B, "seq": S,
        "steps": steps, "losses": losses,
        "first_step_ms": 1e3 * out["step_s"][0],
        "step_ms_median": float(np.median(ms)),
        "step_ms_min": float(ms.min()), "step_ms_max": float(ms.max()),
        "tokens_per_s": T / float(np.median(ms)) * 1e3,
        "peak_gb": peak_gb,
        "bound_6NT_ms": 6 * n * T / H100_FP32_FLOPS * 1e3,
        "bound_8NT_remat_ms": 8 * n * T / H100_FP32_FLOPS * 1e3,
        "kernel_launches": launches,
        "trace_one_step": trace,
    }
    del out
    gc.collect()
    torch.cuda.empty_cache()

    cut = cfg.replace(n_layers=2)
    quiet = dict(log_fn=lambda *_: None)
    tc = dict(steps=3, batch=4, seq=128, peak_lr=1e-3, warmup=1,
              log_every=100)
    t0 = time.perf_counter()
    card = train(cut, TrainConfig(device="cuda", **tc), **quiet)["losses"]
    t1 = time.perf_counter()
    cpu = train(cut, TrainConfig(device="cpu", **tc), **quiet)["losses"]
    t2 = time.perf_counter()
    report["card_vs_cpu"] = {"layers": 2, "batch": 4, "seq": 128,
                             "card": card, "cpu": cpu,
                             "max_rel": max_rel(card, cpu),
                             "rtol": TRAIN_CARD_CPU_RTOL,
                             "card_s": t1 - t0, "cpu_s": t2 - t1}
    check(report["card_vs_cpu"]["max_rel"] <= TRAIN_CARD_CPU_RTOL,
          f"training losses, card {card} vs CPU {cpu}")

    tc = dict(batch=B, seq=S, peak_lr=1e-3, warmup=2, log_every=100,
              device="cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        full = train(cut, TrainConfig(steps=6, **tc), **quiet)["losses"]
        train(cut, TrainConfig(steps=3, ckpt_dir=d, ckpt_every=3, **tc),
              **quiet)
        resumed = train(cut, TrainConfig(steps=6, ckpt_dir=d, ckpt_every=3,
                                         **tc), **quiet)["losses"]
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                         if f.is_file())
    report["resume"] = {"layers": 2, "full": full[3:], "resumed": resumed,
                        "max_rel": max_rel(resumed, full[3:]),
                        "rtol": RESUME_RTOL, "ckpt_bytes": ckpt_bytes,
                        "s": time.perf_counter() - t0}
    check(len(resumed) == 3 and report["resume"]["max_rel"] <= RESUME_RTOL,
          f"resumed losses {resumed} vs {full[3:]}")
    print("train: " + json.dumps(report))
    gc.collect()
    torch.cuda.empty_cache()
    return report


def control_plane_phase() -> dict:
    """The serving control plane (``serve.session``; the NPU simulated on
    the host): qwen3-14b decode next to qwen2-0.5b prefill in closed loop
    under every policy, then an open-loop session in which the second
    tenant registers mid-run with a 1 ms p95 SLO, the autoscaler grows
    it and it deregisters while the first still serves. The second
    tenant's load (10 requests/s) is one its vNPU can finish in the
    window, so every submitted request completes."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.policies import available_policies
    from repro_torch.npu.trace import lm_trace
    from repro_torch.serve import (NPUCluster, PoissonArrivals,
                                   SLOAutoscaler, ServingSession,
                                   run_closed_loop)

    t0 = time.perf_counter()
    llm = lm_trace(ARCHS["qwen3-14b"], batch=8, seq=2048, phase="decode")
    small = lm_trace(ARCHS["qwen2-0.5b"], batch=8, seq=512, phase="prefill")

    def row(r):
        return {"p95_ms": r.p95_ms, "throughput_rps": r.throughput_rps,
                "requests_done": r.requests_done}

    closed = {}
    for policy in available_policies():
        cluster = NPUCluster(policy=policy)
        cluster.register("qwen3-14b/decode", llm, eu_budget=4)
        cluster.register("qwen2-0.5b/prefill", small, eu_budget=4)
        _, reports = run_closed_loop(cluster, n_requests=5)
        closed[policy] = {r.name: row(r) for r in reports}
        check(all(r.requests_done >= 5 for r in reports),
              f"closed loop under {policy}: {closed[policy]}")

    sess = ServingSession(NPUCluster(policy="neu10"),
                          autoscaler=SLOAutoscaler(max_eus=6))
    t_llm = sess.register("qwen3-14b/decode", llm, eu_budget=4)
    sess.submit_arrivals(t_llm, PoissonArrivals(rate_rps=6.0, n=120, seed=0))
    sess.run_until(5.0)
    t_sm = sess.register("qwen2-0.5b/prefill", small, eu_budget=2,
                         slo_p95_ms=1.0)
    n_sm = sess.submit_arrivals(t_sm, PoissonArrivals(
        rate_rps=10.0, n=50, seed=1, start_s=sess.now_s))
    before = t_sm.eu_budget
    sess.run_until(sess.now_s + 5.0)
    sess.run_until(sess.now_s + 5.0)   # a second window lets the hook act
    r_sm = sess.report(t_sm)[0]
    open_loop = {"small": dict(row(r_sm), eu_budget=[before, t_sm.eu_budget],
                               submitted=n_sm, deregistered_at_s=sess.now_s)}
    sess.deregister(t_sm)
    sess.drain()
    r_llm = sess.report(t_llm)[0]
    open_loop["llm"] = dict(row(r_llm), submitted=120, end_s=sess.now_s)
    check(r_sm.requests_done == n_sm and r_sm.queued == 0,
          f"the second tenant left requests unfinished: {open_loop}")
    check(r_llm.requests_done == 120, f"the LLM tenant: {open_loop}")
    check(t_sm.eu_budget > before, "the autoscaler did not grow the budget")
    report = {"closed_loop": closed, "open_loop": open_loop,
              "s": time.perf_counter() - t0}
    print("control plane: " + json.dumps(report))
    return report


def fleet_oracle(core, pairs, policy):
    """The port's discrete simulator on ``pairs`` of workload names at
    the half split of ``core`` (n_requests 4): (makespans, seconds spent
    in ``Simulator.run``)."""
    from repro_torch.core import (Simulator, TenantSpec, VNPUConfig,
                                  VNPUManager, compile_neuisa)
    from repro_torch.npu.workloads import get_workload

    out, seconds = [], 0.0
    for names in pairs:
        mgr = VNPUManager(core=core)
        specs = [TenantSpec(compile_neuisa(get_workload(n, core), core),
                            mgr.create(VNPUConfig(core.n_me // 2,
                                                  core.n_ve // 2,
                                                  hbm_bytes=1 << 30)), 4)
                 for n in names]
        t0 = time.perf_counter()
        out.append(Simulator(specs, policy=policy, core=core).run().makespan)
        seconds += time.perf_counter() - t0
    return out, seconds


def fleet_phase() -> dict:
    """The collocation grid of the fluid simulator on the card: all 78
    pairs of the 12 workloads (self-pairs included) x the 49 EU splits of
    an 8 ME / 8 VE core (each tenant >= 1 ME and >= 1 VE) x 5 HBM
    bandwidths, 4 requests per tenant, harvest off and on (2 x 19110
    cells). Holds the card against the same call on the CPU (events
    equal, floats within SIM_REL_TOL) and the half-split cells of three
    pairs on the default core against the port's discrete simulator in
    the bands of tests/test_sim_jax.py; times the card grid (3 calls),
    the CPU grid and the discrete simulator per cell. The warm-up is one
    cell, then the grid without harvest cut at TRACE_EVENTS events,
    traced by ``torch.profiler``: kernels per iteration and the device's
    idle share. Every op of the loop spans the whole grid, whether its cells
    still run or not, so each iteration launches the same kernels on the
    same widths as in the full call."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from profile_engine import traced
    from repro_torch.core import compile_neuisa, sim_torch
    from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig
    from repro_torch.npu.workloads import PAPER_PAIRS, WORKLOADS, get_workload

    core = NPUCoreConfig(n_me=8, n_ve=8)
    t0 = time.perf_counter()
    progs = {n: compile_neuisa(get_workload(n, core), core)
             for n in WORKLOADS}
    compile_s = time.perf_counter() - t0
    names = list(itertools.combinations_with_replacement(WORKLOADS, 2))
    pairs = [(progs[a], progs[b]) for a, b in names]
    splits = [((m, 8 - m), (v, 8 - v)) for m in range(1, 8)
              for v in range(1, 8)]
    bws = (0.5, 0.75, 1.0, 1.5, 2.0)
    n_cells = len(pairs) * len(splits) * len(bws)
    check(n_cells == 19110, f"fleet grid has {n_cells} cells, not 19110")

    def grid(device):
        """{harvest: leaves} and {harvest: loop iterations}."""
        out, iters = {}, {}
        for h in (False, True):
            sim_torch.iterations = 0
            out[h] = sim_torch.sweep_collocations(
                pairs, splits, bw_points=bws, n_requests=4, harvest=h,
                core=core, device=device)
            iters[h] = sim_torch.iterations
        if device == "cuda":
            torch.cuda.synchronize()
        return out, iters

    sim_torch.sweep_collocations(pairs[:1], splits[:1], n_requests=1,
                                 harvest=False, core=core, device="cuda")
    full_events, sim_torch.MAX_EVENTS = sim_torch.MAX_EVENTS, TRACE_EVENTS
    try:
        sim_torch.iterations = 0
        trace = traced(lambda: sim_torch.sweep_collocations(
            pairs, splits, bw_points=bws, n_requests=4, harvest=False,
            core=core, device="cuda"))
    finally:
        sim_torch.MAX_EVENTS = full_events
    trace.pop("top")
    trace["iterations"] = sim_torch.iterations
    trace["kernels_per_iteration"] = trace["kernels"] / trace["iterations"]
    card_s = []
    for _ in range(3):
        t1 = time.perf_counter()
        card, iterations = grid("cuda")
        card_s.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    cpu, _ = grid("cpu")
    cpu_s = time.perf_counter() - t1

    ev_diff, max_rel, stalled, max_ev = 0, 0.0, 0, 0
    for h in (False, True):
        g = {k: v.cpu() for k, v in card[h].items()}
        c = cpu[h]
        check(g["makespan"].shape == (len(pairs), len(splits), len(bws)),
              f"fleet grid shape {tuple(g['makespan'].shape)}")
        ev_diff += int((g["events"] != c["events"]).sum())
        for k in ("makespan", "throughput", "me_util", "ve_util"):
            check(bool(torch.isfinite(g[k]).all()), f"fleet {k} not finite")
            d = (g[k].double() - c[k].double()).abs()
            rel = d / c[k].double().abs().clamp(min=1e-300)
            max_rel = max(max_rel, float(torch.where(d == 0, 0.0, rel).max()))
        ev = c["events"]
        stalled += int((ev == sim_torch.MAX_EVENTS).sum())
        max_ev = max(max_ev, int(ev[ev < sim_torch.MAX_EVENTS].max()))
    print(f"fleet sweep, card vs CPU over 2 x {n_cells} cells: {ev_diff} "
          f"cells with different events, max relative d {max_rel:.3e} "
          f"(limit {SIM_REL_TOL})")
    check(ev_diff == 0, f"fleet sweep: {ev_diff} cells' events differ")
    check(max_rel <= SIM_REL_TOL, f"fleet sweep: card and CPU differ by "
          f"{max_rel:.3e} relative")

    # the half-split cells of three pairs against the discrete oracle
    three = [("RsNt", "DLRM"), ("BERT", "ENet"), ("ENet", "TFMR")]
    small = [(compile_neuisa(get_workload(a)), compile_neuisa(get_workload(b)))
             for a, b in three]
    fluid = {h: sim_torch.sweep_collocations(
                 small, [((2, 2), (2, 2))], n_requests=4, harvest=h,
                 device="cuda")["makespan"][:, 0, 0].cpu().numpy()
             for h in (False, True)}
    oracle = {h: fleet_oracle(DEFAULT_CORE, three,
                              "neu10" if h else "neu10_nh")[0]
              for h in (False, True)}
    ratios = {h: [float(f) / o for f, o in zip(fluid[h], oracle[h])]
              for h in (False, True)}
    print(f"fleet sweep vs the discrete oracle, half split: no harvest "
          f"{ratios[False]} (0.98-1.02), harvest {ratios[True]} (0.45-1.02)")
    check(all(0.98 < r < 1.02 for r in ratios[False]),
          "fluid (no harvest) outside 0.98-1.02 of neu10_nh")
    check(all(0.45 < r <= 1.02 for r in ratios[True]),
          "fluid (harvest) outside 0.45-1.02 of neu10")
    check(bool(np.all(fluid[True] <= fluid[False] * 1.02)),
          "harvest slower than no harvest")
    check(np.argsort(oracle[False]).tolist()
          == np.argsort(fluid[False]).tolist(),
          "fluid pair ranking differs from the oracle's")

    per_cell = {}
    for policy in ("neu10_nh", "neu10"):
        _, s_ = fleet_oracle(core, [p[:2] for p in PAPER_PAIRS], policy)
        per_cell[policy] = s_ / len(PAPER_PAIRS) * 1e3
    card_ms = sorted(t * 1e3 for t in card_s)
    fleet = {"cells": 2 * n_cells, "pairs": len(pairs),
             "splits": len(splits), "bw_points": len(bws),
             "iterations": {"no_harvest": iterations[False],
                            "harvest": iterations[True]},
             "sync_every": sim_torch.SYNC_EVERY,
             "max_events": max_ev, "stalled_cells": stalled,
             "card_ms": card_ms, "card_median_ms": card_ms[1],
             "cpu_ms": cpu_s * 1e3,
             "discrete_ms_per_cell": per_cell,
             "compile_ms": compile_s * 1e3,
             "trace_no_harvest": trace}
    print("fleet sweep: " + json.dumps(fleet))
    return fleet


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = t0 = time.perf_counter()

    def phase_done(what: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        print(f"phase {what}: {now - t0:.1f} s (total {now - t_start:.1f} s)")
        t0 = now

    _build.build()
    phase_done("build")
    for lib, log in _build.logs.items():   # -Xptxas -v: registers, spills
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas {lib}: {line.split('ptxas info    : ')[-1]}")

    cfgs = {k: ARCHS[k] for k in ("qwen2-0.5b", "qwen2-moe-a2.7b",
                                  "zamba2-7b", "internvl2-1b",
                                  "musicgen-large", "xlstm-350m")}
    moe_cfg, zamba_cfg = cfgs["qwen2-moe-a2.7b"], cfgs["zamba2-7b"]
    kernel_phase(fa, gm, ref, cfgs)
    phase_done("kernels against their plain versions")
    tallies, engines = {}, {}
    dense_cfg = cfgs["qwen2-0.5b"]
    tallies[dense_cfg.name], engines[dense_cfg.name] = family_engine_phase(
        fa, gm, dense_cfg, n_new=64)
    card_vs_cpu(dense_cfg, {}, S=256)
    phase_done("dense engine and card vs CPU")
    tallies[moe_cfg.name], engines[moe_cfg.name] = moe_engine_phase(
        fa, gm, moe_cfg)
    phase_done("moe engine")
    moe_card_vs_cpu(moe_cfg)
    phase_done("moe card vs CPU")
    # zamba2-7b at full width and depth
    tallies[zamba_cfg.name], engines[zamba_cfg.name] = family_engine_phase(
        fa, gm, zamba_cfg, n_new=64)
    phase_done("zamba2 engine")
    card_vs_cpu(zamba_cfg, dict(n_layers=12), S=300)
    phase_done("zamba2 card vs CPU")
    # the other families, 16 new tokens each; the card-vs-CPU cuts keep
    # 2 layers (for xLSTM one mLSTM and one sLSTM block)
    for arch, cut in (("internvl2-1b", dict(n_layers=2)),
                      ("musicgen-large", dict(n_layers=2)),
                      ("xlstm-350m", dict(n_layers=2,
                                          xlstm_pattern=("m", "s")))):
        tallies[arch], engines[arch] = family_engine_phase(
            fa, gm, cfgs[arch], n_new=16)
        card_vs_cpu(cfgs[arch], cut, S=256)
        phase_done(f"{arch} engine and card vs CPU")
    train_phase(fa, gm, dense_cfg)
    phase_done("training")
    control_plane_phase()
    phase_done("control plane")
    fleet_phase()
    phase_done("fleet sweep")
    kernels = timing_phase(fa, gm, ref, tallies, cfgs)
    phase_done("timing")
    for row in kernels:
        if row["name"] != "flash_attention":
            continue
        engine = engines[row["model"]]
        ms = row["in_path_ms"] * row["launches"]
        print(f"{row['model']} prefill time in flash_attention, measured in "
              f"the main run: {row['launches']} x {row['in_path_ms']:.4f} ms "
              f"= {ms:.3f} ms of {engine['prefill_ms']:.2f} ms "
              f"({100 * ms / engine['prefill_ms']:.1f}%); time alone "
              f"{row['ms']:.4f} ms")
    moe_engine = engines[moe_cfg.name]
    for phase, total in (("prefill", moe_engine["prefill_ms"]),
                         ("decode", moe_engine["decode_step_ms"] * 64)):
        ms = moe_engine["k2_in_path_ms"][phase]
        alone = sum(r["in_path_alone_ms"] * r["launches"] for r in kernels
                    if r.get("phase") == phase)
        print(f"moe {phase} time in grouped_matmul, measured in the main "
              f"run: {ms:.3f} ms of {total:.2f} ms ({100 * ms / total:.1f}%); "
              f"launches x time alone with the run's rows: {alone:.3f} ms")

    print(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
