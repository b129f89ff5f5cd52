#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA Hopper GPU.

Run from the repository root, with nothing else on the command line:

    python3 chip_smoke.py

1. Setup: needs CUDA, turns TF32 off, prints the card, builds every
   CUDA kernel of the port from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once).
2. Kernels: holds each kernel against its plain PyTorch version on the
   card: flash attention (K1) at both serving paths' prefill shapes and
   at ragged, wide-head, Sq != Sk and non-causal cases; the grouped GEMM
   (K2) at the moe path's shapes, the reference's sweep and (1,1,1,1).
3. Dense engine: serves full-width qwen2-0.5b (random weights from a
   seed) through ``ServeEngine.generate``, checks that every layer's
   prefill attention went through K1, and holds the card against the
   port's CPU path on the same weights.
4. Moe engine: serves full-width, 24-layer qwen2-moe-a2.7b in fp32
   (14.3 B parameters, 57 GB, drawn on the card from a CUDA generator)
   through ``ServeEngine.generate``, checks that every prefill
   attention went through K1 and every expert GEMM through K2 (counted
   by phase and shape, each launch's device time read from CUDA events
   around it), then holds the card against the CPU path at full width
   and 2 layers.
5. Timing: times each kernel at each of its main-path shapes, its plain
   version and the PyTorch library call that computes the same
   function, beside the least time the card could take for the same
   work.

Prints the card's name and power limit and a ``{"kernels": [...]}``
line before the last line, which is ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, if there is no CUDA device or any phase
fails.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

H100_FP32_FLOPS = 67e12      # non-tensor fp32, SXM, 700 W (data sheet)
H100_BF16_FLOPS = 989e12     # dense tensor-core bf16
H100_BYTES_PER_S = 3.35e12   # HBM3


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
    """(ms, "bytes" | "operations"): the least time an H100 could take.
    Operations are the multiply-adds of q k^T and p v over the (query,
    key) pairs these shapes leave unmasked; bytes read q, k, v once and
    write o once."""
    if causal:
        pairs = sum(min(Sk, r + Sk - Sq + 1) for r in range(Sq))
    else:
        pairs = Sq * Sk
    ops = 4 * B * H * hd * pairs
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd)
    peak = H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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


def moe_rows(cfg, B, S):
    """Rows G*C of K2's (E, G*C, d) operands in a prefill of B x S
    tokens (S = 1: a decode step), as ``moe_apply`` sizes them."""
    from repro_torch.models.moe import _n_groups, capacity

    G = _n_groups(B)
    return G * capacity(cfg, B * S // G)


def moe_attention(cfg, B=4, S=500):
    """K1's (B, Sq, Sk, H, Hkv, hd, causal) in the moe prefill of B x S."""
    return (B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, True)


def engine_bounds(cfg, B, S, max_seq):
    """Least fp32 times for the full-width engine run: the prefill's
    multiply-adds at the fp32 peak, and one decode step's bytes at HBM
    rate: every weight and the whole KV cache read once, but of an
    untied embedding table only the B rows the step gathers (a tied
    table is read whole by the unembed).

    The prefill counts every weight but the embedding once per token,
    the unembed, and causal attention. For the moe family the routed
    experts count as the path computes them, over all G*C capacity
    slots, empty or not; ``prefill_active_bound_ms`` counts them at
    top-k per token instead."""
    V, d, L = cfg.vocab_padded, cfg.d_model, cfg.n_layers
    body = cfg.param_count() - V * d * (1 if cfg.tie_embeddings else 2)
    attn = 4 * B * cfg.n_heads * cfg.d_head * S * (S + 1) // 2 * L
    cache = 2 * L * B * max_seq * cfg.d_kv
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
        prefill_ops = 2 * B * S * (body + d * V) + attn
    out["prefill_bound_ms"] = prefill_ops / H100_FP32_FLOPS * 1e3
    weights = cfg.param_count() - (0 if cfg.tie_embeddings else (V - B) * d)
    out["decode_step_bound_ms"] = (4 * (weights + cache)
                                   / H100_BYTES_PER_S * 1e3)
    return out


def kernel_phase(fa, gm, ref, moe_cfg) -> None:
    # (B, Sq, Sk, H, Hkv, hd, causal): serving shape, ragged, the moe
    # prefill's shape, wide head, Sq != Sk (bottom-right diagonal),
    # non-causal ragged
    cases = [
        (4, 512, 512, 14, 2, 64, True),
        (4, 500, 500, 14, 2, 64, True),
        moe_attention(moe_cfg),
        (2, 384, 384, 8, 2, 128, True),
        (2, 128, 384, 14, 2, 64, True),
        (2, 200, 200, 8, 2, 64, False),
    ]
    for i, (B, Sq, Sk, H, Hkv, hd, causal) in enumerate(cases):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q, k, v = attention_inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed=i)
            out = fa.flash_attention(q, k, v, causal=causal)
            want = ref.gqa_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            out, want = out.float(), want.float()
            err = (out - want).abs().max().item()
            ok = torch.allclose(out, want, rtol=tol, atol=tol)
            print(f"kernel flash_attention B={B} Sq={Sq} Sk={Sk} H={H} "
                  f"Hkv={Hkv} hd={hd} causal={causal} {dtype}: "
                  f"max|d|={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
            check(bool(torch.isfinite(out).all()) and ok,
                  f"flash_attention disagrees with its plain version "
                  f"(case {i}, {dtype})")

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


@torch.inference_mode()
def greedy_trace(model, params, prompt: np.ndarray, n: int, device: str):
    """Last-position prefill logits, greedy tokens and each step's top-2
    logit margin, through the model API."""
    S = prompt.shape[1]
    toks = torch.as_tensor(prompt, dtype=torch.long, device=device)
    cache = model.init_cache(1, S + n, device=device)
    logits, cache = model.prefill(params, {"tokens": toks}, cache)
    first = logits[0, -1].float().cpu()
    last = logits[:, -1:]
    out, margins = [], []
    for i in range(n):
        top2 = last[0, 0].float().topk(2).values
        margins.append(float(top2[0] - top2[1]))
        nxt = last.argmax(dim=-1)
        out.append(int(nxt))
        last, cache = model.decode_step(params, cache,
                                        {"tokens": nxt, "cache_index": S + i})
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


def serve(eng, cfg, counters, watch=contextlib.nullcontext()):
    """The main path: warm up, then 4 prompts x 500 tokens and 64 greedy
    tokens through ``ServeEngine.generate`` inside ``watch``, every
    kernel's launch count set to 0 just before and read just after.
    Returns the prompts, the counts by kernel and the engine's numbers."""
    rng = np.random.default_rng(0)
    eng.generate(rng.integers(0, cfg.vocab_size, (1, 16)), n_new=2)  # warm-up
    prompts = rng.integers(0, cfg.vocab_size, (4, 500))
    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.launches = 0
    with watch:
        res = eng.generate(prompts, n_new=64)
    launches = {mod.__name__.rsplit(".", 1)[-1]: mod.launches
                for mod in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{cfg.name} main path kernel launches: {json.dumps(launches)} "
          f"(n_layers={cfg.n_layers})")
    check(res.tokens.shape == (4, 64) and res.tokens.min() >= 0
          and res.tokens.max() < cfg.vocab_size, "generated tokens malformed")
    engine = {"batch": 4, "prompt": 500, "n_new": 64,
              "prefill_ms": res.prefill_s * 1e3,
              "decode_tokens_per_s": res.tokens_per_s,
              "decode_step_ms": res.decode_s / 64 * 1e3,
              "peak_device_gb": peak_gb,
              **engine_bounds(cfg, 4, 500, 1024)}
    return prompts, launches, engine


def engine_phase(fa, gm, cfg):
    from repro_torch import ServeEngine, build_model

    t0 = time.perf_counter()
    eng = ServeEngine(cfg, max_seq=1024, seed=0, device="cuda")
    n_params = sum(p.numel() for p in eng.params.parameters())
    print(f"engine init (full width, {n_params} params, fp32): "
          f"{time.perf_counter() - t0:.1f} s")
    prompts, launches, engine = serve(eng, cfg, (fa, gm))
    check(launches["flash_attention"] == cfg.n_layers,
          f"prefill made {launches['flash_attention']} flash_attention "
          f"launches, want {cfg.n_layers}")
    check(launches["grouped_matmul"] == 0, "the dense path ran K2")
    print("engine: " + json.dumps(engine))

    # the card against the port's CPU path, same seed -> same weights
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = prompts[:1, :256]
    n = 16
    compare_card_cpu(greedy_trace(model, eng.params, prompt, n, "cuda"),
                     greedy_trace(model, cpu_params, prompt, n, "cpu"), n)
    return launches["flash_attention"], engine["prefill_ms"]


@contextlib.contextmanager
def k2_in_path(gm, model, tally: dict):
    """While active, K2's launches are tallied by phase and shape in
    ``tally[(phase, (E, C, d, f))] = [launches, device ms]``: the phase is
    "prefill" until ``model``'s first ``decode_step`` and "decode" after
    it, and a launch's device time is read from CUDA events recorded on
    the stream just before and just after it. The wrapper's own count
    is left as it is."""
    real_launch = gm._launch
    phase, events = ["prefill"], []

    def launch(x, w):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        o = real_launch(x, w)
        end.record()
        events.append((phase[0], (*x.shape, w.shape[2]), start, end))
        return o

    def decode_step(*args, **kw):
        phase[0] = "decode"
        return type(model).decode_step(model, *args, **kw)

    gm._launch, model.decode_step = launch, decode_step
    try:
        yield
    finally:
        gm._launch = real_launch
        del model.decode_step
    torch.cuda.synchronize()
    for ph, shape, start, end in events:
        n_ms = tally.setdefault((ph, shape), [0, 0.0])
        n_ms[0] += 1
        n_ms[1] += start.elapsed_time(end)


def moe_engine_phase(fa, gm, cfg):
    """Full-width, full-depth moe serving on the card, weights drawn on
    the card. Returns K1's launches, K2's launches and in-path device
    time by phase and shape, and the engine's numbers, all from the
    main path's run."""
    from repro_torch import ServeEngine, build_model

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    eng = ServeEngine(cfg, params=params, max_seq=1024, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    print(f"moe engine init (full width, {cfg.n_layers} layers, {n_params} "
          f"params, fp32, drawn on the card): "
          f"{time.perf_counter() - t0:.1f} s")
    tally: dict = {}
    _, launches, engine = serve(eng, cfg, (fa, gm),
                                k2_in_path(gm, eng.model, tally))
    L, want = cfg.n_layers, 3 * cfg.n_layers * (1 + 64)
    check(launches["flash_attention"] == L,
          f"moe prefill made {launches['flash_attention']} flash_attention "
          f"launches, want {L}")
    check(launches["grouped_matmul"] == want,
          f"moe generate made {launches['grouped_matmul']} grouped_matmul "
          f"launches, want 3 * {L} * (1 + 64) = {want}")
    # gate and up run at (E, G*C, d) x (E, d, d_e), down at
    # (E, G*C, d_e) x (E, d_e, d), once per layer per forward
    E, d, d_e = cfg.n_experts, cfg.d_model, cfg.d_expert
    want_tally = {}
    for phase, C, steps in (("prefill", moe_rows(cfg, 4, 500), 1),
                            ("decode", moe_rows(cfg, 4, 1), 64)):
        want_tally[(phase, (E, C, d, d_e))] = 2 * L * steps
        want_tally[(phase, (E, C, d_e, d))] = L * steps
    got = {k: n for k, (n, _) in tally.items()}
    print("moe main path K2 launches by phase and (E, C, d, f): "
          + json.dumps({f"{ph} {list(s)}": n for (ph, s), n in got.items()}))
    check(got == want_tally, f"moe K2 launches by phase and shape {got}, "
          f"want {want_tally}")
    engine["k2_in_path_ms"] = {
        phase: sum(ms for (ph, _), (_, ms) in tally.items() if ph == phase)
        for phase in ("prefill", "decode")}
    print("moe engine: " + json.dumps(engine))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_attention"], tally, engine


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


def k1_row(fa, ref, model, shape, dtype, launches):
    """K1 timed at (B, Sq, Sk, H, Hkv, hd, causal) in ``dtype`` beside its
    bound, its plain version and SDPA."""
    import torch.nn.functional as F

    B, Sq, Sk, H, Hkv, hd, causal = shape
    q, k, v = attention_inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed=99)
    err = (fa.flash_attention(q, k, v, causal=causal).float()
           - ref.gqa_attention_ref(q, k, v, causal=causal).float()
           ).abs().max().item()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bound_ms, bound_by = attention_bound(*shape, dtype)
    return {
        "name": "flash_attention",
        "model": model,
        "shape": list(shape[:6]),
        "dtype": str(dtype).replace("torch.", ""),
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": launches,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
        "plain_ms": cuda_ms(
            lambda: ref.gqa_attention_ref(q, k, v, causal=causal)),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)),
    }


def timing_phase(fa, gm, ref, k1_dense, k1_moe, k2_tally, moe_cfg):
    """The ``kernels`` line: K1 at the dense and the moe prefill's shapes
    and K2 at each of the moe path's four shapes, fp32 (the main paths'
    dtype), each with its launches on the main path. A K2 row also
    carries its mean device time per launch inside the main run."""
    dense = (4, 500, 500, 14, 2, 64, True)   # qwen2-0.5b's serving prefill
    kernels = [k1_row(fa, ref, "qwen2-0.5b", dense, torch.float32, k1_dense)]
    bf16 = k1_row(fa, ref, "qwen2-0.5b", dense, torch.bfloat16, 0)
    print("kernel timing, bf16 (not the main path's dtype): "
          + json.dumps(bf16))
    kernels.append(k1_row(fa, ref, moe_cfg.name, moe_attention(moe_cfg),
                          torch.float32, k1_moe))

    for (phase, (E, C, d, f)), (n, in_path_ms) in k2_tally.items():
        x, w = gmm_inputs(E, C, d, f, torch.float32, seed=98)
        err = (gm.grouped_matmul(x, w)
               - ref.grouped_matmul_ref(x, w)).abs().max().item()
        bound_ms, bound_by = gmm_bound(E, C, d, f, torch.float32)
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
            "max_abs_err": err,
            "ms": cuda_ms(lambda: gm.grouped_matmul(x, w)),
            "plain_ms": cuda_ms(lambda: ref.grouped_matmul_ref(x, w)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": cuda_ms(lambda: torch.bmm(x, w)),
        })
    return kernels


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
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    moe_cfg = ARCHS["qwen2-moe-a2.7b"]
    kernel_phase(fa, gm, ref, moe_cfg)
    k1_dense, prefill_ms = engine_phase(fa, gm, ARCHS["qwen2-0.5b"])
    k1_moe, k2_tally, moe_engine = moe_engine_phase(fa, gm, moe_cfg)
    moe_card_vs_cpu(moe_cfg)
    kernels = timing_phase(fa, gm, ref, k1_dense, k1_moe, k2_tally, moe_cfg)
    k1_ms = kernels[0]["ms"] * k1_dense
    print(f"dense prefill time in flash_attention, estimated as launches x "
          f"time alone: {k1_dense} x {kernels[0]['ms']:.4f} ms = "
          f"{k1_ms:.3f} ms of {prefill_ms:.2f} ms "
          f"({100 * k1_ms / prefill_ms:.1f}%)")
    for phase, total in (("prefill", moe_engine["prefill_ms"]),
                         ("decode", moe_engine["decode_step_ms"] * 64)):
        ms = moe_engine["k2_in_path_ms"][phase]
        alone = sum(r["ms"] * r["launches"] for r in kernels
                    if r.get("phase") == phase)
        print(f"moe {phase} time in grouped_matmul, measured in the main "
              f"run: {ms:.3f} ms of {total:.2f} ms ({100 * ms / total:.1f}%); "
              f"launches x time alone: {alone:.3f} ms")

    print(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
