#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA Hopper GPU.

Run from the repository root, with nothing else on the command line:

    python3 chip_smoke.py

1. Setup: needs CUDA, turns TF32 off, prints the card, builds every
   CUDA kernel of the port from ``src/repro_torch/kernels/csrc``.
2. Kernels: holds each kernel against its plain PyTorch version on the
   card, at the serving path's shapes and at ragged, wide-head,
   Sq != Sk and non-causal cases.
3. Engine: serves full-width qwen2-0.5b (random weights from a seed)
   through ``ServeEngine.generate``, checks that every layer's prefill
   attention went through the kernel, and holds the card against the
   port's CPU path on the same weights.
4. Timing: times each kernel, its plain version and the PyTorch library
   call that computes the same function, beside the least time the card
   could take for the same work.

Prints the card's name and power limit and a ``{"kernels": [...]}``
line before the last line, which is ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, if there is no CUDA device or any phase
fails.
"""
from __future__ import annotations

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


def engine_bounds(cfg, B, S, max_seq):
    """Least fp32 times for the full-width engine run: the prefill's
    multiply-adds (every weight once per token, the tied unembed, and
    causal attention) at the fp32 peak, and one decode step's bytes
    (every weight and the whole KV cache read once) at HBM rate."""
    V, d = cfg.vocab_padded, cfg.d_model
    weights = cfg.param_count() - V * d            # without the embedding
    attn = 4 * B * cfg.n_heads * cfg.d_head * S * (S + 1) // 2 * cfg.n_layers
    prefill_ops = 2 * B * S * (weights + d * V) + attn
    cache = 2 * cfg.n_layers * B * max_seq * cfg.d_kv
    step_bytes = 4 * (cfg.param_count() + cache)
    return {"prefill_bound_ms": prefill_ops / H100_FP32_FLOPS * 1e3,
            "decode_step_bound_ms": step_bytes / H100_BYTES_PER_S * 1e3}


def kernel_phase(fa, ref) -> None:
    # (B, Sq, Sk, H, Hkv, hd, causal): serving shape, ragged, wide head,
    # Sq != Sk (bottom-right diagonal), non-causal ragged
    cases = [
        (4, 512, 512, 14, 2, 64, True),
        (4, 500, 500, 14, 2, 64, True),
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


def engine_phase(fa, cfg):
    from repro_torch import ServeEngine, build_model

    t0 = time.perf_counter()
    eng = ServeEngine(cfg, max_seq=1024, seed=0, device="cuda")
    n_params = sum(p.numel() for p in eng.params.parameters())
    print(f"engine init (full width, {n_params} params, fp32): "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    eng.generate(rng.integers(0, cfg.vocab_size, (1, 16)), n_new=2)  # warm-up

    prompts = rng.integers(0, cfg.vocab_size, (4, 500))
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    res = eng.generate(prompts, n_new=64)
    launches = fa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path flash_attention launches: {launches} "
          f"(n_layers={cfg.n_layers})")
    check(launches == cfg.n_layers,
          f"prefill made {launches} kernel launches, want {cfg.n_layers}")
    check(res.tokens.shape == (4, 64) and res.tokens.min() >= 0
          and res.tokens.max() < cfg.vocab_size, "generated tokens malformed")
    engine = {"batch": 4, "prompt": 500, "n_new": 64,
              "prefill_ms": res.prefill_s * 1e3,
              "decode_tokens_per_s": res.tokens_per_s,
              "decode_step_ms": res.decode_s / 64 * 1e3,
              "peak_device_gb": peak_gb,
              **engine_bounds(cfg, 4, 500, 1024)}
    print("engine: " + json.dumps(engine))

    # the card against the port's CPU path, same seed -> same weights
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = prompts[:1, :256]
    n = 16
    g_first, g_toks, _ = greedy_trace(model, eng.params, prompt, n, "cuda")
    c_first, c_toks, margins = greedy_trace(model, cpu_params, prompt, n, "cpu")
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
    return launches, engine["prefill_ms"]


def timing_phase(fa, ref, launches):
    import torch.nn.functional as F

    B, S, H, Hkv, hd = 4, 500, 14, 2, 64   # the serving prefill's shape
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(B, S, S, H, Hkv, hd, dtype, seed=99)
        out = fa.flash_attention(q, k, v)
        want = ref.gqa_attention_ref(q, k, v)
        err = (out.float() - want.float()).abs().max().item()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound_ms, bound_by = attention_bound(B, S, S, H, Hkv, hd, True, dtype)
        rows.append({
            "name": "flash_attention",
            "dtype": str(dtype).replace("torch.", ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:29",
            "launches": launches if dtype == torch.float32 else 0,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": cuda_ms(lambda: ref.gqa_attention_ref(q, k, v)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
        })
    print("kernel timing, B=4 S=500 H=14 Hkv=2 hd=64 causal, bf16 (not the "
          "main path's dtype): " + json.dumps(rows[1]))
    return [rows[0]]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    kernel_phase(fa, ref)
    launches, prefill_ms = engine_phase(fa, ARCHS["qwen2-0.5b"])
    kernels = timing_phase(fa, ref, launches)
    k1_ms = kernels[0]["ms"] * launches
    print(f"prefill time in flash_attention: {launches} x "
          f"{kernels[0]['ms']:.4f} ms = {k1_ms:.3f} ms of {prefill_ms:.2f} ms "
          f"({100 * k1_ms / prefill_ms:.1f}%)")

    print(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
