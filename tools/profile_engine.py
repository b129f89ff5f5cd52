#!/usr/bin/env python3
"""Where a served model's time goes on one Hopper GPU: one prefill and
one decode step of the port's model API, traced by ``torch.profiler``.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 tools/profile_engine.py [--model zamba2-7b ...] [--dtype bfloat16]
        [--batch 4] [--prompt 500] [--max-seq 1024]

For each model (full width and depth, weights in ``--dtype``, fp32 by
default, drawn on the card from a CUDA generator seeded 0 as
``chip_smoke.py``'s ``draw_on_card`` draws them, the KV cache fp32 as
the serving engine keeps it, TF32 off): a warm-up, then a prefill of
``--batch`` x ``--prompt`` tokens (by default 4 x 500, the traffic of
``chip_smoke.py``) into a cache of ``--max-seq`` positions (1024) and
one decode step after it, each traced on its own from the
trace's raw records, inside a recorder span named after the phase.
Prints per phase: the host time (clock after ``torch.cuda.synchronize()``),
the device busy time (the union of the device's records), the idle
share (1 - busy / host), the number of records, the kernels grouped by
name with their total device time, the 12 longest, and the idle time
split by the innermost program span open on the host
(``repro_torch.obs.idle_by_span``; the model's detail spans are recorded
while the profiler runs). One JSON line per phase; then one line with
the host ms of 15 more traced decode steps each with and without the
detail spans, in turns, the detail spans one step records, and the host
cost of one detail-span site with the profiler off and on.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import build_model, obs  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402

TOP = 12        # kernel names listed per phase


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, -1
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def traced(fn) -> dict:
    """``fn()`` under a CUDA-only profiler, read from the raw records."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    off = obs.profiler_offset_ns()
    # the raw records: prof.events() drops some and builds a slow tree
    recs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    for name, a, b in recs:
        by_name[name[:100]][0] += 1
        by_name[name[:100]][1] += (b - a) / 1e6
    host_ms = (t1 - t0) / 1e6
    busy = busy_ns((a, b) for _, a, b in recs) / 1e6
    spans = [s for s in obs.RECORDER.spans if s.start_ns >= t0]
    idle = obs.idle_by_span([(a, b) for _, a, b in recs], spans,
                            (t0 + off, t1 + off), off)
    return {"host_ms": host_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / host_ms, "kernels": len(recs),
            "top": [{"name": n, "count": c, "ms": ms} for n, (c, ms) in
                    sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]],
            "idle_by_span": {k: v * 1e3 for k, v in
                             sorted(idle.items(), key=lambda kv: -kv[1])}}


def in_span(name: str, fn):
    def run():
        with obs.RECORDER.span(name):
            fn()
    return run


def detail_cost(decode, n: int = 15) -> dict:
    """Host ms of ``n`` traced decode steps with the detail spans and
    ``n`` without (``obs.detail`` replaced by its off path), in turns,
    their medians, and the detail spans one step records."""
    real = obs.detail
    out = {"with_detail_ms": [], "without_detail_ms": []}
    try:
        for _ in range(n):
            for key, detail in (("with_detail_ms", real),
                                ("without_detail_ms",
                                 lambda name: obs._OFF)):
                obs.detail = detail
                t0 = time.perf_counter_ns()
                out[key].append(traced(decode)["host_ms"])
                if detail is real:
                    out["detail_spans"] = sum(
                        s.start_ns >= t0 for s in obs.RECORDER.spans)
    finally:
        obs.detail = real
    for key in ("with_detail_ms", "without_detail_ms"):
        out[key.replace("_ms", "_median_ms")] = statistics.median(out[key])
    return {**out, **site_cost_us()}


def site_cost_us(n: int = 20000) -> dict:
    """Host us that one detail-span site costs with no profiler (its
    flag test) and under a CUDA-only profiler (a span recorded, into a
    recorder of its own), over ``n`` sites each."""
    from torch.profiler import ProfilerActivity, profile

    def sites() -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with obs.detail("site"):
                pass
        return (time.perf_counter_ns() - t0) / n / 1e3

    real = obs.RECORDER
    obs.RECORDER = obs.Recorder()
    try:
        off = sites()
        with profile(activities=[ProfilerActivity.CUDA]):
            on = sites()
    finally:
        obs.RECORDER = real
    return {"site_off_us": off, "site_on_us": on}


@torch.inference_mode()
def profile_model(name: str, dtype: torch.dtype, B: int, S: int,
                  max_seq: int) -> None:
    cfg = ARCHS[name]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype, device="cuda")
    K = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, *K, S)),
                           device="cuda")
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    batch = {"tokens": toks}
    if n_prefix:
        batch["patch_embeds"] = torch.zeros((B, n_prefix, cfg.d_model),
                                            dtype=dtype, device="cuda")
    state = {}

    def prefill(cache):
        logits, state["cache"] = model.prefill(params, batch, cache)
        nxt = logits[:, -1:].argmax(dim=-1)
        state["next"] = nxt.movedim(-1, 1) if cfg.family == "audio" else nxt

    def decode():
        model.decode_step(params, state["cache"], {
            "tokens": state["next"], "cache_index": n_prefix + S})

    prefill(model.init_cache(B, max_seq, device="cuda"))   # warm-up
    decode()
    cache = model.init_cache(B, max_seq, device="cuda")
    for phase, fn in (("prefill", lambda: prefill(cache)),
                      ("decode_step", decode)):
        out = traced(in_span(phase, fn))
        print(json.dumps({"model": name, "dtype": str(dtype)[6:],
                          "phase": phase, "batch": B, "prompt": S, **out}))
    print(json.dumps({"model": name, "dtype": str(dtype)[6:],
                      "phase": "decode_step", "batch": B, "prompt": S,
                      **detail_cost(decode)}))
    del params, state
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", action="append", choices=sorted(ARCHS),
                    help="a model to profile (default: zamba2-7b)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the weights' dtype")
    ap.add_argument("--batch", type=int, default=4, help="prompts")
    ap.add_argument("--prompt", type=int, default=500, help="their tokens")
    ap.add_argument("--max-seq", type=int, default=1024,
                    help="the KV cache's positions")
    args = ap.parse_args()
    if args.prompt >= args.max_seq:
        ap.error("--max-seq must hold the prompt and one decoded token")
    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for name in args.model or ["zamba2-7b"]:
        profile_model(name, getattr(torch, args.dtype), args.batch,
                      args.prompt, args.max_seq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
