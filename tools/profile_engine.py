#!/usr/bin/env python3
"""Where a served model's time goes on one Hopper GPU: one prefill and
one decode step of the port's model API, traced by ``torch.profiler``.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 tools/profile_engine.py [--model zamba2-7b ...] [--dtype bfloat16]

For each model (full width and depth, weights in ``--dtype``, fp32 by
default, drawn on the card from a CUDA generator seeded 0 as
``chip_smoke.py``'s ``draw_on_card`` draws them, the KV cache fp32 as
the serving engine keeps it, TF32 off): a warm-up, then a prefill of
4 x 500 tokens (the traffic of ``chip_smoke.py``) into a cache of 1024
positions and one decode step after it, each traced on its own. Prints
per phase: the host time (clock after ``torch.cuda.synchronize()``), the
device busy time (the union of the kernels' intervals in the trace), the
idle share (1 - busy / host), the number of kernels, and the kernels
grouped by name with their total device time, the 12 longest. One JSON
line per phase.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import build_model  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402

B, S = 4, 500   # prompts x tokens, as chip_smoke.py serves them
TOP = 12        # kernel names listed per phase


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def traced(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name[:100]][0] += 1
        by_name[e.name[:100]][1] += e.time_range.elapsed_us() / 1e3
    busy = busy_us((e.time_range.start, e.time_range.end)
                   for e in kernels) / 1e3
    return {"host_ms": host_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / host_ms, "kernels": len(kernels),
            "top": [{"name": n, "count": c, "ms": ms} for n, (c, ms) in
                    sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]]}


@torch.inference_mode()
def profile_model(name: str, dtype: torch.dtype) -> None:
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

    prefill(model.init_cache(B, 1024, device="cuda"))   # warm-up
    decode()
    cache = model.init_cache(B, 1024, device="cuda")
    for phase, fn in (("prefill", lambda: prefill(cache)),
                      ("decode_step", decode)):
        out = traced(fn)
        print(json.dumps({"model": name, "dtype": str(dtype)[6:],
                          "phase": phase, "batch": B, "prompt": S, **out}))
    del params, state
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", action="append", choices=sorted(ARCHS),
                    help="a model to profile (default: zamba2-7b)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the weights' dtype")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for name in args.model or ["zamba2-7b"]:
        profile_model(name, getattr(torch, args.dtype))
    return 0


if __name__ == "__main__":
    sys.exit(main())
