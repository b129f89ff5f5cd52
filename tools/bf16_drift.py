#!/usr/bin/env python3
"""How far a bf16 prefill lies from its fp32 truth, layer by layer, on
the card and on the CPU: where a bf16 card-vs-CPU check's difference
comes from.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 tools/bf16_drift.py [--model zamba2-7b] [--layers 12]
                                [--seq 300] [--rows 4]

One set of bf16 weights at full width, cut to ``--layers`` layers, is
drawn on the card from a generator seeded 0 and copied to the CPU (as
``chip_smoke.py``'s card-vs-CPU check draws them), and ``--rows`` prompts of ``--seq`` tokens (prompt
seed 0) are prefilled five ways: bf16 on the CPU; bf16 on the card with
cuBLAS's reduced-precision bf16 reductions allowed (PyTorch's default)
and with them off; and fp32, the same weights upcast, on the card (the
"truth", TF32 off) and on the CPU. For each layer's residual stream and
for the last-position logits (and, for Zamba2, the logits the stack would
give if it ended after each layer: final norm and unembedding of that
layer's stream) it prints max |Δ| / the truth's largest |value| of each
against the truth, and card bf16 against CPU bf16; then one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import build_model  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402


@contextlib.contextmanager
def residuals(record):
    """While active, every ``pin_residual`` of the stacks (one after each
    layer, and after the embedding) first calls ``record(x)``."""
    from repro_torch.models import stacks, transformer

    mods = [m for m in (stacks, transformer) if hasattr(m, "pin_residual")]
    real = {m: m.pin_residual for m in mods}

    def recording(m):
        def pin(x, *args, **kw):
            record(x)
            return real[m](x, *args, **kw)
        return pin

    for m in mods:
        m.pin_residual = recording(m)
    try:
        yield
    finally:
        for m in mods:
            m.pin_residual = real[m]


def head(cfg, params, x):
    """The logits the stack would give if it ended at the residual
    stream x (final norm and unembedding, in x's dtype), for stacks with
    an untied ``lm_head`` (Zamba2); else None."""
    from repro_torch.models import layers as L

    if not hasattr(params, "lm_head"):
        return None
    return L.rmsnorm(params.final_norm, x, cfg.norm_eps) @ \
        params.lm_head.to(x.dtype)


@torch.inference_mode()
def prefill(model, params, prompt, device):
    """Last-position logits (fp32, CPU) of one prefill, each recorded
    residual stream (fp32, CPU), and the last-position logits the stack
    would give if it ended after each layer (``head``; fp32, CPU)."""
    cfg = model.cfg
    toks = torch.as_tensor(prompt, dtype=torch.long, device=device)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (toks.shape[0], cfg.n_patches, cfg.d_model), device=device)
    cache = model.init_cache(toks.shape[0], toks.shape[-1] + cfg.n_patches
                             * (cfg.family == "vlm"), device=device)
    stream, early = [], []

    def record(x):
        stream.append(x.float().cpu())
        lg = head(cfg, params, x[:, -1])
        if lg is not None:
            early.append(lg.float().cpu())

    with residuals(record):
        logits, _ = model.prefill(params, batch, cache)
    return logits[:, -1].float().cpu(), stream, early


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="zamba2-7b", choices=sorted(ARCHS))
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=300)
    ap.add_argument("--rows", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_drift: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cut = dict(n_layers=args.layers)
    if ARCHS[args.model].family == "ssm":
        cut["xlstm_pattern"] = ARCHS[args.model].xlstm_pattern[:args.layers]
    cfg = ARCHS[args.model].replace(**cut)
    model = build_model(cfg)
    bf16, f32 = torch.bfloat16, torch.float32
    card_bf = model.init(torch.Generator(device="cuda").manual_seed(0), bf16,
                         device="cuda")
    state = card_bf.state_dict()

    def on(device, dtype):
        p = type(card_bf)(cfg, dtype, device=device)
        p.load_state_dict(state)
        return p

    K = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.rows, *K, args.seq))
    runs = {}
    matmul = torch.backends.cuda.matmul
    runs["card_fp32"] = prefill(model, on("cuda", f32), prompt, "cuda")
    for allow in (True, False):
        matmul.allow_bf16_reduced_precision_reduction = allow
        runs[f"card_bf16_reduced_{'on' if allow else 'off'}"] = prefill(
            model, on("cuda", bf16), prompt, "cuda")
    matmul.allow_bf16_reduced_precision_reduction = True
    runs["cpu_bf16"] = prefill(model, on("cpu", bf16), prompt, "cpu")
    runs["cpu_fp32"] = prefill(model, on("cpu", f32), prompt, "cpu")

    out = {"model": cfg.name, "layers": cfg.n_layers, "rows": args.rows,
           "seq": args.seq, "card": torch.cuda.get_device_name(0),
           "vs_card_fp32": {}, "card_bf16_vs_cpu_bf16": {}}
    pairs = [(name, "card_fp32") for name in runs if name != "card_fp32"]
    pairs += [(f"card_bf16_reduced_{s}", "cpu_bf16") for s in ("on", "off")]
    for a, b in pairs:
        la, sa, ea = runs[a]
        lb, sb, eb = runs[b]
        layer = [rel(x, y) for x, y in zip(sa, sb)]
        logit = [rel(la[r], lb[r]) for r in range(args.rows)]
        # the worst row's logits if the stack ended after layer l
        early = [max(rel(x[r], y[r]) for r in range(args.rows))
                 for x, y in zip(ea, eb)]
        key = "vs_card_fp32" if b == "card_fp32" else "card_bf16_vs_cpu_bf16"
        out[key][a] = {"logits_by_row": logit, "residual_by_layer": layer,
                       "logits_ending_after_layer": early}
        print(f"{a} vs {b}: last-position logits max|d| / largest |logit| "
              f"by row {[f'{x:.4g}' for x in logit]}; residual stream by "
              f"layer {[f'{x:.3g}' for x in layer]}; logits of the stack "
              f"ended after each layer, worst row "
              f"{[f'{x:.3g}' for x in early]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
