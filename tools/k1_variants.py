#!/usr/bin/env python3
"""Time variants of the port's flash-attention kernel (K1) on one Hopper
GPU.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 tools/k1_variants.py [--model NAME ...] [--also LABEL=PATH ...]
                                 [--sass]

A variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
some of its ``constexpr int NAME = value;`` constants replaced (warps a
block, keys a tile, stages of the K/V ring, the fp32 chunk depth).
``--also`` adds another source with the same C interface as a variant
of its own, for example an earlier commit's kernel (the fp32 route on
the CUDA cores) unpacked with ``git archive``. Every variant is built
(one ``nvcc`` each, all at once, into
``build/flash_attention_variants/``), launched through the port's own
wrapper, held against the plain version (its largest error, and its
largest error over the tolerance, 2e-5 + 2e-5 |want| in fp32 and 2e-2 +
2e-2 |want| in bf16, where above 1 fails; also with q scaled by 8,
where the softmax is peaked, and there against float64 too), and timed
with CUDA events (mean of 200 launches) at the prefill shapes of the
main paths (``--model`` picks some), in fp32 and bf16, in two rounds in
opposite orders, with SDPA timed beside them in each round. Prints the
card's name and power limit, ``ptxas`` registers and spills per variant
(with ``--sass``, the opcode counts of the source's kernels too), and
one JSON line per case.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import kernel_variants as kv
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import gqa_attention_ref

VARIANTS = {
    "source": {},
    "STAGES=3": {"STAGES": 3},
    "WARPS=2": {"WARPS": 2},
    "WARPS=8": {"WARPS": 8},
    "F32_BK_HD128=64": {"F32_BK_HD128": 64},
    "F32_BK_HD112=64": {"F32_BK_HD112": 64},
    "F32_BK_HD64=32": {"F32_BK_HD64": 32},
    "BF16_BK_HD128=32": {"BF16_BK_HD128": 32},
    "BF16_BK_HD112=32": {"BF16_BK_HD112": 32},
    # at hd 112 (14 steps of 8) q k^T takes the deepest chunk that
    # divides 14: 2 for F32_CHUNK=4, 7 for 8, 14 for 16
    "F32_CHUNK=1": {"F32_CHUNK": 1},
    "F32_CHUNK=4": {"F32_CHUNK": 4},
    "F32_CHUNK=8": {"F32_CHUNK": 8},
    "F32_CHUNK=16": {"F32_CHUNK": 16},
}
# (B, Sq, Sk, H, Hkv, hd, causal): the prefill of 4 x 500 tokens of
# qwen2-0.5b, qwen2-moe-a2.7b and zamba2-7b's shared attention block
SHAPES = {"qwen2-0.5b": (4, 500, 500, 14, 2, 64, True),
          "qwen2-moe-a2.7b": (4, 500, 500, 16, 16, 128, True),
          "zamba2-7b": (4, 500, 500, 32, 32, 112, True)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--also", action="append", default=[],
                    metavar="LABEL=PATH",
                    help="another flash_attention.cu to time as a variant")
    ap.add_argument("--model", action="append", choices=sorted(SHAPES),
                    help="time only this model's shape (default: all)")
    ap.add_argument("--sass", action="store_true",
                    help="print the SASS opcode counts of each kernel of "
                    "the package's own source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(kv.card())
    variants = {name: (None, c) for name, c in VARIANTS.items()}
    for spec in args.also:
        label, path = spec.split("=", 1)
        variants[label] = (Path(path), {})
    libs = kv.build("flash_attention", variants)
    if args.sass:
        for kernel, ops in kv.sass_opcodes(libs["source"]).items():
            print(f"sass {kernel}: {sum(ops.values())} instructions, "
                  + json.dumps(dict(ops.most_common(16))))
    for model, (B, Sq, Sk, H, Hkv, hd, causal) in SHAPES.items():
        if args.model and model not in args.model:
            continue
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
                       for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd),
                                 (B, Sk, Hkv, hd)))
            q8 = q * 8
            want = gqa_attention_ref(q, k, v, causal).float()
            want8 = gqa_attention_ref(q8, k, v, causal).float()
            # with q x8 the plain fp32 version is itself off the exact
            # result: both are also held against it in float64
            exact8 = gqa_attention_ref(q8.double(), k.double(), v.double(),
                                       causal).float()
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            times = {name: [] for name in libs}
            # max |out - want| and max |out - want| / (tol + tol |want|)
            errors, errors8, sdpa = {}, {}, []
            errors64 = {"plain": (want8 - exact8).abs().max().item()}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    with kv.use("flash_attention", libs[name]):
                        try:
                            out = fa.flash_attention(q, k, v, causal).float()
                            out8 = fa.flash_attention(q8, k, v, causal).float()
                        except RuntimeError as err:   # a refused launch
                            errors[name] = f"FAIL {err}"
                            continue
                        for errs, o, w in ((errors, out, want),
                                           (errors8, out8, want8)):
                            d = (o - w).abs()
                            errs[name] = [d.max().item(), (d / (
                                tol + tol * w.abs())).max().item()]
                        errors64[name] = (out8 - exact8).abs().max().item()
                        times[name].append(kv.cuda_ms(
                            lambda: fa.flash_attention(q, k, v, causal),
                            iters=200))
                sdpa.append(kv.cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), iters=200))
            print(json.dumps({
                "model": model, "shape": [B, Sq, Sk, H, Hkv, hd],
                "dtype": str(dtype).replace("torch.", ""), "ms": times,
                "sdpa_ms": sdpa, "max_abs_err": errors,
                "max_abs_err_q_x8": errors8,
                "max_abs_err_q_x8_vs_float64": errors64}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
