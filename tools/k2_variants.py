#!/usr/bin/env python3
"""Time variants of the port's grouped-GEMM kernel (K2) on one Hopper GPU.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 tools/k2_variants.py [--dtype bfloat16] [--only NAME ...]
                                 [--also LABEL=PATH ...]
                                 [--phase prefill|decode] [--cold N]

A variant is ``src/repro_torch/kernels/csrc/grouped_matmul.cu`` with
some of its ``constexpr int NAME = value;`` tile constants replaced: the
fp32 prefill variant's (``gmm_wgmma``) n-tile, chunk depth and stages,
the bf16 one's (``gmm_wgmma_bf16``) stages and registers, the fp32
decode variant's (``gmm_small``) tiles, the bf16 decode variant's
(``gmm_decode_bf16``) stages and columns a block, and its ablations
(``D_SKIP``: without the products, without the x copies, the weights
alone; these fail the check by design and are timed all the same).
Every variant is built (one ``nvcc`` each, all at once, into
``build/grouped_matmul_variants/``), launched through the port's own
wrapper, held against the plain version at 2e-5 in fp32 (its distance
to the product computed in float64 printed beside) or 2e-2 in bf16, and
timed at the qwen2-moe-a2.7b serving shapes, densely and with ``rows``
like the moe path's, in two rounds in opposite orders, by CUDA events
(``ms``) and by device time from a torch.profiler trace (``device_ms``,
which leaves out the host where it paces short calls); ``torch.bmm`` is
timed beside the dense cases (in bf16 with
``allow_bf16_reduced_precision_reduction`` printed). With ``--cold N``
the timed calls cycle through N copies of w, so that each reads weights
the last N - 1 calls did not touch (L2 and TLB cold), as the main path's
launches read a new layer's experts each; the first copy is the one
checked. In fp32 the prefill shapes also run with x scaled by 8, held
to the product in float64 at 2e-5. Each case's line names the variant
each source ran (an earlier source without the bf16 tensor-core variant
runs bf16 on ``gmm_large``). ``--only`` keeps some of the variants
below, and
``--also`` adds another source with the same C interface as a variant
of its own (an earlier commit's kernel unpacked with ``git archive``).
Prints the card's name and power limit, ``ptxas`` registers, spills and
wgmma advisories per variant, and one JSON line per case.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from pathlib import Path

import torch

import kernel_variants as kv
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels.ref import grouped_matmul_ref

VARIANTS = {
    "source": {},
    "W_BN=64,W_NT=3": {"W_BN": 64, "W_NT": 3},
    "W_CHUNK=2": {"W_CHUNK": 2},
    "W_CHUNK=1": {"W_CHUNK": 1},
    "W_STAGES=2": {"W_STAGES": 2},
    "W_CONSUMER_REGS=240,W_PRODUCER_REGS=24": {"W_CONSUMER_REGS": 240,
                                               "W_PRODUCER_REGS": 24},
    "S_STAGES=3": {"S_STAGES": 3},
    "B_STAGES=3": {"B_STAGES": 3},
    "B_STAGES=4": {"B_STAGES": 4},
    "B_CONSUMER_REGS=240,B_PRODUCER_REGS=24": {"B_CONSUMER_REGS": 240,
                                               "B_PRODUCER_REGS": 24},
    "B_CONSUMERS=3,B_STAGES=4": {"B_CONSUMERS": 3, "B_STAGES": 4,
                                 "B_CONSUMER_REGS": 160,
                                 "B_PRODUCER_REGS": 24},
    "D_STAGES=2": {"D_STAGES": 2},
    "D_STAGES=4": {"D_STAGES": 4},
    "D_STAGES=6": {"D_STAGES": 6},
    "D_MT=2": {"D_MT": 2},
    "D_MT=2,D_STAGES=6": {"D_MT": 2, "D_STAGES": 6},
    "D_SKIP=1": {"D_SKIP": 1},   # without the products
    "D_SKIP=2": {"D_SKIP": 2},   # without the x copies
    "D_SKIP=3": {"D_SKIP": 3},   # the weights alone
}


def case_rows(kind: str, E: int, C: int, g: torch.Generator):
    """None (dense), or rows like the moe path's: "decode" gives 15
    experts 1-4 rows; "prefill" draws each expert's rows from [0, 164]
    (mean 82 of 192, the mean of the main run's prefill launches); "zero"
    none (what a launch costs that only writes zeros)."""
    if kind == "dense":
        return None
    if kind == "zero":
        return torch.zeros(E, dtype=torch.int32, device="cuda")
    if kind == "decode":
        r = torch.zeros(E, dtype=torch.int32)
        r[torch.randperm(E, generator=g)[:15]] = torch.randint(
            1, 5, (15,), generator=g, dtype=torch.int32)
    else:
        r = torch.randint(0, 165, (E,), generator=g, dtype=torch.int32)
    return r.cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", action="append", choices=sorted(VARIANTS),
                    help="a variant to build (default: all)")
    ap.add_argument("--also", action="append", default=[],
                    metavar="LABEL=PATH",
                    help="another grouped_matmul.cu to time as a variant")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="x's and w's dtype")
    ap.add_argument("--phase", choices=("prefill", "decode"),
                    help="only the prefill (C = 192) or the decode (C = 32) "
                         "shapes (default: both)")
    ap.add_argument("--cold", type=int, default=1, metavar="N",
                    help="time calls that cycle through N copies of w")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    print(kv.card())
    print(f"dtype {args.dtype}; torch.bmm's "
          f"allow_bf16_reduced_precision_reduction = "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    variants = {name: (None, c) for name, c in VARIANTS.items()
                if not args.only or name in args.only}
    for spec in args.also:
        label, path = spec.split("=", 1)
        variants[label] = (Path(path), {})
    libs = kv.build("grouped_matmul", variants)
    g = torch.Generator().manual_seed(0)
    cases = [((60, 192, 2048, 1408), "dense", 1),
             ((60, 192, 1408, 2048), "dense", 1),
             ((60, 192, 2048, 1408), "prefill", 1),
             ((60, 192, 1408, 2048), "prefill", 1),
             ((60, 192, 2048, 1408), "dense", 8),
             ((60, 192, 1408, 2048), "prefill", 8),
             ((60, 32, 2048, 1408), "dense", 1),
             ((60, 32, 1408, 2048), "dense", 1),
             ((60, 32, 2048, 1408), "decode", 1),
             ((60, 32, 1408, 2048), "decode", 1),
             ((60, 32, 2048, 1408), "zero", 1)]
    if dtype != torch.float32:
        cases = [c for c in cases if c[2] == 1]
    if args.phase:
        prefill = args.phase == "prefill"
        cases = [c for c in cases if (c[0][1] > 32) == prefill]
    for (E, C, d, f), kind, scale in cases:
        x = (torch.randn((E, C, d), device="cuda") * scale).to(dtype)
        w = (torch.randn((E, d, f), device="cuda") / math.sqrt(d)).to(dtype)
        rows = case_rows(kind, E, C, g)
        if rows is not None:
            live = torch.arange(C, device="cuda") < rows[:, None]
            x = torch.where(live[..., None], x, 0)
        want = grouped_matmul_ref(x, w, rows)
        exact = torch.einsum("ecd,edf->ecf", x.double(), w.double())
        if rows is not None:
            exact = torch.where(live[..., None], exact, 0)
        held = want if scale == 1 else exact
        ws = itertools.cycle([w] + [w.clone() for _ in range(args.cold - 1)])
        times = {name: [] for name in libs}
        dev = {name: [] for name in libs}
        errors, errors64, ran = {}, {}, {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                with kv.use("grouped_matmul", libs[name]):
                    before = dict(gm.route_launches)
                    try:
                        out = gm.grouped_matmul(x, w, rows)
                    except RuntimeError as err:   # a refused launch
                        errors[name] = f"FAIL {err}"
                        continue
                    ran[name] = [k for k, n in gm.route_launches.items()
                                 if n != before[k]]
                    errors[name] = (out.float() - want.float()
                                    ).abs().max().item()
                    errors64[name] = (out.double() - exact).abs().max().item()
                    if not torch.allclose(out.double(), held.double(),
                                          rtol=tol, atol=tol):
                        errors[name] = f"FAIL {errors[name]}"
                    times[name].append(kv.cuda_ms(
                        lambda: gm.grouped_matmul(x, next(ws), rows)))
                    dev[name].append(kv.device_ms(
                        lambda: gm.grouped_matmul(x, next(ws), rows)))
        line = {"shape": [E, C, d, f], "dtype": args.dtype, "rows": kind,
                "x_scale": scale, "cold": args.cold, "ms": times,
                "device_ms": dev,
                "variant": ran,
                "max_abs_err": errors, "max_abs_err_float64": errors64,
                "plain_max_abs_err_float64": (
                    want.double() - exact).abs().max().item()}
        if rows is None:
            line["bmm_ms"] = kv.cuda_ms(lambda: torch.bmm(x, next(ws)))
            line["bmm_device_ms"] = kv.device_ms(
                lambda: torch.bmm(x, next(ws)))
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
