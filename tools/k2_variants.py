#!/usr/bin/env python3
"""Time variants of the port's grouped-GEMM kernel (K2) on one Hopper GPU.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 tools/k2_variants.py

A variant is ``src/repro_torch/kernels/csrc/grouped_matmul.cu`` with
some of its ``constexpr int NAME = value;`` tile constants replaced.
Every variant is built (one ``nvcc`` each, all at once, into
``build/grouped_matmul_variants/``), launched through the port's own
wrapper, held against the plain version at 2e-5, and timed with CUDA
events at the qwen2-moe-a2.7b serving shapes, densely and with ``rows``
like the moe path's, in two rounds in opposite orders; ``torch.bmm`` is
timed beside the dense cases. Prints the card's name and power limit,
``ptxas`` registers and spills per variant, and one JSON line per case.
"""
from __future__ import annotations

import json
import math
import sys

import torch

import kernel_variants as kv
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels.ref import grouped_matmul_ref

VARIANTS = {
    "source": {},
    "S_BN=64,S_KC=32,S_STAGES=3": {"S_BN": 64, "S_KC": 32, "S_STAGES": 3},
    "S_KC=32,S_STAGES=3": {"S_KC": 32, "S_STAGES": 3},
    "S_STAGES=3": {"S_STAGES": 3},
    "S_BN=64,S_KC=64": {"S_BN": 64},
    "L_BM=32": {"L_BM": 32},
    "L_STAGES=4": {"L_STAGES": 4},
    "L_MIN_BLOCKS=2": {"L_MIN_BLOCKS": 2},
    "L_WARP_TX=8": {"L_WARP_TX": 8},
    "L_BK=32": {"L_BK": 32},
}


def case_rows(kind: str, E: int, C: int, g: torch.Generator):
    """None (dense), or rows like the moe path's: "decode" gives 15
    experts 1-4 rows; "prefill" draws each expert's rows from [0, 164]
    (mean 82 of 192, the mean of the main run's prefill launches)."""
    if kind == "dense":
        return None
    if kind == "decode":
        r = torch.zeros(E, dtype=torch.int32)
        r[torch.randperm(E, generator=g)[:15]] = torch.randint(
            1, 5, (15,), generator=g, dtype=torch.int32)
    else:
        r = torch.randint(0, 165, (E,), generator=g, dtype=torch.int32)
    return r.cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(kv.card())
    libs = kv.build("grouped_matmul",
                    {name: (None, c) for name, c in VARIANTS.items()})
    g = torch.Generator().manual_seed(0)
    cases = [((60, 192, 2048, 1408), "dense"), ((60, 192, 1408, 2048), "dense"),
             ((60, 192, 2048, 1408), "prefill"),
             ((60, 192, 1408, 2048), "prefill"),
             ((60, 32, 2048, 1408), "dense"), ((60, 32, 1408, 2048), "dense"),
             ((60, 32, 2048, 1408), "decode"), ((60, 32, 1408, 2048), "decode")]
    for (E, C, d, f), kind in cases:
        x = torch.randn((E, C, d), device="cuda")
        w = torch.randn((E, d, f), device="cuda") / math.sqrt(d)
        rows = case_rows(kind, E, C, g)
        if rows is not None:
            live = torch.arange(C, device="cuda") < rows[:, None]
            x = torch.where(live[..., None], x, 0)
        want = grouped_matmul_ref(x, w, rows)
        times = {name: [] for name in libs}
        errors = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                with kv.use("grouped_matmul", libs[name]):
                    try:
                        out = gm.grouped_matmul(x, w, rows)
                    except RuntimeError as err:   # a refused launch
                        errors[name] = f"FAIL {err}"
                        continue
                    errors[name] = (out - want).abs().max().item()
                    if not torch.allclose(out, want, rtol=2e-5, atol=2e-5):
                        errors[name] = f"FAIL {errors[name]}"
                    times[name].append(
                        kv.cuda_ms(lambda: gm.grouped_matmul(x, w, rows)))
        line = {"shape": [E, C, d, f], "rows": kind,
                "ms": times, "max_abs_err": errors}
        if rows is None:
            line["bmm_ms"] = kv.cuda_ms(lambda: torch.bmm(x, w))
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
