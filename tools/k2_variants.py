#!/usr/bin/env python3
"""Time variants of the port's grouped-GEMM kernel (K2) on one Hopper GPU.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 tools/k2_variants.py

A variant is ``src/repro_torch/kernels/csrc/grouped_matmul.cu`` with
some of its ``constexpr int NAME = value;`` tile constants replaced.
Every variant is built (one ``nvcc`` each, all at once, into
``build/k2_variants/``), launched through the port's own wrapper, held
against the plain version at 2e-5, and timed with CUDA events at the
qwen2-moe-a2.7b serving shapes, densely and with ``rows`` like the moe
path's, in two rounds in opposite orders; ``torch.bmm`` is timed beside
the dense cases. Prints the card's name and power limit, ``ptxas``
registers and spills per variant, and one JSON line per case.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels.ref import grouped_matmul_ref  # noqa: E402

OUT = ROOT / "build" / "k2_variants"
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


def variant_source(text: str, consts: dict) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"constant {name} not found once in the source")
    return text


def build_all() -> dict:
    """{variant: loaded library} of the variants that build, printing
    each kernel's registers and spills and each failed build's log."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "grouped_matmul.cu").read_text()
    procs = {}
    for i, (name, consts) in enumerate(VARIANTS.items()):
        src, lib = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        src.write_text(variant_source(text, consts))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {name}: build failed\n{log[-2000:]}")
            continue
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.split('ptxas info    : ')[-1]}")
        cdll = ctypes.CDLL(str(lib))
        for fn, (restype, argtypes) in _build.SIGNATURES[
                "grouped_matmul"].items():
            getattr(cdll, fn).restype = restype
            getattr(cdll, fn).argtypes = argtypes
        libs[name] = cdll
    return libs


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build_all()
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
                _build._loaded["grouped_matmul"] = libs[name]
                try:
                    out = gm.grouped_matmul(x, w, rows)
                except RuntimeError as err:   # a refused launch
                    errors[name] = f"FAIL {err}"
                    continue
                errors[name] = (out - want).abs().max().item()
                if not torch.allclose(out, want, rtol=2e-5, atol=2e-5):
                    errors[name] = f"FAIL {errors[name]}"
                times[name].append(
                    cuda_ms(lambda: gm.grouped_matmul(x, w, rows)))
        line = {"shape": [E, C, d, f], "rows": kind,
                "ms": times, "max_abs_err": errors}
        if rows is None:
            line["bmm_ms"] = cuda_ms(lambda: torch.bmm(x, w))
        print(json.dumps(line))
    _build._loaded.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
