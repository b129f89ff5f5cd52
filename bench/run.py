#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port on one NVIDIA H100.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic
mix, metrics and limits come from ``BENCHMARK.json`` and the files it
names (``bench/manifest.py``). The run draws the weights on the card
from the seed, warms up every shape of the mix, serves the mix through
the port's ``ServeEngine.generate`` in a closed loop for at least
``--seconds`` (whole cycles of the mix), checks what it served against
the plain reference (``bench/check.py``), and prints as its last line
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit (also the last lines
on standard error).

Exits non-zero and prints no result without a CUDA device (or fewer
than the cell asks for), without the port's sources, or if JAX or the
JAX package was loaded.
"""
import time

T0 = time.perf_counter()   # the run's start: set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port builds its kernels into ``build/repro_torch`` itself."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / "bench" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs(ROOT)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"bench: no port under {ROOT / 'src'}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import harness
    from bench.manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(manifest, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"bench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    ctx = out.context
    print(f"card: {harness.card()}; torch {torch.__version__}")
    print(f"card beside the window: {json.dumps(out.card)}")
    print(f"launches by variant in the window: {json.dumps(out.routes)}")
    print(f"set-up parts (s): {json.dumps(out.setup_parts)}")
    print(f"window: {len(ctx.batches)} batches, "
          f"{sum(b.rows for b in ctx.batches)} requests, {ctx.window_s} s; "
          f"set-up {ctx.setup_s} s; tokens judged {out.tokens_judged} "
          f"in {out.check_s} s")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": ctx.memory_peak_bytes}
    result = {"correct": harness.correct(out), "attempted": out.attempted,
              "failed": out.failed,
              "metrics": harness.metrics(manifest, out, bool(args.trace)),
              "device": device}
    if args.trace:
        device["busy_s"] = sum(t.busy_s for t in ctx.traced)
        device["window_s"] = sum(t.wall_s for t in ctx.traced)
        result["breakdown"] = harness.breakdown(ctx.traced)
    result["checks"] = out.checks
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
