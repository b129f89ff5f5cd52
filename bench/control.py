#!/usr/bin/env python3
"""The readings that a cell's limit is set from, on the card: the
program's widest gap on many seeds and the float8 control's on some of
them, in one process (each seed a whole run of the cell: weights,
warm-up, a window at the cell's own load, the check of outputs).

    python3 bench/control.py --workload <cell> --seconds <s> \\
        --seeds 11 12 ... --control-seeds 11 12 13 [--out FILE]

Prints one JSON line a seed (and appends it to ``--out``): the window's
batches and requests, the tokens judged, the program's gaps, its
numbers beside the cell's limits (``limits/<cell>.json``) and its
verdict, and for a control seed the same of the control: its tokens go
through the same comparison and ``harness.passes`` in the program's
place, so a control that the check catches reads ``"correct": false``.
The verdicts are also the last lines on standard error. The
benchmark's own runs never run the control.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import check, harness
    from bench.manifest import Manifest
    from bench.run import cache_dirs

    cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT)
    limits = manifest.cell(args.workload).limits
    t0 = T0
    verdicts = []
    for seed in args.seeds:
        out = harness.run_cell(manifest, args.workload, seed, args.seconds,
                               False, "cuda", t0,
                               control=seed in args.control_seeds)
        t0 = time.perf_counter()
        ctx = out.context
        line = {"workload": args.workload, "seed": seed,
                "batches": len(ctx.batches), "attempted": out.attempted,
                "failed": out.failed, "tokens": out.tokens_judged,
                "correct": harness.correct(out), "checks": out.checks,
                "gaps": out.gaps, "check_s": out.check_s,
                "setup_s": ctx.setup_s, "window_s": ctx.window_s}
        verdicts.append(f"program seed {seed}: correct {line['correct']}")
        if out.control_gaps:
            # the control in the program's place: its tokens were served
            # for every row of the sample, and each is a vocabulary id
            cc = harness.compare(limits, 0, 0,
                                 check.numbers(out.control_gaps))
            ok = harness.passes(cc, len(out.control_gaps))
            line["control"] = {"correct": ok, "checks": cc,
                               "gaps": out.control_gaps}
            verdicts.append(f"control seed {seed}: correct {ok}; " + "; ".join(
                f"{k} {c['value']} (limit {c['limit']})"
                for k, c in cc.items()))
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    for v in verdicts:
        print(v, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
