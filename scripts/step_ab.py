"""Host time of two source trees of the port on one card, in turns.

Each run measures, on full-width qwen2-0.5b with weights drawn from
seed 0:

- the training step (8 x 256 tokens, masked attention, fp32, TF32 off),
  plain and then sharded on a one-rank nccl (1, 1) mesh placed by the
  sharding rules, as ``chip_smoke.py``'s mesh phase (a) takes it: ms a
  step, the median after the first;
- the served decode step (``ServeEngine.generate``, 4 x 128 prompt, 32
  new tokens): ms a step, the median of three calls after a warm-up;
- with ``--profile``, one more sharded step under ``cProfile``: its
  wall time, the DTensor results its ops made, and the cumulative time
  of the port's functions that take most of it.

    python3 scripts/step_ab.py OLD/src src [--rounds 2] [--profile]

Each (tree, round) runs in a process of its own with that tree first on
``sys.path``, in the order A B B A for two rounds, so a drift of the
host's load falls on both trees alike. Prints one JSON line a run, the
card's name and power limit, and then the medians of each tree.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ARCH = "qwen2-0.5b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 256, 6
SERVE_B, SERVE_S, SERVE_NEW, SERVE_CALLS = 4, 128, 32, 3


def _child(src: str, profile: bool) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.checkpoint.elastic import reshard_state
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.sharding import (batch_specs, param_specs,
                                                  placements, state_specs)
    from repro_torch.launch.mesh import make_local_mesh, process_group
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[ARCH]
    out = {"package": os.path.dirname(repro_torch.__file__)}

    engine = ServeEngine(cfg, params=build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        max_seq=512, device="cuda")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S))
    engine.generate(prompt, SERVE_NEW)
    decode = [engine.generate(prompt, SERVE_NEW).decode_s / SERVE_NEW * 1e3
              for _ in range(SERVE_CALLS)]
    out["decode_ms"] = decode
    del engine

    model = build_model(cfg, use_flash=False)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                              generator=g).cuda()
             for k in ("tokens", "targets")}
    step = make_train_step(model, peak_lr=1e-3, warmup=1)

    def timed(state, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cuda")
    out["plain_ms"] = [timed(state, batch) for _ in range(TRAIN_STEPS)]
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cuda")
    with process_group("nccl"):
        mesh = make_local_mesh()
        state = reshard_state(state, mesh, state_specs(
            cfg, mesh, param_specs(cfg, state["params"], mesh)))
        bs = batch_specs(cfg, "train", mesh)
        placed = {k: torch.distributed.tensor.distribute_tensor(
            v, mesh, placements(bs[k], mesh)) for k, v in batch.items()}
        out["sharded_ms"] = [timed(state, placed)
                             for _ in range(TRAIN_STEPS)]
        if profile:
            out["profile"] = _profiled(lambda: timed(state, placed))
    for k in ("decode_ms", "plain_ms", "sharded_ms"):
        xs = out[k] if k == "decode_ms" else out[k][1:]
        out[k.replace("_ms", "_median_ms")] = statistics.median(xs)
    return out


def _profiled(fn) -> dict:
    """One call of ``fn`` under cProfile: its wall time, the count of
    DTensor results its ops made (calls of DTensor's dispatcher's
    ``wrap``, one an op output), and the port's functions by cumulative
    time (the 12 largest)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    wall = (time.perf_counter() - t) * 1e3
    stats = pstats.Stats(prof).stats
    results = sum(
        v[1] for (f, _, name), v in stats.items()
        if f.endswith(os.path.join("distributed", "tensor", "_dispatch.py"))
        and name == "wrap")
    ours = sorted(((v[3], v[1], f"{os.path.basename(f)}:{name}")
                   for (f, _, name), v in stats.items()
                   if f"{os.sep}repro_torch{os.sep}" in f),
                  reverse=True)[:12]
    return {"wall_ms": wall, "dtensor_results": results,
            "python_calls": sum(v[1] for v in stats.values()),
            "by_cumulative_ms": [[name, calls, cum * 1e3]
                                 for cum, calls, name in ours]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", help="two source directories")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("RESULT " + json.dumps(_child(args.child, args.profile)))
        return
    if len(args.trees) != 2:
        ap.error("give two source directories")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    order = []
    for r in range(args.rounds):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    runs = {t: [] for t in args.trees}
    for tree in order:
        cmd = [sys.executable, __file__, "--child", tree]
        if args.profile:
            cmd.append("--profile")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"the run of {tree} failed")
        res = json.loads(next(ln for ln in proc.stdout.splitlines()
                              if ln.startswith("RESULT "))[7:])
        res["tree"] = tree
        runs[tree].append(res)
        print(json.dumps(res), flush=True)
    print(card)
    print(json.dumps({t: {k: statistics.median(r[k] for r in rs)
                          for k in ("decode_median_ms", "plain_median_ms",
                                    "sharded_median_ms")}
                      for t, rs in runs.items()}))


if __name__ == "__main__":
    main()
