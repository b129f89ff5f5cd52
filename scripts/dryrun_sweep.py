"""The port's whole dry-run sweep in eight processes, then
``scripts/dryrun_sweep_check.py`` on it.

    python3 scripts/dryrun_sweep.py --out results/sweep [--same-as A.jsonl ...]

Each process runs ``python -m repro_torch.launch.dryrun`` over its share
of the (arch, shape, mesh) rows into ``OUT/<share>.jsonl`` (resumable: a
rerun skips the rows already done; ``--force`` starts over). The shares
even out the host time: xLSTM's train and prefill rows take minutes each
(the sLSTM's 4096 or 32768 steps under the op counter), every other row
seconds. Exits with the check's code; ``--same-as`` is passed on to it
(another release's sweep to agree with).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (name, [(arch, shape or None, mesh), ...]): one process each
SHARES = (
    ("x_train_single", [("xlstm-350m", "train_4k", "single")]),
    ("x_prefill_single", [("xlstm-350m", "prefill_32k", "single")]),
    ("x_train_multi", [("xlstm-350m", "train_4k", "multi")]),
    ("x_prefill_multi", [("xlstm-350m", "prefill_32k", "multi")]),
    ("z", [("zamba2-7b", None, "both"),
           ("xlstm-350m", "decode_32k", "both"),
           ("xlstm-350m", "long_500k", "both")]),
    ("a", [("qwen2-0.5b", None, "both"), ("internvl2-1b", None, "both"),
           ("qwen2-72b", None, "both")]),
    ("b", [("qwen3-14b", None, "both"), ("minicpm-2b", None, "both"),
           ("musicgen-large", None, "both")]),
    ("c", [("qwen2-moe-a2.7b", None, "both"), ("dbrx-132b", None, "both")]),
)


def _share(out: Path, rows) -> str:
    """A shell command running one share's rows in turn."""
    cmds = []
    for arch, shape, mesh in rows:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--mesh", mesh, "--out", str(out)]
        if shape:
            cmd += ["--shape", shape]
        cmds.append(" ".join(cmd))
    return " && ".join(cmds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/sweep")
    ap.add_argument("--same-as", nargs="+", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.force:
        for name, _ in SHARES:
            (out / f"{name}.jsonl").unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    procs = []
    for name, rows in SHARES:
        log = open(out / f"{name}.log", "w")
        procs.append((name, subprocess.Popen(
            _share(out / f"{name}.jsonl", rows), shell=True, env=env,
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    for name, p, log in procs:
        if p.wait():
            failed.append(name)
        log.close()
        print(f"share {name}: exit {p.returncode}, {time.time() - t0:.1f} s",
              flush=True)
    print(f"sweep: {time.time() - t0:.1f} s in {len(SHARES)} processes",
          flush=True)
    cmd = [sys.executable, str(ROOT / "scripts" / "dryrun_sweep_check.py")]
    cmd += [str(out / f"{name}.jsonl") for name, _ in SHARES]
    if args.same_as:
        cmd += ["--same-as", *args.same_as]
    rc = subprocess.run(cmd, env=env).returncode
    if failed:
        print(f"shares that failed: {failed}")
    return rc or bool(failed)


if __name__ == "__main__":
    sys.exit(main())
