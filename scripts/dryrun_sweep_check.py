"""Hold a whole sweep of the port's dry run to the reference's, row by
row, with no JAX.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --out results/sweep.jsonl
    python3 scripts/dryrun_sweep_check.py results/sweep.jsonl [more.jsonl ...] \\
        [--same-as other_release.jsonl ...]

Reads the port's sweep (one or more JSONL files of
``repro_torch.launch.dryrun`` rows; a cell met twice takes its last row)
and ``scripts/dryrun_reference.jsonl``, the reference's per-device FLOPs
and collective bytes of every (arch, shape, mesh) row. Every row the
reference ran must be ``ok`` in the port, its FLOPs within
``DRYRUN_FLOPS_RTOL`` of the reference's and its collective bytes within
``DRYRUN_COLL_RTOL`` of the reference's times the row's expected ratio
(``repro_torch.launch.dryrun_expect``); every row the reference skipped
must be skipped. ``--same-as``: another sweep of the port (another torch
release) whose rows must agree with these, collective bytes within
``DRYRUN_RELEASE_COLL_RTOL`` and FLOPs within
``DRYRUN_RELEASE_FLOPS_RTOL``. Prints one line per row and exits 1
naming each row that fails or is missing.

The reference table is made from the reference's own sweep, in the
machine that has JAX (~3 min on the CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --out ref.jsonl
    PYTHONPATH=src python scripts/dryrun_sweep_check.py --make-reference ref.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import SHAPES_BY_NAME  # noqa: E402
from repro_torch.launch.dryrun_expect import (  # noqa: E402
    DRYRUN_RELEASE_COLL_RTOL, DRYRUN_RELEASE_FLOPS_RTOL, coll_expect,
    row_faults)

REFERENCE = ROOT / "scripts" / "dryrun_reference.jsonl"
KEYS = ("arch", "shape", "mesh", "status", "flops_per_device",
        "collective_bytes_per_device")
Cell = Tuple[str, str, str]


def read_rows(paths) -> Dict[Cell, dict]:
    """{(arch, shape, mesh): row} of JSONL files of dry-run rows; a line
    without "arch" (a header) is skipped."""
    rows = {}
    for path in paths:
        for line in Path(path).read_text().splitlines():
            if not line.strip():
                continue
            r = json.loads(line)
            if "arch" in r:
                rows[(r["arch"], r["shape"], r["mesh"])] = r
    return rows


def read_reference() -> Tuple[dict, Dict[Cell, dict]]:
    """(the header, the rows) of the committed reference table."""
    lines = REFERENCE.read_text().splitlines()
    return json.loads(lines[0]), read_rows([REFERENCE])


def check(port: Dict[Cell, dict], ref: Dict[Cell, dict],
          same_as: Dict[Cell, dict] = None) -> Tuple[List[str], List[str]]:
    """(a line for each row, the rows that fail or are missing, each with
    why) of a port sweep against the reference table."""
    lines, bad = [], []
    for cell, want in ref.items():
        name = " x ".join(cell)
        got = port.get(cell)
        if got is None:
            bad.append(f"{name}: missing")
            lines.append(f"MISSING {name}")
            continue
        if want["status"] != "ok":
            faults = [] if got["status"] == want["status"] else [
                f"status {got['status']}, the reference's {want['status']}"]
            lines.append(f"{'ok  ' if not faults else 'FAIL'} {name}: "
                         f"{got['status']}")
        else:
            kind = SHAPES_BY_NAME[cell[1]].kind
            faults = row_faults(got, want, kind)
            if got["status"] == "ok":
                lines.append(
                    f"{'ok  ' if not faults else 'FAIL'} {name}: FLOPs "
                    f"{got['flops_per_device'] / want['flops_per_device']:.4f}"
                    f", collective bytes "
                    f"{got['collective_bytes_per_device'] / want['collective_bytes_per_device']:.4f}"
                    f" (expected {coll_expect(*cell, kind):.4f})")
            else:
                lines.append(f"FAIL {name}: {got['status']}")
        if same_as is not None and got["status"] == "ok":
            other = same_as.get(cell)
            if other is None or other["status"] != "ok":
                faults.append("missing from the other sweep")
            else:
                for key, tol in (("flops_per_device", DRYRUN_RELEASE_FLOPS_RTOL),
                                 ("collective_bytes_per_device",
                                  DRYRUN_RELEASE_COLL_RTOL)):
                    rel = got[key] / other[key] - 1 if other[key] else 0.0
                    if abs(rel) > tol:
                        faults.append(f"{key} {rel:+.3e} off the other sweep's")
        if faults:
            bad.append(f"{name}: " + "; ".join(faults))
    return lines, bad


def make_reference(sweep: str) -> None:
    """Write the reference table from the reference's own sweep (JSONL
    of ``repro.launch.dryrun`` rows), its header naming the jax and
    jaxlib it ran on."""
    import jax
    import jaxlib

    rows = read_rows([sweep])
    header = {"reference": "python -m repro.launch.dryrun (JAX_PLATFORMS=cpu)",
              "jax": jax.__version__, "jaxlib": jaxlib.__version__,
              "rows": len(rows)}
    with open(REFERENCE, "w") as f:
        f.write(json.dumps(header) + "\n")
        for r in rows.values():
            f.write(json.dumps({k: r[k] for k in KEYS if k in r}) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweep", nargs="*", help="the port's sweep, JSONL")
    ap.add_argument("--same-as", nargs="+", default=None,
                    help="another sweep of the port to agree with")
    ap.add_argument("--make-reference", metavar="REF_SWEEP",
                    help="write the reference table from the reference's "
                         "sweep (needs JAX) and exit")
    args = ap.parse_args(argv)
    if args.make_reference:
        make_reference(args.make_reference)
        return 0
    if not args.sweep:
        ap.error("no sweep given")
    header, ref = read_reference()
    same = read_rows(args.same_as) if args.same_as else None
    lines, bad = check(read_rows(args.sweep), ref, same)
    print("\n".join(lines))
    print(f"{len(ref) - len(bad)} of {len(ref)} rows held to the reference "
          f"(jax {header['jax']})")
    if bad:
        print("FAILED:\n  " + "\n  ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
