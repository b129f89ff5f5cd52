"""Roofline report: reads the dry-run JSONL and emits the tables.

Copy of the reference package's ``launch/roofline.py`` (free of JAX),
its constants those of ``npu.hw_config.H100Roofline``, the divisors
``launch/dryrun.py`` applies. Per (arch x shape) on the single-pod
mesh:
  compute_s    = FLOPs_per_device / 989.4e12          (bf16 dense peak, H100 SXM5)
  memory_s     = bytes_per_device / 3.35e12           (HBM3 BW)
  collective_s = collective_bytes_per_device / 50e9   (400 Gb/s per-GPU
                                                       inter-node link)
plus the dominant term, MODEL_FLOPS (6ND / 2ND) per chip, and the
useful-FLOPs ratio (model/counted: remat & redundancy show up here).
Spec-sheet constants: the terms model a cluster, they measure nothing.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline \
           [--in results/dryrun.jsonl] [--mesh single]
"""
from __future__ import annotations

import argparse
import json
from collections import OrderedDict
from typing import Dict, List


def load_rows(path: str, mesh: str = "single") -> List[Dict]:
    rows: "OrderedDict[tuple, Dict]" = OrderedDict()
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except Exception:
                continue
            if r.get("mesh") != mesh:
                continue
            rows[(r["arch"], r["shape"])] = r  # last write wins (resume)
    return list(rows.values())


def _fmt_s(x: float) -> str:
    if x <= 0:
        return "0"
    if x < 1e-6:
        return f"{x*1e9:.1f}ns"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.2f}s"


def markdown_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | status | compute | memory | collective | "
           "dominant | roofline frac | useful FLOPs | mem/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in rows:
        if r["status"] == "skip":
            out.append(
                f"| {r['arch']} | {r['shape']} | SKIP | - | - | - | - | - |"
                f" - | {r.get('reason','')[:48]} |")
            continue
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | ERROR | - | - | - | - | - |"
                f" - | {r.get('error','')[:48]} |")
            continue
        c, m, k = (r["compute_term_s"], r["memory_term_s"],
                   r["collective_term_s"])
        bound = max(c, m, k)
        total = c + m + k
        frac = c / bound if bound else 0.0  # compute frac of the bound
        temp = r["mem"]["temp_bytes"] / 2**30
        args = (r["mem"]["argument_bytes"] - r["mem"]["alias_bytes"]) / 2**30
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {_fmt_s(c)} | {_fmt_s(m)} |"
            f" {_fmt_s(k)} | {r['dominant'].replace('_term_s','').replace('_s','')} |"
            f" {frac:.2f} | {r['useful_flops_ratio']:.2f} |"
            f" {args + temp:.2f}GiB |")
    return "\n".join(out)


def summarize(rows: List[Dict]) -> Dict:
    ok = [r for r in rows if r["status"] == "ok"]
    dom: Dict[str, int] = {}
    for r in ok:
        dom[r["dominant"]] = dom.get(r["dominant"], 0) + 1
    worst = sorted(
        ok, key=lambda r: r["compute_term_s"]
        / max(r["compute_term_s"] + r["memory_term_s"]
              + r["collective_term_s"], 1e-30))
    coll = sorted(ok, key=lambda r: -r["collective_term_s"])
    return {
        "n_ok": len(ok),
        "dominant_counts": dom,
        "worst_compute_frac": [(r["arch"], r["shape"]) for r in worst[:5]],
        "most_collective": [(r["arch"], r["shape"],
                             r["collective_term_s"]) for r in coll[:5]],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="results/dryrun.jsonl")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    rows = load_rows(args.inp, args.mesh)
    print(markdown_table(rows))
    print()
    s = summarize(rows)
    print(f"cells ok: {s['n_ok']}; dominant terms: {s['dominant_counts']}")
    print("worst compute fraction:", s["worst_compute_frac"])
    print("most collective-bound:", s["most_collective"])


if __name__ == "__main__":
    main()
