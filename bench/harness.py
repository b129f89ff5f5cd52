"""One run of one cell: set-up, the timed window, an optional traced
cycle, the check of outputs, and the result.

The program under test is the port's ``ServeEngine.generate``, driven
in a closed loop: one batch in flight, the next submitted when the last
returns. The window starts after the warm-up and ends at the end of
the first whole cycle of the mix that ends ``seconds`` or more after
its start, so every window carries the mix's proportions. Nothing but
the program's own work and the host's bookkeeping of batches runs in
the window.
"""
from __future__ import annotations

import contextlib
import gc
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import check, tracing, weights, workcount
from bench.manifest import Cell, Manifest

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class BatchRecord:
    index: int
    rows: int
    prompt: int
    n_new: int
    start_s: float        # from the window's start
    wall_s: float         # the call to generate, host clock
    prefill_s: float      # the engine's own
    decode_s: float
    ok: bool


@dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    cell: Cell
    sizes: workcount.Sizes
    setup_s: float
    window_s: float                 # window start to last completion
    batches: List[BatchRecord]
    memory_peak_bytes: Optional[int]
    launches: Optional[List[tracing.Launch]] = None   # window, trace runs
    traced: List[tracing.TracedBatch] = field(default_factory=list)

    @property
    def served(self) -> List[BatchRecord]:
        return [b for b in self.batches if b.ok]


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig

    s = workcount.sizes(cfg)
    kw = dict(name=cfg["name"], family=cfg["family"], n_layers=s.n_layers,
              d_model=s.d, n_heads=s.heads, n_kv_heads=s.kv_heads,
              d_head=s.head_dim, d_ff=cfg["intermediate_size"],
              vocab_size=s.vocab, qkv_bias=s.qkv_bias, qk_norm=s.qk_norm,
              rope_theta=float(cfg["rope_theta"]),
              tie_embeddings=cfg["tie_word_embeddings"],
              norm_eps=cfg["rms_norm_eps"])
    if s.moe:
        kw.update(n_experts=s.experts, n_experts_per_tok=s.top_k,
                  d_expert=s.expert_ffn,
                  n_shared_experts=s.shared_ffn // s.expert_ffn)
    return ModelConfig(**kw)


def seeds(seed: int) -> Dict[str, np.random.SeedSequence]:
    root = np.random.SeedSequence(seed % 2 ** 64)
    return dict(zip(("weights", "traffic", "warmup", "sample"),
                    root.spawn(4)))


def weight_seed(ss: np.random.SeedSequence) -> int:
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Outcome:
    context: Context
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    routes: Dict[str, Dict[str, int]]
    setup_parts: Dict[str, float]   # seconds of each set-up step
    card: Dict[str, str]            # clocks, power, temperature around the window
    tokens_judged: int
    check_s: float                  # the check of outputs, host clock
    gaps: Optional[List[float]] = None          # every judged token's
    control_gaps: Optional[List[float]] = None


def card(query: str = "name,power.limit") -> str:
    """``nvidia-smi``'s reading of ``query`` (read only)."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"


def _card(device) -> str:
    """The card's clocks, power and temperature, read just outside the
    window."""
    if device.type != "cuda":
        return ""
    return card("clocks.sm,clocks.mem,power.draw,temperature.gpu")


def _rows_to_host(launches: List[tracing.Launch]) -> None:
    """K2's rows of ``launches`` copied to the host in one transfer."""
    ks = [x for x in launches if x.rows is not None]
    if ks:
        for x, r in zip(ks, torch.stack([x.rows for x in ks]).cpu()):
            x.rows = r


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float,
             trace: bool, device, t0: float,
             control: bool = False) -> Outcome:
    """One run of cell ``name``. ``control`` (never set by ``run.py``)
    also reads the float8 control's gaps on the same sample."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.serve.engine import ServeEngine

    device = torch.device(device)
    cell = manifest.cell(name)
    cfg, mix = cell.config, cell.mix
    gen = manifest.generator(mix["kind"])
    ref = manifest.reference(cfg["family"])
    dtype = DTYPES[cfg["torch_dtype"]]
    ss = seeds(seed)
    wseed = weight_seed(ss["weights"])

    # ---- set-up: weights from the seed, the engine, the warm-up ----
    parts = {"start": time.perf_counter() - t0}
    t = time.perf_counter()
    tensors = weights.draw(ref.param_specs(cfg), wseed, dtype, device)
    mcfg = port_config(cfg)
    module = weights.port_module(cfg["port_params"], mcfg, tensors, dtype)
    del tensors
    eng = ServeEngine(mcfg, params=module, max_seq=int(mix["max_seq"]),
                      device=device)
    _sync(device)
    parts["weights"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    warm = np.random.default_rng(ss["warmup"])
    rows, vocab = int(mix["rows"]), cfg["vocab_size"]
    for S in gen.warmup_lengths(mix):
        t = time.perf_counter()
        eng.generate(warm.integers(0, vocab, (rows, S), dtype=np.int32),
                     n_new=min(2, int(mix["n_new"])))
        _sync(device)
        parts[f"warmup_{S}"] = time.perf_counter() - t

    # ---- the window ----
    card = {"before": _card(device)}
    for mod in (fa, gm):
        for v in mod.route_launches:
            mod.route_launches[v] = 0
    stream = gen.batches(mix, vocab, np.random.default_rng(ss["traffic"]))
    records: List[BatchRecord] = []
    served: List[List[check.Served]] = []
    launches: Optional[List[tracing.Launch]] = [] if trace else None
    group_rows = ref.group_rows(cfg, rows)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t0
    deadline = t_w0 + seconds
    end = t_w0
    with (tracing.recording(eng.model, launches) if trace
          else contextlib.nullcontext()):
        for b in stream:
            t_a = time.perf_counter()
            try:
                res = eng.generate(b.tokens, n_new=b.n_new)
                ok = True
            except Exception as err:   # counted as failed rows, reported
                print(f"batch {b.index}: generate raised {err!r}",
                      flush=True)
                ok = False
            end = time.perf_counter()
            records.append(BatchRecord(
                b.index, b.rows, b.prompt, b.n_new, t_a - t_w0, end - t_a,
                res.prefill_s if ok else 0.0, res.decode_s if ok else 0.0,
                ok))
            if not ok:
                break
            toks = np.asarray(res.tokens)
            for g in range(0, b.rows, group_rows):
                served.append([check.Served(b.tokens[r], toks[r])
                               for r in range(g, g + group_rows)])
            if end >= deadline and b.last_in_cycle:
                break
    window_s = end - t_w0
    card["after"] = _card(device)
    routes = {"K1": dict(fa.route_launches), "K2": dict(gm.route_launches)}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)

    traced: List[tracing.TracedBatch] = []
    if trace and all(r.ok for r in records):
        cycle = []
        for b in stream:
            cycle.append(b)
            if b.last_in_cycle:
                break
        traced = tracing.trace_batches(eng, cycle)
    ctx = Context(cell, workcount.sizes(cfg), setup_s, window_s, records,
                  peak, launches, traced)
    _rows_to_host((launches or []) + [x for tb in traced
                                      for x in tb.launches])

    # ---- the check of outputs, with the program freed ----
    del eng, module
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    attempted = sum(r.rows for r in records)
    failed = sum(r.rows for r in records if not r.ok)
    out_of_range = sum(int(((u.tokens < 0) | (u.tokens >= vocab)).sum())
                       for unit in served for u in unit)
    judged, t_c, got = 0, time.perf_counter(), {}
    if served and not out_of_range:
        chosen = check.sample(served, int(cell.limits["sample_units"]),
                              np.random.default_rng(ss["sample"]))
        got = check.judge(cfg, ref, wseed, dtype, device, chosen, control)
        judged = got["tokens"]
    checks = compare(cell.limits, failed, out_of_range, got or None)
    _sync(device)
    return Outcome(ctx, attempted, failed, checks, routes, parts, card, judged,
                   time.perf_counter() - t_c, got.get("gaps"),
                   got.get("control_gaps"))


def compare(limits: dict, failed: int, out_of_range: int,
            numbers: Optional[Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """Each number compared beside its limit: failed rows and served
    tokens out of the vocabulary (limit 0), then the numbers that the
    cell's ``limits/<cell>.json`` names, read from ``numbers``
    (``check.numbers``; None where nothing was judged)."""
    checks = {"failed_rows": {"value": failed, "limit": 0},
              "tokens_out_of_range": {"value": out_of_range, "limit": 0}}
    if numbers is not None:
        for number, lim in limits["limits"].items():
            checks[number] = {"value": numbers[number],
                              "limit": float(lim["limit"])}
    return checks


def passes(checks: Dict[str, Dict[str, float]], judged: int) -> bool:
    """Every number compared within its limit, and some tokens judged."""
    return judged > 0 and all(c["value"] <= c["limit"]
                              for c in checks.values())


def correct(out: Outcome) -> bool:
    return passes(out.checks, out.tokens_judged)


def metrics(manifest: Manifest, out: Outcome,
            trace: bool) -> Dict[str, Dict[str, float]]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones,
    each read by its reader; a reader that finds nothing is left out."""
    entries = out.context.cell.per_layer if trace \
        else out.context.cell.end_to_end
    got = {}
    for m in entries:
        v = manifest.reader(m["name"]).read(out.context)
        if v is not None:
            got[m["name"]] = {"value": v, "unit": m["unit"]}
    return got


def breakdown(traced: List[tracing.TracedBatch], top: int = 10) -> dict:
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for t in traced:
        for k, v in t.ops.items():
            ops[k] = ops.get(k, 0.0) + v
        for k, v in t.gaps.items():
            gaps[k] = gaps.get(k, 0.0) + v

    def first(d):
        return [[k[:200], v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]

    return {"device_ops": first(ops), "idle_gaps": first(gaps)}
