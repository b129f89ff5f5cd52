"""What the program did, read from outside it: K1's and K2's launches
(by wrapping their launchers, as the port's ``chip_smoke.py`` does in
``in_path``) and a ``torch.profiler`` trace of whole batches.

A traced batch is recorded with ``ProfilerActivity.CUDA`` alone, from
the trace's raw records. The trace starts with ``PAD`` spin kernels,
since a trace can lose its first records; then, after a synchronise,
three one-spin markers go into the stream: before ``generate``, at its
first decode step and after it returns. The markers bound the batch in
the trace's own clock. A batch whose trace holds fewer K1 or K2
kernels than it launched is traced again.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

PAD = 3000
ATTEMPTS = 3   # traces of one batch before the run fails
# The kernels of the port's two wrappers in a trace (each launch of a
# wrapper runs exactly one of them).
KERNELS = {"flash_attention": "flash_wgmma", "grouped_matmul": "gmm_"}


class TraceIncomplete(RuntimeError):
    """A trace that kept fewer of a wrapper's kernels than it launched,
    or lost a marker."""


@dataclass
class Launch:
    kernel: str                 # "flash_attention" | "grouped_matmul"
    phase: str                  # "prefill" | "decode"
    shape: Tuple[int, ...]      # K1 (B, Sq, Sk, H, Hkv, hd); K2 (E, C, d, f)
    rows: Optional[torch.Tensor] = None   # K2's rows (E,), on the device
    device_s: Optional[float] = None      # from a trace


@dataclass
class TracedBatch:
    wall_s: float               # begin marker's end to end marker's start
    busy_s: float               # union of the device's records between
    launches: List[Launch]
    ops: Dict[str, float] = field(default_factory=dict)   # name -> s
    gaps: Dict[str, float] = field(default_factory=dict)  # label -> s


def _spin(name: str) -> bool:
    return "spin" in name or "sleep" in name


@contextlib.contextmanager
def recording(model, launches: List[Launch], markers: bool = False):
    """While active, each K1 and K2 launch appends a ``Launch`` to
    ``launches`` (K2's with its ``rows``), its phase "prefill" from
    ``model.prefill`` on and "decode" from ``model.decode_step`` on. With
    ``markers`` the first decode step of a prefill puts a spin marker
    into the stream."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm

    real_fa, real_gm = fa._launch, gm._launch
    phase = ["prefill"]

    def fa_launch(q, k, v, causal):
        launches.append(Launch("flash_attention", phase[0],
                               (*q.shape[:2], k.shape[1], q.shape[2],
                                k.shape[2], q.shape[3])))
        return real_fa(q, k, v, causal)

    def gm_launch(x, w, rows=None):
        launches.append(Launch("grouped_matmul", phase[0],
                               (*x.shape, w.shape[2]), rows))
        return real_gm(x, w, rows)

    def prefill(*args, **kw):
        phase[0] = "prefill"
        return type(model).prefill(model, *args, **kw)

    def decode_step(*args, **kw):
        if markers and phase[0] == "prefill":
            torch.cuda._sleep(1)
        phase[0] = "decode"
        return type(model).decode_step(model, *args, **kw)

    fa._launch, gm._launch = fa_launch, gm_launch
    model.prefill, model.decode_step = prefill, decode_step
    try:
        yield
    finally:
        fa._launch, gm._launch = real_fa, real_gm
        del model.prefill, model.decode_step


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def trace_batch(eng, tokens, n_new: int) -> TracedBatch:
    """Serve one batch under the profiler; raises ``TraceIncomplete``
    where the trace lost records."""
    from torch.profiler import ProfilerActivity, profile

    launches: List[Launch] = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        with recording(eng.model, launches, markers=True):
            eng.generate(tokens, n_new=n_new)
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    # the raw records: prof.events() would build a tree of every record
    recs = sorted(((e.name(), e.start_ns(), e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA),
                  key=lambda r: r[1])
    spins = [i for i, r in enumerate(recs) if _spin(r[0])]
    if len(spins) < 4:
        raise TraceIncomplete(f"the trace kept {len(spins)} spin kernels")
    i0, i_mid, i1 = spins[-3:]
    start = recs[i0][1] + recs[i0][2]
    mid, end = recs[i_mid][1], recs[i1][1]
    work = [r for r in recs[i0 + 1:i1] if not _spin(r[0])]
    for kernel, part in KERNELS.items():
        traced = [r for r in work if part in r[0]]
        mine = [x for x in launches if x.kernel == kernel]
        if len(traced) != len(mine):
            raise TraceIncomplete(f"the trace holds {len(traced)} {kernel} "
                                  f"kernels for {len(mine)} launches")
        for x, r in zip(mine, traced):
            x.device_s = r[2] / 1e9
    busy = _union([(r[1], r[1] + r[2]) for r in work])
    out = TracedBatch(wall_s=(end - start) / 1e9,
                      busy_s=sum(b - a for a, b in busy) / 1e9,
                      launches=launches)
    for name, _, dur in work:
        out.ops[name] = out.ops.get(name, 0.0) + dur / 1e9
    edges = [start] + [t for ab in busy for t in ab] + [end]
    nxt = {r[1]: r[0] for r in reversed(work)}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            label = ("prefill" if b <= mid else "decode") + ", before " + (
                nxt.get(b, "the end marker")[:120])
            out.gaps[label] = out.gaps.get(label, 0.0) + (b - a) / 1e9
    return out


def trace_batches(eng, batches) -> List[TracedBatch]:
    """Each batch traced on its own, taken again (up to ``ATTEMPTS``
    times in all) where its trace lost records."""
    out = []
    for b in batches:
        for attempt in range(1, ATTEMPTS + 1):
            try:
                out.append(trace_batch(eng, b.tokens, b.n_new))
                break
            except TraceIncomplete as err:
                if attempt == ATTEMPTS:
                    raise
                print(f"batch {b.index}: {err}; traced again", flush=True)
    return out
