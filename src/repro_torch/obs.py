"""The port's own spans and counters: what the serving path did, kept in
memory for a reader after the fact.

A span is a name, a start and an end on the host's
``time.perf_counter_ns()`` clock, an id, the id of the span that was
open around it (0 at the top) and the id of the ``generate`` call it
belongs to (0 outside one). ``ServeEngine.generate`` opens a call
(``Recorder.call``) and records its own spans always: ``generate``
around ``init_cache``, ``prefill``, one ``decode_step`` per step and
``to_host``. Detail spans (``detail``) inside the model step and the
moe layer are recorded only while a ``torch.profiler`` is active: the
profiler's own enabled flag is tested once a site, and that test is
their whole cost otherwise. No span puts a record on a profiler's
timeline (no ``record_function``, no NVTX range), so a trace's device
records are the program's kernels alone.

Each call keeps one record (``Call``): its rows, prompt length and
``n_new``, its engine spans and its moe counters. The moe layer counts
routed assignments and slots on the host, from shapes, and kept rows on
the device, one ``add_`` a forward into the call's own buffer; nothing
reads that buffer while the call runs (``Recorder.read_counters`` reads
every pending one in one transfer per device). A forward outside a call
counts nothing.

The log of spans is bounded (``MAX_SPANS``, oldest dropped first, with
a count of what was dropped), as is the list of calls (``MAX_CALLS``).
Nothing is written to a file. One recorder, ``RECORDER``, serves the
process; it is meant for the one thread that serves, as the engine is.

``profiler_offset_ns`` places a span on the clock of ``torch.profiler``'s
raw records (``prof.profiler.kineto_results.events()``), and
``idle_by_span`` splits a trace's idle time by the innermost span that
was open on the host.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Deque, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16
MAX_CALLS = 1 << 12
OUTSIDE = "outside any span"


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int          # 0 while open
    id: int
    parent: int          # the enclosing span's id; 0 at the top
    call: int            # the generate call's id; 0 outside one

    @property
    def duration_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Call:
    """One ``generate`` call: its shapes, the ``generate`` span and its
    children, and the moe layer's counters summed over its forwards."""
    id: int
    rows: int
    prompt: int
    n_new: int
    profiled: bool       # a torch.profiler was active when it began
    spans: List[Span] = field(default_factory=list)
    moe_routed: int = 0  # top-k assignments made
    moe_slots: int = 0   # E x G x C of each forward
    moe_kept: Union[int, torch.Tensor] = 0   # kept assignments (occupied slots)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def count_moe(self, rows: torch.Tensor, routed: int, slots: int) -> None:
        """One moe forward: ``rows`` (E,) the kept assignments by expert,
        on the device; ``routed`` and ``slots`` from its shapes."""
        self.moe_routed += routed
        self.moe_slots += slots
        if isinstance(self.moe_kept, int):
            self.moe_kept = rows.to(torch.int64, copy=True)
        else:
            self.moe_kept.add_(rows)


class _Open:
    """A span being recorded: ``with`` records it on exit."""
    __slots__ = ("rec", "span")

    def __init__(self, rec: "Recorder", name: str) -> None:
        self.rec = rec
        self.span = Span(name, 0, 0, 0, 0, 0)

    def __enter__(self) -> Span:
        rec, s = self.rec, self.span
        s.id = next(rec._ids)
        s.parent = rec._open[-1] if rec._open else 0
        s.call = rec.open_call.id if rec.open_call is not None else 0
        rec._open.append(s.id)
        s.start_ns = time.perf_counter_ns()
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.end_ns = time.perf_counter_ns()
        self.rec._open.pop()
        self.rec._log(s)
        return False


class _Off:
    """What ``detail`` returns while no profiler is active."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Recorder:
    def __init__(self, max_spans: int = MAX_SPANS,
                 max_calls: int = MAX_CALLS) -> None:
        self.spans: Deque[Span] = deque(maxlen=max_spans)
        self.dropped = 0     # spans pushed out of the log
        self.calls: Deque[Call] = deque(maxlen=max_calls)
        self.open_call: Optional[Call] = None
        self._open: List[int] = []
        self._ids = itertools.count(1)

    def clear(self) -> None:
        """Forget every span and call (ids keep counting)."""
        self.spans.clear()
        self.calls.clear()
        self.dropped = 0

    def span(self, name: str) -> _Open:
        return _Open(self, name)

    def _log(self, s: Span) -> None:
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(s)
        c = self.open_call
        if c is not None and s.parent == c.spans[0].id:
            c.spans.append(s)

    @contextlib.contextmanager
    def call(self, rows: int, prompt: int, n_new: int) -> Iterator[Call]:
        """``with`` around one ``generate``: opens its record and its
        ``generate`` span."""
        if self.open_call is not None:
            raise RuntimeError("a generate call is already open")
        c = Call(next(self._ids), rows, prompt, n_new,
                 bool(_profiler._is_profiler_enabled))
        self.open_call = c
        try:
            with self.span("generate") as root:
                c.spans.append(root)
                yield c
        finally:
            self.open_call = None
            self.calls.append(c)

    def read_counters(self) -> None:
        """Brings every call's kept-rows buffer to the host, summed, in
        one transfer per device."""
        pending: Dict[torch.device, List[Call]] = {}
        for c in self.calls:
            if isinstance(c.moe_kept, torch.Tensor):
                pending.setdefault(c.moe_kept.device, []).append(c)
        for cs in pending.values():
            sums = torch.stack([c.moe_kept.sum() for c in cs]).tolist()
            for c, n in zip(cs, sums):
                c.moe_kept = int(n)


RECORDER = Recorder()


def detail(name: str):
    """A detail span on ``RECORDER`` while a ``torch.profiler`` is
    active; otherwise a ``with`` that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return RECORDER.span(name)


def profiler_offset_ns() -> int:
    """Nanoseconds to add to a ``perf_counter_ns`` reading to place it on
    the clock of ``torch.profiler``'s raw records, CPU and CUDA alike,
    which read the system's wall clock (``time.time_ns``). Taken from
    the tightest of 16 readings of the wall clock between two of the
    host's."""
    best: Optional[Tuple[int, int]] = None
    for _ in range(16):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(spans: Sequence[Span], offset_ns: int
               ) -> List[Tuple[int, int, str]]:
    """(start, end, name) pieces of time, in order, each labelled by the
    innermost span open over it; time under no span has no piece.
    Spans of one thread nest, so the innermost is the latest begun."""
    pieces: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []     # (end, name), innermost last
    t = None

    def advance(upto: Optional[int]) -> None:
        nonlocal t
        while stack and (upto is None or stack[-1][0] <= upto):
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end
        if stack and upto > t:
            pieces.append((t, upto, stack[-1][1]))
        if upto is not None and (t is None or upto > t):
            t = upto

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        advance(s.start_ns + offset_ns)
        stack.append((s.end_ns + offset_ns, s.name))
    advance(None)
    return pieces


def idle_by_span(intervals: Iterable[Tuple[int, int]], spans: Sequence[Span],
                 window: Tuple[int, int], offset_ns: Optional[int] = None
                 ) -> Dict[str, float]:
    """The device's idle time in ``window`` split by program span.

    ``intervals``: (start, end) of the trace's device records and
    ``window`` (start, end), in ns on the trace's clock; ``spans`` are
    placed there by adding ``offset_ns`` (``profiler_offset_ns()`` when
    None). Each stretch of the window that no record covers is given to
    the innermost span open on the host then, or to ``OUTSIDE``. Returns
    seconds by span name; they sum to the window's idle time."""
    if offset_ns is None:
        offset_ns = profiler_offset_ns()
    lo, hi = window
    busy = _union((max(a, lo), min(b, hi)) for a, b in intervals
                  if b > lo and a < hi)
    edges = [lo] + [t for ab in busy for t in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    pieces = _innermost([s for s in spans if s.end_ns], offset_ns)
    out: Dict[str, float] = {}

    def add(name: str, ns: int) -> None:
        out[name] = out.get(name, 0.0) + ns / 1e9

    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        t, k = a, j
        while k < len(pieces) and pieces[k][0] < b:
            p0, p1, name = pieces[k]
            if p0 > t:
                add(OUTSIDE, p0 - t)
                t = p0
            end = min(p1, b)
            add(name, end - t)
            t = end
            k += 1
        if b > t:
            add(OUTSIDE, b - t)
    return out
