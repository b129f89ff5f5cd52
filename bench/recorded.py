"""Per-layer metrics read from the port's own recorder
(``repro_torch.obs``): the spans and counters of each ``generate`` call.

The window's calls are the last ``len(ctx.batches)`` calls that ran with
no profiler active, where their rows, prompt lengths and ``n_new``
equal the window's batches', in order: the warm-up comes before the
window and the traced cycle, profiled, after it. Where they do not
match, or the program has no recorder, a reader reads None.
"""
from __future__ import annotations

import statistics
from typing import List, Optional


def program_recorder():
    """The program's ``RECORDER``, or None in a program without one."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.RECORDER


def window_calls(ctx, recorder) -> Optional[List]:
    """The recorder's ``Call`` of each of the window's batches, or None."""
    want = [(b.rows, b.prompt, b.n_new) for b in ctx.batches]
    if recorder is None or not want:
        return None
    calls = [c for c in recorder.calls if not c.profiled][-len(want):]
    if [(c.rows, c.prompt, c.n_new) for c in calls] != want:
        return None
    return calls


def decode_host_ms(ctx, recorder=None) -> Optional[float]:
    """The median ``decode_step`` span, in ms, over the decode steps of
    the window's served batches: the host's enqueue of one step.
    ``recorder`` defaults to the program's."""
    calls = window_calls(ctx, recorder or program_recorder())
    if calls is None:
        return None
    steps = [s.duration_s * 1e3 for c, b in zip(calls, ctx.batches) if b.ok
             for s in c.named("decode_step")]
    return statistics.median(steps) if steps else None


def moe_drop_share(ctx, recorder=None) -> Optional[float]:
    """100 x (routed - kept) / routed top-k assignments of the moe layer,
    summed over the window's calls, from the program's counters."""
    recorder = recorder or program_recorder()
    calls = window_calls(ctx, recorder)
    if calls is None:
        return None
    recorder.read_counters()
    routed = sum(c.moe_routed for c in calls)
    if not routed:
        return None
    return 100.0 * (routed - sum(c.moe_kept for c in calls)) / routed
