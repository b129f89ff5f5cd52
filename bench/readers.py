"""The arithmetic of the metrics, over a run's ``harness.Context``. Each
metric's own reader, ``metrics/<name>.py``, calls one of these; a
reader that finds nothing to read returns None."""
from __future__ import annotations

from typing import Optional

from bench import workcount
from bench.stats import percentile


def ttft_p95_ms(ctx) -> Optional[float]:
    """Nearest-rank 95th percentile over every request served in the
    window of its time to first token: its batch's call to ``generate``
    to the end of the prefill, taken as the call's wall time less the
    engine's own ``decode_s`` (closed loop: no queueing)."""
    vals = [(b.wall_s - b.decode_s) * 1e3 for b in ctx.served
            for _ in range(b.rows)]
    return percentile(vals, 0.95) if vals else None


def requests_per_s(ctx) -> Optional[float]:
    """Requests served over the window's start to the last completion."""
    n = sum(b.rows for b in ctx.served)
    return n / ctx.window_s if n else None


def output_tokens_per_s(ctx) -> Optional[float]:
    """Generated tokens (rows x n_new of each served batch) over the
    window's start to the last completion."""
    n = sum(b.rows * b.n_new for b in ctx.served)
    return n / ctx.window_s if n else None


def peak_mem_gib(ctx) -> Optional[float]:
    """``torch.cuda.max_memory_allocated()`` over the warm-up and the
    window, the weights included."""
    if ctx.memory_peak_bytes is None:
        return None
    return ctx.memory_peak_bytes / 2 ** 30


def prefill_ms_per_ktok(ctx) -> Optional[float]:
    """The engine's own ``prefill_s`` summed over the window, per 1000
    prompt tokens."""
    toks = sum(b.rows * b.prompt for b in ctx.served)
    if not toks:
        return None
    return sum(b.prefill_s for b in ctx.served) * 1e3 / (toks / 1e3)


def decode_step_ms(ctx) -> Optional[float]:
    """The engine's own ``decode_s`` summed over the window, per decode
    step (``generate`` runs n_new of them)."""
    steps = sum(b.n_new for b in ctx.served)
    if not steps:
        return None
    return sum(b.decode_s for b in ctx.served) * 1e3 / steps


def mfu(ctx) -> Optional[float]:
    """The least time the window's batches need (``workcount``) over the
    window's time, in %."""
    if not ctx.served:
        return None
    need = sum(workcount.batch_least_s(ctx.sizes, b.rows, b.prompt, b.n_new)
               for b in ctx.served)
    return 100.0 * need / ctx.window_s


def moe_slot_fill(ctx) -> Optional[float]:
    """Occupied rows over slots (E x C) of every K2 launch in the
    window, in %."""
    ks = [x for x in ctx.launches or () if x.kernel == "grouped_matmul"
          and x.rows is not None]
    if not ks:
        return None
    slots = sum(x.shape[0] * x.shape[1] for x in ks)
    return 100.0 * sum(int(x.rows.clamp(0, x.shape[1]).sum())
                       for x in ks) / slots


def _traced(ctx, kernel: str):
    return [x for t in ctx.traced for x in t.launches
            if x.kernel == kernel and x.device_s is not None]


def k1_roofline(ctx) -> Optional[float]:
    """Each traced K1 launch's least time from its shape, summed, over
    the sum of its device time, in %."""
    ks = _traced(ctx, "flash_attention")
    if not ks:
        return None
    s = ctx.sizes
    need = sum(workcount.least_s(*workcount.attention_work(
        *x.shape, s.elt), s.peak_flops) for x in ks)
    return 100.0 * need / sum(x.device_s for x in ks)


def k2_roofline(ctx) -> Optional[float]:
    """The same for K2, each launch's least time taken with its rows."""
    ks = [x for x in _traced(ctx, "grouped_matmul") if x.rows is not None]
    if not ks:
        return None
    s = ctx.sizes
    need = sum(workcount.least_s(*workcount.gmm_rows_work(
        x.rows.clamp(0, x.shape[1]).tolist(), x.shape[2], x.shape[3],
        s.elt), s.peak_flops) for x in ks)
    return 100.0 * need / sum(x.device_s for x in ks)


def idle_share(ctx) -> Optional[float]:
    """1 - the union of the device's records over the traced wall time
    of the traced batches, in %."""
    wall = sum(t.wall_s for t in ctx.traced)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(t.busy_s for t in ctx.traced) / wall)
