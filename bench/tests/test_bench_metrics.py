"""The metrics' arithmetic on synthetic records, and the work counts
against hand counts at one shape each."""
from __future__ import annotations

import math

import pytest
import torch

from bench import readers, workcount
from bench.harness import BatchRecord, Context
from bench.manifest import Manifest
from bench.stats import percentile
from bench.tests.conftest import tiny_config
from bench.tracing import Launch, TracedBatch


def test_percentile_is_nearest_rank():
    xs = list(range(100, 0, -1))
    assert percentile(xs, 0.95) == 95
    assert percentile(xs, 0.5) == 50
    assert percentile([3.0], 0.95) == 3.0
    with pytest.raises(ValueError):
        percentile([], 0.95)


def _ctx(batches, window_s=10.0, **kw):
    cell = Manifest().cell("qwen3-14b.prompt")
    return Context(cell, workcount.sizes(cell.config), 3.5, window_s,
                   batches, 2 ** 30 * 5, **kw)


def _rec(i, rows, prompt, n_new, wall, prefill, decode, ok=True):
    return BatchRecord(i, rows, prompt, n_new, float(i), wall, prefill,
                       decode, ok)


def test_ttft_rates_and_spans():
    # 20 batches of 8: TTFT = wall - decode = 100 ms for 19, 900 for one
    bs = [_rec(i, 8, 512, 2, 0.15, 0.09, 0.05) for i in range(19)]
    bs.append(_rec(19, 8, 4096, 2, 0.95, 0.89, 0.05))
    bs.append(_rec(20, 8, 512, 2, 0.01, 0.0, 0.0, ok=False))
    ctx = _ctx(bs)
    # 160 requests served; the top 8 are 900 ms; rank ceil(.95*160) = 152
    assert readers.ttft_p95_ms(ctx) == pytest.approx(100.0)
    more = list(bs)
    more[18] = _rec(18, 8, 4096, 2, 0.95, 0.89, 0.05)
    assert readers.ttft_p95_ms(_ctx(more)) == pytest.approx(900.0)
    assert readers.requests_per_s(ctx) == pytest.approx(16.0)
    assert readers.output_tokens_per_s(ctx) == pytest.approx(32.0)
    assert readers.peak_mem_gib(ctx) == 5.0
    toks = 19 * 8 * 512 + 8 * 4096
    assert readers.prefill_ms_per_ktok(ctx) == pytest.approx(
        (19 * 0.09 + 0.89) * 1e3 / (toks / 1e3))
    assert readers.decode_step_ms(ctx) == pytest.approx(0.05 * 1e3 / 2)


def test_attention_work_by_hand():
    # B=1, S=4, H=2, Hkv=1, hd=8: 10 causal pairs
    flops, nbytes = workcount.attention_work(1, 4, 4, 2, 1, 8, 2)
    assert flops == 4 * 2 * 8 * 10
    assert nbytes == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)


def test_gmm_rows_work_by_hand():
    flops, nbytes = workcount.gmm_rows_work([0, 2, 3], 4, 5, 2)
    assert flops == 2 * 5 * 4 * 5
    assert nbytes == 2 * (2 * 4 * 5 + 5 * 4 + 5 * 5)


def test_step_work_by_hand_dense():
    s = workcount.sizes(tiny_config("dense", "bfloat16"))
    # d 64, 4 heads / 2 kv of 16, ffn 128, vocab 512, 2 layers, qk-norm
    d, dq, dkv, ff, V, L = 64, 64, 32, 128, 512, 2
    lin = 2 * d * dq + 2 * d * dkv + 3 * d * ff
    flops, nbytes = workcount.forward_work(s, 3, 10, 0)
    assert flops == L * (2 * 30 * lin + 4 * 3 * 4 * 16 * 55) + 2 * 3 * d * V
    weights = L * (lin + 2 * d + 2 * 16) + d + d * V
    assert nbytes == 2 * (weights + 30 * d) + 2 * 2 * L * 3 * 10 * dkv
    # a decode step after 10 cached positions: 11 pairs a row
    flops, nbytes = workcount.forward_work(s, 3, 1, 10)
    assert flops == L * (2 * 3 * lin + 4 * 3 * 4 * 16 * 11) + 2 * 3 * d * V
    assert nbytes == 2 * (weights + 3 * d) + 2 * 2 * L * 3 * 11 * dkv
    # n_new tokens need the prefill and n_new - 1 steps
    assert len(workcount.batch_forwards(s, 3, 10, 4)) == 4


def test_step_work_by_hand_moe():
    s = workcount.sizes(tiny_config("moe", "bfloat16"))
    d, E, k, de, ds, L, V = 64, 6, 2, 96, 192, 2, 512
    attn = 4 * d * d
    ffn_ops = d * E + 3 * d * ds + k * 3 * d * de
    flops, nbytes = workcount.forward_work(s, 2, 1, 0)
    assert flops == L * (2 * 2 * (attn + ffn_ops) + 4 * 2 * 4 * 16 * 1) \
        + 2 * 2 * d * V
    active = E * (1 - (1 - k / E) ** 2)       # 2 tokens
    weights = L * (attn + 2 * d + 3 * d + d * E + 3 * d * ds
                   + active * 3 * d * de) + d + d * V
    assert nbytes == pytest.approx(2 * (weights + 2 * d)
                                   + 2 * 2 * L * 2 * 1 * d)
    assert workcount.active_experts(s, 10 ** 6) == pytest.approx(E)


def test_mfu_is_least_time_over_window():
    bs = [_rec(i, 8, 1024, 1, 0.5, 0.4, 0.05) for i in range(4)]
    ctx = _ctx(bs, window_s=2.0)
    need = 4 * workcount.batch_least_s(ctx.sizes, 8, 1024, 1)
    assert readers.mfu(ctx) == pytest.approx(100 * need / 2.0)


def test_slot_fill_rooflines_and_idle_share():
    rows = torch.tensor([3, 0, 5], dtype=torch.int32)
    win = [Launch("grouped_matmul", "prefill", (3, 8, 64, 32), rows),
           Launch("flash_attention", "prefill", (1, 4, 4, 2, 1, 8))]
    k2 = Launch("grouped_matmul", "prefill", (3, 8, 64, 32), rows, 1e-3)
    k1 = Launch("flash_attention", "prefill", (1, 4, 4, 2, 1, 8), None, 2e-3)
    traced = [TracedBatch(wall_s=4.0, busy_s=3.0, launches=[k1, k2])]
    ctx = _ctx([_rec(0, 8, 512, 1, 0.1, 0.05, 0.01)], launches=win,
               traced=traced)
    assert readers.moe_slot_fill(ctx) == pytest.approx(100 * 8 / 24)
    s = ctx.sizes
    k1_need = workcount.least_s(*workcount.attention_work(
        1, 4, 4, 2, 1, 8, 2), s.peak_flops)
    assert readers.k1_roofline(ctx) == pytest.approx(100 * k1_need / 2e-3)
    k2_need = workcount.least_s(*workcount.gmm_rows_work(
        [3, 0, 5], 64, 32, 2), s.peak_flops)
    assert readers.k2_roofline(ctx) == pytest.approx(100 * k2_need / 1e-3)
    assert readers.idle_share(ctx) == pytest.approx(25.0)


def test_readers_find_nothing_where_nothing_ran():
    ctx = _ctx([_rec(0, 8, 512, 1, 0.1, 0.05, 0.01)])
    for f in (readers.moe_slot_fill, readers.k1_roofline,
              readers.k2_roofline, readers.idle_share):
        assert f(ctx) is None
    empty = _ctx([])
    for f in (readers.ttft_p95_ms, readers.requests_per_s, readers.mfu,
              readers.prefill_ms_per_ktok, readers.decode_step_ms):
        assert f(empty) is None
    assert math.isclose(readers.peak_mem_gib(empty), 5.0)
