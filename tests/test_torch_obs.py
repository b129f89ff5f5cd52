"""The port's recorder (``repro_torch.obs``): spans and their nesting,
the bounded log, detail spans only under a profiler, ``idle_by_span``,
the engine's record of each call, the moe layer's counters, and the
benchmark's readers of them (``bench/recorded.py``).

The tests marked ``gpu`` run on an NVIDIA Hopper card and skip here;
whether there is one is decided inside the fixture:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_obs.py
"""
import statistics
import sys
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from bench import recorded
from bench.harness import BatchRecord
from bench.manifest import Manifest
from repro_torch import obs
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.models import moe as moe_mod
from repro_torch.serve.engine import ServeEngine


@pytest.fixture
def rec():
    """The process's recorder, emptied before and after the test."""
    obs.RECORDER.clear()
    yield obs.RECORDER
    obs.RECORDER.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# ---------------------------------------------------------------- recorder
def test_spans_nest_and_carry_their_call():
    r = obs.Recorder()
    with r.span("outer") as outer:
        with r.span("inner") as inner:
            pass
        with r.span("sibling") as sibling:
            pass
    assert outer.parent == 0 and inner.parent == outer.id
    assert sibling.parent == outer.id and inner.call == 0
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= sibling.start_ns <= sibling.end_ns <= outer.end_ns
    assert [s.name for s in r.spans] == ["inner", "sibling", "outer"]
    with r.call(rows=2, prompt=5, n_new=3) as c:
        with r.span("prefill") as p:
            with r.span("deeper") as d:
                pass
    assert r.open_call is None and list(r.calls) == [c]
    root = c.spans[0]
    assert root.name == "generate" and root.parent == 0 and root.end_ns
    assert p.parent == root.id and d.parent == p.id
    assert p.call == d.call == root.call == c.id
    # the call keeps its root and the root's children, not deeper spans
    assert [s.name for s in c.spans] == ["generate", "prefill"]
    assert (c.rows, c.prompt, c.n_new, c.profiled) == (2, 5, 3, False)


def test_calls_do_not_nest():
    r = obs.Recorder()
    with r.call(1, 1, 1):
        with pytest.raises(RuntimeError, match="already open"):
            with r.call(1, 1, 1):
                pass
    assert r.open_call is None and len(r.calls) == 1


def test_log_is_bounded_and_counts_what_it_dropped():
    r = obs.Recorder(max_spans=3, max_calls=2)
    for i in range(5):
        with r.span(f"s{i}"):
            pass
    assert [s.name for s in r.spans] == ["s2", "s3", "s4"]
    assert r.dropped == 2
    for i in range(3):
        with r.call(i + 1, 1, 1):
            pass
    assert [c.rows for c in r.calls] == [2, 3]
    r.clear()
    assert not r.spans and not r.calls and r.dropped == 0


def test_detail_spans_only_under_a_profiler(rec):
    with obs.detail("attn.core") as s:
        assert s is None
    assert not rec.spans
    with _cpu_profile() as prof:
        with obs.detail("attn.core") as s:
            torch.ones(4).sum()
    assert [x.name for x in rec.spans] == ["attn.core"] and s.end_ns
    # a span is no record of the profiler's (no record_function)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::sum" in names and "attn.core" not in names


def test_profiler_offset_places_host_times_on_the_trace():
    """A CPU record's start lies between the host readings around the
    op, once placed on the records' clock (1 ms for the conversion)."""
    with _cpu_profile() as prof:
        a = time.perf_counter_ns()
        torch.ones(8)
        b = time.perf_counter_ns()
    off = obs.profiler_offset_ns()
    start = min(e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.name() == "aten::ones")
    assert a + off - 1_000_000 <= start <= b + off + 1_000_000


# ---------------------------------------------------------------- idle_by_span
def _span(name, a, b, sid, parent=0):
    return obs.Span(name, a, b, sid, parent, 0)


SPANS = [_span("generate", 0, 100, 1), _span("prefill", 10, 40, 2, 1),
         _span("attn.core", 20, 30, 3, 2), _span("decode_step", 50, 60, 4, 1),
         _span("to_host", 80, 100, 5, 1)]
DEVICE = [(0, 5), (12, 25), (35, 45), (55, 58), (85, 90), (88, 89)]


@pytest.mark.parametrize("offset", [0, 10 ** 12])
def test_idle_by_span_splits_gaps_by_the_innermost_span(offset):
    spans = [_span(s.name, s.start_ns - offset, s.end_ns - offset, s.id,
                   s.parent) for s in SPANS]
    got = obs.idle_by_span(DEVICE, spans, (0, 110), offset_ns=offset)
    # gaps 5-12, 25-35, 45-55, 58-85, 90-110 (ns)
    want = {"generate": 30, "prefill": 7, "attn.core": 5, "decode_step": 7,
            "to_host": 15, obs.OUTSIDE: 10}
    assert got.keys() == want.keys()
    for k, ns in want.items():
        assert got[k] == pytest.approx(ns / 1e9, abs=1e-18)
    assert sum(got.values()) == pytest.approx(74 / 1e9, abs=1e-18)


def test_idle_by_span_clips_to_the_window_and_sums_to_the_idle():
    rng = np.random.default_rng(0)
    starts = np.sort(rng.integers(0, 10_000, 200))
    device = [(int(a), int(a + d)) for a, d in
              zip(starts, rng.integers(1, 60, 200))]
    spans, t, sid = [], 0, 1
    while t < 10_000:     # steps with a nested part, gaps between
        spans.append(_span("decode_step", t, t + 300, sid))
        spans.append(_span("attn.core", t + 100, t + 150, sid + 1, sid))
        t, sid = t + 400, sid + 2
    window = (1_000, 9_000)
    got = obs.idle_by_span(device, spans, window, offset_ns=0)
    busy = obs._union((max(a, window[0]), min(b, window[1]))
                      for a, b in device if b > window[0] and a < window[1])
    idle = (window[1] - window[0]) - sum(b - a for a, b in busy)
    assert sum(got.values()) == pytest.approx(idle / 1e9, rel=1e-12)
    assert set(got) == {"decode_step", "attn.core", obs.OUTSIDE}
    assert obs.idle_by_span([], [], (0, 50), offset_ns=0) == {
        obs.OUTSIDE: pytest.approx(50e-9)}


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def dense_engine():
    return ServeEngine(SMOKES["qwen2-0.5b"], max_seq=64, device="cpu")


@pytest.mark.parametrize("n_new", [1, 3])
def test_engine_records_each_call(rec, dense_engine, n_new):
    prompt = np.random.default_rng(0).integers(0, 100, (2, 12))
    res = dense_engine.generate(prompt, n_new=n_new)
    res2 = dense_engine.generate(prompt[:1, :7], n_new=n_new)
    assert len(rec.calls) == 2
    c, c2 = rec.calls
    assert (c.rows, c.prompt, c.n_new) == (2, 12, n_new)
    assert (c2.rows, c2.prompt, c2.n_new) == (1, 7, n_new)
    assert [s.name for s in c.spans] == (["generate", "init_cache", "prefill"]
                                         + ["decode_step"] * n_new
                                         + ["to_host"])
    root = c.spans[0]
    assert all(s.parent == root.id and s.call == c.id for s in c.spans[1:])
    assert root.start_ns <= c.spans[1].start_ns \
        and c.spans[-1].end_ns <= root.end_ns
    (prefill,), (to_host,) = c.named("prefill"), c.named("to_host")
    assert res.prefill_s == prefill.duration_s
    first = (c.named("decode_step") or [to_host])[0]
    assert res.decode_s == (to_host.end_ns - first.start_ns) / 1e9
    assert c.moe_routed == 0 and c.moe_kept == 0 and not c.profiled
    assert res2.tokens.shape == (1, n_new)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_tokens_bit_identical_with_detail_spans(rec, arch):
    eng = ServeEngine(SMOKES[arch], max_seq=64, device="cpu")
    prompt = np.random.default_rng(1).integers(0, 100, (2, 20))
    plain = eng.generate(prompt, n_new=4)
    assert len(rec.spans) == 1 + 3 + 4     # engine spans only
    with _cpu_profile():
        spanned = eng.generate(prompt, n_new=4)
    np.testing.assert_array_equal(plain.tokens, spanned.tokens)
    assert rec.calls[-1].profiled and not rec.calls[0].profiled
    names = {s.name for s in rec.spans}
    layer = {"moe", "moe.route", "moe.experts", "moe.combine", "moe.shared"} \
        if arch.startswith("qwen2-moe") else {"mlp"}
    assert {"embed", "attention", "attn.qkv", "attn.core",
            "unembed"} | layer <= names
    # one attention a layer a forward, inside its step
    n_fwd = 1 + 4
    assert sum(s.name == "attention" for s in rec.spans) \
        == n_fwd * SMOKES[arch].n_layers


# ---------------------------------------------------------------- moe counters
def test_moe_counters_equal_a_hand_count(rec, monkeypatch):
    """Prompts of one repeated token send every token of a group to the
    same experts, so capacity drops most of them. The counters equal the
    shapes' count and the sum of ``_dispatch``'s rows."""
    cfg = SMOKES["qwen2-moe-a2.7b"]
    E, k, L = cfg.n_experts, cfg.n_experts_per_tok, cfg.n_layers
    assert (E, k, L) == (6, 2, 2)
    eng = ServeEngine(cfg, max_seq=300, device="cpu")
    rows_seen = []
    real = moe_mod._dispatch

    def dispatch(*a, **kw):
        out = real(*a, **kw)
        rows_seen.append(out[-1].clone())
        return out

    monkeypatch.setattr(moe_mod, "_dispatch", dispatch)
    B, S, n_new = 2, 256, 2
    eng.generate(np.full((B, S), 7), n_new=n_new)
    rec.read_counters()
    (c,) = rec.calls
    # G = 2 groups of 256 tokens: C = ceil(256 * 2 / 6 * 1.25) = 107 -> 112;
    # a decode step's groups of 1 token are dropless: C = 8
    G = 2
    assert c.moe_routed == L * (B * S * k + n_new * B * k)
    assert c.moe_slots == L * E * G * (112 + n_new * 8)
    assert len(rows_seen) == L * (1 + n_new)
    assert c.moe_kept == int(sum(r.sum() for r in rows_seen))
    # each group keeps at most C of the 256 tokens of each of its experts
    assert c.moe_kept <= L * (G * k * 112 + n_new * B * k) < c.moe_routed


def test_moe_counts_nothing_outside_a_call(rec):
    cfg = SMOKES["qwen2-moe-a2.7b"]
    p = moe_mod.MoE(cfg)
    p.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, cfg.d_model)
    moe_mod.moe_apply(p, cfg, x)
    moe_mod.moe_apply(p, cfg, x, einsum=True)
    assert not rec.calls and not rec.spans


# ---------------------------------------------------------------- readers
def _batch(i, rows, prompt, n_new, ok=True):
    return BatchRecord(i, rows, prompt, n_new, float(i), 0.1, 0.05, 0.05, ok)


def _call(r, rows, prompt, n_new, step_ms=(), profiled=False, routed=0,
          kept=0, slots=0):
    c = obs.Call(len(r.calls) + 1, rows, prompt, n_new, profiled)
    c.spans = [obs.Span("generate", 0, 10 ** 9, 1, 0, c.id)]
    t = 0
    for ms in step_ms:
        c.spans.append(obs.Span("decode_step", t, t + int(ms * 1e6), 2, 1,
                                c.id))
        t += 10 ** 8
    c.moe_routed, c.moe_kept, c.moe_slots = routed, kept, slots
    r.calls.append(c)
    return c


def _window_recorder():
    """Warm-up, a window of three batches, then a profiled trace."""
    r = obs.Recorder()
    _call(r, 8, 512, 1, [500.0], routed=10, kept=10)          # warm-up
    _call(r, 8, 512, 1, [40.0], routed=100, kept=60)
    _call(r, 8, 4096, 1, [70.0], routed=800,
          kept=torch.tensor([100, 200, 110]))
    _call(r, 8, 1024, 1, [50.0], routed=200, kept=130)
    _call(r, 8, 512, 1, [900.0], profiled=True, routed=100, kept=0)
    return r


WINDOW = [_batch(0, 8, 512, 1), _batch(1, 8, 4096, 1), _batch(2, 8, 1024, 1)]


def test_readers_pick_the_window_and_read_it():
    r = _window_recorder()
    ctx = SimpleNamespace(batches=WINDOW)
    assert recorded.decode_host_ms(ctx, r) == 50.0
    # routed 1100, kept 60 + 410 + 130 = 600
    assert recorded.moe_drop_share(ctx, r) == pytest.approx(100 * 500 / 1100)
    assert r.calls[2].moe_kept == 410        # read once, to the host
    # a failed batch's steps are left out
    failed = [WINDOW[0], _batch(1, 8, 4096, 1, ok=False), WINDOW[2]]
    assert recorded.decode_host_ms(SimpleNamespace(batches=failed), r) == 45.0


def test_chat_reader_takes_the_median_step():
    r = obs.Recorder()
    _call(r, 16, 1024, 4, [10.0, 60.0, 61.0, 62.0])
    _call(r, 16, 3072, 4, [12.0, 63.0, 64.0, 65.0])
    ctx = SimpleNamespace(batches=[_batch(0, 16, 1024, 4),
                                   _batch(1, 16, 3072, 4)])
    assert recorded.decode_host_ms(ctx, r) == statistics.median(
        [10, 60, 61, 62, 12, 63, 64, 65])
    assert recorded.moe_drop_share(ctx, r) is None     # no moe layer


@pytest.mark.parametrize("batches", [
    [_batch(0, 8, 512, 1), _batch(1, 8, 1024, 1), _batch(2, 8, 4096, 1)],
    [_batch(0, 8, 512, 1)] * 6,
    [],
], ids=["order", "too_many", "empty"])
def test_readers_read_none_where_calls_do_not_match(batches):
    ctx = SimpleNamespace(batches=batches)
    r = _window_recorder()
    assert recorded.decode_host_ms(ctx, r) is None
    assert recorded.moe_drop_share(ctx, r) is None


def test_readers_read_none_in_a_program_without_the_recorder(monkeypatch):
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    ctx = SimpleNamespace(batches=WINDOW)
    assert recorded.program_recorder() is None
    assert recorded.decode_host_ms(ctx) is None
    assert recorded.moe_drop_share(ctx) is None


@pytest.mark.parametrize("metric,cell", [
    ("decode_host_ms.chat", "qwen3-14b.chat"),
    ("decode_host_ms.moe_prompt", "qwen2-moe-a2.7b.prompt"),
    ("moe_drop_share.prompt", "qwen2-moe-a2.7b.prompt"),
])
def test_new_metrics_reach_their_cells(metric, cell):
    m = Manifest()
    assert metric in [x["name"] for x in m.cell(cell).per_layer]
    reader = m.reader(metric).read
    assert reader in (recorded.decode_host_ms, recorded.moe_drop_share)


# ---------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def moe_card():
    """Full-width qwen2-moe-a2.7b at 2 layers in bf16, drawn on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU; no CUDA device here")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) GPU")
    from repro_torch.models.registry import build_model

    cfg = ARCHS["qwen2-moe-a2.7b"].replace(n_layers=2)
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, "cuda")
    eng = ServeEngine(cfg, params=params, max_seq=600, device="cuda")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 512))
    eng.generate(prompt, n_new=2)             # builds and warms the kernels
    torch.cuda.synchronize()
    return eng, prompt


def _traced_batch(eng, prompt, n_new):
    """One batch under a CUDA-only profiler, as ``bench/tracing.py``
    traces it (spin kernels first, K1 and K2 launches recorded by its
    wrapper), between two spin markers. Returns the device records
    (name, start, end) and the markers' window, on the trace's clock,
    and the wrapper's launches."""
    from bench import tracing

    launches = []
    obs.RECORDER.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(tracing.PAD):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        with tracing.recording(eng.model, launches):
            eng.generate(prompt, n_new=n_new)
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    recs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA),
                  key=lambda r: r[1])
    spins = [i for i, r in enumerate(recs) if "spin" in r[0]
             or "sleep" in r[0]]
    i0, i1 = spins[-2:]
    work = [r for r in recs[i0 + 1:i1]]
    assert not any("spin" in r[0] or "sleep" in r[0] for r in work)
    return work, (recs[i0][2], recs[i1][1]), launches


@pytest.mark.gpu
def test_card_kernels_start_inside_their_spans(moe_card):
    """The n-th K1 kernel pairs with the n-th ``attn.core`` span of the
    prefill and each three K2 kernels with a ``moe.experts`` span; no
    kernel starts more than 20 us before its span on the shared clock."""
    eng, prompt = moe_card
    work, _, _ = _traced_batch(eng, prompt, n_new=2)
    off = obs.profiler_offset_ns()
    spans = list(obs.RECORDER.spans)
    (prefill,) = obs.RECORDER.calls[-1].named("prefill")
    core = [s for s in spans if s.name == "attn.core"
            and prefill.start_ns <= s.start_ns <= prefill.end_ns]
    experts = [s for s in spans if s.name == "moe.experts"]
    k1 = [r for r in work if "flash_wgmma" in r[0]]
    k2 = [r for r in work if "gmm_" in r[0]]
    n_layers = eng.cfg.n_layers
    assert len(core) == len(k1) == n_layers
    assert len(experts) == n_layers * (1 + 2) and len(k2) == 3 * len(experts)
    early = [s.start_ns + off - r[1]
             for s, r in list(zip(core, k1))
             + [(experts[i // 3], r) for i, r in enumerate(k2)]]
    print(f"kernel start - span start (us): min {-max(early) / 1e3:.1f}, "
          f"median {-statistics.median(early) / 1e3:.1f}")
    assert max(early) <= 20_000


@pytest.mark.gpu
def test_card_idle_by_span_sums_to_the_traced_idle(moe_card):
    from bench import tracing

    eng, prompt = moe_card
    work, window, _ = _traced_batch(eng, prompt, n_new=2)
    busy = tracing._union([(a, b) for _, a, b in work])
    idle = (window[1] - window[0]) - sum(b - a for a, b in busy)
    got = obs.idle_by_span([(a, b) for _, a, b in work],
                           list(obs.RECORDER.spans), window)
    print("idle by span (ms):", {k: round(v * 1e3, 3) for k, v in
                                 sorted(got.items(), key=lambda kv: -kv[1])})
    assert sum(got.values()) == pytest.approx(idle / 1e9, rel=0.01)
    assert got.get(obs.OUTSIDE, 0.0) < 0.05 * idle / 1e9


@pytest.mark.gpu
def test_card_counter_equals_the_wrappers_slot_fill(moe_card):
    from bench import readers

    eng, prompt = moe_card
    _, _, launches = _traced_batch(eng, prompt, n_new=1)
    obs.RECORDER.read_counters()
    (c,) = obs.RECORDER.calls
    fill = readers.moe_slot_fill(SimpleNamespace(launches=launches))
    mine = 100.0 * c.moe_kept / c.moe_slots
    print(f"slot fill: counter {mine:.6f}%, wrapper {fill:.6f}%; drop share "
          f"{100.0 * (c.moe_routed - c.moe_kept) / c.moe_routed:.4f}%")
    assert c.moe_kept < c.moe_routed
    assert mine == pytest.approx(fill, rel=5e-5)


@pytest.mark.gpu
def test_card_recorder_adds_no_sync(moe_card):
    """A decode step warns of no more synchronisations with the recorder
    counting and its detail spans on than with neither."""
    eng, prompt = moe_card
    B = prompt.shape[0]
    cache = eng.model.init_cache(B, eng.max_seq, device="cuda")
    toks = torch.as_tensor(prompt, device="cuda")
    with torch.inference_mode():
        logits, cache = eng.model.prefill(eng.params, {"tokens": toks}, cache)
    nxt = logits[:, -1:].argmax(dim=-1)

    def step():
        with torch.inference_mode():
            eng.model.decode_step(eng.params, cache,
                                  {"tokens": nxt, "cache_index": 512})

    def warned(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return [str(x.message) for x in w if "ynchroniz" in str(x.message)]

    step()                                   # any first-call work
    obs.RECORDER.clear()
    without = warned(step)
    with profile(activities=[ProfilerActivity.CUDA]):
        with obs.RECORDER.call(B, 1, 1) as c:
            with_rec = warned(step)
    assert c.moe_routed == eng.cfg.n_layers * B * eng.cfg.n_experts_per_tok
    assert sum(s.name == "moe.experts" for s in obs.RECORDER.spans) \
        == eng.cfg.n_layers
    print(f"sync warnings: {len(without)} without, {len(with_rec)} with")
    assert len(with_rec) <= len(without)
