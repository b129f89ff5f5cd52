"""The card-vs-CPU rule of ``chip_smoke.py``, held on the CPU: which
greedy steps a check compares (each row up to its first CPU near-tie,
and for moe its first router near-tie), that a check comparing no step
fails, that the limits are the stated ones, and the engine bounds in
bf16. ``greedy_trace`` and ``compare_card_cpu`` run here with both sides
on the CPU at smoke size. The script itself needs a card.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import build_model
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.models import layers as L
from repro_torch.models import stacks, transformer
from repro_torch.models.registry import stack_kind

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

F32, BF16 = torch.float32, torch.bfloat16
N, R = 16, 4


def _margins(ties, n=N, wide=1.0):
    """Margins by step for len(ties) rows: ``wide`` everywhere but 0 at
    each row's step ``ties[r]`` (None: no near-tie)."""
    return [[0.0 if t == i else wide for t in ties] for i in range(n)]


def _peaks(rows=R, n=N, peak=4.0):
    return [[peak] * rows for _ in range(n)]


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_a_near_tie_at_step_zero_in_every_row_compares_nothing(dtype):
    compared = cs.compared_steps(_margins([0] * R), _peaks(), dtype)
    assert compared == [0] * R
    # tokens equal everywhere, yet nothing was compared: the rule fails
    assert not cs.tokens_hold(compared, [N] * R)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_compared_steps_by_row(dtype):
    margins = _margins([3, 0, None, 7])
    assert cs.compared_steps(margins, _peaks(), dtype) == [3, 0, N, 7]
    # a per-row cut (moe: the first router near-tie) shortens a row
    assert cs.compared_steps(margins, _peaks(), dtype,
                             cut=[N, N, 5, 2]) == [3, 0, 5, 2]
    compared = [3, 0, N, 7]
    assert cs.tokens_hold(compared, [3, 0, N, 7])
    assert cs.tokens_hold(compared, [5, 0, N, 9])
    assert not cs.tokens_hold(compared, [3, 0, N - 1, 7])
    assert not cs.tokens_hold(compared, [2, 16, N, 7])


def test_steps_equal_by_row():
    g = [[[1], [2]], [[3], [4]], [[5], [6]]]
    c = [[[1], [2]], [[3], [9]], [[0], [6]]]
    assert cs.steps_equal(g, c) == [2, 1]
    assert cs.steps_equal(g, g) == [3, 3]
    # an audio row's step holds K codebook tokens: one differing is enough
    assert cs.steps_equal([[[1, 2]]], [[[1, 3]]]) == [0]


def test_the_limits_are_the_stated_ones():
    assert cs.FP32_LOGITS_TOL == 1e-3
    assert cs.FP32_MARGIN == 1e-4
    assert cs.FP32_ROUTER_GAP == 1e-6
    assert cs.BF16_REL == 2.0 ** -5
    assert cs.BF16_ROUTER_REL == 2.0 ** -8
    for peak in (0.5, 4.0, 100.0):
        assert cs.logits_limit(peak, F32) == 1e-3
        assert cs.near_tie(peak, F32) == 1e-4
        assert cs.logits_limit(peak, BF16) == peak / 32
        assert cs.near_tie(peak, BF16) == peak / 32
    # the boundary: a margin just below the limit is a near-tie, one at it
    # is not
    for dtype, peak in ((F32, 4.0), (BF16, 4.0), (BF16, 0.3)):
        lim = cs.near_tie(peak, dtype)
        below = [[math.nextafter(lim, 0.0)], [1.0]]
        at = [[lim], [1.0]]
        peaks = [[peak], [peak]]
        assert cs.compared_steps(below, peaks, dtype) == [0]
        assert cs.compared_steps(at, peaks, dtype) == [2]
    assert cs.CARD_CPU_SEEDS == 3
    assert cs.CARD_CPU_ROWS[F32] >= 4 and cs.CARD_CPU_ROWS[BF16] >= 16


def test_first_below():
    vals = [[1.0, 0.5, 1.0], [0.1, 1.0, 1.0], [0.1, 0.1, 1.0]]
    assert cs.first_below(vals, 0.2) == [1, 2, 3]
    assert cs.first_below(vals, 0.05) == [3, 3, 3]


def _calls(L, n, rows=2, S=5, gap=1.0):
    """Router gaps of n forwards of L layers: prefill (rows, S), then
    decode steps (rows, 1)."""
    return [torch.full((rows, S if f == 0 else 1), gap)
            for f in range(n + 1) for _ in range(L)]


def test_moe_router_cut_fp32_cuts_at_any_layer_and_position():
    L, n = 2, 6
    calls = _calls(L, n)
    calls[0][1, 2] = 1e-7           # prefill, layer 0, row 1, mid-prompt
    calls[3 * L + 1][0, 0] = 5e-7   # step 3, last layer, row 0
    calls[n * L][0, 0] = 0.0        # forward n: its logits are not compared
    cut, _ = cs.moe_router_cut(calls, L, n, F32)
    assert cut == [3, 0]


def test_moe_router_cut_bf16_cuts_at_the_compared_position_only():
    L, n = 2, 6
    calls = _calls(L, n)
    calls[0][0, 2] = 1e-4           # prefill, layer 0: counted, not cut
    calls[1][0, 2] = 1e-4           # last layer, not the last position
    calls[1][1, -1] = 1e-4          # last layer, last prompt position
    calls[4 * L + 1][0, 0] = 2e-3   # step 4, last layer, row 0
    calls[2 * L][0, 0] = 1e-4       # step 2, first layer: counted
    cut, note = cs.moe_router_cut(calls, L, n, BF16)
    assert cut == [4, 0]
    assert "3 near-ties elsewhere" in note


def _cpu_trace(arch, prompt, n, params=None):
    cfg = SMOKES[arch]
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cs.greedy_trace(model, params, prompt, n, "cpu"), params


@pytest.mark.parametrize("arch", ["qwen3-14b", "musicgen-large",
                                  "internvl2-1b"])
def test_greedy_trace_by_row_and_the_check_on_one_device(arch):
    """Both sides of the check on the CPU: the same weights and prompts
    give the same trace, so every row compares up to its own near-tie
    and the check holds; a trace whose tokens differ in a compared step
    fails it."""
    cfg = SMOKES[arch]
    K = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (R, *K, 12))
    a, params = _cpu_trace(arch, prompt, 6)
    b, _ = _cpu_trace(arch, prompt, 6, params)
    first, toks, margins, peaks = a
    assert first.shape[:-1] == (R, *K)
    assert len(toks) == len(margins) == len(peaks) == 6
    assert all(len(t) == R and len(t[0]) == (K[0] if K else 1)
               for t in toks)
    # row r of the batch is the prompt served alone
    solo, _ = _cpu_trace(arch, prompt[2:3], 6, params)
    torch.testing.assert_close(solo[0][0], first[2], rtol=1e-5, atol=1e-5)
    assert [t[0] for t in solo[1]] == [t[2] for t in toks]
    out = cs.compare_card_cpu(b, a, F32)
    assert out["compared"] == cs.compared_steps(margins, peaks, F32)
    assert sum(out["compared"]) > 0
    # a row whose first token differs where it is compared
    r = out["compared"].index(max(out["compared"]))
    bad = [[list(row) for row in step] for step in b[1]]
    bad[0][r] = [(x + 1) % cfg.vocab_size for x in bad[0][r]]
    with pytest.raises(SystemExit, match="diverge"):
        cs.compare_card_cpu((b[0], bad, b[2], b[3]), a, F32)
    # prefill logits off by more than the limit
    with pytest.raises(SystemExit, match="prefill logits"):
        cs.compare_card_cpu((b[0] + 2e-3, b[1], b[2], b[3]), a, F32)


def test_zamba2_layer_by_layer_check_on_one_device():
    """Zamba2's layer-by-layer check (prefill, then decode steps on the
    KV cache and the Mamba2 states) with both sides on the CPU: the same
    weights agree exactly in every layer of every forward; a fault in the
    shared block shows at each of its applications and nowhere else."""
    cfg = SMOKES["zamba2-7b"].replace(n_layers=4, hybrid_attn_every=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), BF16,
                        device="cpu")
    other = type(params)(cfg, BF16, device="cpu")
    other.load_state_dict(params.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 40 + 2)))
    assert cs.zamba2_layer_errors(cfg, params, other, tokens, 2) == \
        [[0.0] * 4] * 3
    with torch.no_grad():
        other.shared_attn.wo.mul_(1.5)
    worst = cs.zamba2_layer_errors(cfg, params, other, tokens, 2)
    assert len(worst) == 3
    for by_layer in worst:
        assert [e > 0 for e in by_layer] == [False, True, False, True]


def test_a_check_that_compares_nothing_fails():
    first = torch.zeros(R, 8)
    toks = [[[1]] * R for _ in range(N)]
    trace = (first, toks, _margins([0] * R, wide=1.0), _peaks())
    with pytest.raises(SystemExit, match="compared no step"):
        cs.compare_card_cpu(trace, trace, BF16)
    # moe: the router cut alone can leave nothing to compare
    trace = (first, toks, _margins([None] * R), _peaks())
    with pytest.raises(SystemExit, match="compared no step"):
        cs.compare_card_cpu(trace, trace, BF16, cut=[0] * R)


def test_cpu_prompt_moves_to_the_next_seed_and_then_fails():
    cfg = SMOKES["qwen2-0.5b"]
    seen = []

    def run(tie_seeds):
        def cpu_run(prompt):
            seen.append(prompt)
            ties = [0] * R if len(seen) - 1 in tie_seeds else [None] * R
            return None, None, _margins(ties), _peaks()
        return cpu_run

    seed, prompt, _ = cs.cpu_prompt(cfg, 8, F32, run({0}))
    assert seed == 1 and prompt.shape == (cs.CARD_CPU_ROWS[F32], 8)
    assert np.array_equal(prompt, np.random.default_rng(1).integers(
        0, cfg.vocab_size, (cs.CARD_CPU_ROWS[F32], 8)))
    seen.clear()
    with pytest.raises(SystemExit, match="no prompt seed"):
        cs.cpu_prompt(cfg, 8, F32, run({0, 1, 2}))
    assert len(seen) == cs.CARD_CPU_SEEDS


def test_route_flips_in_the_forwards_both_sides_fed_alike():
    L, n, rows = 2, 3, 2
    cpu = [torch.tensor([[[0, 1]] * (4 if f == 0 else 1)] * rows)
           for f in range(n + 1) for _ in range(L)]
    gaps = [torch.full(c.shape[:2], 0.5) for c in cpu]
    card = [c.clone() for c in cpu]
    card[0][1, 2] = torch.tensor([1, 0])    # the same experts, other order
    card[1][0, 3] = torch.tensor([0, 5])    # prefill, layer 1, row 0
    gaps[1][0, 3] = 2e-7
    card[2 * L][1, 0] = torch.tensor([7, 1])  # step 2, layer 0, row 1
    card[3 * L + 1][0, 0] = torch.tensor([2, 3])  # step 3, row 0
    assert cs.route_flips(cpu, card, gaps, L, [n, n]) == [
        (0, 1, 0, 3, pytest.approx(2e-7)), (2, 0, 1, 0, 0.5),
        (3, 1, 0, 0, 0.5)]
    # row 1's tokens differ from step 1 on: its later forwards are not
    # fed alike
    assert cs.route_flips(cpu, card, gaps, L, [n, 1]) == [
        (0, 1, 0, 3, pytest.approx(2e-7)), (3, 1, 0, 0, 0.5)]
    assert cs.route_flips(cpu, cpu, gaps, L, [n, n]) == []


def _moe_layer():
    cfg = SMOKES["qwen2-moe-a2.7b"]
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, params.layers[0].moe


@torch.no_grad()
def test_each_moe_call_serves_the_given_experts():
    """A moe layer given experts (``each_moe_call``'s ``routes``): its own
    choices given back change no bit; other choices give the experts'
    sum weighted by the layer's own router probabilities at them, and the
    tokens past an expert's capacity drop as they would."""
    from repro_torch.models import moe, transformer

    real = moe.router_probs
    cfg, p = _moe_layer()
    k = cfg.n_experts_per_tok
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 200, cfg.d_model, generator=g)   # Tg > 128: drops
    seen = []
    with cs.each_moe_call(lambda p_, c, x_: seen.append(
            cs.top_experts(p_, c, x_))):
        own, _ = transformer.moe_apply(p, cfg, x)
    assert seen[0].shape == (2, 200, k)
    with cs.each_moe_call(lambda *a: None, routes=iter(seen)):
        again, _ = transformer.moe_apply(p, cfg, x)
    assert torch.equal(own, again)
    assert transformer.moe_apply is moe.moe_apply
    # every token of both rows to experts 0 .. k-1: the first C of each
    # row keep them, the rest keep only the shared expert
    given = torch.arange(k).expand(2, 200, k)
    with cs.each_moe_call(lambda *a: None, routes=iter([given])):
        out, _ = transformer.moe_apply(p, cfg, x)
    C = moe.capacity(cfg, 200)
    probs = moe.router_probs(p.router, x)[..., :k]
    gate = probs / probs.sum(dim=-1, keepdim=True)
    y = sum(gate[..., e, None] * (F.silu(x @ p.w_gate[e]) * (x @ p.w_up[e]))
            @ p.w_down[e] for e in range(k))
    shared = (0 if p.shared is None else
              L.mlp_apply(p.shared, cfg.replace(mlp_gated=True), x))
    torch.testing.assert_close(out[:, :C], (y + shared)[:, :C],
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out[:, C:], shared[:, C:], rtol=1e-4,
                               atol=1e-5)
    assert moe.router_probs is real


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-350m", "qwen3-14b"])
def test_engine_bounds_in_bf16_read_2_byte_weights_and_a_4_byte_cache(arch):
    """The decode step's bound in bf16 reads every weight (of an untied
    table the rows a step gathers) at 2 bytes and the cache or state at 4,
    as the bf16 engine keeps it; the fp32 bound reads the weights at 4."""
    cfg = ARCHS[arch]
    B, S, T = 4, 500, 1024
    model = build_model(cfg)
    cache = cs.tensors(model.init_cache(B, T, device="meta"))
    assert {t.dtype for t in cache} == {torch.float32}
    n_cache = sum(t.numel() for t in cache)
    V, d = cfg.vocab_padded, cfg.d_model
    weights = cfg.param_count() - (0 if cfg.tie_embeddings else (V - B) * d)
    rate = cs.H100_BYTES_PER_S / 1e3
    b16 = cs.engine_bounds(cfg, B, S, T, BF16)
    f32 = cs.engine_bounds(cfg, B, S, T, F32)
    assert math.isclose(b16["decode_step_bound_ms"] * rate,
                        2 * weights + 4 * n_cache, rel_tol=1e-12)
    assert math.isclose(f32["decode_step_bound_ms"] * rate,
                        4 * weights + 4 * n_cache, rel_tol=1e-12)
    # the weights the bf16 model holds: all bf16 but what the reference
    # keeps in fp32 (Mamba2's A_log, D and dt_bias), well under 0.1%
    params = {"transformer": transformer.Transformer, "xlstm": stacks.XLSTM,
              "zamba2": stacks.Zamba2}[stack_kind(cfg)](cfg, BF16,
                                                        device="meta")
    held = sum(p.numel() * p.element_size() for p in params.parameters())
    assert held == pytest.approx(2 * cfg.param_count(), rel=1e-3)
    # the prefill bound in bf16 is never below reading every weight once
    assert b16["prefill_bound_ms"] >= 2 * cfg.param_count() / rate


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_moe_check_on_one_device(monkeypatch, dtype):
    """The moe card-vs-CPU check with both sides on the CPU at smoke
    width: the second side serves the first's expert choices through
    every layer call of the prefill and the decode steps, flips none, and
    holds."""
    cfg = SMOKES["qwen2-moe-a2.7b"]

    def both_on_cpu(cfg_, dtype_):
        model = build_model(cfg_)
        params = model.init(torch.Generator().manual_seed(0), dtype_,
                            device="cpu")
        return model, params, params

    trace = cs.greedy_trace
    monkeypatch.setattr(cs, "card_and_cpu_params", both_on_cpu)
    monkeypatch.setattr(cs, "greedy_trace",
                        lambda m, p, pr, n, dev: trace(m, p, pr, n, "cpu"))
    out = cs.moe_card_vs_cpu(cfg, n=6, dtype=dtype)
    assert out["route_flips"] == 0 and sum(out["compared"]) > 0
    assert len(out["compared"]) == cs.CARD_CPU_ROWS[dtype]
