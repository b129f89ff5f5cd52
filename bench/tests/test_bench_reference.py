"""The plain reference against the port's CPU path, on the port's SMOKE
sizes of both families, in float32: prefill logits at the last prompt
position and decode-step logits through the KV cache, and the moe
layer's capacity drops. Then the control, the reference in float8,
against the dense cells' own limits."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import check, harness, weights
from bench.manifest import Manifest
from bench.reference import common
from bench.tests.conftest import tiny_config


def port_logits(cfg, W, prompt: np.ndarray, nxt: np.ndarray) -> torch.Tensor:
    """The port's logits (B, n, V): the prefill's last position, then one
    decode step for each of ``nxt``'s first n - 1 columns."""
    from repro_torch import build_model

    mc = harness.port_config(cfg)
    params = weights.port_module(cfg["port_params"], mc, W, torch.float32)
    model = build_model(mc)
    B, S = prompt.shape
    n = nxt.shape[1]
    cache = model.init_cache(B, S + n, device="cpu")
    with torch.inference_mode():
        lg, cache = model.prefill(
            params, {"tokens": torch.as_tensor(prompt, dtype=torch.long)},
            cache)
        out = [lg[:, -1]]
        for i in range(n - 1):
            lg, cache = model.decode_step(params, cache, {
                "tokens": torch.as_tensor(nxt[:, i:i + 1], dtype=torch.long),
                "cache_index": S + i})
            out.append(lg[:, -1])
    return torch.stack(out, dim=1).float()


def ref_logits(cfg, ref, W, prompt, nxt) -> torch.Tensor:
    B, S = prompt.shape
    blk = common.Block(
        tokens=torch.as_tensor(np.concatenate([prompt, nxt[:, :-1]], 1),
                               dtype=torch.long),
        judged=list(range(S - 1, S - 1 + nxt.shape[1])), prompt=S,
        group_rows=ref.group_rows(cfg, B))
    return ref.logits(cfg, W, [blk])[0]


@pytest.mark.parametrize("family,B,S,repeat", [
    ("dense", 3, 40, False), ("moe", 2, 40, False),
    ("moe", 2, 160, False), ("moe", 4, 160, True)])
def test_reference_matches_port_cpu(family, B, S, repeat):
    cfg = tiny_config(family)
    ref = Manifest().reference(family)
    W = weights.draw(ref.param_specs(cfg), 11, torch.float32,
                     torch.device("cpu"))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg["vocab_size"], (B, S))
    if repeat:   # every position routes alike: the capacity drops tokens
        prompt[:] = prompt[:, :1]
    nxt = rng.integers(0, cfg["vocab_size"], (B, 5))
    mine = port_logits(cfg, W, prompt, nxt)
    theirs = ref_logits(cfg, ref, W, prompt, nxt)
    assert mine.shape == theirs.shape == (B, 5, cfg["vocab_size"])
    assert (mine - theirs).abs().max() < 1e-4


def test_moe_reference_drops_over_capacity(monkeypatch):
    cfg = tiny_config("moe")
    ref = Manifest().reference("moe")
    W = weights.draw(ref.param_specs(cfg), 5, torch.float32,
                     torch.device("cpu"))
    kept = []
    real = ref.route

    def spy(*a, **kw):
        g, e, k = real(*a, **kw)
        kept.append(k)
        return g, e, k

    monkeypatch.setattr(ref, "route", spy)
    prompt = np.full((2, 160), 7)
    ref_logits(cfg, ref, W, prompt, np.full((2, 3), 9))
    k = kept[0]
    assert not bool(k[:, :160].all())      # the prompt drops
    assert bool(k[:, 160:].all())          # decode positions drop nothing
    C = ref.capacity(cfg, 160)
    assert C == 72 and int(k[0].sum()) <= C * cfg["num_experts"]


def test_capacity_and_groups_match_the_port():
    from repro_torch.models.moe import _n_groups, capacity

    cfg = tiny_config("moe")
    ref = Manifest().reference("moe")
    mc = harness.port_config(cfg)
    for n in (1, 8, 128, 129, 512, 4096):
        assert ref.capacity(cfg, n) == capacity(mc, n)
    for B in (1, 2, 3, 8, 12, 16, 96, 128):
        assert ref.group_rows(cfg, B) == B // _n_groups(B)


def test_weights_are_the_seeds():
    cfg = tiny_config("moe")
    specs = Manifest().reference("moe").param_specs(cfg)
    a = weights.draw(specs, 3, torch.float32, torch.device("cpu"))
    b = weights.draw(specs, 3, torch.float32, torch.device("cpu"))
    c = weights.draw(specs, 4, torch.float32, torch.device("cpu"))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert float(a["layers.0.attn_norm.scale"].min()) == 1.0
    assert abs(float(a["layers.0.moe.w_down"].std()) - 96 ** -0.5) < 0.01
    base = min(t.data_ptr() for t in a.values())
    assert all((t.data_ptr() - base) % 128 == 0 for t in a.values())


@pytest.mark.parametrize("cell", [c for c in Manifest().workloads()
                                  if Manifest().cell(c).config["family"]
                                  == "dense"])
def test_control_fails_where_the_program_passes(cell):
    """The float8 control, at a tiny size on the CPU, fails the cell's
    own limits (``limits/<cell>.json``) through the comparison and the
    verdict that a run takes, where the float32 program passes. (At this
    size the control's mean gap, 0.09 on the moe cell's tiny sizes, stays
    under that cell's limit; its readings there come from the card.)"""
    limits = Manifest().cell(cell).limits
    cfg = tiny_config("dense")
    ref = Manifest().reference("dense")
    W = weights.draw(ref.param_specs(cfg), 21, torch.float32,
                     torch.device("cpu"))
    rng = np.random.default_rng(1)
    units = []
    for i in range(6):
        prompt = rng.integers(0, cfg["vocab_size"], (1, 24))
        lg = ref_logits(cfg, ref, W, prompt, np.zeros((1, 1), np.int64))
        # greedy decode by the reference: the program's tokens, exactly
        toks = [int(lg[0, -1].argmax())]
        for _ in range(5):
            lg = ref_logits(cfg, ref, W, prompt, np.array([toks + [0]]))
            toks.append(int(lg[0, -1].argmax()))
        units.append([check.Served(prompt[0], np.array(toks))])
    got = check.judge(cfg, ref, 21, torch.float32, torch.device("cpu"),
                      units, control=True)
    assert got["widest_gap"] < 1e-4
    assert got["tokens"] == 36
    assert harness.passes(harness.compare(limits, 0, 0, got), 36)
    ctl = harness.compare(limits, 0, 0, check.numbers(got["control_gaps"]))
    assert not harness.passes(ctl, 36), ctl
