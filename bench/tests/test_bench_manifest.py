"""Every cell's files are found by name, and a layout with a new
configuration, mix and metric runs with no edit to the harness."""
from __future__ import annotations

import time

import pytest

from bench import harness
from bench.manifest import Manifest
from bench.tests.conftest import CHAT_MIX, write_layout


def test_every_cell_finds_its_files():
    m = Manifest()
    assert m.workloads() == ["qwen2-moe-a2.7b.prompt", "qwen3-14b.prompt",
                             "qwen3-14b.chat"]
    for name in m.workloads():
        cell = m.cell(name)
        assert cell.chips == 1
        gen = m.generator(cell.mix["kind"])
        assert gen.warmup_lengths(cell.mix)
        assert hasattr(m.reference(cell.config["family"]), "logits")
        assert cell.limits["sample_units"] >= 1
        assert set(cell.limits["limits"]) <= {"widest_gap", "mean_gap"}
        assert {e["name"] for e in cell.end_to_end} >= {"setup_s",
                                                        "peak_mem_gib"}
        assert cell.per_layer
        for metric in cell.end_to_end + cell.per_layer:
            assert callable(m.reader(metric["name"]).read)


def test_benchmark_json_shape():
    m = Manifest()
    d = m.data
    assert d["command"] == ["python3", "bench/run.py"]
    assert d["paths"] == ["bench"]
    names = {e["name"] for e in d["end_to_end"]}
    for e in d["per_layer"]:
        assert e["moves"] in names
        for w in e["workloads"]:
            cell = m.cell(w)
            assert e["moves"] in {x["name"] for x in cell.end_to_end}
    for c in d["configs"]:
        cfg = m.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert all(k in cfg for k in c["reduced"])
        assert isinstance(cfg["assumed"], list)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        Manifest().cell("no-such-cell")


def test_port_config_matches_the_port(monkeypatch):
    from repro_torch.configs import ARCHS

    m = Manifest()
    for c in m.data["configs"]:
        cfg = m.config(c["name"])
        mine, port = harness.port_config(cfg), ARCHS[cfg["arch"]]
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_head", "vocab_size", "qkv_bias", "qk_norm",
                  "rope_theta", "tie_embeddings", "mlp_gated", "n_experts",
                  "n_experts_per_tok", "n_shared_experts", "d_expert",
                  "norm_eps", "pad_vocab"):
            assert getattr(mine, f) == getattr(port, f), f
        if port.family != "moe":   # d_ff is unused by a moe model
            assert mine.d_ff == port.d_ff


def test_new_config_mix_and_metric_run_without_edits(tmp_path):
    src = ('def read(ctx):\n'
           '    return float(sum(b.rows for b in ctx.served))\n')
    name = write_layout(tmp_path, "dense", CHAT_MIX, metric_src=src)
    m = Manifest(tmp_path)
    out = harness.run_cell(m, name, seed=2 ** 31 + 7, seconds=0.01,
                           trace=False, device="cpu", t0=time.perf_counter())
    assert harness.correct(out), out.checks
    e2e = harness.metrics(m, out, trace=False)
    assert set(e2e) == {"output_tokens_per_s", "setup_s"}
    # the window holds whole cycles of the mix: 2 x 12 and 1 x 24 tokens
    assert len(out.context.batches) % 3 == 0
    per_layer = harness.metrics(m, out, trace=True)
    assert per_layer["tiny_metric"]["value"] == out.attempted
