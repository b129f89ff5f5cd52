"""Fixtures of the benchmark's CPU tests: tiny configurations with the
keys of the real files (the port's SMOKE sizes), a tiny cell laid out
like ``bench/`` in a temporary directory, and the ``gpu`` marker's
skip, decided in a fixture."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The port's SMOKE sizes of qwen3-14b and qwen2-moe-a2.7b, by the
# configuration files' keys.
SMOKE = {
    "dense": {"num_hidden_layers": 2, "hidden_size": 64,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 16, "intermediate_size": 128, "vocab_size": 512},
    "moe": {"num_hidden_layers": 2, "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 4,
            "intermediate_size": 96, "vocab_size": 512, "num_experts": 6,
            "num_experts_per_tok": 2, "moe_intermediate_size": 96,
            "shared_expert_intermediate_size": 192},
}
FILES = {"dense": "qwen3-14b-bf16.json", "moe": "qwen2-moe-a2.7b-bf16.json"}


def tiny_config(family: str, dtype: str = "float32") -> dict:
    cfg = json.loads((ROOT / "bench" / "configs" / FILES[family]).read_text())
    cfg.update(SMOKE[family], name=f"tiny-{family}", torch_dtype=dtype)
    return cfg


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def write_layout(root: Path, family: str, mix: dict, limit: float = 1e-3,
                 metric_src: str = "") -> str:
    """A BENCHMARK.json and a bench/ of data files under ``root`` with
    one tiny cell, ``tiny.cell``; returns its name. ``metric_src`` adds
    a per-layer metric ``tiny_metric`` with that reader."""
    b = root / "bench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (b / d).mkdir(parents=True, exist_ok=True)
    (b / "configs" / "tiny.json").write_text(json.dumps(tiny_config(family)))
    (b / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny.cell.json").write_text(json.dumps(
        {"sample_units": 3, "limits": {"widest_gap": {"limit": limit},
                                       "mean_gap": {"limit": limit}}}))
    per_layer = []
    if metric_src:
        (b / "metrics" / "tiny_metric.py").write_text(metric_src)
        per_layer.append({"name": "tiny_metric", "unit": "1",
                          "better": "higher", "source": "host_clock",
                          "layer": "engine", "moves": "output_tokens_per_s"})
    bench = {
        "command": ["python3", "bench/run.py"], "paths": ["bench"],
        "run_seconds": 1,
        "configs": [{"name": "tiny", "source": "https://example.org/tiny",
                     "file": "bench/configs/tiny.json", "reduced": [],
                     "why": "test"}],
        "workloads": [{"name": "tiny.cell", "config": "tiny",
                       "traffic": "tiny-mix", "chips": 1, "why": "test"}],
        "end_to_end": [
            {"name": "output_tokens_per_s", "unit": "tokens/s",
             "better": "higher", "bound": 0.05, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": per_layer}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "tiny.cell"


CHAT_MIX = {"kind": "closed_batches", "rows": 2, "n_new": 4, "max_seq": 48,
            "cycle": [[12, 2], [24, 1]], "why": "test"}
