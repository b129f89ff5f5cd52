"""``run.py`` as a check of the benchmark starts it: no result without a card, or in
a directory with only ``BENCHMARK.json`` and ``bench/``; on the card
(marked ``gpu``) a short run of each cell is correct."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from bench.tests.conftest import ROOT


def _run(root, cell="qwen3-14b.chat", seconds="1", timeout=120):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", seconds, "--trace", "0"],
        cwd=str(root), capture_output=True, text=True, timeout=timeout)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_no_result_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["qwen2-moe-a2.7b.prompt",
                                  "qwen3-14b.prompt", "qwen3-14b.chat"])
def test_cell_is_correct_on_the_card(cuda, cell):
    out = _run(ROOT, cell, "2", timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res)[-1] == "checks"
