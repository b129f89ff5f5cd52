"""A fresh interpreter that runs the harness's CPU-side code loads no
module whose top-level name is jax, jaxlib, flax or repro (the JAX
package; ``repro_torch`` is the port, compared by whole name), and one
that runs the reference loads none of those nor ``repro_torch``."""
from __future__ import annotations

import json
import subprocess
import sys

from bench.tests.conftest import CHAT_MIX, ROOT

PRELUDE = f"""
import json, sys, tempfile, time
from pathlib import Path
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
"""
REPORT = """
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code + REPORT],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = f"""
from bench import harness
from bench.manifest import Manifest
from bench.run import forbidden_modules
from bench.tests.conftest import write_layout
root = Path(tempfile.mkdtemp())
name = write_layout(root, "moe", {CHAT_MIX!r})
m = Manifest(root)
out = harness.run_cell(m, name, 9, 0.01, False, "cpu", time.perf_counter())
assert harness.correct(out), out.checks
harness.metrics(m, out, False)
assert forbidden_modules() == [], forbidden_modules()
"""
    mods = _top_level(code)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_neither_jax_nor_the_port():
    code = """
import numpy as np, torch
from bench import check
from bench.manifest import Manifest
from bench.tests.conftest import tiny_config
for family in ("dense", "moe"):
    cfg = tiny_config(family)
    ref = Manifest().reference(family)
    units = [[check.Served(np.arange(20) % 7, np.array([1, 2, 3]))]]
    check.judge(cfg, ref, 5, torch.float32, torch.device("cpu"), units,
                control=True)
"""
    mods = _top_level(code)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
