"""Shared parts of ``k1_variants.py`` and ``k2_variants.py``: build
variants of one of the port's CUDA sources and time them on the card.

A variant is a CUDA source (the package's own, or another file with the
same C interface) with some of its ``constexpr int NAME = value;``
constants replaced. Every variant builds with the package's ``nvcc``
flags (one process each, all at once) into its own library, which
``use`` puts behind the port's wrapper in place of the package's build.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import re
import subprocess
import sys
from pathlib import Path
from typing import Counter, Dict, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

# name -> (source, or None for the package's own; constants to replace)
Variants = Dict[str, Tuple[Optional[Path], Dict[str, int]]]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def variant_source(text: str, consts: Dict[str, int]) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"constant {name} not found once in the source")
    return text


def build(lib: str, variants: Variants) -> Dict[str, ctypes.CDLL]:
    """{variant: loaded library} of the variants of ``csrc/<lib>.cu``
    that build (into ``build/<lib>_variants/``), printing each kernel's
    registers and spills and each failed build's log."""
    out = ROOT / "build" / f"{lib}_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (source, consts)) in enumerate(variants.items()):
        text = (source or _build.CSRC / f"{lib}.cu").read_text()
        src, so = out / f"v{i}.cu", out / f"v{i}.so"
        src.write_text(variant_source(text, consts))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {name}: build failed\n{log[-2000:]}")
            continue
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.split('ptxas info    : ')[-1]}")
        cdll = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in _build.SIGNATURES[lib].items():
            getattr(cdll, fn).restype = restype
            getattr(cdll, fn).argtypes = argtypes
        libs[name] = cdll
    return libs


@contextlib.contextmanager
def use(lib: str, cdll: ctypes.CDLL):
    """While active, the port's wrapper of ``lib`` launches ``cdll``."""
    _build._loaded[lib] = cdll
    try:
        yield
    finally:
        _build._loaded.pop(lib, None)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_opcodes(cdll: ctypes.CDLL) -> Dict[str, Counter[str]]:
    """{kernel: SASS opcode counts} of a built variant, from the
    toolkit's ``cuobjdump -sass`` (the instructions of each kernel as
    compiled, counted once each, not as executed)."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", cdll._name],
                          capture_output=True, text=True, check=True).stdout
    counts: Dict[str, Counter[str]] = {}
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            counts[kernel] = collections.Counter()
            continue
        m = re.match(
            r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and kernel:
            counts[kernel][m.group(1)] += 1
    return counts
