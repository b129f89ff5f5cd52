"""Build the port's CUDA kernels with ``nvcc`` at first use and load
them through ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so``
at the repository root, where ``<hash>`` covers the package's CUDA
sources and the compiler flags, so an edited source builds anew. The
libraries have a plain C interface (no PyTorch headers), which keeps a
build to seconds. Several sources build in parallel, one ``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> {C function: (restype, argtypes)}; pointers and the stream are
# c_void_p so that ctypes passes them as 64-bit values.
SIGNATURES: Dict[str, Dict[str, Tuple[object, List[object]]]] = {
    "flash_attention": {
        "repro_flash_attention_fwd": (_I, [_P, _P, _P, _P] + [_I] * 8 + [_P]),
        "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "grouped_matmul": {
        "repro_grouped_matmul": (_I, [_P, _P, _P] + [_I] * 5 + [_P]),
        "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME,
    CUDA_PATH or DEFAULT_CUDA_HOME. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    roots = (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             DEFAULT_CUDA_HOME)
    for root in filter(None, roots):
        cand = Path(root) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use")


def source_digest() -> str:
    """Hash of every CUDA source of the package and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_digest()}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once; return {name: library path}."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            nvcc_command(n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, todo[n])  # atomic: readers never see half a file
        else:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib
