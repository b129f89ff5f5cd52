#!/usr/bin/env python3
"""Where the time of the port's flash-attention kernel (K1) goes, by role
and phase, on one Hopper GPU.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 tools/k1_probe.py [--model NAME ...]

Writes a copy of ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
``clock64()`` counters added at fixed places (it fails if those lines
moved), builds it with the package's flags into
``build/flash_attention_variants/``, runs it through the port's wrapper
at the prefill shapes of the main paths in fp32 and bf16, and prints,
summed over every block and divided by the key tiles the blocks walked,
the SM cycles a tile that the first consumer warpgroup spends waiting
for an item's query rows (``q_wait``) and for a stage (``tile_wait``),
in q k^T (``qk``), in the mask and softmax (``softmax``) and in p v
(``pv``), its whole run (``total``), the first helper thread's waits
and work (fp32) and the producer thread's waits for a free stage. The
counters cost registers and time, so the kernel's own time is taken
without them (``tools/k1_variants.py``); the device time printed here is
the probed copy's.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

import kernel_variants as kv
from k1_variants import SHAPES
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

# (anchor in the source, text put in its place)
PATCHES = [
    ("namespace {\n\nusing namespace hopper;",
     "__device__ unsigned long long probe_buf[4096][10];\n"
     "namespace {\n\nusing namespace hopper;"),
    ("    if (pt == 0) {\n      int it = 0;\n",
     "    if (pt == 0) {\n      int it = 0;\n"
     "      unsigned long long pw = 0;\n"),
    ("          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);\n",
     "          unsigned long long e0 = clock64();\n"
     "          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);\n"
     "          pw += clock64() - e0;\n"),
    ("                          t.kvh, i * BK, t.b);\n          }\n        }\n"
     "      }\n",
     "                          t.kvh, i * BK, t.b);\n          }\n        }\n"
     "      }\n      probe_buf[blockIdx.x][9] = pw;\n"),
    ("      int it = 0;\n      for (int n = 0, w = work_of(0); w < items; "
     "w = work_of(++n)) {\n        const Item t = item_of(w, B, Sq, Sk, H, "
     "Hkv, causal, BQ, BK);\n        mbar_wait(q_full, n & 1);",
     "      int it = 0;\n      unsigned long long hw = 0, h0 = clock64();\n"
     "      for (int n = 0, w = work_of(0); w < items; w = work_of(++n)) {\n"
     "        const Item t = item_of(w, B, Sq, Sk, H, Hkv, causal, BQ, BK);\n"
     "        unsigned long long c0 = clock64();\n"
     "        mbar_wait(q_full, n & 1);\n        hw += clock64() - c0;"),
    ("          mbar_wait(&full[s], (it / STAGES) & 1);\n"
     "          unsigned char* st",
     "          unsigned long long c0 = clock64();\n"
     "          mbar_wait(&full[s], (it / STAGES) & 1);\n"
     "          hw += clock64() - c0;\n          unsigned char* st"),
    ("          fence_proxy_async();\n          mbar_arrive(&ready[s]);\n"
     "        }\n      }\n",
     "          fence_proxy_async();\n          mbar_arrive(&ready[s]);\n"
     "        }\n      }\n      if (ht == 0) {\n"
     "        probe_buf[blockIdx.x][7] = hw;\n"
     "        probe_buf[blockIdx.x][8] = clock64() - h0 - hw;\n      }\n"),
    ("  int it = 0;\n  for (int n = 0, w = work_of(0); w < items; "
     "w = work_of(++n)) {\n    const Item item",
     "  int it = 0;\n  const unsigned long long t0 = clock64();\n"
     "  unsigned long long w_wait = 0, w_qk = 0, w_sm = 0, w_pv = 0, qw = 0;\n"
     "  unsigned long long ntl = 0;\n"
     "  for (int n = 0, w = work_of(0); w < items; w = work_of(++n)) {\n"
     "    const Item item"),
    ("    mbar_wait(q_full, n & 1);\n    if constexpr (C::F32) "
     "mbar_wait(q_ready, n & 1);\n    if (last < 0",
     "    unsigned long long qa = clock64();\n    mbar_wait(q_full, n & 1);\n"
     "    if constexpr (C::F32) mbar_wait(q_ready, n & 1);\n"
     "    qw += clock64() - qa;\n    ntl += item.n_tiles;\n    if (last < 0"),
    ("      mbar_wait(&full[s], phase);\n      if constexpr (C::F32) "
     "mbar_wait(&ready[s], phase);\n",
     "      unsigned long long a0 = clock64();\n"
     "      mbar_wait(&full[s], phase);\n"
     "      if constexpr (C::F32) mbar_wait(&ready[s], phase);\n"
     "      w_wait += clock64() - a0;\n"),
    ("        Math<T, HD>::qk(sc, q, qs, st);\n",
     "        unsigned long long b0 = clock64();\n"
     "        Math<T, HD>::qk(sc, q, qs, st);\n"
     "        unsigned long long b1 = clock64();\n        w_qk += b1 - b0;\n"),
    ("        Math<T, HD>::pv(acc, sc, st);\n      }",
     "        unsigned long long b2 = clock64();\n        w_sm += b2 - b1;\n"
     "        Math<T, HD>::pv(acc, sc, st);\n"
     "        w_pv += clock64() - b2;\n      }"),
    ("               acc[4 * c + 2 * r + 1] / denom);\n    }\n  }\n}\n",
     "               acc[4 * c + 2 * r + 1] / denom);\n    }\n  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned long long* pb = probe_buf[blockIdx.x];\n"
     "    pb[0] = qw; pb[1] = w_wait; pb[2] = w_qk; pb[3] = w_sm;\n"
     "    pb[4] = w_pv; pb[5] = clock64() - t0; pb[6] = ntl;\n  }\n}\n"),
]
READ = '''
extern "C" int repro_probe_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, probe_buf, sizeof(probe_buf));
}
extern "C" int repro_probe_clear() {
  static unsigned long long zero[4096][10];
  return (int)cudaMemcpyToSymbol(probe_buf, zero, sizeof(zero));
}
'''
COLUMNS = ("q_wait", "tile_wait", "qk", "softmax", "pv", "total", "tiles",
           "helper_wait", "helper_work", "producer_wait")


def probed_source() -> str:
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for anchor, new in PATCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"k1_probe: anchor not found once in the "
                             f"source:\n{anchor}")
        text = text.replace(anchor, new)
    return text + READ


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", action="append", choices=sorted(SHAPES),
                    help="probe only this model's shape (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 1
    print(kv.card())
    out = kv.ROOT / "build" / "flash_attention_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "probe.cu"
    src.write_text(probed_source())
    lib = kv.build("flash_attention", {"probe": (Path(src), {})})["probe"]
    lib.repro_probe_read.argtypes = [ctypes.c_void_p]
    for model, (B, Sq, Sk, H, Hkv, hd, causal) in SHAPES.items():
        if args.model and model not in args.model:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
                       for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd),
                                 (B, Sk, Hkv, hd)))
            with kv.use("flash_attention", lib):
                ms = kv.device_ms(lambda: fa.flash_attention(q, k, v, causal))
                lib.repro_probe_clear()
                fa.flash_attention(q, k, v, causal)
                torch.cuda.synchronize()
            buf = np.zeros((4096, 10), np.uint64)
            lib.repro_probe_read(buf.ctypes.data)
            used = buf[buf[:, 5] > 0].astype(np.float64)
            tiles = used[:, 6].sum()
            per_tile = {c: round(float(used[:, i].sum()) / tiles, 1)
                        for i, c in enumerate(COLUMNS) if c != "tiles"}
            print(json.dumps({"model": model, "dtype": str(dtype)[6:],
                              "blocks": len(used), "tiles": int(tiles),
                              "probed_device_ms": ms,
                              "cycles_per_tile": per_tile}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
