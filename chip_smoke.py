#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA Hopper GPU.

Run from the repository root, with nothing else on the command line:

    python3 chip_smoke.py

1. Setup: needs CUDA, turns TF32 off, prints the card, builds every
   CUDA kernel of the port from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once).
2. Kernels: holds each kernel against its plain PyTorch version on the
   card: flash attention (K1) at every serving path's prefill shape
   (head dims 64, 112 and 128; qwen3-14b's GQA groups of 5, minicpm-2b's
   36 heads) and at ragged, wide-head, Sq != Sk,
   non-causal, off-tile and GQA-group cases, in fp32 and bf16, and in
   fp32 with q scaled by 8 (a peaked softmax) at the qwen2, moe and
   Zamba2 prefill shapes; the grouped GEMM (K2) at the moe path's
   shapes, the reference's sweep, (1,1,1,1) and shapes TMA cannot copy,
   densely and with ``rows`` (occupied rows per expert) as the moe path
   passes them, at the prefill shapes also with NaN past ``rows`` and
   with x scaled by 8, every prefill case also held to the product in
   float64, and each case's variant (K1: flash_wgmma in fp32 or bf16;
   K2: gmm_small, gmm_wgmma, gmm_wgmma_bf16, gmm_decode_bf16 or
   gmm_large) checked. (K3, the q/k/v epilogue, is held to its plain
   chain by the card tests in ``tests/test_torch_gpu.py``; here every
   engine counts its launches, one an attention layer a forward, and
   the timing phase holds it to the chain at the benchmark cells'
   shapes, at the card tests' tolerance: ``k3_held``.)
   The build fails the run if ``ptxas`` spills in
   flash_wgmma, gmm_wgmma, gmm_wgmma_bf16 or gmm_decode_bf16, or
   serializes gmm_decode_bf16's wgmma (C7514), and prints any line of
   ptxas's about serialized wgmma.
3. Dense engine: serves full-width qwen2-0.5b (random weights drawn on
   the card from a seed) through ``ServeEngine.generate``, checks that
   every layer's prefill attention went through K1, on its 3xTF32
   variant (each launch's device time read from CUDA events around it,
   and from a torch.profiler trace of a repeat of its prefill), and holds
   the card against the port's CPU path at full depth (the weights drawn
   on the card and copied to the CPU). Then the same in bf16 (the KV cache stays fp32, as the
   reference engine keeps it): every K1 launch on flash_wgmma_bf16, and
   card against CPU at 2 layers within bf16's limits (``BF16_REL``).
   Every card-vs-CPU check serves ``CARD_CPU_ROWS`` prompts (4 in fp32,
   16 in bf16) and compares each row's greedy tokens up to its first CPU
   near-tie
   (``compared_steps``), prints the steps it compared by row and in
   all, moves to the next prompt seed (at most ``CARD_CPU_SEEDS``) while
   none is left to compare, and then fails.
4. Moe engine: serves full-width, 24-layer qwen2-moe-a2.7b in fp32
   (14.3 B parameters, 57 GB, drawn on the card from a CUDA generator)
   through ``ServeEngine.generate``, checks that every prefill
   attention went through K1 and every expert GEMM through K2 (counted
   by kernel, phase and shape, and K2 by variant: every prefill launch on
   the tensor-core gmm_wgmma; each launch's device time read from CUDA
   events around it and from a torch.profiler trace of a repeat of the
   run, which is not traced itself: the profiler slows its host-bound
   decode; K2's ``rows`` read after it), then holds the card against the
   CPU path at full width and 2 layers. Then the same in bf16 (28.6 GB
   of weights drawn on the card in bf16): K1 on flash_wgmma_bf16, every
   prefill K2 launch on gmm_wgmma_bf16, and card against CPU within
   bf16's limits; each row compared up to its first CPU router near-tie
   (bf16: ``BF16_ROUTER_REL`` at the compared position of the last
   layer; fp32: ``FP32_ROUTER_GAP`` anywhere in the row's forward); every
   decode K2 launch on gmm_decode_bf16. The card's moe layers serve the
   CPU's expert choices, and the card's own choices are held beside them
   (fp32: a flip where the CPU's gap is at least ``FP32_ROUTER_GAP``
   fails; bf16: counted).
5. Zamba2 engine: serves zamba2-7b at its full
   width and depth (81 Mamba2 layers and 13 applications of the shared
   attention block, 6.75 B parameters, 27 GB in fp32, drawn on the card)
   through ``ServeEngine.generate``, in fp32 and then in bf16, checks 13
   K1 launches per prefill at hd 112 and none in decode, then holds the
   card against the CPU path at full width and 12 layers (two
   shared-block applications) on 300-token prompts (two SSD chunks); in
   bf16 those 12 layers one by one, each on the CPU's input, through the
   prefill and ``ZAMBA2_LAYER_STEPS`` decode steps
   (``zamba2_layers_card_vs_cpu``), and end to end at
   ``ZAMBA2_BF16_LAYERS``.
6. The other models at full width and depth, each through
   ``ServeEngine.generate`` (4 x 500 tokens, 16 new) in fp32 and then in
   bf16: internvl2-1b (256 zero patch embeddings before the text; K1 at
   S = 756), musicgen-large (four codebook streams), xlstm-350m (no
   attention, so no K1), qwen3-14b (14.77 B parameters, 59 GB in fp32;
   qk-norm, K1 at GQA 40 / 8, hd 128) and minicpm-2b (MHA, 36 heads at
   hd 64, tied embeddings); each also held against the CPU path at 2
   layers.
7. Training: trains full-width qwen2-0.5b (494,032,768 parameters,
   not cut) on the card through ``train()``: fp32, TF32 off, remat on,
   8 x 256 tokens of ``SyntheticLMData``, 10 steps; checks that the loss
   falls and that neither kernel was launched (training takes the
   reference's routes), prints ms per step, tokens/s, peak memory, the
   6·N·T and 8·N·T FLOP bounds and a ``torch.profiler`` trace of one more
   step; then, cut to 2 layers, holds 3 steps on the card to 3 on the
   CPU from the same weights and 6 steps to 3 + checkpoint + resume + 3.
8. Mesh: the distribution layer. (a) A world-size-1 nccl group and a
   (1, 1) (`data`, `model`) mesh; full-width qwen2-0.5b from the
   training phase's CPU-generator weights, placed by ``reshard_state``
   under the sharding rules, takes 3 steps at 8 x 256 tokens on the
   masked-attention route and 3 on "cp"; each loss is held to the plain
   step from the same weights on the card (``MESH_RTOL``), with no K1 or
   K2 launch; prints ms a step beside the plain step's and peak memory.
   (b) The dry run, host only: ``analyze_cell`` on
   ``MESH_DRYRUN_CELLS`` at full width on a fake 16x16 mesh and a fake
   2x16x16 mesh (11 cells: dense, moe, hybrid, xLSTM, a vocab and kv
   heads that do not divide `model`), every row ok, under the card's
   memory per device, and held to the reference's per-device FLOPs and
   collective bytes (its numbers from the committed table
   ``scripts/dryrun_reference.jsonl``: the card's machine has no JAX).
9. Control plane: the serving session (the NPU simulated on the host):
   qwen3-14b decode next to qwen2-0.5b prefill in closed loop under
   every policy, then open loop with a mid-run register, SLO autoscale
   and deregister; checks that every submitted request finished and
   that the autoscaler grew the budget.
10. Fleet sweep: the port's fluid fleet simulator
    (``repro_torch.core.sim_torch``, no kernel of its own) runs the whole
    collocation grid on the card: all 78 pairs of the 12 workloads x the
    49 EU splits of an 8 ME / 8 VE core x 5 HBM bandwidths, harvest off
    and on (2 x 19110 cells, 4 requests each). The card is held to the
    same call on the CPU (equal events in every cell, floats within
    ``SIM_REL_TOL``) and, at the half split of three pairs, to the port's
    discrete-event simulator in the bands of ``tests/test_sim_jax.py``;
    prints the card's grid time (median and spread of 3 calls after a
    warm-up), the CPU's, the discrete simulator's time per cell over the
    nine paper pairs, the loop's iterations and the largest event count.
11. Timing: times each kernel at each of its main-path shapes (K1 at
    the prefill shape of every model served with attention, in each
    dtype it was served in), its plain
    version and the PyTorch library call that computes the same
    function (with the kernels that call ran, from torch.profiler),
    beside the least time the card could take for the same work (fp32:
    on the CUDA cores and as 3xTF32 on the tensor cores; bf16: on the
    bf16 tensor cores), and beside its device time per launch inside the
    main run of its dtype (from the trace of its repeat); K2 also with
    the ``rows`` of the main run, beside the least time for what those
    rows need. K1 and SDPA are
    timed by their device time in a torch.profiler trace (K2 too, beside
    its CUDA-event time), since back-to-back calls of a kernel shorter
    than its wrapper read the host. K3 at the benchmark cells' shapes
    (``K3_CELL_SHAPES``: dense and moe 8 x 4096 prefill, the chat
    cell's 16-row decode step), held to the plain chain first
    (``k3_held``), beside its byte bound, the plain chain's device time
    and kernels, and the launches a forward of the engine run.

Prints the card's name and power limit and a ``{"kernels": [...]}``
line before the last line, which is ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, if there is no CUDA device or any phase
fails.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

H100_FP32_FLOPS = 67e12      # non-tensor fp32, SXM, 700 W (data sheet)
H100_TF32_FLOPS = 494.7e12   # dense tensor-core tf32
H100_BF16_FLOPS = 989e12     # dense tensor-core bf16
H100_BYTES_PER_S = 3.35e12   # HBM3

# Training, card against the port's CPU path: the largest relative
# difference of a loss over 3 steps of the 2-layer cut of qwen2-0.5b
# (4 x 128 tokens, lr 1e-3) that the check allows. Measured on an H100
# 80GB HBM3 at 700 W: 8.0e-8 (the fp32 GEMMs sum in another order).
TRAIN_CARD_CPU_RTOL = 1e-6
# Resume: the reference's own bound (tests/test_train.py).
RESUME_RTOL = 1e-5
# The sharded training step on a one-rank mesh against the plain step
# from the same weights on the card: the largest relative difference of
# a loss over 3 steps.
MESH_RTOL = 1e-6
# The dry-run cells the mesh phase traces at full width: (arch, shape,
# mesh, the port's per-device FLOPs on torch 2.13 on the CPU, from
# ``python -m repro_torch.launch.dryrun`` with the same arguments on the
# tree that added them). The reference's numbers come from the committed
# table ``scripts/dryrun_reference.jsonl`` (its own dry run, which needs
# JAX, absent on the card's machine; ``scripts/dryrun_sweep_check.py``
# says how it is made), and the bounds from
# ``repro_torch.launch.dryrun_expect``.
MESH_DRYRUN_CELLS = (
    ("qwen2-0.5b", "train_4k", "single", 128219671953408.0),
    ("qwen2-moe-a2.7b", "decode_32k", "single", 54641033216.0),
    ("zamba2-7b", "prefill_32k", "single", 107161648627712.0),
    ("qwen2-0.5b", "train_4k", "multi", 64109835976704.0),
    ("qwen3-14b", "train_4k", "multi", 1269702391234560.0),
    # a batch-1 decode over a KV cache sharded 16 ways on its sequence
    # (on the 2x16x16 mesh replicated over `pod`): the flash-decoding
    # combine, no gather of the cache
    ("zamba2-7b", "long_500k", "single", 1593353216.0),
    ("zamba2-7b", "long_500k", "multi", 1593353216.0),
    # the mLSTM on (head, head-dim) shards, the sLSTM on its units
    ("xlstm-350m", "decode_32k", "single", 1211541504.0),
    ("xlstm-350m", "long_500k", "multi", 151442688.0),
    # a vocab that does not divide `model`: the logits all-reduced
    ("internvl2-1b", "decode_32k", "single", 23042287744.0),
    # kv heads that do not divide `model`: the cache on kv-head shards
    ("qwen2-72b", "decode_32k", "single", 115750207488.0),
)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events around them: where ``fn``'s kernels are shorter than the host's
    time to launch them, this reads the host."""
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


def device_ms(fn, part: str = "", iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` per call, from a torch.profiler trace of
    ``iters`` calls: for each kernel name (those that hold ``part``), its
    mean duration times its launches a call, summed. Unlike ``cuda_ms``
    it leaves out the gaps in which the device waits for the host.

    Late in this script's process a trace loses its first records (at
    the timing phase, all of 50 calls of K1), so the calls follow
    ``PAD`` short spin kernels, of which some must be left: then no
    record of the calls is lost."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD):
            torch.cuda._sleep(100)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    pad = [e for e in kernels if "spin" in e.name or "sleep" in e.name]
    by_name = defaultdict(list)
    for e in kernels:
        if part in e.name and "spin" not in e.name and "sleep" not in e.name:
            by_name[e.name].append(e.time_range.elapsed_us())
    per_call = {n: round(len(d) / iters) for n, d in by_name.items()}
    check(len(pad) > 0 and sum(per_call.values()) > 0,
          f"the trace of {PAD} spin kernels and {iters} calls holds "
          f"{len(pad)} and {sum(map(len, by_name.values()))} kernels named "
          f"{part!r}")
    return sum(sum(d) / len(d) * per_call[n]
               for n, d in by_name.items()) / 1e3


# Spin kernels ahead of the calls in ``device_ms``'s trace.
PAD = 3000


def attention_inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd),
                               (B, Sk, Hkv, hd)))


def attention_bound(B, Sq, Sk, H, Hkv, hd, causal, dtype):
    """{"bound_ms", "bound_by", ...}: the least time an H100 could take.
    Operations are the multiply-adds of q k^T and p v over the (query,
    key) pairs these shapes leave unmasked; bytes read q, k, v once and
    write o once. bf16: operations at the bf16 tensor-core peak. fp32:
    the lesser of two bounds, both given: operations at the fp32 peak of
    the CUDA cores, and 3xTF32's three tf32 products per operation at the
    tf32 tensor-core peak (the route K1 takes), each beside the bytes."""
    if causal:
        pairs = sum(min(Sk, r + Sk - Sq + 1) for r in range(Sq))
    else:
        pairs = Sq * Sk
    ops = 4 * B * H * hd * pairs
    elt = torch.finfo(dtype).bits // 8
    t_bytes = elt * (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd) \
        / H100_BYTES_PER_S * 1e3

    def bound(t_ops):
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    if dtype != torch.float32:
        ms, by = bound(ops / H100_BF16_FLOPS * 1e3)
        return {"bound_ms": ms, "bound_by": by}
    fp32, tf32x3 = (bound(ops / H100_FP32_FLOPS * 1e3),
                    bound(3 * ops / H100_TF32_FLOPS * 1e3))
    ms, by = min(fp32, tf32x3)
    return {"bound_ms": ms, "bound_by": by,
            "bound_fp32_ms": fp32[0], "bound_fp32_by": fp32[1],
            "bound_3xtf32_ms": tf32x3[0], "bound_3xtf32_by": tf32x3[1]}


def gmm_inputs(E, C, d, f, dtype, seed):
    """x ~ N(0, 1) and w ~ N(0, 1/d): the scale of the activations the
    moe path feeds K2 and of its expert weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((E, C, d), generator=g, device="cuda")
    w = torch.randn((E, d, f), generator=g, device="cuda") / math.sqrt(d)
    return x.to(dtype), w.to(dtype)


def gmm_routes(ops: float, nbytes: float, dtype) -> dict:
    """{"bound_ms", "bound_by", ...}: the least time an H100 could take
    for ``ops`` operations (2 per multiply-add) and ``nbytes`` moved, as
    ``attention_bound`` states it. bf16: operations at the bf16
    tensor-core peak. fp32: the lesser of two bounds, both given: the
    operations at the fp32 peak of the CUDA cores, and 3xTF32's three
    tf32 products per operation at the tf32 tensor-core peak (the route
    of the prefill variant, gmm_wgmma), each beside the bytes."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3

    def bound(t_ops):
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    if dtype != torch.float32:
        ms, by = bound(ops / H100_BF16_FLOPS * 1e3)
        return {"bound_ms": ms, "bound_by": by}
    fp32, tf32x3 = (bound(ops / H100_FP32_FLOPS * 1e3),
                    bound(3 * ops / H100_TF32_FLOPS * 1e3))
    ms, by = min(fp32, tf32x3)
    return {"bound_ms": ms, "bound_by": by,
            "bound_fp32_ms": fp32[0], "bound_fp32_by": fp32[1],
            "bound_3xtf32_ms": tf32x3[0], "bound_3xtf32_by": tf32x3[1]}


def gmm_bound(E, C, d, f, dtype) -> dict:
    """``gmm_routes`` for (E, C, d) x (E, d, f): every slot's multiply-adds
    (the moe path computes every capacity slot, empty or not); x and w
    read once, the output written once."""
    elt = torch.finfo(dtype).bits // 8
    return gmm_routes(2 * E * C * d * f, elt * E * (C * d + d * f + C * f),
                      dtype)


def gmm_rows_bound(rows: torch.Tensor, C, d, f, dtype) -> dict:
    """``gmm_routes`` for one K2 launch with ``rows`` (E,): 2 rows[e] d f
    operations per expert; the weights of the experts with rows[e] > 0,
    x's rows below rows[e] and all of o written once."""
    r = rows.clamp(0, C).double()
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * ((r > 0).sum() * d * f + r.sum() * d + r.numel() * C * f)
    return gmm_routes(float(2 * r.sum() * d * f), float(nbytes), dtype)


def gmm_rows(kind, E, C, seed=0):
    """(E,) int32 rows on the card: "decode" gives 15 experts 1-4 rows
    and the rest 0, as a decode step of 4 tokens at top-4 does; "ragged"
    draws from [0, C] with rows[0] = 0 and rows[-1] = C; "zero" and
    "full" are all 0 and all C."""
    g = torch.Generator().manual_seed(seed)
    if kind == "decode":
        r = torch.zeros(E, dtype=torch.int32)
        m = min(15, E)
        r[torch.randperm(E, generator=g)[:m]] = torch.randint(
            1, min(4, C) + 1, (m,), generator=g, dtype=torch.int32)
    elif kind == "ragged":
        r = torch.randint(0, C + 1, (E,), generator=g, dtype=torch.int32)
        r[0], r[-1] = 0, C
    else:
        r = torch.full((E,), 0 if kind == "zero" else C, dtype=torch.int32)
    return r.cuda()


def moe_rows(cfg, B, S):
    """Rows G*C of K2's (E, G*C, d) operands in a prefill of B x S
    tokens (S = 1: a decode step), as ``moe_apply`` sizes them."""
    from repro_torch.models.moe import _n_groups, capacity

    G = _n_groups(B)
    return G * capacity(cfg, B * S // G)


def tensors(tree) -> list:
    """The tensors of a cache or state: a tensor, or a tuple or dict of
    them, nested."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in (tree.values() if isinstance(tree, dict) else tree)
            for t in tensors(v)]


def prefill_attention(cfg, B=4, S=500):
    """K1's (B, Sq, Sk, H, Hkv, hd, causal) in a prefill of B x S text
    tokens (a vlm's patch embeddings come first)."""
    S += cfg.n_patches if cfg.family == "vlm" else 0
    return (B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, True)


def attention_layers(cfg) -> int:
    """Full-sequence attentions per forward: one a layer, Zamba2's shared
    block once per application, none in xLSTM."""
    from repro_torch.models.stacks import n_attn_applications

    return {"hybrid": n_attn_applications(cfg), "ssm": 0}.get(
        cfg.family, cfg.n_layers)


def engine_bounds(cfg, B, S, max_seq, dtype=torch.float32):
    """Least times for the full-width engine run with weights in
    ``dtype``: the prefill's multiply-adds at the fp32 peak (bf16: the
    larger of them at the bf16 tensor-core peak and every weight read
    once at 2 bytes), and one decode step's bytes at HBM rate: every
    weight (4 bytes, bf16 2) and the whole KV cache or recurrent state
    (4 bytes: the engine keeps it in fp32 whatever the weights' dtype)
    read once, but of an untied embedding table only the rows the step
    gathers (a tied table is read whole by the unembed).

    The prefill counts every weight but the embedding once per position
    (Zamba2's shared block once per application; a vlm's patches are
    positions), the unembed, and causal attention; not the SSD's
    quadratic chunk sums. For the moe family the routed experts count as
    the path computes them, over all G*C capacity slots, empty or not;
    ``prefill_active_bound_ms`` counts them at top-k per token instead."""
    from repro_torch import build_model

    V, d, L = cfg.vocab_padded, cfg.d_model, cfg.n_layers
    K = cfg.n_codebooks if cfg.family == "audio" else 1
    body = cfg.param_count() - K * V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "hybrid":   # the shared block runs once per application
        shared = cfg.param_count() - cfg.replace(
            hybrid_attn_every=0).param_count()
        body += (attention_layers(cfg) - 1) * shared
    T = prefill_attention(cfg, B, S)[1]
    attn = (4 * B * cfg.n_heads * cfg.d_head * T * (T + 1) // 2
            * attention_layers(cfg))
    cache = sum(x.numel() for x in tensors(
        build_model(cfg).init_cache(B, max_seq, device="meta")))
    out = {}
    if cfg.family == "moe":
        expert = 3 * d * cfg.d_expert
        dense = body - L * cfg.n_experts * expert
        prefill_ops = (2 * B * S * (dense + d * V) + attn
                       + 2 * L * cfg.n_experts * moe_rows(cfg, B, S) * expert)
        active_ops = (2 * B * S * (dense + L * cfg.n_experts_per_tok * expert
                                   + d * V) + attn)
    else:
        prefill_ops = 2 * B * T * (body + K * d * V) + attn
    elt = torch.finfo(dtype).bits // 8
    read_all = elt * cfg.param_count() / H100_BYTES_PER_S * 1e3

    def prefill_ms(ops):
        if dtype == torch.float32:
            return ops / H100_FP32_FLOPS * 1e3
        return max(ops / H100_BF16_FLOPS * 1e3, read_all)

    if cfg.family == "moe":
        out["prefill_active_bound_ms"] = prefill_ms(active_ops)
    out["prefill_bound_ms"] = prefill_ms(prefill_ops)
    weights = cfg.param_count() - (0 if cfg.tie_embeddings
                                   else K * (V - B) * d)
    out["decode_step_bound_ms"] = ((elt * weights + 4 * cache)
                                   / H100_BYTES_PER_S * 1e3)
    return out


def check_k3_launches(cfg, launches: dict, n_new: int) -> float:
    """K3 runs once an attention layer a forward: the prefill and each of
    the ``n_new`` decode steps. Returns the launches a forward."""
    want = attention_layers(cfg) * (1 + n_new)
    check(launches["qkv_rope"] == want,
          f"{cfg.name} generate made {launches['qkv_rope']} qkv_rope "
          f"launches, want {attention_layers(cfg)} * (1 + {n_new}) = {want}")
    return launches["qkv_rope"] / (1 + n_new)


def kernel_phase(fa, gm, ref, cfgs) -> None:
    """K1 and K2 against their plain versions; ``cfgs`` maps each served
    config's name to it (their prefill shapes are K1's cases)."""
    moe_cfg, zamba_cfg = cfgs["qwen2-moe-a2.7b"], cfgs["zamba2-7b"]
    # (B, Sq, Sk, H, Hkv, hd, causal): serving shape, ragged, the moe
    # prefill's shape, wide head, Sq != Sk (bottom-right diagonal),
    # non-causal ragged; then S off every query and key tile, Sq < Sk
    # off the tiles, GQA groups 1, 7 and 8; then Zamba2's prefill (hd
    # 112) and hd 112 off the tiles, Sq < Sk and non-causal; then the
    # internvl2-1b and musicgen-large prefills; then qwen3-14b's (GQA
    # groups of 5 at hd 128) and minicpm-2b's (36 heads at hd 64)
    cases = [
        (4, 512, 512, 14, 2, 64, True),
        (4, 500, 500, 14, 2, 64, True),
        prefill_attention(moe_cfg),
        (2, 384, 384, 8, 2, 128, True),
        (2, 128, 384, 14, 2, 64, True),
        (2, 200, 200, 8, 2, 64, False),
        (1, 17, 17, 4, 4, 128, True),
        (2, 127, 127, 7, 1, 64, True),
        (1, 129, 129, 8, 1, 128, True),
        (2, 129, 127, 8, 8, 64, False),
        (2, 127, 500, 7, 1, 128, True),
        (1, 1, 500, 8, 1, 64, True),
        prefill_attention(zamba_cfg),
        (1, 17, 17, 4, 4, 112, True),
        (2, 127, 500, 7, 1, 112, True),
        (2, 129, 127, 8, 8, 112, False),
        prefill_attention(cfgs["internvl2-1b"]),
        prefill_attention(cfgs["musicgen-large"]),
        prefill_attention(cfgs["qwen3-14b"]),
        prefill_attention(cfgs["minicpm-2b"]),
    ]
    checks = [(c, dtype, tol, 1) for c in cases for dtype, tol in
              ((torch.float32, 2e-5), (torch.bfloat16, 2e-2))]
    # q scaled by 8 (logits x8, a peaked softmax), fp32 at the dense, moe
    # and Zamba2 prefill shapes: plain TF32 is 1e-2 off here, so the
    # small parts of 3xTF32 decide. The plain version in fp32 is itself
    # up to 2.6e-5 off the exact result here (its q k^T is an fp32 sum of
    # logits x8), so K1 is held to the plain version computed in float64
    # on the same inputs; its distance to the fp32 plain version is
    # printed beside. (In bf16 the plain version rounds the scores to
    # bf16.)
    checks += [(c, torch.float32, 2e-5, 8) for c in
               (cases[1], cases[2], prefill_attention(zamba_cfg))]
    for i, ((B, Sq, Sk, H, Hkv, hd, causal), dtype, tol, scale) in \
            enumerate(checks):
        q, k, v = attention_inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed=i)
        q = q * scale
        before = dict(fa.route_launches)
        out = fa.flash_attention(q, k, v, causal=causal).float()
        ran = [r for r, n in fa.route_launches.items() if n != before[r]]
        want = ref.gqa_attention_ref(q, k, v, causal=causal).float()
        note = ""
        if scale != 1:
            fp32 = want
            want = ref.gqa_attention_ref(q.double(), k.double(), v.double(),
                                         causal=causal).float()
            note = (f" q x{scale}, held to the plain version in float64; "
                    f"to the fp32 plain version "
                    f"{(out - fp32).abs().max().item():.3e}, which is "
                    f"{(fp32 - want).abs().max().item():.3e} from float64")
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        ok = torch.allclose(out, want, rtol=tol, atol=tol)
        print(f"kernel flash_attention B={B} Sq={Sq} Sk={Sk} H={H} "
              f"Hkv={Hkv} hd={hd} causal={causal} {dtype}: "
              f"max|d|={err:.3e} tol={tol:g}{note} {'ok' if ok else 'FAIL'}")
        check(bool(torch.isfinite(out).all()) and ok,
              f"flash_attention disagrees with its plain version "
              f"(case {i}, {dtype}, q x{scale})")
        check(ran == [fa.variant(hd, dtype)],
              f"flash_attention case {i} ({dtype}) ran {ran}")

    # (E, C, d, f): the moe path's prefill gate/up and down and its
    # decode step's, the reference's sweep (ragged edges), one element;
    # then f and d that TMA cannot copy (not multiples of 4 fp32)
    E, d, d_e = moe_cfg.n_experts, moe_cfg.d_model, moe_cfg.d_expert
    pre, dec = moe_rows(moe_cfg, 4, 500), moe_rows(moe_cfg, 4, 1)
    cases = [(E, pre, d, d_e), (E, pre, d_e, d), (E, dec, d, d_e),
             (E, dec, d_e, d), (4, 128, 256, 128), (2, 64, 512, 96),
             (6, 100, 300, 130), (1, 1, 1, 1), (6, 100, 302, 128)]

    def variant_of(x, w, C, d_, f):
        """The variant the wrapper picks: where TMA can copy (d and f
        multiples of 16 bytes) gmm_wgmma in fp32 and gmm_wgmma_bf16 in
        bf16 at C > 32, gmm_decode_bf16 in bf16 at C <= 32; else
        gmm_small at C <= 32 and gmm_large above."""
        v = 16 // x.element_size()
        bf16 = x.dtype == torch.bfloat16
        if d_ % v or f % v:
            return "gmm_small" if C <= 32 else "gmm_large"
        if C <= 32:
            return "gmm_decode_bf16" if bf16 else "gmm_small"
        return "gmm_wgmma_bf16" if bf16 else "gmm_wgmma"

    def run(x, w, rows=None):
        before = dict(gm.route_launches)
        out = gm.grouped_matmul(x, w, rows)
        torch.cuda.synchronize()
        return out, [k for k, n in gm.route_launches.items()
                     if n != before[k]]

    for i, (E_, C, d_, f) in enumerate(cases):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            x, w = gmm_inputs(E_, C, d_, f, dtype, seed=100 + i)
            out, ran = run(x, w)
            want = ref.grouped_matmul_ref(x, w)
            out, want = out.float(), want.float()
            err = (out - want).abs().max().item()
            ok = out.shape == (E_, C, f) and torch.allclose(
                out, want, rtol=tol, atol=tol)
            print(f"kernel grouped_matmul E={E_} C={C} d={d_} f={f} {dtype} "
                  f"({ran[0]}): max|d|={err:.3e} tol={tol:g} "
                  f"{'ok' if ok else 'FAIL'}")
            check(bool(torch.isfinite(out).all()) and ok,
                  f"grouped_matmul disagrees with its plain version "
                  f"(case {i}, {dtype})")
            check(ran == [variant_of(x, w, C, d_, f)],
                  f"grouped_matmul case {i} ({dtype}) ran {ran}")

    # the same with rows: x zero past rows[e], as the moe path packs it;
    # the rows past rows[e] must come out exactly 0. "nan": NaN in x past
    # rows[e] and in the weights of experts with no row, which must reach
    # no output (fp32 and bf16); "x8": x scaled by 8, held to the plain
    # version computed in float64 (the fp32 plain version is itself up to
    # 1.1e-4 off it there), as every fp32 prefill case is too
    cases = [((E, dec, d, d_e), "decode"), ((E, dec, d_e, d), "decode"),
             ((E, pre, d, d_e), "ragged"), ((E, pre, d_e, d), "ragged"),
             ((E, dec, d, d_e), "zero"), ((E, pre, d_e, d), "zero"),
             ((E, dec, d, d_e), "full"), ((E, pre, d, d_e), "full"),
             ((E, pre, d_e, d), "full"),
             ((E, pre, d, d_e), "nan"), ((E, pre, d_e, d), "nan"),
             ((E, dec, d, d_e), "nan"), ((E, dec, d_e, d), "nan"),
             ((E, pre, d, d_e), "x8"), ((E, pre, d_e, d), "x8"),
             ((4, 128, 256, 128), "ragged"), ((2, 64, 512, 96), "ragged"),
             ((6, 100, 300, 130), "ragged"), ((6, 20, 300, 130), "ragged"),
             ((2, 1, 1, 1), "ragged")]
    for i, ((E_, C, d_, f), kind) in enumerate(cases):
        rows = gmm_rows("ragged" if kind in ("nan", "x8") else kind, E_, C,
                        seed=i)
        live = torch.arange(C, device="cuda") < rows[:, None]
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            if kind == "x8" and dtype != torch.float32:
                continue
            x, w = gmm_inputs(E_, C, d_, f, dtype, seed=200 + i)
            x = torch.where(live[..., None], x * (8 if kind == "x8" else 1),
                            0)
            want = ref.grouped_matmul_ref(x, w, rows).float()
            exact = None
            if C > 32 and dtype == torch.float32:
                exact = torch.where(live[..., None], torch.einsum(
                    "ecd,edf->ecf", x.double(), w.double()), 0)
            if kind == "nan":
                x = torch.where(live[..., None], x, float("nan"))
                w[rows == 0] = float("nan")
            out, ran = run(x, w, rows)
            out = out.float()
            held = want if kind != "x8" else exact.float()
            err = (out - held).abs().max().item()
            ok = out.shape == (E_, C, f) and torch.allclose(
                out, held, rtol=tol, atol=tol) and not out[~live].any()
            note = ""
            if exact is not None:
                err64 = (out.double() - exact).abs().max().item()
                ok = ok and torch.allclose(out.double(), exact, rtol=tol,
                                           atol=tol)
                note = (f"; to float64 {err64:.3e} (the fp32 plain version "
                        f"{(want.double() - exact).abs().max().item():.3e})")
            print(f"kernel grouped_matmul E={E_} C={C} d={d_} f={f} rows="
                  f"{kind} (sum {int(rows.sum())}, {int((rows > 0).sum())} "
                  f"experts) {dtype} ({ran[0]}): max|d|={err:.3e}{note} "
                  f"tol={tol:g} {'ok' if ok else 'FAIL'}")
            check(bool(torch.isfinite(out).all()) and ok,
                  f"grouped_matmul with rows disagrees with its plain "
                  f"version (case {i}, {kind}, {dtype})")
            check(ran == [variant_of(x, w, C, d_, f)],
                  f"grouped_matmul rows case {i} ({dtype}) ran {ran}")


@torch.inference_mode()
def greedy_trace(model, params, prompt: np.ndarray, n: int, device: str):
    """A batch of prompts (R, S) (an audio model's (R, K, S)) through the
    model API, as ``ServeEngine`` drives it (a vlm with zero patch
    embeddings, decoding after them), and ``n`` greedy steps: the
    last-position prefill logits (R, V) (audio (R, K, V)) in fp32 on the
    CPU, and by step, a list over the rows of: the row's tokens, its top-2
    logit margin (the least over an audio step's codebooks) and its
    largest |logit|."""
    cfg = model.cfg
    toks = torch.as_tensor(prompt, dtype=torch.long, device=device)
    R, S = toks.shape[0], toks.shape[-1]
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    batch = {"tokens": toks}
    if n_prefix:
        batch["patch_embeds"] = torch.zeros((R, n_prefix, cfg.d_model),
                                            device=device)
    cache = model.init_cache(R, n_prefix + S + n, device=device)
    logits, cache = model.prefill(params, batch, cache)
    first = logits[:, -1].float().cpu()
    last = logits[:, -1:]
    out, margins, peaks = [], [], []
    for i in range(n):
        lg = last[:, 0].float()                 # (R, V) | (R, K, V)
        top2 = lg.topk(2, dim=-1).values
        margins.append((top2[..., 0] - top2[..., 1]).reshape(R, -1)
                       .amin(dim=1).tolist())
        peaks.append(lg.abs().reshape(R, -1).amax(dim=1).tolist())
        nxt = last.argmax(dim=-1)               # (R, 1) | (R, 1, K)
        if cfg.family == "audio":
            nxt = nxt.movedim(-1, 1)            # (R, K, 1)
        out.append(nxt.reshape(R, -1).tolist())
        last, cache = model.decode_step(
            params, cache, {"tokens": nxt, "cache_index": n_prefix + S + i})
    return first, out, margins, peaks


# Card against CPU, set before any card run. fp32: the last-position
# prefill logits within FP32_LOGITS_TOL, and greedy tokens equal up to the
# first CPU step whose top-2 margin is below FP32_MARGIN. bf16, from bf16's
# 8-bit mantissa: the logits within BF16_REL x the CPU's largest |logit|,
# and a near-tie where the margin is below BF16_REL x that step's largest
# |logit|. For moe, a router choice whose k-th and (k+1)-th probabilities
# are within FP32_ROUTER_GAP (fp32, absolute) or BF16_ROUTER_REL x the
# k-th (bf16) is a near-tie that rounding can flip.
FP32_LOGITS_TOL = 1e-3
FP32_MARGIN = 1e-4
FP32_ROUTER_GAP = 1e-6
BF16_REL = 2.0 ** -5
BF16_ROUTER_REL = 2.0 ** -8
# Prompts of a card-vs-CPU check (rows of one batch) by dtype, and the
# prompt seeds it may try before it fails for want of a step to compare.
# fp32 compares every step of every row; bf16's near-tie (BF16_REL of the
# largest |logit|) ends most rows within a few steps, so bf16 serves more.
CARD_CPU_ROWS = {torch.float32: 4, torch.bfloat16: 16}
CARD_CPU_SEEDS = 3
# Layers of Zamba2's end-to-end card-vs-CPU check in bf16. Zamba2's bf16
# rounding grows through its layers on either device: at 12 layers its
# last-position logits lie 6-33% of the largest |logit| from the fp32
# model on the same weights, on the card and on the CPU alike, and the two
# 4.2-8.0% from each other, whether cuBLAS may reduce bf16 sums in bf16 or
# not (the same bits). Ended after 2 layers the card and the CPU lie at
# most 0.78% apart (the worst of 4 rows), after 4 1.5%, after 6 (its first
# shared block) 2.2%, after 8 6.2% (tools/bf16_drift.py on an H100 80GB
# HBM3, 700 W). Fed the same input, one layer on the card lies within
# 1.0% of the CPU's.
# So the end-to-end check runs at 2 layers, and zamba2_layers_card_vs_cpu
# holds all 12, its two shared-block applications included, layer by
# layer through a prefill and ZAMBA2_LAYER_STEPS decode steps.
ZAMBA2_BF16_LAYERS = 2
ZAMBA2_LAYER_ROWS = 4
ZAMBA2_LAYER_STEPS = 4


def logits_limit(peak: float, dtype) -> float:
    """How far the card's last-position prefill logits of a row may lie
    from the CPU's, whose largest |logit| is ``peak``."""
    return FP32_LOGITS_TOL if dtype == torch.float32 else BF16_REL * peak


def near_tie(peak: float, dtype) -> float:
    """A CPU step whose top-2 margin is below this (its largest |logit|
    ``peak``) is a near-tie: rounding may pick the other token."""
    return FP32_MARGIN if dtype == torch.float32 else BF16_REL * peak


def first_below(values, limit: float) -> list:
    """``values`` by step, a list over rows each: per row, the first step
    whose value is below ``limit`` (the number of steps if none is)."""
    n = len(values)
    return [next((i for i in range(n) if values[i][r] < limit), n)
            for r in range(len(values[0]))]


def compared_steps(margins, peaks, dtype, cut=None) -> list:
    """Per row, the greedy steps a card-vs-CPU check compares: those
    before the row's first CPU near-tie (``near_tie``), and before its
    ``cut`` where one is given (moe: the row's first router near-tie).
    ``margins`` and ``peaks`` by step, a list over rows each."""
    n = len(margins)
    out = []
    for r in range(len(margins[0])):
        near = next((i for i in range(n)
                     if margins[i][r] < near_tie(peaks[i][r], dtype)), n)
        out.append(near if cut is None else min(near, cut[r]))
    return out


def steps_equal(g_toks, c_toks) -> list:
    """Per row, the greedy steps before the first whose tokens differ."""
    n = len(g_toks)
    return [next((i for i in range(n) if g_toks[i][r] != c_toks[i][r]), n)
            for r in range(len(g_toks[0]))]


def tokens_hold(compared, equal) -> bool:
    """The token rule: at least one step compared in all, and every row's
    tokens equal in each of its compared steps."""
    return sum(compared) > 0 and all(e >= c for e, c in zip(equal, compared))


def compare_card_cpu(g_trace, c_trace, dtype=torch.float32,
                     cut=None) -> dict:
    """The card's ``greedy_trace`` against the CPU's: each row's
    last-position prefill logits within ``logits_limit``, and its tokens
    equal in each step ``compared_steps`` counts (up to ``cut`` where one
    is given); at least one step compared in all (``tokens_hold``)."""
    (g_first, g_toks, _, _), (c_first, c_toks, margins, peaks) = \
        g_trace, c_trace
    R = len(margins[0])
    errs = [(g_first[r] - c_first[r]).abs().max().item() for r in range(R)]
    peak = [c_first[r].abs().max().item() for r in range(R)]
    limits = [logits_limit(p, dtype) for p in peak]
    print(f"prefill last-position logits, card vs CPU, {dtype}, by row: "
          f"max|d| {json.dumps([float(f'{e:.4g}') for e in errs])}, limit "
          f"{json.dumps([float(f'{x:.4g}') for x in limits])} (largest CPU "
          f"|logit| {json.dumps([float(f'{p:.4g}') for p in peak])})")
    check(all(math.isfinite(e) and e <= x for e, x in zip(errs, limits)),
          "card and CPU prefill logits disagree")
    compared = compared_steps(margins, peaks, dtype, cut)
    equal = steps_equal(g_toks, c_toks)
    what = (f"{FP32_MARGIN:g}" if dtype == torch.float32
            else f"{BF16_REL:g} x the step's largest |logit|")
    print(f"greedy tokens, card vs CPU, {dtype}: compared steps by row "
          f"{compared} ({sum(compared)} of {R} x {len(margins)}; each row up "
          f"to its first CPU top-2 margin < {what}"
          f"{'' if cut is None else ' or its router near-tie'}); steps "
          f"equal by "
          f"row {equal}")
    if dtype != torch.float32:
        print("CPU top-2 margins / largest |logit| by step and row: "
              + json.dumps([[float(f"{m / p:.4g}") for m, p in zip(ms, ps)]
                            for ms, ps in zip(margins, peaks)]))
    check(sum(compared) > 0, "the card-vs-CPU check compared no step")
    check(tokens_hold(compared, equal),
          "greedy tokens diverge before a near-tie")
    return {"compared": compared, "equal": equal, "max_abs_err": errs,
            "limit": limits}


def cpu_prompt(cfg, S: int, dtype, cpu_run):
    """Prompt seeds 0, 1, ... in turn, ``CARD_CPU_ROWS[dtype]`` prompts of
    S tokens each (an audio model's K x S): ``cpu_run(prompt)`` gives the
    CPU's ``greedy_trace``. The first seed whose CPU run leaves a step to
    compare (``compared_steps``) is kept: (seed, prompt, trace). Fails
    after ``CARD_CPU_SEEDS`` seeds."""
    K = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    for seed in range(CARD_CPU_SEEDS):
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (CARD_CPU_ROWS[dtype], *K, S))
        c_trace = cpu_run(prompt)
        compared = compared_steps(c_trace[2], c_trace[3], dtype)
        print(f"{cfg.name} card vs CPU, {dtype}, prompt seed {seed}: the CPU "
              f"run leaves {compared} steps by row to compare")
        if sum(compared):
            return seed, prompt, c_trace
    check(False, f"{cfg.name} card vs CPU: no prompt seed of "
          f"{CARD_CPU_SEEDS} leaves a step to compare")


def serve(eng, cfg, counters, watch=contextlib.nullcontext(), n_new=64):
    """The main path: warm up, then 4 prompts x 500 tokens (an audio
    model's 4 x K x 500) and ``n_new`` greedy tokens through
    ``ServeEngine.generate`` inside ``watch``, every kernel's launch count
    set to 0 just before and read just after. Returns the prompts, the
    counts by kernel and the engine's numbers."""
    rng = np.random.default_rng(0)
    K = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    eng.generate(rng.integers(0, cfg.vocab_size, (1, *K, 16)), n_new=2)
    prompts = rng.integers(0, cfg.vocab_size, (4, *K, 500))
    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.launches = 0
        for variant in getattr(mod, "route_launches", {}):
            mod.route_launches[variant] = 0
    with watch:
        res = eng.generate(prompts, n_new=n_new)
    launches = {mod.__name__.rsplit(".", 1)[-1]: mod.launches
                for mod in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dtype = next(eng.params.parameters()).dtype
    print(f"{cfg.name} {dtype} main path kernel launches: "
          f"{json.dumps(launches)} (n_layers={cfg.n_layers})")
    check(res.tokens.shape == (4, *K, n_new) and res.tokens.min() >= 0
          and res.tokens.max() < cfg.vocab_size, "generated tokens malformed")
    engine = {"model": cfg.name, "dtype": str(dtype).replace("torch.", ""),
              "batch": 4, "prompt": 500, "n_new": n_new,
              "prefill_ms": res.prefill_s * 1e3,
              "decode_tokens_per_s": res.tokens_per_s,
              "decode_step_ms": res.decode_s / n_new * 1e3,
              "peak_device_gb": peak_gb,
              **engine_bounds(cfg, 4, 500, 1024, dtype)}
    if dtype == torch.bfloat16:
        # cuBLAS's bf16 GEMMs may reduce split sums in bf16 where this is
        # on (PyTorch's default, which the serving path keeps)
        engine["cublas_bf16_reduced_precision_reduction"] = \
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    return prompts, launches, engine


# The kernels of the port's two wrappers by name in a torch.profiler trace
# (each launch of a wrapper runs exactly one of them).
TRACED_KERNELS = {"flash_attention": "flash_wgmma",
                  "grouped_matmul": "gmm_"}
# The tensor-core kernels, whose build fails the run if ptxas spills in
# them ("gmm_wgmma" names gmm_wgmma_bf16 too).
TENSOR_CORE = ("flash_wgmma", "gmm_wgmma", "gmm_decode_bf16")


class TraceIncomplete(RuntimeError):
    """A torch.profiler trace that kept fewer of a wrapper's kernels than
    the wrapper launched."""


@contextlib.contextmanager
def in_path(fa, gm, model, tally: dict, trace: bool = False):
    """While active, K1's and K2's launches are tallied by kernel, phase
    and shape in ``tally[(kernel, phase, shape)]``, a dict of
    ``launches``, ``event_ms`` (CUDA events recorded on the stream just
    before and just after each launch: on an idle device the start event
    fires before the host has enqueued the kernel, so this counts host
    time too), ``traced_ms`` (with ``trace``: the device time of their
    kernels, from the records of a torch.profiler trace of the run, which
    starts with ``PAD`` spin kernels, as ``device_ms``'s does, since a
    trace can lose its first records; else None) and ``rows`` (each K2 launch's ``rows`` stacked, read
    after the run, not during it; None for K1). The phase is "prefill"
    until ``model``'s first ``decode_step`` and "decode" after it; K1's
    shape is (B, Sq, Sk, H, Hkv, hd), K2's (E, C, d, f). The wrappers'
    own counts are left as they are."""
    from torch.profiler import ProfilerActivity, profile

    real_fa, real_gm = fa._launch, gm._launch
    phase, events = ["prefill"], []

    def timed(name, shape, rows, run):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        o = run()
        end.record()
        events.append((name, phase[0], shape, start, end, rows))
        return o

    def fa_launch(q, k, v, causal):
        shape = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3])
        return timed("flash_attention", shape, None,
                     lambda: real_fa(q, k, v, causal))

    def gm_launch(x, w, rows=None):
        return timed("grouped_matmul", (*x.shape, w.shape[2]), rows,
                     lambda: real_gm(x, w, rows))

    def decode_step(*args, **kw):
        phase[0] = "decode"
        return type(model).decode_step(model, *args, **kw)

    fa._launch, gm._launch, model.decode_step = fa_launch, gm_launch, \
        decode_step
    prof = profile(activities=[ProfilerActivity.CUDA]) if trace else \
        contextlib.nullcontext()
    try:
        with prof:
            for _ in range(PAD if trace else 0):
                torch.cuda._sleep(100)
            yield
            torch.cuda.synchronize()
    finally:
        fa._launch, gm._launch = real_fa, real_gm
        del model.decode_step
    torch.cuda.synchronize()
    if trace:
        # the trace's raw records: ``prof.events()`` would build a tree of
        # every record of the run (minutes for Zamba2's 64 decode steps)
        kernels = [(e.name(), e.start_ns(), e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        pad = sum(1 for n, _, _ in kernels if "spin" in n or "sleep" in n)
        check(pad > 0, f"the trace kept none of its {PAD} spin kernels")
        traced = {name: sorted((k for k in kernels if part in k[0]),
                               key=lambda k: k[1])
                  for name, part in TRACED_KERNELS.items()}
        for name, kernels in traced.items():
            n = sum(1 for ev in events if ev[0] == name)
            if len(kernels) != n:
                raise TraceIncomplete(f"the trace holds {len(kernels)} "
                                      f"{name} kernels for {n} launches")
    seen = dict.fromkeys(TRACED_KERNELS, 0)
    rows_by_key: dict = {}
    for name, ph, shape, start, end, rows in events:
        key = (name, ph, shape)
        t = tally.setdefault(key, {"launches": 0, "event_ms": 0.0,
                                   "traced_ms": 0.0 if trace else None,
                                   "rows": None})
        t["launches"] += 1
        if trace:
            t["traced_ms"] += traced[name][seen[name]][2] / 1e6
            seen[name] += 1
        t["event_ms"] += start.elapsed_time(end)
        if name == "grouped_matmul":
            rows_by_key.setdefault(key, []).append(rows)
    for key, rows in rows_by_key.items():
        check(all(r is not None for r in rows),
              f"a moe K2 launch at {key} had no rows")
        tally[key]["rows"] = torch.stack(rows).cpu()


def traced_repeat(fa, gm, eng, prompts, n_new: int, tally: dict) -> None:
    """The main run once more, same prompts (``n_new`` new tokens: the
    main run's, or fewer where its kernels run in the prefill alone),
    under torch.profiler: its
    K1 and K2 launches by phase and shape must equal the main run's
    ``tally``, and the device time of their kernels in the trace becomes
    ``tally[key]["traced_ms"]``. The main run itself is not traced: the
    profiler slows its host-bound decode steps about 2.2 times. A trace
    that lost records (``TraceIncomplete``) is taken once more."""
    for attempt in (1, 2):
        again: dict = {}
        try:
            with in_path(fa, gm, eng.model, again, trace=True):
                eng.generate(prompts, n_new=n_new)
            break
        except TraceIncomplete as err:
            check(attempt == 1, f"{eng.cfg.name}: {err}")
            print(f"{eng.cfg.name}: {err}; the repeat is traced once more")
    check({k: t["launches"] for k, t in again.items()}
          == {k: t["launches"] for k, t in tally.items()},
          f"{eng.cfg.name}: the traced repeat launched other kernels")
    for key, t in again.items():
        tally[key]["traced_ms"] = t["traced_ms"]


def check_k1_in_path(fa, cfg, tally: dict, dtype=torch.float32) -> None:
    """One K1 launch per full-sequence attention (``attention_layers``),
    all in the prefill, at its serving shape, every one on the variant of
    ``dtype`` (``flash_wgmma_3xtf32`` or ``flash_wgmma_bf16``, counted by
    the wrapper since the main run began); none without attention."""
    n = attention_layers(cfg)
    want = {("flash_attention", "prefill", prefill_attention(cfg)[:6]): n
            } if n else {}
    got = {k: t["launches"] for k, t in tally.items()
           if k[0] == "flash_attention"}
    check(got == want, f"{cfg.name} K1 launches by phase and shape {got}, "
          f"want {want}")
    want_routes = dict.fromkeys(fa.ROUTES, 0)
    if n:
        want_routes[fa.variant(cfg.d_head, dtype)] = n
    print(f"{cfg.name} {dtype} main path K1 launches by variant: "
          + json.dumps(fa.route_launches))
    check(fa.route_launches == want_routes, f"{cfg.name} K1 launches by "
          f"variant {fa.route_launches}, want {want_routes}")


def draw_on_card(cfg, dtype=torch.float32):
    """Random weights in ``dtype`` drawn on the card from a CUDA generator
    seeded 0 (the host draws billions of parameters too slowly). Each
    tensor is drawn in fp32 and copied into the model's ``dtype``, so a
    bf16 model never holds an fp32 copy of itself (the moe model in fp32
    takes 57 GB) and holds the fp32 model's weights rounded."""
    from repro_torch import build_model

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), dtype, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name} init (full width, {cfg.n_layers} layers, {n_params} "
          f"params, {dtype}, drawn on the card): "
          f"{time.perf_counter() - t0:.1f} s")
    return params


def moe_engine_phase(fa, gm, cfg, dtype=torch.float32):
    """Full-width, full-depth moe serving on the card, weights in
    ``dtype`` drawn on the card. Returns K1's and K2's launches, rows and
    device time by CUDA events by phase and shape, and the engine's
    numbers, all from the main path's run, and each launch's device time
    from a trace of its repeat (``traced_repeat``)."""
    from repro_torch import ServeEngine

    from repro_torch.kernels import qkv_rope as k3

    eng = ServeEngine(cfg, params=draw_on_card(cfg, dtype), max_seq=1024,
                      device="cuda")
    tally: dict = {}
    prompts, launches, engine = serve(eng, cfg, (fa, gm, k3),
                                      in_path(fa, gm, eng.model, tally))
    engine["k3_launches_per_forward"] = check_k3_launches(cfg, launches, 64)
    L, want = cfg.n_layers, 3 * cfg.n_layers * (1 + 64)
    check(launches["flash_attention"] == L,
          f"moe prefill made {launches['flash_attention']} flash_attention "
          f"launches, want {L}")
    check(launches["grouped_matmul"] == want,
          f"moe generate made {launches['grouped_matmul']} grouped_matmul "
          f"launches, want 3 * {L} * (1 + 64) = {want}")
    check_k1_in_path(fa, cfg, tally, dtype)
    # gate and up run at (E, G*C, d) x (E, d, d_e), down at
    # (E, G*C, d_e) x (E, d_e, d), once per layer per forward
    E, d, d_e = cfg.n_experts, cfg.d_model, cfg.d_expert
    want_tally = {}
    for phase, C, steps in (("prefill", moe_rows(cfg, 4, 500), 1),
                            ("decode", moe_rows(cfg, 4, 1), 64)):
        want_tally[(phase, (E, C, d, d_e))] = 2 * L * steps
        want_tally[(phase, (E, C, d_e, d))] = L * steps
    k2 = {(ph, s): v for (name, ph, s), v in tally.items()
          if name == "grouped_matmul"}
    got = {k: t["launches"] for k, t in k2.items()}
    print(f"moe {dtype} main path K2 launches by phase and (E, C, d, f): "
          + json.dumps({f"{ph} {list(s)}": n for (ph, s), n in got.items()}))
    check(got == want_tally, f"moe K2 launches by phase and shape {got}, "
          f"want {want_tally}")
    # every prefill launch (C > 32) on the tensor-core variant of the
    # dtype; every decode launch on the CUDA cores' gmm_small in fp32,
    # on the tensor cores' gmm_decode_bf16 in bf16
    n_pre = sum(n for (ph, _), n in got.items() if ph == "prefill")
    want_routes = dict.fromkeys(gm.ROUTES, 0)
    f32 = dtype == torch.float32
    want_routes["gmm_small" if f32 else "gmm_decode_bf16"] = want - n_pre
    want_routes["gmm_wgmma" if f32 else "gmm_wgmma_bf16"] = n_pre
    print(f"moe {dtype} main path K2 launches by variant: "
          + json.dumps(gm.route_launches))
    check(gm.route_launches == want_routes, f"moe K2 launches by variant "
          f"{gm.route_launches}, want {want_routes}")
    traced_repeat(fa, gm, eng, prompts, 64, tally)
    for key in ("traced_ms", "event_ms"):
        engine[f"k2_in_path_{key}"] = {
            phase: sum(t[key] for (ph, _), t in k2.items() if ph == phase)
            for phase in ("prefill", "decode")}
    for (ph, shape), t in k2.items():
        rows = t["rows"]
        active = (rows > 0).sum(dim=1).double()
        print(f"moe {dtype} {ph} K2 {list(shape)} rows per launch: mean active "
              f"experts {float(active.mean()):.4f} (max {int(active.max())}),"
              f" mean occupied rows {float(rows.sum(dim=1).double().mean()):.4f}"
              f" of {shape[0] * shape[1]}")
        if ph == "decode":
            check(int(active.max()) <= 16,
                  "a decode K2 launch had more than 16 active experts")
    print(f"moe engine, {dtype}: " + json.dumps(engine))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return tally, engine


def family_engine_phase(fa, gm, cfg, n_new: int, dtype=torch.float32):
    """Full-width, full-depth serving of a model without experts on the
    card, weights in ``dtype`` drawn on the card: one K1 launch per full-sequence
    attention of the prefill (one a layer, 13 for Zamba2's shared block,
    none for xLSTM), none in decode, no K2. Returns K1's launches and
    device time by CUDA events by phase and shape, and the engine's
    numbers, all from the main path's run, and each launch's device time
    from a trace of its repeat (``traced_repeat``)."""
    from repro_torch import ServeEngine
    from repro_torch.kernels import qkv_rope as k3

    eng = ServeEngine(cfg, params=draw_on_card(cfg, dtype), max_seq=1024,
                      device="cuda")
    tally: dict = {}
    prompts, launches, engine = serve(eng, cfg, (fa, gm, k3),
                                      in_path(fa, gm, eng.model, tally),
                                      n_new)
    engine["k3_launches_per_forward"] = check_k3_launches(cfg, launches,
                                                          n_new)
    n = attention_layers(cfg)
    check(launches["flash_attention"] == n,
          f"{cfg.name} prefill made {launches['flash_attention']} "
          f"flash_attention launches, want {n}")
    check(launches["grouped_matmul"] == 0, f"the {cfg.name} path ran K2")
    check_k1_in_path(fa, cfg, tally, dtype)
    if n:
        # K1 runs in the prefill alone (checked above), so the repeat
        # serves the same prompts with one new token
        t0 = time.perf_counter()
        traced_repeat(fa, gm, eng, prompts, 1, tally)
        engine["traced_repeat_s"] = time.perf_counter() - t0
    for key in ("traced_ms", "event_ms"):
        engine[f"k1_in_path_{key}"] = sum(
            t[key] for (name, _, _), t in tally.items()
            if name == "flash_attention")
    print(f"{cfg.name} engine, {dtype}: " + json.dumps(engine))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return tally, engine


def card_and_cpu_params(cfg, dtype):
    """One set of random weights in ``dtype`` on the card and on the CPU,
    for a card-vs-CPU check: drawn on the card from a generator seeded 0
    (the CPU draws billions of parameters too slowly), each tensor in fp32
    and copied into ``dtype``, then copied to the CPU. Returns (model, the
    card's weights, the CPU's)."""
    from repro_torch import build_model

    model = build_model(cfg)
    t0 = time.perf_counter()
    gpu_params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            dtype, device="cuda")
    cpu_params = type(gpu_params)(cfg, dtype, device="cpu")
    cpu_params.load_state_dict(gpu_params.state_dict())
    n_params = sum(p.numel() for p in cpu_params.parameters())
    print(f"{cfg.name} card vs CPU: {cfg.n_layers} layers, {n_params} params "
          f"in {dtype} drawn on the card and copied to the CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    return model, gpu_params, cpu_params


def card_vs_cpu(cfg, cut: dict, S: int, n: int = 16,
                dtype=torch.float32) -> dict:
    """The path on the card against the port's CPU path at full width,
    cut to ``cut`` (fewer layers, or nothing), on one set of weights in
    ``dtype`` (``card_and_cpu_params``): ``CARD_CPU_ROWS[dtype]`` prompts
    of S tokens (an audio model's K x S) from the first prompt seed that
    leaves a step to compare (``cpu_prompt``), and ``n`` greedy tokens,
    held by ``compare_card_cpu``."""
    cfg = cfg.replace(**cut)
    model, gpu_params, cpu_params = card_and_cpu_params(cfg, dtype)
    seed, prompt, c_trace = cpu_prompt(
        cfg, S, dtype, lambda p: greedy_trace(model, cpu_params, p, n, "cpu"))
    out = compare_card_cpu(greedy_trace(model, gpu_params, prompt, n, "cuda"),
                           c_trace, dtype)
    del gpu_params
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "seed": seed, **out}


@torch.inference_mode()
def zamba2_layer_errors(cfg, cpu_params, params, tokens: torch.Tensor,
                        n_dec: int) -> list:
    """Zamba2 layer by layer on the CPU's inputs: ``tokens`` (R, S +
    n_dec) are prefilled (the first S) and then decoded one at a time, as
    the engine serves them (each side with a state of its own, the KV
    cache in fp32); each layer of each of those forwards runs on the CPU
    (``cpu_params``) and on ``params``'s device, both fed the CPU's output
    of the layer before it, so a layer's difference is its own and not
    the rounding the layers before it carried in. Returns, by forward (the
    prefill, then each decode step) and layer, the worst row's max|d| /
    ``logits_limit`` of the CPU's largest |value| in that row."""
    from repro_torch.models import stacks

    dev = next(params.parameters()).device
    dtype = next(cpu_params.parameters()).dtype
    R, S = tokens.shape[0], tokens.shape[1] - n_dec
    states = [stacks.zamba2_state(cfg, R, S + n_dec, device=d)
              for d in ("cpu", dev)]
    worst = []
    for f in range(n_dec + 1):
        if f == 0:
            toks, at = tokens[:, :S], None
            pos = torch.arange(S, dtype=torch.int32)[None, :].expand(R, S)
        else:
            toks, at = tokens[:, S + f - 1:S + f], S + f - 1
            pos = torch.full((R, 1), at, dtype=torch.int32)
        x = stacks.embed(cpu_params.embed, toks)
        by_layer = []
        for i in range(cfg.n_layers):
            want = stacks._zamba2_layer(cfg, cpu_params, i, x, pos,
                                        states[0], at, f > 0, None)
            got = stacks._zamba2_layer(cfg, params, i, x.to(dev),
                                       pos.to(dev), states[1], at, f > 0,
                                       None).cpu()
            by_layer.append(max(
                float((got[r] - want[r]).float().abs().max()
                      / logits_limit(float(want[r].float().abs().max()),
                                     dtype)) for r in range(R)))
            x = want
        worst.append(by_layer)
    return worst


def zamba2_layers_card_vs_cpu(fa, cfg, n_layers: int, S: int,
                              dtype=torch.bfloat16) -> dict:
    """Zamba2 at full width and ``n_layers`` layers (weights in ``dtype``
    from ``card_and_cpu_params``), held layer by layer on the CPU's
    inputs (``zamba2_layer_errors``): ``ZAMBA2_LAYER_ROWS`` prompts of S
    tokens (prompt seed 0) prefilled, then ``ZAMBA2_LAYER_STEPS`` decode
    steps (the shared block's attention on its KV cache, cast to
    ``dtype``); every layer's output of every forward within
    ``logits_limit``, and the prefill's shared-block applications on
    K1."""
    from repro_torch.models import stacks

    cfg = cfg.replace(n_layers=n_layers)
    _, gpu_params, cpu_params = card_and_cpu_params(cfg, dtype)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (ZAMBA2_LAYER_ROWS, S + ZAMBA2_LAYER_STEPS)))
    k1 = fa.launches
    worst = zamba2_layer_errors(cfg, cpu_params, gpu_params, tokens,
                                ZAMBA2_LAYER_STEPS)
    k1 = fa.launches - k1
    for f, by_layer in enumerate(worst):
        print(f"{cfg.name} {dtype} layer by layer, card vs CPU on the CPU's "
              f"inputs, {'prefill' if f == 0 else f'decode step {f}'} "
              f"({ZAMBA2_LAYER_ROWS} rows, {S} prompt tokens): max|d| / "
              f"({BF16_REL:g} x the largest |value|), the worst row by layer "
              f"{json.dumps([float(f'{e:.4g}') for e in by_layer])}")
    check(all(math.isfinite(e) and e <= 1 for row in worst for e in row),
          "zamba2 layer by layer: card and CPU outputs disagree")
    check(k1 == stacks.n_attn_applications(cfg),
          f"the layer-by-layer check made {k1} K1 launches")
    del gpu_params
    torch.cuda.empty_cache()
    return {"layers": n_layers, "worst_by_layer": worst}


@contextlib.contextmanager
def each_moe_call(record, routes=None):
    """While active, every moe layer first calls ``record(p, cfg, x)``
    with its parameters, config and input. With ``routes``, an iterator
    giving one (B, S, k) tensor of expert indices a call, the layer sends
    each token to those experts instead of its own router's top k (its own
    router probabilities still weigh them, and capacity drops follow the
    given choices as they would its own)."""
    from repro_torch.models import moe, transformer

    real, probs = transformer.moe_apply, moe.router_probs

    def recording(p, cfg, x, *args, **kw):
        record(p, cfg, x)
        if routes is None:
            return real(p, cfg, x, *args, **kw)
        idx = next(routes).to(x.device)

        def given(router, xg):   # every other expert below any router prob
            pr = probs(router, xg)
            chosen = torch.zeros_like(pr, dtype=torch.bool).scatter_(
                -1, idx.reshape(*pr.shape[:2], -1), True)
            return pr.masked_fill(~chosen, -1.0)

        moe.router_probs = given
        try:
            return real(p, cfg, x, *args, **kw)
        finally:
            moe.router_probs = probs

    transformer.moe_apply = recording
    try:
        yield
    finally:
        transformer.moe_apply = real


def router_gaps(p, cfg, x, relative: bool) -> torch.Tensor:
    """For each token of x (B, S, d), the gap between its k-th and
    (k+1)-th router probabilities as ``moe_apply`` routes them (B, S),
    with ``relative`` over the k-th: a gap within rounding is a top-k
    choice that can flip. (``moe.topk_gap`` gives the smallest absolute
    gap.)"""
    from repro_torch.models import moe

    k = cfg.n_experts_per_tok
    top = moe.router_probs(p.router, moe._grouped(x)).topk(k + 1,
                                                           dim=-1).values
    gap = top[..., k - 1] - top[..., k]
    return (gap / top[..., k - 1] if relative else gap).reshape(
        x.shape[:2]).float()


def top_experts(p, cfg, x) -> torch.Tensor:
    """The k experts ``moe_apply``'s router picks for each token of x
    (B, S, d), (B, S, k) on the CPU; each row must be a routing group of
    its own."""
    from repro_torch.models import moe

    xg = moe._grouped(x)
    check(xg.shape[0] == x.shape[0], "a routing group spans more than one row")
    return moe.router_probs(p.router, xg).topk(
        cfg.n_experts_per_tok, dim=-1).indices.reshape(
            *x.shape[:2], -1).cpu()


def route_flips(cpu_idx: list, card_idx: list, gaps: list, n_layers: int,
                reach: list) -> list:
    """The tokens the card's router sent to other experts than the CPU's,
    in the forwards whose inputs the two share: for row r the prefill and
    the decode steps fed tokens both chose, forwards 0 .. ``reach[r]``.
    Each argument holds one moe layer call's (B, S, ...) a list entry,
    layer by layer, one forward after another (``top_experts``,
    ``router_gaps``). Returns (forward, layer, row, position, the CPU's
    router gap there) for each."""
    out = []
    for j, (c, g, gap) in enumerate(zip(cpu_idx, card_idx, gaps)):
        f, i = divmod(j, n_layers)
        differ = (c.sort(dim=-1).values != g.sort(dim=-1).values).any(dim=-1)
        out += [(f, i, r, s, float(gap[r, s]))
                for r, s in differ.nonzero().tolist() if f <= reach[r]]
    return out


def moe_router_cut(calls: list, n_layers: int, n: int, dtype):
    """Per row, the first of ``n`` greedy steps whose logits a CPU router
    near-tie can move directly, from ``calls``, each moe layer call's
    ``router_gaps`` (rows, positions), layer by layer, one forward after
    another (forward i gives step i's logits). fp32: an absolute gap below
    ``FP32_ROUTER_GAP`` anywhere in the row's forward. bf16: a gap below
    ``BF16_ROUTER_REL`` of the k-th probability in the last layer at the
    compared position (the last prompt position, then each decode step's
    token); the near-ties elsewhere are counted. Returns (cut, a note)."""
    forwards = [calls[f * n_layers:(f + 1) * n_layers] for f in range(n)]
    if dtype == torch.float32:
        least = [torch.stack([c.amin(dim=1) for c in fw]).amin(dim=0).tolist()
                 for fw in forwards]
        cut = first_below(least, FP32_ROUTER_GAP)
        return cut, (f"smallest CPU router gap between choices k and k+1 "
                     f"over {len(calls)} layer calls "
                     f"{min(float(c.min()) for c in calls):.3e}; first "
                     f"step with one below {FP32_ROUTER_GAP:g} by row {cut}")
    at = [fw[-1][:, -1].tolist() for fw in forwards]
    cut = first_below(at, BF16_ROUTER_REL)
    ties = sum(int((c < BF16_ROUTER_REL).sum()) for c in calls[:n * n_layers])
    ties_at = sum(g < BF16_ROUTER_REL for step in at for g in step)
    return cut, (f"CPU router gaps between choices k and k+1 relative to the "
                 f"k-th over {len(calls)} layer calls: smallest "
                 f"{min(float(c.min()) for c in calls):.3e}; at the compared "
                 f"positions of the last layer smallest "
                 f"{min(min(s) for s in at):.3e}, {ties_at} below "
                 f"{BF16_ROUTER_REL:g}, first by row {cut}; "
                 f"{ties - ties_at} near-ties elsewhere")


def moe_card_vs_cpu(cfg, n_layers: int = 2, n: int = 16,
                    dtype=torch.float32) -> dict:
    """The moe path on the card against the port's CPU path at full
    width and ``n_layers`` layers, on one set of weights in ``dtype``
    (``card_and_cpu_params``). ``CARD_CPU_ROWS[dtype]`` prompts of 256
    tokens (each row a routing group of its own: Tg = 256 > 128, so tokens
    can drop) and ``n`` greedy tokens. Each row is compared up to its
    first CPU near-tie and its first CPU router near-tie
    (``moe_router_cut``); prompt seeds 0, 1, ... in turn while no step is
    left to compare, failing after ``CARD_CPU_SEEDS``. Every moe layer on
    the card takes the CPU's expert choices (``each_moe_call``): a choice
    that rounding flips sends a token to other experts, a difference no
    limit on the logits can hold. The card's own choices are held beside
    the CPU's (``route_flips``): in fp32 a flip where the CPU's gap is at
    least ``FP32_ROUTER_GAP`` fails; in bf16 the flips are counted."""
    cfg = cfg.replace(n_layers=n_layers)
    model, gpu_params, cpu_params = card_and_cpu_params(cfg, dtype)
    relative = dtype != torch.float32
    for seed in range(CARD_CPU_SEEDS):
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (CARD_CPU_ROWS[dtype], 256))
        gaps, c_idx = [], []

        def on_cpu(p, c, x):
            gaps.append(router_gaps(p, c, x, relative))
            c_idx.append(top_experts(p, c, x))

        with each_moe_call(on_cpu):
            c_trace = greedy_trace(model, cpu_params, prompt, n, "cpu")
        cut, note = moe_router_cut(gaps, n_layers, n, dtype)
        left = compared_steps(c_trace[2], c_trace[3], dtype, cut)
        print(f"moe {dtype}, prompt seed {seed}: {note}; compared steps by "
              f"row {left}")
        if sum(left):
            break
    else:
        check(False, f"moe card vs CPU ({dtype}): no prompt seed of "
              f"{CARD_CPU_SEEDS} leaves a step to compare")
    g_idx = []
    with each_moe_call(lambda p, c, x: g_idx.append(top_experts(p, c, x)),
                       routes=iter(c_idx)):
        g_trace = greedy_trace(model, gpu_params, prompt, n, "cuda")
    check(len(g_idx) == len(c_idx) == (n + 1) * n_layers,
          f"moe card vs CPU: {len(g_idx)} card and {len(c_idx)} CPU moe "
          f"layer calls")
    flips = route_flips(c_idx, g_idx, gaps, n_layers,
                        steps_equal(g_trace[1], c_trace[1]))
    wide = [t for t in flips if t[-1] >= FP32_ROUTER_GAP]
    print(f"moe {dtype}: the card's own router chose other experts than "
          f"the CPU's for {len(flips)} tokens of the forwards both fed the "
          f"same tokens (by forward: "
          f"{dict(sorted(collections.Counter(t[0] for t in flips).items()))}"
          f"); largest CPU router gap among them "
          f"{max((t[-1] for t in flips), default=0.0):.3e}"
          f"{' (relative to the k-th)' if relative else ''}; the card served "
          f"the CPU's choices")
    if dtype == torch.float32:
        check(not wide, f"moe card vs CPU: the card's router flips "
              f"{len(wide)} choices whose CPU gap is at least "
              f"{FP32_ROUTER_GAP:g}: (forward, layer, row, position, gap) "
              f"{wide[:8]}")
    out = compare_card_cpu(g_trace, c_trace, dtype, cut)
    del gpu_params
    torch.cuda.empty_cache()
    return {"layers": n_layers, "seed": seed, "router_cut": cut,
            "route_flips": len(flips), **out}


def device_kernels(fn, top: int = 3) -> dict:
    """The kernels one call of ``fn`` runs on the card, from a
    torch.profiler trace of it after ``PAD`` spin kernels (as in
    ``device_ms``): how many, and the names of the ``top`` longest (or
    why there is no trace)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD):
                torch.cuda._sleep(100)
            fn()
            torch.cuda.synchronize()
    except RuntimeError as err:   # the trace is a label, not a check
        return {"count": None, "longest": [f"not traced: {err}"]}
    ran = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin" not in e.name and "sleep" not in e.name),
                 key=lambda e: -e.time_range.elapsed_us())
    return {"count": len(ran), "longest": [e.name[:120] for e in ran[:top]]}


def k1_row(fa, ref, model, shape, dtype, tally=None):
    """K1 timed at (B, Sq, Sk, H, Hkv, hd, causal) in ``dtype`` beside its
    bounds, its plain version and SDPA (with the kernels SDPA ran), and
    its launches and device time per launch in the main run's ``tally``
    (0 launches without one). K1's and SDPA's times are device times from
    a torch.profiler trace (``device_ms``); CUDA events around the same
    calls, which read the host where it paces them, are kept beside
    (``event_ms``, ``library_event_ms``)."""
    import torch.nn.functional as F

    B, Sq, Sk, H, Hkv, hd, causal = shape
    q, k, v = attention_inputs(B, Sq, Sk, H, Hkv, hd, dtype, seed=99)
    err = (fa.flash_attention(q, k, v, causal=causal).float()
           - ref.gqa_attention_ref(q, k, v, causal=causal).float()
           ).abs().max().item()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def kernel():
        return fa.flash_attention(q, k, v, causal=causal)

    t = (tally or {}).get(("flash_attention", "prefill", shape[:6]),
                          {"launches": 0})
    launches = t["launches"]
    variant = fa.variant(hd, dtype)
    row = {
        "name": "flash_attention",
        "model": model,
        "shape": list(shape[:6]),
        "dtype": str(dtype).replace("torch.", ""),
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "variant": variant,
        "products": {"flash_wgmma_3xtf32": "3xTF32 wgmma",
                     "flash_wgmma_bf16": "bf16 wgmma"}[variant],
        "launches": launches,
        "max_abs_err": err,
        "ms": device_ms(kernel, TRACED_KERNELS["flash_attention"]),
        "event_ms": cuda_ms(kernel),
        "plain_ms": cuda_ms(
            lambda: ref.gqa_attention_ref(q, k, v, causal=causal)),
        **attention_bound(*shape, dtype),
        "library_ms": device_ms(sdpa),
        "library_event_ms": cuda_ms(sdpa),
        "library_kernels": device_kernels(sdpa),
    }
    if launches:
        row["in_path_ms"] = t["traced_ms"] / launches
        row["in_path_event_ms"] = t["event_ms"] / launches
    return row


def k2_rows(gm, ref, cfg, tally: dict, dtype) -> list:
    """K2's rows of the ``kernels`` line at each of the moe path's four
    shapes in ``dtype``, from that run's ``tally`` (see ``timing_phase``)."""
    rows_out = []
    for (kernel, phase, shape), t in tally.items():
        if kernel != "grouped_matmul":
            continue
        E, C, d, f = shape
        n, rows = t["launches"], t["rows"]
        x, w = gmm_inputs(E, C, d, f, dtype, seed=98)
        err = (gm.grouped_matmul(x, w).float()
               - ref.grouped_matmul_ref(x, w).float()).abs().max().item()
        before = dict(gm.route_launches)
        gm.grouped_matmul(x, w)
        variant = next(k for k, v in gm.route_launches.items()
                       if v != before[k])
        # the main run's rows: each launch's bounds, and K2 alone cycling
        # through the first 50 launches' rows
        per_launch = [gmm_rows_bound(r, C, d, f, dtype) for r in rows]
        some = itertools.cycle([r.cuda() for r in rows[:50]])
        row = {
            "name": "grouped_matmul",
            "model": cfg.name,
            "phase": phase,
            "shape": [E, C, d, f],
            "dtype": str(dtype).replace("torch.", ""),
            "route": "cuda",
            "variant": variant,
            "products": {"gmm_wgmma": "3xTF32 wgmma",
                         "gmm_wgmma_bf16": "bf16 wgmma",
                         "gmm_decode_bf16": "bf16 wgmma"}.get(variant,
                                                             "fp32 FMA"),
            "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:21",
            "launches": n,
            "in_path_ms": t["traced_ms"] / n,
            "in_path_event_ms": t["event_ms"] / n,
            "in_path_alone_ms": cuda_ms(
                lambda: gm.grouped_matmul(x, w, next(some))),
            "mean_active_experts": float((rows > 0).sum(dim=1).double().mean()),
            "mean_rows": float(rows.sum(dim=1).double().mean()),
            "max_abs_err": err,
            "ms": cuda_ms(lambda: gm.grouped_matmul(x, w)),
            "device_ms": device_ms(lambda: gm.grouped_matmul(x, w),
                                   TRACED_KERNELS["grouped_matmul"]),
            "plain_ms": cuda_ms(lambda: ref.grouped_matmul_ref(x, w)),
            **gmm_bound(E, C, d, f, dtype),
            "library_ms": cuda_ms(lambda: torch.bmm(x, w)),
        }
        if dtype == torch.bfloat16:
            # torch.bmm's bf16 kernels may reduce split sums in bf16
            row["library_bf16_reduced_precision_reduction"] = \
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        for key in ("bound_ms", "bound_fp32_ms", "bound_3xtf32_ms"):
            if key in per_launch[0]:
                row[f"in_path_{key}"] = sum(b[key] for b in per_launch) / n
        for key in ("bound_by", "bound_fp32_by", "bound_3xtf32_by"):
            if key in per_launch[0]:
                row[f"in_path_{key}"] = max(
                    ("bytes", "operations"),
                    key=[b[key] for b in per_launch].count)
        rows_out.append(row)
    return rows_out


# K3 at the benchmark cells' shapes: (model, B, S, cache rows, the decode
# step's cache index or None for a prefill): the prompt cells' 8 x 4096
# prefill, dense and moe, and the chat cell's 16-row decode step.
K3_CELL_SHAPES = (("qwen3-14b", 8, 4096, 4097, None),
                  ("qwen2-moe-a2.7b", 8, 4096, 4097, None),
                  ("qwen3-14b", 16, 1, 3104, 2048))
# every cache row K3 does not write keeps this value
K3_SENTINEL = -7.25


def k3_heads(cfg) -> tuple:
    """(H, Hkv, hd, bias, qk-norm) of a model's attention."""
    return (cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.qkv_bias,
            cfg.qk_norm)


def k3_inputs(heads, B, S, index, dtype, theta=1e6, eps=1e-6, seed=0):
    """K3's arguments at ``heads`` (``k3_heads``): random projections,
    biases and qk-norm scales where the heads have them, positions
    0 .. S - 1, or ``index`` for a decode step."""
    H, Hkv, hd, bias, norm = heads
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    q, k, v = r(B, S, H * hd, scale=3.0), r(B, S, Hkv * hd), r(B, S, Hkv * hd)
    b = (r(H * hd), r(Hkv * hd), r(Hkv * hd)) if bias else (None,) * 3
    n = (1 + r(hd, scale=0.2), 1 + r(hd, scale=0.2)) if norm else (None,) * 2
    if index is None:
        pos = torch.arange(S, dtype=torch.int32, device="cuda")[None]
        pos = pos.expand(B, S)
    else:
        pos = torch.full((B, 1), index, dtype=torch.int32, device="cuda")
    return (q, k, v, pos, hd, theta, *b, *n, eps)


def k3_caches(B, T, Hkv, hd, dtype=torch.float32) -> tuple:
    """A (k, v) cache pair (B, T, Hkv, hd) filled with ``K3_SENTINEL``."""
    return tuple(torch.full((B, T, Hkv, hd), K3_SENTINEL, dtype=dtype,
                            device="cuda") for _ in "kv")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (x held in fp32)."""
    e = torch.frexp(x.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(x), e - 8)


def k3_chain_with_factor(args, fq, fk):
    """``ref.qkv_rope_ref``'s q and k with qk-norm's rounded rsqrt
    factors given, (B, S, heads, 1) in the input's dtype."""
    from repro_torch.kernels.ref import apply_rope

    q, k, v, pos, hd, theta, bq, bk, bv, sq, sk, _ = args
    B, S = q.shape[:2]
    if bq is not None:
        q, k = q + bq, k + bk
    q, k = (t.reshape(B, S, -1, hd) for t in (q, k))
    q, k = q * fq * sq, k * fk * sk
    return apply_rope(q, pos, theta), apply_rope(k, pos, theta)


def factor_ties(x, hd, eps):
    """For x (B, S, heads*hd) after its bias: the chain's rounded rsqrt
    factor by head, the bf16 factor on the other side of its fp32 value,
    and the heads whose fp32 factor lies within 2^-18 of the midpoint
    between the two: there the fp32 sum's order decides the rounding."""
    B, S = x.shape[:2]
    x = x.reshape(B, S, -1, hd)
    rf = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps)
    near = rf.to(torch.bfloat16)
    step = torch.where(rf > near.float(), 1, -1).to(torch.int16)
    other = (near.view(torch.int16) + step).view(torch.bfloat16)
    mid = (near.float() + other.float()) / 2
    return near, other, (rf - mid).abs() <= rf * 2.0 ** -18


def k3_heads_off(got, want, dtype, alt=None, ties=None) -> int:
    """The heads of ``got`` (B, S, heads, hd) not close to the plain
    chain's ``want``. fp32: within 2e-6 of each head's largest value.
    bf16: within one bf16 ulp of the plain chain, or, in a head where
    the rsqrt factor is a near-tie (``ties``), of the chain with the
    other rounding (``alt``)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        peak = want.abs().amax(dim=-1, keepdim=True)
        ok = ((got - want).abs() <= 2e-6 * peak).all(dim=-1)
        return int((~ok).sum())
    ulp = bf16_ulp(torch.maximum(got.abs(), want.abs()))
    ok = ((got - want).abs() <= ulp).all(dim=-1, keepdim=True)
    if alt is not None:
        alt = alt.float()
        ulp_alt = bf16_ulp(torch.maximum(got.abs(), alt.abs()))
        ok |= ties & ((got - alt).abs() <= ulp_alt).all(dim=-1, keepdim=True)
    return int((~ok).sum())


def k3_held(got, want, args, dtype, cache=None, index=None) -> dict:
    """K3's outputs ``got`` against the plain chain's ``want`` on the same
    ``args``: the heads of q and of k off by more than the card tests
    allow (``k3_heads_off``; in bf16 with qk-norm, the rsqrt near-ties
    are counted and the chain is rebuilt from its rounded factors to
    show the tie model reproduces it), v equal bit for bit, and, with
    the kernel's ``cache``, whether the written rows hold its own k and v
    in the cache's dtype bit for bit and every other row its
    ``K3_SENTINEL``."""
    out = {"heads_off": [0, 0], "v_equal": torch.equal(got[2], want[2])}
    alt = ties = (None, None)
    if dtype == torch.bfloat16 and args[9] is not None:
        (q_in, k_in), (bq, bk), hd, eps = args[:2], args[6:8], args[4], \
            args[11]
        fq, oq, tq = factor_ties(q_in if bq is None else q_in + bq, hd, eps)
        fk, ok_, tk = factor_ties(k_in if bk is None else k_in + bk, hd, eps)
        same = k3_chain_with_factor(args, fq, fk)
        out["chain_rebuilt"] = bool(torch.equal(same[0], want[0])
                                    and torch.equal(same[1], want[1]))
        alt, ties = k3_chain_with_factor(args, oq, ok_), (tq, tk)
        out["near_ties"] = [int(tq.sum()), int(tk.sum())]
    for i in (0, 1):
        out["heads_off"][i] = k3_heads_off(got[i], want[i], dtype, alt[i],
                                           ties[i])
    if cache is not None:
        S = got[1].shape[1]
        rows = slice(index, index + 1) if index is not None and S == 1 \
            else slice(0, S)
        own, rest = True, True
        for c, t in zip(cache, got[1:]):
            own &= torch.equal(c[:, rows], t.to(c.dtype))
            kept = c.clone()
            kept[:, rows] = K3_SENTINEL
            rest &= bool((kept == K3_SENTINEL).all())
        out["cache_rows_own"], out["cache_rest_kept"] = own, rest
    return out


def k3_ok(held: dict) -> bool:
    return (held["heads_off"] == [0, 0] and held["v_equal"]
            and held.get("chain_rebuilt", True)
            and held.get("cache_rows_own", True)
            and held.get("cache_rest_kept", True))


def k3_bound(cfg, B, S, dtype) -> dict:
    """K3's least time: q, k and v read once, q and k written (v too where
    the bias changes it), k and v written to the fp32 cache, at 3.35 TB/s
    (biases, scales, positions and the frequency table are left out: under
    0.01%)."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    eb = torch.finfo(dtype).bits // 8
    vals = B * S * hd
    nbytes = vals * ((H + 2 * Hkv) * eb + (H + Hkv + Hkv * cfg.qkv_bias) * eb
                     + 2 * Hkv * 4)
    return {"bytes": nbytes, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def k3_row(k3, ref, cfg, B, S, T, index, dtype, per_forward) -> dict:
    """K3 at one cell shape, held to the plain chain
    (``ref.qkv_rope_ref``) on the same inputs by ``k3_held`` (the run
    fails otherwise), beside its byte bound and the plain chain: device
    times from a torch.profiler trace (all of the plain chain's kernels,
    and how many), CUDA events beside; the largest difference, the share
    of q and k values equal bit for bit, and whether the two caches came
    out the same; ``per_forward``, the launches a forward counted in the
    model's engine run."""
    args = k3_inputs(k3_heads(cfg), B, S, index, dtype, cfg.rope_theta,
                     cfg.norm_eps, seed=97)
    Hkv, hd = cfg.n_kv_heads, cfg.d_head
    cache, plain_cache = k3_caches(B, T, Hkv, hd), k3_caches(B, T, Hkv, hd)
    got = k3.qkv_rope(*args, cache=cache, cache_index=index)
    want = ref.qkv_rope_ref(*args, cache=plain_cache, cache_index=index)
    held = k3_held(got, want, args, dtype, cache, index)
    shape = [B, S, cfg.n_heads, Hkv, hd]
    check(k3_ok(held), f"qkv_rope {cfg.name} {shape} against the plain "
          f"chain: {held}")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    equal = sum(int((a == b).sum()) for a, b in zip(got[:2], want[:2])) / \
        sum(a.numel() for a in got[:2])
    cache_equal = all(torch.equal(a, b) for a, b in zip(cache, plain_cache))
    del got, want

    def kernel():
        return k3.qkv_rope(*args, cache=cache, cache_index=index)

    def plain():
        return ref.qkv_rope_ref(*args, cache=plain_cache, cache_index=index)

    row = {
        "name": "qkv_rope",
        "model": cfg.name,
        "phase": "prefill" if index is None else "decode",
        "shape": shape,
        "bias": cfg.qkv_bias, "qk_norm": cfg.qk_norm,
        "dtype": str(dtype).replace("torch.", ""),
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qkv_rope.cu",
        "replaces": "port only: no TPU kernel",
        "launches_per_forward": per_forward,
        "max_abs_err": err,
        "equal_share": equal,
        "cache_equal": cache_equal,
        **held,
        "ms": device_ms(kernel, "qkv_rope"),
        "event_ms": cuda_ms(kernel),
        "plain_ms": device_ms(plain),
        "plain_event_ms": cuda_ms(plain),
        "plain_kernels": device_kernels(plain)["count"],
        **k3_bound(cfg, B, S, dtype),
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def k3_rows(k3, ref, cfgs, engines) -> list:
    """``k3_row`` at each of ``K3_CELL_SHAPES`` in bf16, the cells' dtype,
    with the launches a forward of that model's bf16 engine run."""
    bf16 = torch.bfloat16
    return [k3_row(k3, ref, cfgs[name], B, S, T, index, bf16,
                   engines[(name, bf16)]["k3_launches_per_forward"])
            for name, B, S, T, index in K3_CELL_SHAPES]


def timing_phase(fa, gm, ref, tallies, engines, cfgs):
    """The ``kernels`` line: K1 at the prefill shape of every served model
    that has attention (all in ``tallies`` but xlstm-350m) in each dtype
    it was served in (fp32 rows first), and K2 at each of the moe path's
    four shapes in fp32 and in bf16, each with its launches on its model's
    main path in its dtype (``tallies[(name, dtype)]``) and its device
    time per launch in that run, from the trace of its repeat
    (``in_path_ms``; ``in_path_event_ms`` from CUDA events around each
    launch of the run). K2's ``ms``, ``plain_ms``, bounds and
    ``library_ms`` are the dense product (no rows), like for like with
    ``torch.bmm``; its rows name the variant that ran. A K2 row also
    carries, per launch of the main run: its time alone with the run's
    rows (``in_path_alone_ms``), the least time those rows need on each
    route (``in_path_bound_*``), and the mean active experts and rows."""
    moe_cfg = cfgs["qwen2-moe-a2.7b"]
    f32, bf16 = torch.float32, torch.bfloat16
    kernels = [k1_row(fa, ref, name, prefill_attention(cfgs[name]), dtype,
                      tallies[(name, dtype)])
               for dtype in (f32, bf16) for name, d in tallies
               if d == dtype and attention_layers(cfgs[name])]
    for dtype in (f32, bf16):
        kernels += k2_rows(gm, ref, moe_cfg, tallies[(moe_cfg.name, dtype)],
                           dtype)
    from repro_torch.kernels import qkv_rope as k3

    return kernels + k3_rows(k3, ref, cfgs, engines)


# The fluid simulator on the card against the same call on the CPU: the
# relative tolerance of tests/test_torch_sim.py (REL_TOL), where the port
# equals the reference bit for bit.
SIM_REL_TOL = 0.0
# Events per cell of the fleet phase's traced warm-up call.
TRACE_EVENTS = 128


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def train_step_trace(cfg, state, B: int, S: int) -> dict:
    """One more training step of ``state``, traced by ``torch.profiler``
    after an untraced one: host ms, device busy ms, idle share, kernels
    and the longest kernels by name."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from profile_engine import traced
    from repro_torch import build_model
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step

    step = make_train_step(build_model(cfg), peak_lr=1e-3, warmup=2)
    data = SyntheticLMData(cfg, B, S, seed=1)
    batches = [{k: torch.from_numpy(v).to("cuda", torch.long)
                for k, v in data.sample(i).items()} for i in range(2)]
    step(state, batches[0])
    torch.cuda.synchronize()
    return traced(lambda: step(state, batches[1]))


def train_phase(fa, gm, cfg) -> dict:
    """Trains full-width ``cfg`` (qwen2-0.5b) on the card through
    ``train()``: fp32, TF32 off, remat on, batch 8 x 256 tokens of
    ``SyntheticLMData``, 10 steps with a 2-step warm-up. Checks that the
    loss falls and that no K1 or K2 launch happened (training takes the
    reference's routes: the kernels have no backward). Then, at the
    same width cut to 2 layers: 3 steps on the card against 3 on the
    CPU from the same weights (a CPU generator), and 6 steps against 3 +
    checkpoint + resume + 3 on the card."""
    from repro_torch.train import TrainConfig, train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, steps = 8, 256, 10
    fa.launches = gm.launches = 0
    out = train(cfg, TrainConfig(steps=steps, batch=B, seq=S, peak_lr=1e-3,
                                 warmup=2, log_every=1, device="cuda"))
    launches = {"flash_attention": fa.launches,
                "grouped_matmul": gm.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = sum(p.numel() for p in out["state"]["params"].parameters())
    losses = out["losses"]
    check(launches == {"flash_attention": 0, "grouped_matmul": 0},
          f"training launched a kernel: {launches}")
    check(np.isfinite(losses).all(), f"non-finite training loss {losses}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.1,
          f"the loss did not fall: {losses}")
    ms = 1e3 * np.array(out["step_s"][1:])
    T = B * S
    trace = train_step_trace(cfg, out["state"], B, S)
    report = {
        "model": cfg.name, "params": n, "batch": B, "seq": S,
        "steps": steps, "losses": losses,
        "first_step_ms": 1e3 * out["step_s"][0],
        "step_ms_median": float(np.median(ms)),
        "step_ms_min": float(ms.min()), "step_ms_max": float(ms.max()),
        "tokens_per_s": T / float(np.median(ms)) * 1e3,
        "peak_gb": peak_gb,
        "bound_6NT_ms": 6 * n * T / H100_FP32_FLOPS * 1e3,
        "bound_8NT_remat_ms": 8 * n * T / H100_FP32_FLOPS * 1e3,
        "kernel_launches": launches,
        "trace_one_step": trace,
    }
    del out
    gc.collect()
    torch.cuda.empty_cache()

    cut = cfg.replace(n_layers=2)
    quiet = dict(log_fn=lambda *_: None)
    tc = dict(steps=3, batch=4, seq=128, peak_lr=1e-3, warmup=1,
              log_every=100)
    t0 = time.perf_counter()
    card = train(cut, TrainConfig(device="cuda", **tc), **quiet)["losses"]
    t1 = time.perf_counter()
    cpu = train(cut, TrainConfig(device="cpu", **tc), **quiet)["losses"]
    t2 = time.perf_counter()
    report["card_vs_cpu"] = {"layers": 2, "batch": 4, "seq": 128,
                             "card": card, "cpu": cpu,
                             "max_rel": max_rel(card, cpu),
                             "rtol": TRAIN_CARD_CPU_RTOL,
                             "card_s": t1 - t0, "cpu_s": t2 - t1}
    check(report["card_vs_cpu"]["max_rel"] <= TRAIN_CARD_CPU_RTOL,
          f"training losses, card {card} vs CPU {cpu}")

    tc = dict(batch=B, seq=S, peak_lr=1e-3, warmup=2, log_every=100,
              device="cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        full = train(cut, TrainConfig(steps=6, **tc), **quiet)["losses"]
        train(cut, TrainConfig(steps=3, ckpt_dir=d, ckpt_every=3, **tc),
              **quiet)
        resumed = train(cut, TrainConfig(steps=6, ckpt_dir=d, ckpt_every=3,
                                         **tc), **quiet)["losses"]
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                         if f.is_file())
    report["resume"] = {"layers": 2, "full": full[3:], "resumed": resumed,
                        "max_rel": max_rel(resumed, full[3:]),
                        "rtol": RESUME_RTOL, "ckpt_bytes": ckpt_bytes,
                        "s": time.perf_counter() - t0}
    check(len(resumed) == 3 and report["resume"]["max_rel"] <= RESUME_RTOL,
          f"resumed losses {resumed} vs {full[3:]}")
    print("train: " + json.dumps(report))
    gc.collect()
    torch.cuda.empty_cache()
    return report


def _mesh_steps(cfg, route, batches, sharded: bool) -> dict:
    """``len(batches)`` training steps of full-width ``cfg`` on the card
    from the CPU-generator weights of seed 0 (as the training phase's),
    plain or, with ``sharded``, placed by ``reshard_state`` under
    ``state_specs(param_specs(...))`` on a one-rank (`data`, `model`)
    mesh of a world-size-1 nccl group (destroyed on the way out)."""
    from repro_torch import build_model
    from repro_torch.checkpoint.elastic import reshard_state
    from repro_torch.distributed.sharding import (batch_specs, param_specs,
                                                  placements, state_specs)
    from repro_torch.launch.mesh import make_local_mesh, process_group
    from repro_torch.launch.steps import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, use_flash=route)
    step = make_train_step(model, peak_lr=1e-3, warmup=2)
    losses, ms = [], []
    with (process_group("nccl") if sharded else contextlib.nullcontext()):
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 device="cuda")
        if sharded:
            mesh = make_local_mesh()
            state = reshard_state(state, mesh, state_specs(
                cfg, mesh, param_specs(cfg, state["params"], mesh)))
            bs = batch_specs(cfg, "train", mesh)
            batches = [{k: distribute_tensor(v, mesh, placements(bs[k], mesh))
                        for k, v in b.items()} for b in batches]
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            loss = m["loss"]
            loss = float(loss.full_tensor() if sharded else loss)
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(loss)
        del state
    out = {"losses": losses, "step_ms": ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_phase(fa, gm, cfg) -> dict:
    """The distribution layer. (a) Full-width ``cfg`` (qwen2-0.5b) takes
    3 training steps at 8 x 256 tokens on a world-size-1 nccl group's
    (1, 1) mesh, placed by the sharding rules, on the masked-attention
    route and on "cp"; each loss is held to the plain step from the same
    weights on the card within ``MESH_RTOL``, with no K1 or K2 launch.
    (b) ``dryrun_cells``."""
    from repro_torch.data import SyntheticLMData

    B, S, steps = 8, 256, 3
    data = SyntheticLMData(cfg, B, S, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda", torch.long)
                for k, v in data.sample(i).items()} for i in range(steps)]
    report = {"model": cfg.name, "batch": B, "seq": S, "steps": steps,
              "rtol": MESH_RTOL, "routes": {}}
    for route in (False, "cp"):
        plain = _mesh_steps(cfg, route, batches, sharded=False)
        fa.launches = gm.launches = 0
        shard = _mesh_steps(cfg, route, batches, sharded=True)
        launches = {"flash_attention": fa.launches,
                    "grouped_matmul": gm.launches}
        rel = max_rel(shard["losses"], plain["losses"])
        name = "cp" if route else "masked"
        report["routes"][name] = {
            "plain": plain, "sharded": shard, "max_rel": rel,
            "kernel_launches": launches,
            "sharded_ms_median_after_first": float(
                np.median(shard["step_ms"][1:])),
            "plain_ms_median_after_first": float(
                np.median(plain["step_ms"][1:]))}
        check(launches == {"flash_attention": 0, "grouped_matmul": 0},
              f"the sharded step launched a kernel: {launches}")
        check(np.isfinite(shard["losses"]).all() and rel <= MESH_RTOL,
              f"{name}: sharded losses {shard['losses']} vs plain "
              f"{plain['losses']} (max rel {rel:.2e})")
    print("mesh (a) sharded training step: " + json.dumps(report))
    return {"a": report, "b": dryrun_cells(fa, gm)}


def dryrun_cells(fa, gm) -> dict:
    """The dry run, host only: ``analyze_cell`` on ``MESH_DRYRUN_CELLS``
    at full width, inside a fake 256-rank group for the 16x16 mesh and
    then a fake 512-rank group for the 2x16x16 one (meta shards). Every
    row must be ok, its per-device argument bytes under the card's
    memory, within ``DRYRUN_RELEASE_FLOPS_RTOL`` of the port's FLOPs on torch
    2.13, and held to the reference's row in
    ``scripts/dryrun_reference.jsonl`` by ``dryrun_expect.row_faults``
    (FLOPs within ``DRYRUN_FLOPS_RTOL``, collective bytes within
    ``DRYRUN_COLL_RTOL`` of the row's expected ratio), with no K1 or K2
    launch."""
    from repro_torch.configs import ARCHS, SHAPES_BY_NAME
    from repro_torch.launch import dryrun
    from repro_torch.launch.dryrun_expect import (DRYRUN_RELEASE_FLOPS_RTOL,
                                                  coll_expect, row_faults)
    from repro_torch.launch.mesh import make_production_mesh, process_group

    table = Path(__file__).resolve().parent / "scripts" / "dryrun_reference.jsonl"
    refs = {}
    for line in table.read_text().splitlines():
        r = json.loads(line)
        if "arch" in r:
            refs[(r["arch"], r["shape"], r["mesh"])] = r
    rows = []
    t0 = time.perf_counter()
    fa.launches = gm.launches = 0
    for mesh_name in ("single", "multi"):
        world, multi_pod = dryrun.MESHES[mesh_name]
        with process_group("fake", world):
            mesh = make_production_mesh(multi_pod=multi_pod)
            for arch, shape, m, flops_213 in MESH_DRYRUN_CELLS:
                if m != mesh_name:
                    continue
                r = dryrun.analyze_cell(arch, ARCHS[arch],
                                        SHAPES_BY_NAME[shape], mesh, m)
                ref = refs[(arch, shape, m)]
                r["ref"] = {k: ref[k] for k in
                            ("flops_per_device", "collective_bytes_per_device")}
                r["flops_torch_2_13"] = flops_213
                rows.append(r)
    launches = {"flash_attention": fa.launches, "grouped_matmul": gm.launches}
    total = torch.cuda.get_device_properties(0).total_memory
    keys = ("arch", "shape", "mesh", "status", "dominant", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device", "trace_s")
    dry = {"host_only": True, "s": time.perf_counter() - t0,
           "card_total_memory": total, "kernel_launches": launches,
           "cells": [{k: r[k] for k in keys}
                     | {"argument_bytes": r["mem"]["argument_bytes"],
                        "temp_bytes": r["mem"]["temp_bytes"],
                        "ref": r["ref"],
                        "flops_torch_2_13": r["flops_torch_2_13"],
                        "flops_ratio": r["flops_per_device"]
                        / r["ref"]["flops_per_device"],
                        "collective_ratio": r["collective_bytes_per_device"]
                        / r["ref"]["collective_bytes_per_device"]}
                     for r in rows]}
    print("mesh (b) dry run, host only, a model of a 256- and a 512-GPU "
          "cluster from spec-sheet constants: " + json.dumps(dry))
    check(launches == {"flash_attention": 0, "grouped_matmul": 0},
          f"the dry run launched a kernel: {launches}")
    for r, c in zip(rows, dry["cells"]):
        what = f"dry run {r['arch']} x {r['shape']} ({r['mesh']})"
        check(r["status"] == "ok", f"{what}: {r['status']}")
        check(r["mem"]["argument_bytes"] < total,
              f"{what}: {r['mem']['argument_bytes']} argument bytes per "
              "device")
        check(abs(r["flops_per_device"] / r["flops_torch_2_13"] - 1)
              <= DRYRUN_RELEASE_FLOPS_RTOL,
              f"{what}: {r['flops_per_device']:.6e} FLOPs per device on "
              f"torch {torch.__version__}, {r['flops_torch_2_13']:.6e} on "
              "torch 2.13")
        kind = SHAPES_BY_NAME[r["shape"]].kind
        faults = row_faults(r, r["ref"], kind)
        check(not faults,
              f"{what}: {'; '.join(faults)} ({r['flops_per_device']:.6e} "
              f"FLOPs, {r['collective_bytes_per_device']:.6e} collective "
              f"bytes per device; {coll_expect(r['arch'], r['shape'], r['mesh'], kind):.4f} expected)")
    return dry


def control_plane_phase() -> dict:
    """The serving control plane (``serve.session``; the NPU simulated on
    the host): qwen3-14b decode next to qwen2-0.5b prefill in closed loop
    under every policy, then an open-loop session in which the second
    tenant registers mid-run with a 1 ms p95 SLO, the autoscaler grows
    it and it deregisters while the first still serves. The second
    tenant's load (10 requests/s) is one its vNPU can finish in the
    window, so every submitted request completes."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.policies import available_policies
    from repro_torch.npu.trace import lm_trace
    from repro_torch.serve import (NPUCluster, PoissonArrivals,
                                   SLOAutoscaler, ServingSession,
                                   run_closed_loop)

    t0 = time.perf_counter()
    llm = lm_trace(ARCHS["qwen3-14b"], batch=8, seq=2048, phase="decode")
    small = lm_trace(ARCHS["qwen2-0.5b"], batch=8, seq=512, phase="prefill")

    def row(r):
        return {"p95_ms": r.p95_ms, "throughput_rps": r.throughput_rps,
                "requests_done": r.requests_done}

    closed = {}
    for policy in available_policies():
        cluster = NPUCluster(policy=policy)
        cluster.register("qwen3-14b/decode", llm, eu_budget=4)
        cluster.register("qwen2-0.5b/prefill", small, eu_budget=4)
        _, reports = run_closed_loop(cluster, n_requests=5)
        closed[policy] = {r.name: row(r) for r in reports}
        check(all(r.requests_done >= 5 for r in reports),
              f"closed loop under {policy}: {closed[policy]}")

    sess = ServingSession(NPUCluster(policy="neu10"),
                          autoscaler=SLOAutoscaler(max_eus=6))
    t_llm = sess.register("qwen3-14b/decode", llm, eu_budget=4)
    sess.submit_arrivals(t_llm, PoissonArrivals(rate_rps=6.0, n=120, seed=0))
    sess.run_until(5.0)
    t_sm = sess.register("qwen2-0.5b/prefill", small, eu_budget=2,
                         slo_p95_ms=1.0)
    n_sm = sess.submit_arrivals(t_sm, PoissonArrivals(
        rate_rps=10.0, n=50, seed=1, start_s=sess.now_s))
    before = t_sm.eu_budget
    sess.run_until(sess.now_s + 5.0)
    sess.run_until(sess.now_s + 5.0)   # a second window lets the hook act
    r_sm = sess.report(t_sm)[0]
    open_loop = {"small": dict(row(r_sm), eu_budget=[before, t_sm.eu_budget],
                               submitted=n_sm, deregistered_at_s=sess.now_s)}
    sess.deregister(t_sm)
    sess.drain()
    r_llm = sess.report(t_llm)[0]
    open_loop["llm"] = dict(row(r_llm), submitted=120, end_s=sess.now_s)
    check(r_sm.requests_done == n_sm and r_sm.queued == 0,
          f"the second tenant left requests unfinished: {open_loop}")
    check(r_llm.requests_done == 120, f"the LLM tenant: {open_loop}")
    check(t_sm.eu_budget > before, "the autoscaler did not grow the budget")
    report = {"closed_loop": closed, "open_loop": open_loop,
              "s": time.perf_counter() - t0}
    print("control plane: " + json.dumps(report))
    return report


def fleet_oracle(core, pairs, policy):
    """The port's discrete simulator on ``pairs`` of workload names at
    the half split of ``core`` (n_requests 4): (makespans, seconds spent
    in ``Simulator.run``)."""
    from repro_torch.core import (Simulator, TenantSpec, VNPUConfig,
                                  VNPUManager, compile_neuisa)
    from repro_torch.npu.workloads import get_workload

    out, seconds = [], 0.0
    for names in pairs:
        mgr = VNPUManager(core=core)
        specs = [TenantSpec(compile_neuisa(get_workload(n, core), core),
                            mgr.create(VNPUConfig(core.n_me // 2,
                                                  core.n_ve // 2,
                                                  hbm_bytes=1 << 30)), 4)
                 for n in names]
        t0 = time.perf_counter()
        out.append(Simulator(specs, policy=policy, core=core).run().makespan)
        seconds += time.perf_counter() - t0
    return out, seconds


def fleet_phase() -> dict:
    """The collocation grid of the fluid simulator on the card: all 78
    pairs of the 12 workloads (self-pairs included) x the 49 EU splits of
    an 8 ME / 8 VE core (each tenant >= 1 ME and >= 1 VE) x 5 HBM
    bandwidths, 4 requests per tenant, harvest off and on (2 x 19110
    cells). Holds the card against the same call on the CPU (events
    equal, floats within SIM_REL_TOL) and the half-split cells of three
    pairs on the default core against the port's discrete simulator in
    the bands of tests/test_sim_jax.py; times the card grid (3 calls),
    the CPU grid and the discrete simulator per cell. The warm-up is one
    cell, then the grid without harvest cut at TRACE_EVENTS events,
    traced by ``torch.profiler``: kernels per iteration and the device's
    idle share. Every op of the loop spans the whole grid, whether its cells
    still run or not, so each iteration launches the same kernels on the
    same widths as in the full call."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from profile_engine import traced
    from repro_torch.core import compile_neuisa, sim_torch
    from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig
    from repro_torch.npu.workloads import PAPER_PAIRS, WORKLOADS, get_workload

    core = NPUCoreConfig(n_me=8, n_ve=8)
    t0 = time.perf_counter()
    progs = {n: compile_neuisa(get_workload(n, core), core)
             for n in WORKLOADS}
    compile_s = time.perf_counter() - t0
    names = list(itertools.combinations_with_replacement(WORKLOADS, 2))
    pairs = [(progs[a], progs[b]) for a, b in names]
    splits = [((m, 8 - m), (v, 8 - v)) for m in range(1, 8)
              for v in range(1, 8)]
    bws = (0.5, 0.75, 1.0, 1.5, 2.0)
    n_cells = len(pairs) * len(splits) * len(bws)
    check(n_cells == 19110, f"fleet grid has {n_cells} cells, not 19110")

    def grid(device):
        """{harvest: leaves} and {harvest: loop iterations}."""
        out, iters = {}, {}
        for h in (False, True):
            sim_torch.iterations = 0
            out[h] = sim_torch.sweep_collocations(
                pairs, splits, bw_points=bws, n_requests=4, harvest=h,
                core=core, device=device)
            iters[h] = sim_torch.iterations
        if device == "cuda":
            torch.cuda.synchronize()
        return out, iters

    sim_torch.sweep_collocations(pairs[:1], splits[:1], n_requests=1,
                                 harvest=False, core=core, device="cuda")
    full_events, sim_torch.MAX_EVENTS = sim_torch.MAX_EVENTS, TRACE_EVENTS
    try:
        sim_torch.iterations = 0
        trace = traced(lambda: sim_torch.sweep_collocations(
            pairs, splits, bw_points=bws, n_requests=4, harvest=False,
            core=core, device="cuda"))
    finally:
        sim_torch.MAX_EVENTS = full_events
    trace.pop("top")
    trace["iterations"] = sim_torch.iterations
    trace["kernels_per_iteration"] = trace["kernels"] / trace["iterations"]
    card_s = []
    for _ in range(3):
        t1 = time.perf_counter()
        card, iterations = grid("cuda")
        card_s.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    cpu, _ = grid("cpu")
    cpu_s = time.perf_counter() - t1

    ev_diff, max_rel, stalled, max_ev = 0, 0.0, 0, 0
    for h in (False, True):
        g = {k: v.cpu() for k, v in card[h].items()}
        c = cpu[h]
        check(g["makespan"].shape == (len(pairs), len(splits), len(bws)),
              f"fleet grid shape {tuple(g['makespan'].shape)}")
        ev_diff += int((g["events"] != c["events"]).sum())
        for k in ("makespan", "throughput", "me_util", "ve_util"):
            check(bool(torch.isfinite(g[k]).all()), f"fleet {k} not finite")
            d = (g[k].double() - c[k].double()).abs()
            rel = d / c[k].double().abs().clamp(min=1e-300)
            max_rel = max(max_rel, float(torch.where(d == 0, 0.0, rel).max()))
        ev = c["events"]
        stalled += int((ev == sim_torch.MAX_EVENTS).sum())
        max_ev = max(max_ev, int(ev[ev < sim_torch.MAX_EVENTS].max()))
    print(f"fleet sweep, card vs CPU over 2 x {n_cells} cells: {ev_diff} "
          f"cells with different events, max relative d {max_rel:.3e} "
          f"(limit {SIM_REL_TOL})")
    check(ev_diff == 0, f"fleet sweep: {ev_diff} cells' events differ")
    check(max_rel <= SIM_REL_TOL, f"fleet sweep: card and CPU differ by "
          f"{max_rel:.3e} relative")

    # the half-split cells of three pairs against the discrete oracle
    three = [("RsNt", "DLRM"), ("BERT", "ENet"), ("ENet", "TFMR")]
    small = [(compile_neuisa(get_workload(a)), compile_neuisa(get_workload(b)))
             for a, b in three]
    fluid = {h: sim_torch.sweep_collocations(
                 small, [((2, 2), (2, 2))], n_requests=4, harvest=h,
                 device="cuda")["makespan"][:, 0, 0].cpu().numpy()
             for h in (False, True)}
    oracle = {h: fleet_oracle(DEFAULT_CORE, three,
                              "neu10" if h else "neu10_nh")[0]
              for h in (False, True)}
    ratios = {h: [float(f) / o for f, o in zip(fluid[h], oracle[h])]
              for h in (False, True)}
    print(f"fleet sweep vs the discrete oracle, half split: no harvest "
          f"{ratios[False]} (0.98-1.02), harvest {ratios[True]} (0.45-1.02)")
    check(all(0.98 < r < 1.02 for r in ratios[False]),
          "fluid (no harvest) outside 0.98-1.02 of neu10_nh")
    check(all(0.45 < r <= 1.02 for r in ratios[True]),
          "fluid (harvest) outside 0.45-1.02 of neu10")
    check(bool(np.all(fluid[True] <= fluid[False] * 1.02)),
          "harvest slower than no harvest")
    check(np.argsort(oracle[False]).tolist()
          == np.argsort(fluid[False]).tolist(),
          "fluid pair ranking differs from the oracle's")

    per_cell = {}
    for policy in ("neu10_nh", "neu10"):
        _, s_ = fleet_oracle(core, [p[:2] for p in PAPER_PAIRS], policy)
        per_cell[policy] = s_ / len(PAPER_PAIRS) * 1e3
    card_ms = sorted(t * 1e3 for t in card_s)
    fleet = {"cells": 2 * n_cells, "pairs": len(pairs),
             "splits": len(splits), "bw_points": len(bws),
             "iterations": {"no_harvest": iterations[False],
                            "harvest": iterations[True]},
             "sync_every": sim_torch.SYNC_EVERY,
             "max_events": max_ev, "stalled_cells": stalled,
             "card_ms": card_ms, "card_median_ms": card_ms[1],
             "cpu_ms": cpu_s * 1e3,
             "discrete_ms_per_cell": per_cell,
             "compile_ms": compile_s * 1e3,
             "trace_no_harvest": trace}
    print("fleet sweep: " + json.dumps(fleet))
    return fleet


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = t0 = time.perf_counter()

    def phase_done(what: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        print(f"phase {what}: {now - t0:.1f} s (total {now - t_start:.1f} s)")
        t0 = now

    _build.build()
    phase_done("build")
    kernel = ""
    for lib, log in _build.logs.items():   # -Xptxas -v: registers, spills
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill",
                                       "wgmma", "C7514")):
                print(f"ptxas {lib}: {line.split('ptxas info    : ')[-1]}")
            if "Compiling entry" in line:
                kernel = line
            elif "spill" in line and any(k in kernel for k in TENSOR_CORE):
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"ptxas spills in {kernel}: {line}")
            check("C7514" not in line or "gmm_decode_bf16" not in line,
                  f"ptxas serializes gmm_decode_bf16's wgmma: {line}")

    cfgs = {k: ARCHS[k] for k in ("qwen2-0.5b", "qwen2-moe-a2.7b",
                                  "zamba2-7b", "internvl2-1b",
                                  "musicgen-large", "xlstm-350m",
                                  "qwen3-14b", "minicpm-2b")}
    moe_cfg = cfgs["qwen2-moe-a2.7b"]
    kernel_phase(fa, gm, ref, cfgs)
    phase_done("kernels against their plain versions")
    # tallies and engines by (model, dtype)
    tallies, engines = {}, {}
    f32, bf16 = torch.float32, torch.bfloat16
    dense_cfg = cfgs["qwen2-0.5b"]
    for dtype in (f32, bf16):
        key = (dense_cfg.name, dtype)
        tallies[key], engines[key] = family_engine_phase(
            fa, gm, dense_cfg, n_new=64, dtype=dtype)
        # fp32 at full depth; bf16 at 2 layers, as the moe model
        card_vs_cpu(dense_cfg, {} if dtype == f32 else dict(n_layers=2),
                    S=256, dtype=dtype)
        phase_done(f"dense engine and card vs CPU, {dtype}")
    for dtype in (f32, bf16):
        key = (moe_cfg.name, dtype)
        tallies[key], engines[key] = moe_engine_phase(fa, gm, moe_cfg, dtype)
        phase_done(f"moe engine, {dtype}")
        moe_card_vs_cpu(moe_cfg, dtype=dtype)
        phase_done(f"moe card vs CPU, {dtype}")
    # the other models at full width and depth, each in fp32 and in bf16:
    # (name, new tokens, the card-vs-CPU check's prompt length and its cut
    # in fp32 and in bf16, and the layers held one by one in bf16).
    # Zamba2's fp32 cut keeps two applications of the shared block and its
    # 300-token prompts two SSD chunks; in bf16 those 12 layers are held
    # one by one, and the whole at ZAMBA2_BF16_LAYERS (see there). xLSTM's
    # cut keeps one mLSTM and one sLSTM block.
    two, xl = dict(n_layers=2), dict(n_layers=2, xlstm_pattern=("m", "s"))
    for arch, n_new, S, f32_cut, bf16_cut, by_layer in (
            ("zamba2-7b", 64, 300, dict(n_layers=12),
             dict(n_layers=ZAMBA2_BF16_LAYERS), 12),
            ("internvl2-1b", 16, 256, two, two, 0),
            ("musicgen-large", 16, 256, two, two, 0),
            ("xlstm-350m", 16, 256, xl, xl, 0),
            ("qwen3-14b", 16, 256, two, two, 0),
            ("minicpm-2b", 16, 256, two, two, 0)):
        for dtype, cut in ((f32, f32_cut), (bf16, bf16_cut)):
            key = (arch, dtype)
            tallies[key], engines[key] = family_engine_phase(
                fa, gm, cfgs[arch], n_new, dtype)
            phase_done(f"{arch} engine, {dtype}")
            if by_layer and dtype == bf16:
                zamba2_layers_card_vs_cpu(fa, cfgs[arch], by_layer, S)
            card_vs_cpu(cfgs[arch], cut, S, dtype=dtype)
            phase_done(f"{arch} card vs CPU, {dtype}")
    train_phase(fa, gm, dense_cfg)
    phase_done("training")
    mesh_phase(fa, gm, dense_cfg)
    phase_done("mesh")
    control_plane_phase()
    phase_done("control plane")
    fleet_phase()
    phase_done("fleet sweep")
    kernels = timing_phase(fa, gm, ref, tallies, engines, cfgs)
    phase_done("timing")
    dtypes = {"float32": f32, "bfloat16": bf16}
    for row in kernels:
        if row["name"] != "flash_attention":
            continue
        engine = engines[(row["model"], dtypes[row["dtype"]])]
        ms = row["in_path_ms"] * row["launches"]
        print(f"{row['model']} {row['dtype']} prefill time in "
              f"flash_attention, traced in "
              f"a repeat of the main run: {row['launches']} x "
              f"{row['in_path_ms']:.4f} ms = {ms:.3f} ms of "
              f"{engine['prefill_ms']:.2f} ms "
              f"({100 * ms / engine['prefill_ms']:.1f}%); by CUDA events in "
              f"the run {row['in_path_event_ms']:.4f} ms a launch; time alone "
              f"{row['ms']:.4f} ms")
    for row in kernels:
        if row["name"] == "qkv_rope":
            print(f"qkv_rope {row['model']} {row['phase']} {row['shape']}: "
                  f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({100 * row['bound_share']:.1f}%), plain chain "
                  f"{row['plain_ms']:.4f} ms in {row['plain_kernels']} "
                  f"kernels, {row['launches_per_forward']:g} a forward in "
                  f"the engine run; heads off {row['heads_off']}")
    for dname, dtype in dtypes.items():
        moe_engine = engines[(moe_cfg.name, dtype)]
        for phase, total in (("prefill", moe_engine["prefill_ms"]),
                             ("decode", moe_engine["decode_step_ms"] * 64)):
            ms = moe_engine["k2_in_path_traced_ms"][phase]
            alone = sum(r["in_path_alone_ms"] * r["launches"] for r in kernels
                        if r["name"] == "grouped_matmul"
                        and r["phase"] == phase and r["dtype"] == dname)
            print(f"moe {dname} {phase} time in grouped_matmul, traced in a "
                  f"repeat of the main run: {ms:.3f} ms of {total:.2f} ms "
                  f"({100 * ms / total:.1f}%); by CUDA events in the run "
                  f"{moe_engine['k2_in_path_event_ms'][phase]:.3f} ms; "
                  f"launches x time alone with the run's rows: "
                  f"{alone:.3f} ms")

    print(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
