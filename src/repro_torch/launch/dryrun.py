"""Multi-pod dry run: trace every (architecture x input shape) on the
16x16 single-pod mesh AND the 2x16x16 multi-pod mesh, prove it fits
(the per-device bytes of everything passed in), and harvest the
roofline terms (per-device FLOPs, bytes and collective bytes).

Port of the reference package's ``launch/dryrun.py``. The reference
lowers and compiles each cell on 512 forced host devices and reads the
compiled HLO. The port runs each step for real, but on nothing: inside
a fake process group of 256 or 512 ranks (``launch.mesh``), on DTensors
whose local shards are ``meta`` tensors, so no tensor is allocated and
the run is host-only. Params are drawn by ``Model.init`` under
``FakeTensorMode`` (which allocates nothing either) and kept as meta
parameters of their shapes. The steps do not run under
``FakeTensorMode`` itself: DTensor works out the offsets of a
``_StridedShard`` (which einsums over two sharded dims produce) with a
tensor and ``.tolist()``, which a fake tensor cannot answer; on meta
shards that bookkeeping runs on the CPU as it would on a card. Params,
train state, batch (``Model.batch_shapes``) and cache are placed by the
rules of ``distributed.sharding``; the train step (forward, backward,
AdamW), the prefill or the decode step then runs once under
``launch.op_analysis.OpCounter``, which counts what rank 0 runs, and the
counts are divided by ``H100Roofline``: spec-sheet constants, so the
terms model a 256- or 512-GPU cluster and measure nothing. A cell's
DTensors live on ``cell_mesh``'s mesh: on the multi-pod mesh its
(pod*data, model) view (``launch.mesh.dtensor_mesh``: DTensor's
redistribution planner takes minutes a cell on three mesh dims), but
the whole (2, 16, 16) mesh for a batch-1 cache sharded 16 ways on its
sequence; xLSTM's `model` split over the mLSTM's heads.

The steps take the reference's routes (``serve_kernels=False``): masked
``_sdpa``, or ``_sdpa_chunked`` under the ``flash``/``flash_cp`` opts,
and the experts as einsums; no kernel is handed a meta tensor. The
models pin the layouts the sharding rules imply where GSPMD would
spread them (``distributed.sharding``'s module docstring), so the
per-device counts follow the rules, not the DTensor release's op-by-op
choices.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
      --shape train_4k --mesh multi                           # one cell
  ... --out results/dryrun.jsonl        (resumable: done cells skipped)
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint.elastic import reshard_state
from repro_torch.configs import ALL_SHAPES, ARCHS, SHAPES_BY_NAME, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.distributed.sharding import (
    batch_specs,
    cache_specs,
    _map_with_path,
    carried_specs,
    codebooks_split,
    kv_heads_split,
    param_specs,
    placements,
    sanitize_spec,
    sanitize_tree,
    state_specs,
)
from repro_torch.launch.mesh import (dtensor_mesh, make_production_mesh,
                                     process_group)
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models.registry import build_model, stack_kind
from repro_torch.npu.hw_config import H100
from repro_torch.optim.adamw import adamw_init

DTYPE = torch.bfloat16
MESHES = {"single": (256, False), "multi": (512, True)}


def cell_mesh(cfg: ModelConfig, cell: ShapeCell, mesh):
    """The mesh this cell's DTensors live on (``dtensor_mesh``): `model`
    split over an mLSTM's heads where each head spans several devices of
    it, over a serving cell's kv heads where each spans several
    (``kv_heads_split``: the cache holds them there), and over an audio
    serving cell's codebooks (``codebooks_split``: the logits hold them
    there); `pod` and `data` kept apart where the cell's cache specs name
    `data` alone (a batch-1 KV cache sharded on its sequence)."""
    M = mesh.size(mesh.mesh_dim_names.index("model"))
    heads = cfg.n_heads if (cfg.xlstm_pattern and M > cfg.n_heads
                            and M % cfg.n_heads == 0) else 0
    if cell.kind != "train" and stack_kind(cfg) == "transformer":
        heads = kv_heads_split(cfg, M) or codebooks_split(cfg, M)
    data_alone = False
    if cell.kind != "train":
        cache = build_model(cfg).init_cache(cell.global_batch, cell.seq_len,
                                            DTYPE, device="meta")
        specs = []
        _map_with_path(lambda _, sp: specs.append(sp),
                       cache_specs(cfg, cell, mesh, cache))
        data_alone = any("data" in sp for sp in specs)
    return dtensor_mesh(mesh, model_heads=heads, flatten_dp=not data_alone)


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                dmesh=None) -> Dict[str, Any]:
    """{name: (shape, dtype, placements or None)} for every model input
    of this cell: the stand-ins the dry run places, sanitized; the
    placements are on ``dmesh`` (by default ``cell_mesh``'s)."""
    model = build_model(cfg)
    shapes = model.batch_shapes(cell.kind, cell.global_batch, cell.seq_len)
    specs = batch_specs(cfg, cell.kind, mesh)
    dmesh = dmesh or cell_mesh(cfg, cell, mesh)
    out = {}
    for k, (shp, dt) in shapes.items():
        pl = None
        if k in specs:
            pl = placements(sanitize_spec(shp, specs[k], mesh), dmesh)
        out[k] = (shp, dt, pl)
    return out


def _draw_params(model, gen: torch.Generator) -> torch.nn.Module:
    """``Model.init``'s module, drawn under ``FakeTensorMode``, with
    every parameter a meta tensor of its shape and dtype."""
    with FakeTensorMode():
        params = model.init(gen, DTYPE, device="meta")
    for mod in params.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, torch.nn.Parameter(
                torch.empty(p.shape, dtype=p.dtype, device="meta"),
                requires_grad=False))
    return params


def _local_bytes(tree) -> int:
    """Bytes of the shards one device holds, over a tree of tensors
    (dicts, tuples, a params module)."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def analyze_cell(
    arch_id: str,
    cfg: ModelConfig,
    cell: ShapeCell,
    mesh,
    mesh_name: str,
    opts: frozenset = frozenset(),
) -> Dict[str, Any]:
    """One row. ``mesh`` is a production mesh over a running fake group.

    opts, the perf-iteration knobs:
      flash        chunked online-softmax attention (no S^2 scores)
      flash_cp     the same with q sequence-sharded over `model`
      pad_vocab    pad vocab to 256-multiple so it TP-shards
      kv_shard_hd  shard KV cache head-dim when kv-heads don't divide
      last_logit   prefill emits last-position logits only
      kv8          decode's KV cache in float8_e4m3fn
    """
    t0 = time.time()
    if "pad_vocab" in opts:
        cfg = cfg.replace(pad_vocab=True)
    use_flash: Any = "flash" in opts
    if "flash_cp" in opts:
        use_flash = "cp"   # chunked + context-parallel q
    model = build_model(cfg, remat=True, use_flash=use_flash,
                        prefill_last_only="last_logit" in opts,
                        serve_kernels=False)
    n_chips = mesh.size()
    dmesh = cell_mesh(cfg, cell, mesh)
    gen = torch.Generator().manual_seed(0)
    counter = OpCounter()

    batch: Dict[str, Any] = {}
    for k, (shp, dt, pl) in input_specs(cfg, cell, mesh, dmesh).items():
        if k == "cache_index":
            # read on the host (``int()``): a value, not a tensor
            batch[k] = cell.seq_len - 1
        else:
            batch[k] = distribute_tensor(
                torch.empty(shp, dtype=dt, device="meta"), dmesh, pl)
    arg_bytes = _local_bytes(batch) + 4 * ("cache_index" in batch)
    params = _draw_params(model, gen)
    if cell.kind == "train":
        params.requires_grad_(True)
        state = {"params": params,
                 **adamw_init(dict(params.named_parameters()))}
        p_spec = param_specs(cfg, params, mesh)
        state = reshard_state(state, dmesh, state_specs(cfg, mesh, p_spec))
        arg_bytes += _local_bytes(state)
        alias_bytes = _local_bytes(state)
        step = make_train_step(model)
        with counter:
            state, metrics = step(state, batch)
        out_bytes = _local_bytes(state) + _local_bytes(metrics)
    else:
        params = reshard_state(params, dmesh, param_specs(cfg, params, mesh))
        kv_dtype = DTYPE
        if cell.kind == "decode" and "kv8" in opts:
            kv_dtype = torch.float8_e4m3fn
        cache = model.init_cache(cell.global_batch, cell.seq_len, kv_dtype,
                                 device="meta")
        c_spec = cache_specs(cfg, cell, mesh, cache,
                             kv_hd_shard="kv_shard_hd" in opts)
        cache = reshard_state(cache, dmesh, carried_specs(
            sanitize_tree(cache, c_spec, mesh), dmesh))
        arg_bytes += _local_bytes(params) + _local_bytes(cache)
        alias_bytes = _local_bytes(cache)
        with counter:
            if cell.kind == "prefill":
                logits, cache = make_prefill_step(model)(params, batch, cache)
            else:
                logits, cache = make_decode_step(model)(params, cache, batch)
        out_bytes = _local_bytes(logits) + _local_bytes(cache)
    t_trace = time.time() - t0

    colls = counter.metrics()
    flops = colls.pop("hlo_flops")
    bytes_accessed = colls.pop("hlo_bytes")
    coll_b = colls["total_weighted_bytes"]

    compute_s = flops / H100.peak_flops_bf16
    memory_s = bytes_accessed / H100.hbm_bw
    collective_s = coll_b / H100.link_bw

    # model flops (6ND train / 2ND forward) across the whole step
    n_active = cfg.active_param_count()
    tokens = cell.tokens
    model_flops = (6.0 if cell.kind == "train" else 2.0) * n_active * tokens
    model_flops_per_chip = model_flops / n_chips

    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    row: Dict[str, Any] = {
        "arch": arch_id,
        "shape": cell.name,
        "mesh": mesh_name,
        "opts": sorted(opts),
        "status": "ok",
        "n_chips": n_chips,
        "trace_s": round(t_trace, 2),
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        # no XLA cost analysis in torch: the reference's keys, empty
        "xla_cost_flops": None,
        "xla_cost_bytes": None,
        "collective_bytes_per_device": coll_b,
        "compute_term_s": compute_s,
        "memory_term_s": memory_s,
        "collective_term_s": collective_s,
        "dominant": dominant,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flops_ratio": (model_flops_per_chip / flops) if flops else 0.0,
        "mem": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": counter.peak_bytes,
            "alias_bytes": alias_bytes,
        },
        "collectives": {k: v for k, v in colls.items() if v},
    }
    return row


def run(args) -> None:
    done = set()
    if args.out and os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skip"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    opts = frozenset(o for o in (args.opt or "").split(",") if o)
    names = [m for m in ("single", "multi") if args.mesh in (m, "both")]

    out_f = open(args.out, "a") if args.out else None
    n_ok = n_fail = 0
    try:
        for mesh_name in names:
            world, multi_pod = MESHES[mesh_name]
            with process_group("fake", world):
                mesh = make_production_mesh(multi_pod=multi_pod)
                for arch_id, cfg in ARCHS.items():
                    if args.arch and arch_id != args.arch:
                        continue
                    for cell in ALL_SHAPES:
                        if args.shape and cell.name != args.shape:
                            continue
                        if (arch_id, cell.name, mesh_name) in done:
                            continue
                        ok, why = shape_applicable(cfg, cell)
                        if not ok:
                            row = {"arch": arch_id, "shape": cell.name,
                                   "mesh": mesh_name, "status": "skip",
                                   "reason": why}
                        else:
                            try:
                                row = analyze_cell(arch_id, cfg, cell, mesh,
                                                   mesh_name, opts=opts)
                                n_ok += 1
                            except Exception as e:  # record and continue
                                row = {"arch": arch_id, "shape": cell.name,
                                       "mesh": mesh_name, "status": "error",
                                       "error": f"{type(e).__name__}: {e}",
                                       "trace": traceback.format_exc()[-2000:]}
                                n_fail += 1
                        msg = (f"[{mesh_name}] {arch_id} x {cell.name}: "
                               f"{row['status']}")
                        if row["status"] == "ok":
                            msg += (f" trace={row['trace_s']:.1f}s"
                                    f" dom={row['dominant']}"
                                    f" flops/dev={row['flops_per_device']:.3e}")
                        elif row["status"] == "error":
                            msg += f" ({row['error'][:160]})"
                        print(msg, flush=True)
                        if out_f:
                            out_f.write(json.dumps(row) + "\n")
                            out_f.flush()
                        gc.collect()
    finally:
        if out_f:
            out_f.close()
    print(f"dry-run finished: {n_ok} ok, {n_fail} failed", flush=True)
    if n_fail:
        raise SystemExit(1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES_BY_NAME) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--opt", default="",
                    help="comma list: flash,flash_cp,pad_vocab,kv_shard_hd,"
                         "last_logit,kv8")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    run(args)


if __name__ == "__main__":
    main()
