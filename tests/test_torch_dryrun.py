"""The port's dry run on the CPU: the per-device op counter
(``launch/op_analysis.py``, the counterpart of the reference's
``launch/hlo_analysis.py``), ``analyze_cell`` on the fake 16x16 and
2x16x16 meshes, the CLI, and the copied ``roofline.py``.

Tolerances:
- counted FLOPs of a smoke dense prefill against the reference's
  ``hlo_metrics`` of the same jitted prefill: 1e-9 relative (both count
  2 * |result| * K of every matmul; measured equal);
- per-device FLOPs on a fake 16x16 mesh: exactly 1/256 of the logical.
"""
import json
import math
import types

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.configs import SMOKES as J_SMOKES
from repro.launch import roofline as j_roofline
from repro.launch.hlo_analysis import hlo_metrics
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models.registry import build_model as j_build_model
from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import params_from_jax
from repro_torch.distributed.sharding import P, param_specs
from repro_torch.checkpoint.elastic import reshard_state
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     process_group)
from repro_torch.launch.op_analysis import COLLECTIVES, OpCounter
from repro_torch.models.registry import build_model
from repro_torch.npu.hw_config import H100

# the reference's row keys (launch/dryrun.py), lower_s / compile_s aside
ROW_KEYS = {"arch", "shape", "mesh", "opts", "status", "n_chips",
            "flops_per_device", "bytes_per_device", "xla_cost_flops",
            "xla_cost_bytes", "collective_bytes_per_device",
            "compute_term_s", "memory_term_s", "collective_term_s",
            "dominant", "model_flops_per_chip", "useful_flops_ratio",
            "mem", "collectives"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
FLOP_RTOL = 1e-9


# ---- test_hlo_analysis.py's cases that carry over ----
def test_loop_of_matmuls_is_counted_each_time():
    """A Python loop of 10 matmuls is 10 matmuls (the reference's scan of
    7 needed its trip count)."""
    w = torch.ones(32, 32)

    def f(x):
        for _ in range(10):
            x = x @ w
        return x

    x = torch.ones(32, 32)
    with OpCounter() as c:
        f(x)
    m = c.metrics()
    assert m["hlo_flops"] == 10 * 2 * 32 * 32 * 32
    assert m["hlo_bytes"] == 10 * 32 * 32 * 4


def test_collective_bytes_and_factors():
    """An all-reduce of f32[8,8] weighs 2 x 256 B, an all-gather of its
    16 shards 1 x 4096 B; the keys are the reference's."""
    with process_group("fake", 256):
        mesh = make_production_mesh()
        a = torch.randn(8, 8)
        with OpCounter() as c:
            r = funcol.all_reduce(a, "sum", mesh["model"])
            g = funcol.all_gather_single(a, 0, mesh["model"])
            r, g = funcol.wait_tensor(r), funcol.wait_tensor(g)
    m = c.metrics()
    assert m["all-reduce_bytes"] == 512 and m["all-reduce_count"] == 1
    assert m["all-gather_bytes"] == 16 * 256 and m["all-gather_count"] == 1
    assert m["total_weighted_bytes"] == 512 + 4096
    assert set(m) == ({f"{k}_bytes" for k in COLLECTIVES}
                      | {f"{k}_count" for k in COLLECTIVES}
                      | {"total_weighted_bytes", "hlo_flops", "hlo_bytes"})
    assert not dist.is_initialized()


@pytest.mark.parametrize("where", ["fake", "meta"])
def test_flops_are_per_device_not_logical(where):
    """x (256, 4096, 896) batch-sharded over `data`, w column- and w2
    row-parallel over `model`: each of 256 devices does 1/256 of the
    logical FLOPs, and the row-parallel product's partial sums cost one
    all-reduce of the local result."""
    logical = 2 * 2 * 256 * 4096 * 896 * 4864
    with process_group("fake", 256):
        mesh = make_production_mesh()
        ctx = FakeTensorMode() if where == "fake" else torch.device("meta")
        with ctx:
            x = distribute_tensor(torch.empty(256, 4096, 896), mesh,
                                  [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(896, 4864), mesh,
                                  [Replicate(), Shard(1)])
            w2 = distribute_tensor(torch.empty(4864, 896), mesh,
                                   [Replicate(), Shard(0)])
            with OpCounter() as c:
                y = ((x @ w) @ w2).redistribute(mesh, [Shard(0), Replicate()])
        assert tuple(y.to_local().shape) == (16, 4096, 896)
    m = c.metrics()
    assert m["hlo_flops"] == logical / 256
    assert m["all-reduce_count"] == 1
    assert m["all-reduce_bytes"] == 2 * 16 * 4096 * 896 * 4


def test_peak_bytes_follow_frees():
    with OpCounter() as c:
        a = torch.ones(1000)            # 4000 B
        b = a * 2                       # 4000 B
        del a
        d = b + 1                       # 4000 B, a freed
    assert c.peak_bytes == 8000 and c.live_bytes == 8000
    assert d.shape == b.shape


# ---- against the reference's hlo_metrics ----
def test_flops_match_the_reference_hlo():
    """A smoke dense prefill, the same weights, on a one-rank mesh: the
    port's counted FLOPs against ``hlo_metrics`` of the jitted reference
    prefill."""
    cfg, jcfg = SMOKES["qwen2-0.5b"], J_SMOKES["qwen2-0.5b"]
    B, S = 2, 64
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    cache = jax.eval_shape(lambda: jm.init_cache(B, S, jnp.float32))
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
    hlo = jax.jit(j_make_prefill_step(jm)).lower(
        jp, batch, cache).compile().as_text()
    ref = hlo_metrics(hlo)["hlo_flops"]

    model = build_model(cfg, serve_kernels=False)
    with process_group("gloo"):
        mesh = make_local_mesh(device="cpu")
        params = params_from_jax(cfg, jp, device="cpu")
        params = reshard_state(params, mesh, param_specs(cfg, params, mesh))
        tokens = distribute_tensor(torch.zeros(B, S, dtype=torch.int32),
                                   mesh, [Shard(0), Replicate()])
        c = model.init_cache(B, S, device="cpu")
        c = reshard_state(c, mesh, (P(*[None] * 5),) * 2)
        with OpCounter() as counter, torch.no_grad():
            model.prefill(params, {"tokens": tokens}, c)
    assert counter.flops == pytest.approx(ref, rel=FLOP_RTOL)


# ---- analyze_cell end to end ----
CELLS = [ShapeCell("train_s", "train", 64, 32),
         ShapeCell("prefill_s", "prefill", 64, 32),
         ShapeCell("decode_s", "decode", 64, 64)]


@pytest.fixture
def no_kernel(monkeypatch):
    """Counts calls of the kernels' entry points (there must be none)."""
    calls = []
    for name in ("flash_attention", "grouped_matmul"):
        real = getattr(kops, name)
        monkeypatch.setattr(kops, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    fa.launches = gm.launches = 0
    return calls


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c.kind)
@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_analyze_cell(cell, mesh_name, no_kernel):
    cfg = SMOKES["qwen2-0.5b"]
    world, multi = dryrun.MESHES[mesh_name]
    with process_group("fake", world):
        mesh = make_production_mesh(multi_pod=multi)
        row = dryrun.analyze_cell("qwen2-0.5b", cfg, cell, mesh, mesh_name)
    assert not dist.is_initialized()
    assert no_kernel == [] and fa.launches == 0 and gm.launches == 0
    assert set(row) == ROW_KEYS | {"trace_s"} and set(row["mem"]) == MEM_KEYS
    assert row["status"] == "ok" and row["n_chips"] == world
    n_active = cfg.active_param_count()
    want = (6.0 if cell.kind == "train" else 2.0) * n_active * cell.tokens
    assert row["model_flops_per_chip"] == want / world
    assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
    assert row["compute_term_s"] == row["flops_per_device"] / H100.peak_flops_bf16
    assert row["collective_term_s"] == (row["collective_bytes_per_device"]
                                        / H100.link_bw)
    # argument bytes: the local shards of everything passed in
    B, S = cell.global_batch, cell.seq_len
    dp = world // 16
    params = sum(t.numel() * 2 for t in _smoke_params(cfg).values())
    local = sum(n * 2 for n in _local_param_numels(cfg, mesh_name).values())
    if cell.kind == "train":
        tokens = 2 * (B // dp) * S * 4
        state = local + 2 * 2 * local + 4    # params bf16, m and v fp32
        assert row["mem"]["argument_bytes"] == tokens + state
    else:
        kv = 2 * cfg.n_layers * (B // dp) * S * cfg.n_kv_heads * cfg.d_head * 2
        S_in = S if cell.kind == "prefill" else 1
        extra = 4 if cell.kind == "decode" else 0
        assert row["mem"]["argument_bytes"] == \
            (B // dp) * S_in * 4 + extra + local + kv
    assert local < params


def _smoke_params(cfg):
    with FakeTensorMode():
        return dict(build_model(cfg).init(torch.Generator(), torch.bfloat16,
                                          device="cpu").named_parameters())


def _local_param_numels(cfg, mesh_name):
    """Each parameter's elements on one device under the rules."""
    shape = {"data": 16, "model": 16}
    if mesh_name == "multi":
        shape = {"pod": 2, **shape}
    with FakeTensorMode():
        p = build_model(cfg).init(torch.Generator(), torch.bfloat16,
                                  device="cpu")
    specs = param_specs(cfg, p, shape)
    out = {}
    for name, t in p.named_parameters():
        n = t.numel()
        for e in specs[name]:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= shape[a]
        out[name] = n
    return out


def test_cli_writes_one_ok_row(tmp_path, no_kernel):
    """``python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape
    train_4k --mesh single --out <tmp>``, in process: one ok row at full
    width, resumable (a second run adds nothing)."""
    out = tmp_path / "dry.jsonl"
    args = types.SimpleNamespace(arch="qwen2-0.5b", shape="train_4k",
                                 mesh="single", out=str(out), opt="",
                                 force=False)
    dryrun.run(args)
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["status"] == "ok"
    assert set(rows[0]) == ROW_KEYS | {"trace_s"}
    assert rows[0]["mem"]["argument_bytes"] < H100.hbm_per_chip
    dryrun.run(args)
    assert len(out.read_text().splitlines()) == 1
    assert no_kernel == [] and not dist.is_initialized()


# ---- roofline.py ----
def test_roofline_matches_the_reference():
    """The port's copy gives the reference's table and summary on the
    same rows (ok, skip and error)."""
    rows = [
        {"arch": "a", "shape": "train_4k", "mesh": "single", "status": "ok",
         "compute_term_s": 2e-3, "memory_term_s": 5e-4,
         "collective_term_s": 7e-7, "dominant": "compute_s",
         "useful_flops_ratio": 0.71,
         "mem": {"argument_bytes": 3 * 2**30, "alias_bytes": 2**30,
                 "temp_bytes": 2**29, "output_bytes": 2**30}},
        {"arch": "b", "shape": "decode_32k", "mesh": "single", "status": "ok",
         "compute_term_s": 1e-9, "memory_term_s": 2.5,
         "collective_term_s": 0.0, "dominant": "memory_s",
         "useful_flops_ratio": 0.2,
         "mem": {"argument_bytes": 2**33, "alias_bytes": 0,
                 "temp_bytes": 0, "output_bytes": 0}},
        {"arch": "c", "shape": "long_500k", "mesh": "single",
         "status": "skip", "reason": "long_500k skipped: pure attention"},
        {"arch": "d", "shape": "train_4k", "mesh": "single",
         "status": "error", "error": "RuntimeError: x"},
    ]
    assert roofline.markdown_table(rows) == j_roofline.markdown_table(rows)
    assert roofline.summarize(rows) == j_roofline.summarize(rows)


# ---- layouts the rules give (the reference's under GSPMD) ----
@pytest.mark.parametrize("heads", [(14, 2), (40, 8)], ids=["7to1", "5to1"])
def test_multi_pod_gqa_train_runs(heads, no_kernel):
    """A train step on the 2x16x16 mesh (its (32, 16) `pod_data` view)
    with 7 or 5 query heads a kv head, as `qwen2-0.5b`, `internvl2-1b`
    and `qwen3-14b` have: the masked scores' backward used to take a
    view DTensor could not split (B = 256 over 512 ranks); attention now
    runs on each device's shards."""
    hq, hkv = heads
    cfg = SMOKES["qwen2-0.5b"].replace(n_heads=hq, n_kv_heads=hkv, d_head=64)
    cell = ShapeCell("train_4k", "train", 4096, 256)
    with process_group("fake", 512):
        mesh = make_production_mesh(multi_pod=True)
        row = dryrun.analyze_cell("qwen2-0.5b", cfg, cell, mesh, "multi")
    assert row["status"] == "ok" and row["flops_per_device"] > 0
    assert no_kernel == [] and fa.launches == 0 and gm.launches == 0


_REFERENCE_CELLS = r'''
import json, sys
import repro.launch.dryrun as D
from repro.configs.base import ShapeCell
from repro.launch.mesh import make_production_mesh
rows = []
for arch, kw, cell, mesh_name in json.loads(sys.argv[1]):
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    cfg = D.ARCHS[arch].replace(**kw)
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    row = D.analyze_cell(arch, cfg, ShapeCell(*cell), mesh, mesh_name)
    rows.append([row["flops_per_device"], row["collective_bytes_per_device"]])
print(json.dumps(rows))
'''


def _reference_rows(cells):
    """The reference's (per-device FLOPs, collective bytes) of each
    (arch, config changes, cell, mesh) in ``cells``, from its
    ``analyze_cell`` in a subprocess: ``repro.launch.dryrun`` forces 512
    host devices at import."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", _REFERENCE_CELLS,
                          json.dumps(cells)],
                         capture_output=True, text=True, env=env, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_row(arch, kw, cell, mesh_name):
    world, multi = dryrun.MESHES[mesh_name]
    cfg = dryrun.ARCHS[arch].replace(**kw)
    with process_group("fake", world):
        mesh = make_production_mesh(multi_pod=multi)
        return dryrun.analyze_cell(arch, cfg, ShapeCell(*cell), mesh,
                                   mesh_name)


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_flops_match_the_reference_dry_run(mesh_name):
    """A train cell of `qwen2-0.5b` cut to 2 layers and d_model 128, with
    its 14 query heads (not a divisor of the 16-way `model` axis) and 2
    kv heads: per-device FLOPs equal the reference's ``analyze_cell`` on
    the same mesh (run in a subprocess: ``repro.launch.dryrun`` forces
    512 host devices at import). Measured equal; ``FLOP_RTOL``.
    Collective bytes within [0.25, 2] of the reference's (measured 0.49
    and 0.52: the reference's CPU compile all-reduces bf16 partial sums
    in f32, twice the bytes of the port's bf16)."""
    kw = dict(n_layers=2, d_model=128, n_heads=14, n_kv_heads=2, d_head=64,
              d_ff=256, vocab_size=1024)
    cell = ("train_s", "train", 512, 64)
    ((ref_flops, ref_coll),) = _reference_rows(
        [["qwen2-0.5b", kw, cell, mesh_name]])
    row = _port_row("qwen2-0.5b", kw, cell, mesh_name)
    assert row["flops_per_device"] == pytest.approx(ref_flops, rel=FLOP_RTOL)
    assert 0.25 * ref_coll <= row["collective_bytes_per_device"] <= 2 * ref_coll


# ---- xLSTM's heads over `model`, a sequence-sharded decode ----
# `xlstm-350m` cut to 2 blocks ("m", "s") and d_model 256: up = 512, so
# each of the 4 heads (hd 128) spans 4 devices of the 16-way `model`, 32
# features a device, as the full model's heads (hd 512, 128 a device).
XLSTM_CUT = dict(n_layers=2, xlstm_pattern=("m", "s"), d_model=256,
                 vocab_size=1024)
# `zamba2-7b` cut to 2 Mamba2 layers and one application of the shared
# block (the reference counts its branch 2 x 1/2 times), 16 heads and kv
# heads on 16 devices, at batch 1 with a cache of 256 = 16 x 16
# positions: sharded on its sequence over `data`, as `long_500k`'s.
ZAMBA2_CUT = dict(n_layers=2, hybrid_attn_every=2, d_model=512, n_heads=16,
                  n_kv_heads=16, d_head=32, d_ff=1024, vocab_size=1024,
                  ssm_heads=16, ssm_head_dim=64)
# (arch, cut, cell, FLOPs' rtol, the band of collective bytes over the
# reference's); the bands from the op-by-op lists of
# ``scripts/dryrun_collectives.py`` at these sizes (PERF.md, section 6):
# - every all-reduce and all-gather of bf16 data moves half the
#   reference's bytes, which its CPU compile moves in f32 (the residual
#   stream's partial sums, mLSTM's y and v, the sLSTM's input path);
# - the reference trades v's ones channel by two all-to-alls and the
#   sLSTM's gates each step by 14 to 17 collective-permutes, where the
#   port all-to-alls its gates once and gathers a head's h (a third to a
#   half of those bytes);
# - in training the reference all-reduces the sLSTM's recurrent weight
#   gradient every step (f32[1,512,32] x64), the port once at the end.
#   Measured 0.3713 / 0.3811 (train, single / multi), 0.4245 (prefill),
#   0.4583 (decode);
# - the Zamba2 cell: the combine's fp32 max, sum and output all-reduces
#   equal the reference's byte for byte, the rest are bf16 residual
#   all-reduces: measured 0.5069.
# FLOPs: the xLSTM cells within 0.05 (measured 1.029 train, 1.028
# prefill, 1.0097 decode): the port runs the mLSTM's intra-chunk product
# on every column of v, where GSPMD splits it over the head's devices
# (its f32[4,129,64] dots), and its gates' product whole; the Zamba2
# cell equal.
XLSTM_FLOP_RTOL = 0.05
HEADS_CELLS = {
    "xlstm_train": ("xlstm-350m", XLSTM_CUT, ("train_s", "train", 64, 64),
                    XLSTM_FLOP_RTOL, (0.30, 0.45)),
    "xlstm_prefill": ("xlstm-350m", XLSTM_CUT,
                      ("prefill_s", "prefill", 64, 64), XLSTM_FLOP_RTOL,
                      (0.35, 0.55)),
    "xlstm_decode": ("xlstm-350m", XLSTM_CUT,
                     ("decode_s", "decode", 128, 64), XLSTM_FLOP_RTOL,
                     (0.35, 0.55)),
    "zamba2_decode_b1": ("zamba2-7b", ZAMBA2_CUT,
                         ("long_s", "decode", 256, 1), FLOP_RTOL,
                         (0.45, 0.55)),
}


@pytest.fixture(scope="module")
def heads_reference():
    """The reference's rows of every ``HEADS_CELLS`` cell on both meshes,
    in one subprocess."""
    keys = [(name, m) for name in HEADS_CELLS for m in ("single", "multi")]
    rows = _reference_rows([[HEADS_CELLS[n][0], HEADS_CELLS[n][1],
                             HEADS_CELLS[n][2], m] for n, m in keys])
    return dict(zip(keys, rows))


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("name", list(HEADS_CELLS))
def test_heads_and_sequence_cells_match_the_reference(heads_reference, name,
                                                      mesh_name, no_kernel):
    """xLSTM's mLSTM on (head, head-dim) shards and sLSTM on its units,
    and Zamba2's decode over a sequence-sharded cache, at cut sizes:
    per-device FLOPs and collective bytes against the reference's
    ``analyze_cell`` on the same config, cell and mesh."""
    arch, kw, cell, rtol, (lo, hi) = HEADS_CELLS[name]
    ref_flops, ref_coll = heads_reference[(name, mesh_name)]
    row = _port_row(arch, kw, cell, mesh_name)
    assert row["status"] == "ok" and no_kernel == []
    assert row["flops_per_device"] == pytest.approx(ref_flops, rel=rtol)
    assert lo <= row["collective_bytes_per_device"] / ref_coll <= hi


class _CollectiveLog(OpCounter):
    """``OpCounter`` that also keeps each collective's kind and result
    shape."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is not NotImplemented and func.namespace in
                ("_c10d_functional", "c10d_functional")
                and not self._propagation()):
            from repro_torch.launch.op_analysis import _COLL_KIND
            kind = _COLL_KIND.get(func._opname)
            if kind:
                t = out if isinstance(out, torch.Tensor) else out[0]
                self.log.append((kind, tuple(t.shape),
                                 t.numel() * t.element_size()))
        return out


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_sequence_sharded_decode_combines_on_shards(mesh_name):
    """One decode step of the shared attention block over a batch-1 KV
    cache sharded 16 ways on its sequence over `data` (on the 2x16x16
    mesh too, replicated over `pod`), on a fake mesh: every collective
    is an all-reduce, none larger than (B, H, hd + 2) fp32 (the combine's
    max, sum and output; the out-projection's partial sums), and no
    device gathers the cache to write or read it."""
    from repro_torch.distributed.sharding import (cache_specs, placements,
                                                  replicate_plain,
                                                  sanitize_tree)
    from repro_torch.models.layers import Attention, attention_apply

    cfg = dryrun.ARCHS["zamba2-7b"].replace(**ZAMBA2_CUT)
    cell = ShapeCell("long_s", "decode", 256, 1)
    world, multi = dryrun.MESHES[mesh_name]
    with process_group("fake", world):
        mesh = make_production_mesh(multi_pod=multi)
        dmesh = dryrun.cell_mesh(cfg, cell, mesh)
        model = build_model(cfg)
        cache = model.init_cache(1, 256, torch.bfloat16, device="meta")
        spec = sanitize_tree(cache, cache_specs(cfg, cell, mesh, cache), mesh)
        kv = distribute_tensor(cache["kv_k"], dmesh,
                               placements(spec["kv_k"], dmesh))
        assert dict(zip(dmesh.mesh_dim_names, kv.placements)) == (
            {"data": Shard(2), "model": Shard(3)} | (
                {"pod": Replicate()} if multi else {}))
        attn = Attention(cfg, torch.bfloat16, device="meta")
        attn = reshard_state(attn, dmesh, param_specs(cfg, attn, mesh))
        x = distribute_tensor(torch.empty(1, 1, cfg.d_model,
                                          dtype=torch.bfloat16,
                                          device="meta"),
                              dmesh, [Replicate()] * dmesh.ndim)
        k_c, v_c = kv[0], distribute_tensor(
            cache["kv_v"], dmesh, placements(spec["kv_v"], dmesh))[0]
        with replicate_plain(x), _CollectiveLog() as c, torch.no_grad():
            out, _ = attention_apply(attn, cfg, x, torch.full((1, 1), 200, device="meta"),
                                     cache=(k_c, v_c), cache_index=200)
    assert tuple(out.shape) == (1, 1, cfg.d_model)
    limit = 1 * cfg.n_heads * (cfg.d_head + 2) * 4
    assert c.log and {k for k, _, _ in c.log} == {"all-reduce"}
    assert max(b for _, _, b in c.log) <= limit


def test_mlstm_gathers_no_qkv():
    """One mLSTM block's decode step on the fake 16x16 mesh split over its
    4 heads, each spanning 4 devices of `model`: q and k stay on (head,
    head-dim) shards and the matrix memory on (head, n) shards; the only
    gather is v's within its head (for its ones channel), the only other
    collectives the all-reduce of y's partial sums over n, the out-norm's
    variance and the out-projection's partial sums. Before, q, k and v
    were gathered whole and the memory ran replicated over `model`
    (``bf16 (128, 1, 128) x63`` at full width)."""
    from repro_torch.distributed.sharding import (MODEL_HD, MODEL_HEADS,
                                                  placements,
                                                  replicate_plain)
    from repro_torch.models.ssm import MLSTM, mlstm_apply, mlstm_state

    cfg = dryrun.ARCHS["xlstm-350m"].replace(**XLSTM_CUT)
    b, up, H = 64, 512, 4
    hd = up // H
    with process_group("fake", 256):
        mesh = make_production_mesh()
        dmesh = dryrun.cell_mesh(cfg, ShapeCell("d", "decode", 128, b), mesh)
        assert dmesh.mesh_dim_names == ("data", MODEL_HEADS, MODEL_HD)
        blk = MLSTM(cfg, torch.bfloat16, device="meta")
        blk = reshard_state(blk, dmesh, param_specs(cfg, blk, mesh))
        C = distribute_tensor(mlstm_state(cfg, b, device="meta")["C"], dmesh,
                              placements(P("data", MODEL_HEADS, MODEL_HD,
                                           None), dmesh))
        x = distribute_tensor(torch.empty(b, 1, cfg.d_model,
                                          dtype=torch.bfloat16,
                                          device="meta"), dmesh,
                              placements(P("data", None, None), dmesh))
        with replicate_plain(x), _CollectiveLog() as c, torch.no_grad():
            out, st = mlstm_apply(blk, cfg, x, {"C": C}, decode=True)
    assert st["C"].placements == C.placements
    bl = b // 16
    gathers = [s for k, s, _ in c.log if k == "all-gather"]
    assert gathers == [(bl * 4, 1, 1, hd // 4)]        # v, within its head
    reduces = sorted(s for k, s, _ in c.log if k == "all-reduce")
    assert reduces == sorted([(bl, 1, 1, hd + 1), (bl, 1, 1),
                              (bl, 1, cfg.d_model)])


def test_ssd_chunk_loop_runs_on_shards():
    """``ssd_chunked`` on DTensors in the rules' layout (batch over
    `data`, heads over `model`) on a fake 16x16 mesh: no collective at
    any chunk count (2 or 8 chunks), and each device's FLOPs are those of
    the plain function on its own shards."""
    from repro_torch.distributed.sharding import placements, replicate_plain
    from repro_torch.models.ssm import ssd_chunked

    b, h, p, n, L = 32, 32, 16, 16, 32

    def meta(shape):
        return torch.empty(shape, device="meta")

    counts = {}
    with process_group("fake", 256):
        mesh = make_production_mesh()

        def put(shape, *spec):
            return distribute_tensor(meta(shape), mesh,
                                     placements(P(*spec), mesh))

        for nc in (2, 8):
            s = nc * L
            args = (put((b, s, h, p), "data", None, "model", None),
                    put((b, s, h), "data", None, "model"),
                    put((b, s, 1, n), "data", None, None, None),
                    put((b, s, 1, n), "data", None, None, None))
            h0 = put((b, h, n, p), "data", "model", None, None)
            with replicate_plain(args[0]), OpCounter() as c:
                y, state = ssd_chunked(*args, L, h0)
            assert y.placements == (Shard(0), Shard(2))
            assert state.placements == (Shard(0), Shard(1))
            with OpCounter() as plain:
                ssd_chunked(*(meta(t.to_local().shape) for t in args), L,
                            meta(h0.to_local().shape))
            counts[nc] = c.metrics()
            assert counts[nc]["hlo_flops"] == plain.flops
    assert counts[2]["total_weighted_bytes"] == 0
    assert counts[8]["total_weighted_bytes"] == 0
    assert counts[8]["hlo_flops"] == 4 * counts[2]["hlo_flops"]


def test_rmsnorm_keeps_a_feature_sharded_layout():
    """``rmsnorm`` over a DTensor sharded on its features (Mamba2's gated
    norm over d_in, or a residual stream sharded on d) on a fake 16x16
    mesh, forward and backward: the output and the input's gradient keep
    the input's layout, and the only collectives are all-reduces of the
    variance (b, s, 1), one forward and one backward. Left to DTensor, the
    variance's partial sum is reduce-scattered onto the batch and the
    backward gathers the whole input."""
    from repro_torch.distributed.sharding import placements, replicate_plain
    from repro_torch.models.layers import RMSNorm, rmsnorm

    b, s, d = 32, 64, 512
    with process_group("fake", 256):
        mesh = make_production_mesh()
        spec = placements(P("data", None, "model"), mesh)
        x = distribute_tensor(torch.empty((b, s, d), device="meta"), mesh,
                              spec).requires_grad_(True)
        norm = RMSNorm(d, device="meta")
        norm.scale = torch.nn.Parameter(distribute_tensor(
            norm.scale.detach(), mesh, placements(P("model"), mesh)))
        with replicate_plain(x), OpCounter() as c:
            y = rmsnorm(norm, x)
            (gx,) = torch.autograd.grad(y, x, torch.ones_like(y))
        assert y.placements == x.placements == gx.placements
        m = c.metrics()
    var = (b // 16) * s * 4 * 2                     # f32 (b, s, 1), x2
    assert m["all-reduce_count"] == 2
    assert m["total_weighted_bytes"] == m["all-reduce_bytes"] == 2 * var


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_audio_codebooks_reduce_each_lookup(kind, no_kernel):
    """`musicgen-large` cut to 2 layers: each codebook's vocab-parallel
    lookup is all-reduced into the residual stream's layout before the
    sum, as the reference all-reduces the four (one tuple all-reduce).
    Left to DTensor, torch 2.13 reduce-scattered the sum of the four
    partial lookups onto the sequence and gathered it back, torch 2.11
    all-reduced each: the rows' collective bytes moved 1.4-3.4% with the
    release. No reduce-scatter is left; a decode step all-reduces two
    partial sums a layer and the four lookups, and gathers nothing (the
    logits keep the codebooks and the vocab split 4 x 4 over `model`)."""
    cfg = dryrun.ARCHS["musicgen-large"].replace(n_layers=2, d_model=256,
                                                n_heads=16, n_kv_heads=16,
                                                d_head=16, d_ff=512)
    cell = (ShapeCell("t", "train", 64, 64) if kind == "train"
            else ShapeCell("d", "decode", 64, 64))
    with process_group("fake", 256):
        mesh = make_production_mesh()
        row = dryrun.analyze_cell("musicgen-large", cfg, cell, mesh, "single")
    colls = row["collectives"]
    assert row["status"] == "ok"
    assert "reduce-scatter_count" not in colls
    if kind == "decode":
        assert colls["all-reduce_count"] == 2 * cfg.n_layers + cfg.n_codebooks
        assert "all-gather_count" not in colls


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_audio_serving_logits_stay_split_over_codebooks(kind, monkeypatch,
                                                        no_kernel):
    """`musicgen-large` cut to 2 layers, a serving cell on the fake 16x16
    mesh: the (B, S, K*V) unembedding, vocab-parallel over `model`, is
    viewed as (B, S, K, V) with no collective, its 4 codebooks over
    "model_h" and its vocab over "model_d" of a `model` split 4 x 4, and
    the step returns them so: (B / 16, S, 1, V / 4) a device, the layout
    of the reference's ``bf16[2,32768,1,512]`` at full width. The cell's
    collectives are the layers' and the lookups' all-reduces, no
    all-gather (before: the logits gathered to (B / 16, S, K*V))."""
    from repro_torch.models import registry

    cfg = dryrun.ARCHS["musicgen-large"].replace(n_layers=2, d_model=256,
                                                n_heads=16, n_kv_heads=16,
                                                d_head=16, d_ff=512)
    cell = ShapeCell("s", kind, 64, 64)
    seen, logs = [], []
    name = kind if kind == "prefill" else "decode_step"
    real = getattr(registry.Model, name)

    def step(self, *a):
        lg, cache = real(self, *a)
        seen.append((tuple(lg.to_local().shape), lg.device_mesh.mesh_dim_names,
                     tuple(lg.placements)))
        return lg, cache

    def counter():
        logs.append(_CollectiveLog())
        return logs[-1]

    monkeypatch.setattr(registry.Model, name, step)
    monkeypatch.setattr(dryrun, "OpCounter", counter)
    with process_group("fake", 256):
        mesh = make_production_mesh()
        row = dryrun.analyze_cell("musicgen-large", cfg, cell, mesh, "single")
    assert row["status"] == "ok" and no_kernel == []
    S = cell.seq_len if kind == "prefill" else 1
    K, V = cfg.n_codebooks, cfg.vocab_padded
    assert seen == [((cell.global_batch // 16, S, 1, V // 4),
                     ("data", "model_h", "model_d"),
                     (Shard(0), Shard(2), Shard(3)))]
    kinds = {k for k, _, _ in logs[0].log}
    assert kinds == {"all-reduce"}
    assert all(shape[-1] != K * V for _, shape, _ in logs[0].log)


# ---- the serving steps' logits, kv heads that span devices ----
# `internvl2-1b` cut to 2 layers and d_model 128, its 14 query heads and
# 2 kv heads, 16 patches, and a vocab of 1031, which does not divide the
# 16-way `model` axis: the rules shard the tied embedding on d, so the
# residual stream runs on d shards and the logits are partial sums the
# serving steps reduce (F18: they came back pending, and the dry run
# counted no logits all-reduce, 0.09-0.11 of the reference's bytes at
# full width). `qwen2-72b` cut to 2 layers with 32 query heads and 4 kv
# heads on 16 devices: each device projects the one kv head its q heads
# share, and the cache holds the kv heads over "model_h" of a `model`
# split 4 x 4, as the reference's decode step hands it back (each device
# gathered its kv head back into a cache replicated over `model`:
# 0.5621 of the reference's bytes at full width).
VOCAB_CUT = dict(n_layers=2, d_model=128, n_heads=14, n_kv_heads=2,
                 d_head=64, d_ff=256, vocab_size=1031, n_patches=16)
KV_SPLIT_CUT = dict(n_layers=2, d_model=256, n_heads=32, n_kv_heads=4,
                    d_head=16, d_ff=512, vocab_size=1024)
SERVE_CELLS = {
    "odd_vocab_prefill": ("internvl2-1b", VOCAB_CUT,
                          ("prefill_s", "prefill", 64, 32)),
    "odd_vocab_decode": ("internvl2-1b", VOCAB_CUT,
                         ("decode_s", "decode", 128, 64)),
    "kv_split_decode": ("qwen2-72b", KV_SPLIT_CUT,
                        ("decode_s", "decode", 128, 64)),
}
# Collective bytes over the reference's, from the op-by-op lists of
# ``scripts/dryrun_collectives.py``: the same all-reduces and gathers,
# bf16 against the reference's f32. Measured 0.5007 (both odd-vocab
# cells, both meshes: the f32 variance all-reduces of the norms equal
# the reference's) and 0.5000 (the kv-split cell). Before, 0.3977 and
# 0.3289 (odd-vocab prefill and decode: no logits all-reduce, the MLP's
# partial sums reduce-scattered, k and v reduced twice in prefill) and
# 0.7000 (kv split: each kv head gathered into the cache).
SERVE_COLL_BAND = (0.45, 0.55)


@pytest.fixture(scope="module")
def serve_reference():
    """The reference's rows of every ``SERVE_CELLS`` cell on both meshes,
    in one subprocess."""
    keys = [(name, m) for name in SERVE_CELLS for m in ("single", "multi")]
    rows = _reference_rows([[SERVE_CELLS[n][0], SERVE_CELLS[n][1],
                             SERVE_CELLS[n][2], m] for n, m in keys])
    return dict(zip(keys, rows))


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("name", list(SERVE_CELLS))
def test_serving_cells_match_the_reference(serve_reference, name, mesh_name,
                                           no_kernel):
    """Prefill and decode with a vocab that does not divide `model`, and
    decode with kv heads that do not: per-device FLOPs equal the
    reference's ``analyze_cell`` on the same config, cell and mesh, and
    collective bytes lie in ``SERVE_COLL_BAND`` of its."""
    arch, kw, cell = SERVE_CELLS[name]
    ref_flops, ref_coll = serve_reference[(name, mesh_name)]
    row = _port_row(arch, kw, cell, mesh_name)
    assert row["status"] == "ok" and no_kernel == []
    assert row["flops_per_device"] == pytest.approx(ref_flops, rel=FLOP_RTOL)
    lo, hi = SERVE_COLL_BAND
    assert lo <= row["collective_bytes_per_device"] / ref_coll <= hi


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_logits_come_back_reduced(kind, monkeypatch, no_kernel):
    """The odd-vocab cut cell on the fake 16x16 mesh: the logits the
    serving step returns are no pending partial sum (batch shards over
    `data`, whole over `model`, as the reference's step returns them:
    ``bf16[8,1,151655]`` a device at full width), and the step's
    collectives hold their all-reduce (B / 16, S, V)."""
    from repro_torch.models import registry

    cfg = dryrun.ARCHS["internvl2-1b"].replace(**VOCAB_CUT)
    cell = ShapeCell(*SERVE_CELLS[f"odd_vocab_{kind}"][2])
    seen, logs = [], []
    real = getattr(registry.Model, kind if kind == "prefill"
                   else "decode_step")

    def step(self, *a):
        lg, cache = real(self, *a)
        seen.append(tuple(lg.placements))
        return lg, cache

    def counter():
        logs.append(_CollectiveLog())
        return logs[-1]

    monkeypatch.setattr(registry.Model, kind if kind == "prefill"
                        else "decode_step", step)
    monkeypatch.setattr(dryrun, "OpCounter", counter)
    with process_group("fake", 256):
        mesh = make_production_mesh()
        row = dryrun.analyze_cell("internvl2-1b", cfg, cell, mesh, "single")
    assert row["status"] == "ok" and no_kernel == []
    assert seen == [(Shard(0), Replicate())]
    S = cell.seq_len if kind == "prefill" else 1
    want = (cell.global_batch // 16, S, cfg.vocab_size)
    assert ("all-reduce", want, 2 * math.prod(want)) in logs[0].log
