"""Sharding rules: DP over (`pod`,`data`), TP/EP over `model`.

Port of the reference package's ``distributed/sharding.py``. Every rule
checks divisibility against the mesh axis size and falls back
(alternate dim, then replicate), so non-divisible cases (qwen3's 40
heads or minicpm's 122753 vocab on a 16-way axis) degrade instead of
failing. The fallbacks taken are queryable (``explain_params``) and
recorded in the dry-run report.

A spec is a ``P``: one entry per tensor dim, each None, an axis name or
a tuple of axis names, as the reference's ``PartitionSpec``.
``placements`` turns a spec into DTensor placements on a
``DeviceMesh``. The rules read axis sizes from a ``DeviceMesh`` or from
a plain ``{axis: size}`` mapping, so a 16x16 rule can be checked with
no process group.

The port's parameters are per-layer modules with no stacked leading
axes. A parameter's spec is its reference leaf's spec without those
axes: the rule is applied to the reference leaf's shape (the stacked
axes are never sharded) and the stacked entries are dropped.

Only params, inputs and caches are placed; intermediate layouts are
left to DTensor's propagation, apart from the ``maybe_constrain`` sites
the models share with the reference.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Mapping, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeCell

MODEL_AX = "model"

MeshLike = Union[DeviceMesh, Mapping[str, int]]


class P(tuple):
    """Per-tensor-dim spec of mesh axis names: the reference's
    ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, DeviceMesh):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh)


def mesh_axes(mesh: DeviceMesh) -> Tuple[Tuple[str, ...], ...]:
    """The mesh axes each dim of a ``DeviceMesh`` carries: a dim whose
    name joins axis names with "_" (torch's name for flattened dims, as
    in ``launch.mesh.dtensor_mesh``'s "pod_data") carries each of them."""
    return tuple(tuple(n.split("_")) for n in mesh.mesh_dim_names)


def dp_axes(mesh: MeshLike):
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return axes if len(axes) > 1 else axes[0]


def _div(n: int, k: int) -> bool:
    return n % k == 0


def _entry_axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


# ----------------------------------------------------------------------
def _param_rule(cfg: ModelConfig, name: str, shape: Tuple[int, ...],
                M: int) -> P:
    """The reference's rule for one leaf, by its last key ``name`` and
    its (stacked) reference shape."""
    heads_ok = _div(cfg.n_heads, M)
    kv_ok = _div(cfg.n_kv_heads, M)
    nd = len(shape)

    # stacked-layer leading dims (L,) / (reps, k) are never sharded.
    def col(last_ok: bool) -> P:
        """shard last dim on model (col-parallel) w/ fallbacks."""
        spec = [None] * nd
        if last_ok and _div(shape[-1], M):
            spec[-1] = MODEL_AX
        return P(*spec)

    def row() -> P:
        spec = [None] * nd
        if _div(shape[-2], M):
            spec[-2] = MODEL_AX
        return P(*spec)

    # ---- embeddings / unembeddings ----
    if name == "embed":
        spec = [None] * nd
        if _div(shape[-2], M):          # vocab
            spec[-2] = MODEL_AX
        elif _div(shape[-1], M):        # d_model fallback
            spec[-1] = MODEL_AX
        return P(*spec)
    if name == "lm_head":
        spec = [None] * nd
        if _div(shape[-1], M):
            spec[-1] = MODEL_AX
        elif _div(shape[-2], M):
            spec[-2] = MODEL_AX
        return P(*spec)

    # ---- attention ----
    if cfg.xlstm_pattern and name in ("wq", "wk", "wv"):
        # mLSTM q/k/v: 4 heads never divide the model axis; shard the
        # contraction/feature dim instead.
        return col(True)
    if name == "wq":
        return col(heads_ok)
    if name in ("wk", "wv"):
        return col(kv_ok)
    if name == "wo":
        sp = [None] * nd
        if heads_ok and _div(shape[-2], M):
            sp[-2] = MODEL_AX
        return P(*sp)
    if name == "bq":
        return col(heads_ok)
    if name in ("bk", "bv"):
        return col(kv_ok)

    # ---- MoE experts: leading (L, E, ...) ----
    if name in ("w_gate", "w_up", "w_down") and nd >= 4:
        expert_mode = cfg.moe_shard == "expert" and _div(cfg.n_experts, M)
        sp = [None] * nd
        if expert_mode:
            sp[-3] = MODEL_AX            # E dim
        elif name in ("w_gate", "w_up") and _div(shape[-1], M):
            sp[-1] = MODEL_AX            # ffn cols
        elif name == "w_down" and _div(shape[-2], M):
            sp[-2] = MODEL_AX            # ffn rows
        return P(*sp)

    # ---- dense / shared-expert MLP ----
    if name in ("w_gate", "w_up"):
        return col(True)
    if name == "w_down":
        return row()

    # ---- mamba2 ----
    if name in ("w_z", "w_x"):
        return col(True)
    if name == "out_proj":
        return row()
    if name in ("conv_w", "conv_b") and cfg.family in ("ssm", "hybrid"):
        return col(True)
    if name in ("A_log", "D", "dt_bias"):
        return col(_div(cfg.ssm_heads or 1, M))
    if name == "gate_norm":
        return col(True)

    # ---- xLSTM ----
    if name == "w_gates":               # sLSTM (up, 4up): aligned splits
        return col(_div(shape[-1], 4 * M))
    # mLSTM w_up (d, 2up): z/u split aligns iff up % shard == 0
    # (unreachable: w_up matches the dense MLP rule above, as in the
    # reference)
    if name == "w_up" and cfg.xlstm_pattern:
        return col(_div(shape[-1], 2 * M))

    # everything else (norms, router, small gates): replicate
    return P(*([None] * nd))


def param_specs(cfg: ModelConfig, params: nn.Module, mesh: MeshLike
                ) -> Dict[str, P]:
    """{parameter name: spec} of a params module (``Model.init``'s; a
    ``FakeTensorMode`` init allocates nothing). Each spec is the
    reference leaf's spec without the leaf's stacked leading axes."""
    from repro_torch.convert import _reference_key   # convert imports models

    M = mesh_shape(mesh)[MODEL_AX]
    out: Dict[str, P] = {}
    for name, t in params.named_parameters():
        key, idx = _reference_key(params, name)
        ref_shape = (1,) * len(idx) + tuple(t.shape)
        spec = _param_rule(cfg, key.rpartition(".")[2], ref_shape, M)
        if any(e is not None for e in spec[:len(idx)]):
            raise AssertionError(f"{name}: a stacked axis is sharded {spec}")
        out[name] = P(*spec[len(idx):])
    return out


def explain_params(cfg: ModelConfig, params: nn.Module, mesh: MeshLike
                   ) -> Dict[str, str]:
    """Human-readable {param_path: spec}, used in the dry-run report."""
    specs = param_specs(cfg, params, mesh)
    return {name.replace(".", "/"): f"{tuple(t.shape)} -> {specs[name]}"
            for name, t in params.named_parameters()}


# ----------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, kind: str, mesh: MeshLike) -> Dict[str, P]:
    dp = dp_axes(mesh)
    toks = P(dp, None, None) if cfg.family == "audio" else P(dp, None)
    d: Dict[str, P] = {"tokens": toks}
    if kind == "train":
        d["targets"] = toks
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        d["patch_embeds"] = P(dp, None, None)
    if kind == "decode":
        d["cache_index"] = P()
    return d


def _map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists: a dict
    entry's key in the path is its name, a sequence entry's its index."""
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_specs(cfg: ModelConfig, cell: ShapeCell, mesh: MeshLike, cache,
                kv_hd_shard: bool = False):
    """Specs for the KV-cache / recurrent-state tree (``Model.init_cache``'s
    tensors, or anything with their ``shape``s), in its structure.

    decode_32k: batch over DP, kv-heads over model (when divisible).
    long_500k (batch=1): SEQUENCE over `data` (KV) and SSM heads over
    `model`, the sub-quadratic long-context layout.
    ``kv_hd_shard``: when the kv-head count doesn't divide the model
    axis (GQA kv=8 on 16 shards), shard the HEAD-DIM channels instead
    (128/16=8); attention contracts hd, so a small reduction is added
    but the cache bytes per device drop 16x.
    """
    shape_of = mesh_shape(mesh)
    M = shape_of[MODEL_AX]
    dp = dp_axes(mesh)
    batch_shardable = _div(cell.global_batch, math.prod(
        shape_of[a] for a in _entry_axes(dp)))
    kv_ok = _div(cfg.n_kv_heads, M)
    ssm_heads_ok = _div(cfg.ssm_heads or 1, M)

    def spec(keys, leaf) -> P:
        # a sequence entry has no name (the reference's SequenceKey)
        name = keys[-1] if keys and isinstance(keys[-1], str) else ""
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name in ("kv_k", "kv_v") or nd == 5 and "mamba" not in keys:
            # attention KV: (L|n_attn, B, S, kv, hd)
            sp = [None] * nd
            if batch_shardable:
                sp[1] = dp
            elif _div(shape[2], 16) and cell.global_batch == 1:
                sp[2] = "data"               # sequence-sharded cache
            if kv_ok:
                sp[3] = MODEL_AX
            elif kv_hd_shard and _div(shape[4], M):
                sp[4] = MODEL_AX
            return P(*sp)
        if name == "ssm":
            # (L, B, nh, st, hd)
            sp = [None] * nd
            if batch_shardable:
                sp[1] = dp
            if ssm_heads_ok:
                sp[2] = MODEL_AX
            return P(*sp)
        if name in ("conv", "conv_bc"):
            sp = [None] * nd
            if batch_shardable:
                sp[1] = dp
            if name == "conv" and _div(shape[-1], M):
                sp[-1] = MODEL_AX
            return P(*sp)
        if name == "C":                      # mLSTM matrix memory
            sp = [None] * nd
            if batch_shardable:
                sp[2] = dp
            return P(*sp)
        if name in ("c", "n", "h"):          # sLSTM
            sp = [None] * nd
            if batch_shardable:
                sp[2] = dp
            return P(*sp)
        # plain transformer tuple-cache leaves: (L, B, S, kv, hd)
        sp = [None] * nd
        if nd == 5:
            if batch_shardable:
                sp[1] = dp
            elif _div(shape[2], 16) and cell.global_batch == 1:
                sp[2] = "data"
            if kv_ok:
                sp[3] = MODEL_AX
        return P(*sp)

    return _map_with_path(spec, cache)


def state_specs(cfg: ModelConfig, mesh: MeshLike, param_spec_tree):
    """Train state = {params, m, v, step}: moments follow params."""
    return {
        "params": param_spec_tree,
        "m": param_spec_tree,
        "v": param_spec_tree,
        "step": P(),
    }


def sanitize_spec(shape: Tuple[int, ...], spec: P, mesh: MeshLike) -> P:
    """Drop spec entries whose mesh-axis product doesn't divide the
    dim: the last-resort guard, so no input is sharded unevenly."""
    sizes = mesh_shape(mesh)
    out = []
    for i, entry in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        k = math.prod(sizes[a] for a in _entry_axes(entry))
        out.append(entry if shape[i] % k == 0 else None)
    return P(*out)


# ----------------------------------------------------------------------
def placements(spec: P, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim, in
    mesh order, ``Shard(i)`` for the tensor dim whose entry names (one
    of) its axes, else ``Replicate()`` (and on a mesh dim of size 1). An
    entry ("pod", "data") on dim 0 gives ``Shard(0)`` on both mesh dims,
    pod's split outermost as in the reference, or on the one flattened
    "pod_data" dim."""
    out = []
    for size, axes in zip(mesh.shape, mesh_axes(mesh)):
        dims = [i for i, e in enumerate(spec)
                if e is not None and set(axes) & set(_entry_axes(e))]
        if len(dims) > 1:
            raise ValueError(f"axis {axes!r} shards two dims in {spec}")
        # one shard is the whole tensor: replicated, which DTensor takes
        # through every op (a size-1 Shard can trip its view rules)
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def named(mesh: DeviceMesh, tree):
    """The placements of every spec of a spec tree."""
    return _map_with_path(lambda _, s: placements(s, mesh), tree)


def sanitize_tree(shapes_tree, spec_tree, mesh: MeshLike):
    """The spec tree of ``shapes_tree`` (tensors, or anything with a
    ``shape``), each spec sanitized against its leaf's shape. The two
    trees have one structure."""
    specs = {}
    _map_with_path(lambda path, s: specs.__setitem__(path, s), spec_tree)
    return _map_with_path(
        lambda path, t: sanitize_spec(tuple(t.shape), specs[path], mesh),
        shapes_tree)


def shardings_for(shapes_tree, spec_tree, mesh: DeviceMesh):
    """Zip a tree of tensors (or shapes' holders) with a spec tree of the
    same structure into placements, sanitizing non-divisible entries."""
    return named(mesh, sanitize_tree(shapes_tree, spec_tree, mesh))


def maybe_constrain(x, *entries):
    """Identity on a plain tensor. On a DTensor whose mesh has the named
    axes, redistribute it to the spec of ``entries`` (axes the mesh
    lacks are dropped, as in the reference), so layers can call it
    unconditionally; single-device paths are unaffected."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = {a for axes in mesh_axes(mesh) for a in axes}
    cleaned = []
    for e in entries:
        axes = tuple(a for a in _entry_axes(e) if a in names) if e else ()
        cleaned.append(None if not axes else
                       axes[0] if len(axes) == 1 else axes)
    want = placements(P(*cleaned), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _gathered_for(x: DTensor, shape) -> DTensor:
    """x with each sharded dim gathered that reshaping to ``shape`` would
    split or merge in a way DTensor refuses (see ``reshape``)."""
    old, new = tuple(x.shape), torch.Size(shape)
    if -1 in new:
        new = torch.empty(old, device="meta").reshape(new).shape
    n_of: Dict[int, int] = {}
    for mdim, p in enumerate(x.placements):
        if isinstance(p, Shard):
            n_of[p.dim] = n_of.get(p.dim, 1) * x.device_mesh.size(mdim)
    gather = set()
    i = k = 0
    while i < len(old) or k < len(new):     # segments of equal products
        i0, k0 = i, k
        a = old[i] if i < len(old) else 1
        b = new[k] if k < len(new) else 1
        i, k = i + 1, k + 1
        while a != b:
            if a < b:
                a, i = a * old[i], i + 1
            else:
                b, k = b * new[k], k + 1
        seg = [d for d in range(i0, min(i, len(old))) if d in n_of]
        if not seg or (i - i0 == 1 and k - k0 == 1):
            continue
        n = n_of[i0] if seg == [i0] else 0
        ok = n and old[i0] % n == 0 and (
            (i - i0 == 1 and new[k0] % n == 0) or k - k0 == 1)
        if not ok:
            gather.update(seg)
    if gather:
        pl = [Replicate() if isinstance(p, Shard) and p.dim in gather else p
              for p in x.placements]
        x = x.redistribute(x.device_mesh, pl)
    return x


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward reshapes the gradient back with
    the same guard (the gradient arrives with its own placements)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.old = tuple(x.shape)
        return _gathered_for(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _gathered_for(g, ctx.old).reshape(ctx.old), None


def reshape(x, *shape):
    """``x.reshape(shape)``. A DTensor first gathers each sharded dim the
    reshape would split or merge in a way DTensor refuses (GSPMD pads
    instead): a split keeps the shards only on its outermost new dim and
    a merge only from its outermost old dim, each when the shard count
    divides it. So the batch's and the heads' shards survive wherever the
    counts divide, and the reshape runs wherever they do not; the
    backward takes the same guard."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, torch.Size(shape))


def einsum(equation: str, *operands):
    """``torch.einsum``. Where DTensor cannot flatten the batch dims of
    sharded operands (an older DTensor refuses to merge a sharded dim
    that is not the outermost, as the batch and kv-head dims of a GQA
    einsum are), the operands' shards over `model` are gathered and the
    einsum runs again with the data-parallel shards alone."""
    try:
        return torch.einsum(equation, *operands)
    except RuntimeError as e:
        if "flatten" not in str(e) or not any(
                isinstance(t, DTensor) for t in operands):
            raise
    out = []
    for t in operands:
        if isinstance(t, DTensor):
            pl = [p if {"pod", "data"} & set(axes) else Replicate()
                  for p, axes in zip(t.placements, mesh_axes(t.device_mesh))]
            t = t.redistribute(t.device_mesh, pl)
        out.append(t)
    return torch.einsum(equation, *out)


def embed(table, tokens):
    """``table[tokens]``, the rows of an embedding table. A sharded
    table is gathered whole first and read through ``F.embedding`` (its
    gradient goes back to the table's shards as a reduction): DTensor's
    masked lookup of a vocab-sharded table, and the backward of an
    indexed read, carry placements its redistribution refuses."""
    if isinstance(table, DTensor):
        table = maybe_constrain(table, *([None] * table.dim()))
        return torch.nn.functional.embedding(tokens, table)
    return table[tokens]


def pin_batch(x):
    """``maybe_constrain`` to batch shards over (`pod`, `data`) and every
    other dim whole: where the models pin the residual stream after the
    embedding. DTensor propagates layouts op by op, with no global pass
    like GSPMD's, and left alone it keeps a vocab-sharded table's lookup
    sharded on d_model and spreads that through every layer."""
    return maybe_constrain(x, ("pod", "data"), *([None] * (x.dim() - 1)))


def sharded(t) -> bool:
    """Whether a tensor, or the first parameter of a module, is a
    DTensor."""
    if isinstance(t, nn.Module):
        t = next(t.parameters(), None)
    return isinstance(t, DTensor)


# Depth of nested ``replicate_plain`` blocks: ``implicit_replication()``
# switches DTensor's one process-wide flag on and, on exit, off, so only
# the outermost block may enter it.
_replicating = [0]


@contextlib.contextmanager
def replicate_plain(params) -> Iterator[None]:
    """``implicit_replication()`` when ``params`` (a module or a tensor)
    is sharded, so the plain tensors a forward makes (positions, masks,
    RoPE tables, scan states) join DTensor ops as replicated; nothing
    otherwise, so the unsharded path runs as it did. Reentrant, unlike
    ``implicit_replication()``, whose exit would switch it off for an
    outer block too (a train step's backward recomputes remat'ed layers
    after the forward's block has closed)."""
    if _replicating[0] or not sharded(params):
        yield
        return
    _replicating[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _replicating[0] -= 1
