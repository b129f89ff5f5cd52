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

The rules place params, inputs and caches; GSPMD spreads their layouts
through a whole program, while DTensor picks each op's layout on its
own, and a split costs it nothing, so it may shard a dim the rules
replicate and gather it later (for the whole SSD chunk loop). So the
models state the layouts the rules imply: the residual stream after
the embedding, each residual add and each layer (``pin_residual``,
``residual_add``), the logits (``pin_vocab``), and the blocks that run
on each device's shards (``on_shards``: attention, the SSD chunk loop,
the sLSTM scan, the embedding lookup, a decode step's attention over a
cache sharded on its sequence, ``seq_on_shards``). A pin holds a
gradient to the same layout, as GSPMD lays out a cotangent like its
primal. Heads that span several devices of `model` (xLSTM's 4 on 16)
take a mesh whose `model` is split over them (``MODEL_HEADS`` x
``MODEL_HD``, ``split_heads``), where GSPMD splits one dim two ways.
On plain tensors every one of them is the plain op.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Dict, Iterator, Mapping, Tuple, Union

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeCell

MODEL_AX = "model"
# the two dims of a `model` split over an mLSTM's heads
# (``launch.mesh.dtensor_mesh(..., model_heads=H)``): the heads, outer,
# and each head's slice of its dims
MODEL_HEADS, MODEL_HD = "model_h", "model_d"

MeshLike = Union[DeviceMesh, Mapping[str, int]]


class P(tuple):
    """Per-tensor-dim spec of mesh axis names: the reference's
    ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping; a `model`
    split over heads counts as one `model` axis too."""
    if isinstance(mesh, DeviceMesh):
        out = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
        if splits_model(mesh):
            out[MODEL_AX] = out[MODEL_HEADS] * out[MODEL_HD]
        return out
    return dict(mesh)


def mesh_axes(mesh: DeviceMesh) -> Tuple[Tuple[str, ...], ...]:
    """The mesh axes each dim of a ``DeviceMesh`` carries: a dim whose
    name joins axis names with "_" (torch's name for flattened dims, as
    in ``launch.mesh.dtensor_mesh``'s "pod_data") carries each of them,
    and its own name, which names that dim alone (a split `model`'s
    ``MODEL_HEADS`` and ``MODEL_HD`` each carry `model`)."""
    return tuple(tuple(n.split("_")) + ((n,) if "_" in n else ())
                 for n in mesh.mesh_dim_names)


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


def carried_specs(spec_tree, mesh: DeviceMesh):
    """``cache_specs``' tree (sanitized) as the port carries a cache or
    state between steps on ``mesh``, where its blocks leave it and where
    the reference's step hands it back: the sLSTM's c, n and h (..., B,
    up) on their units over `model` (``ssm._slstm_on_units``); where
    ``mesh`` splits `model` over the mLSTM's heads, its matrix memory C
    (..., B, H, n, p) on (head, n) shards (``ssm._on_head_shards``); and
    where it splits `model` over a transformer's kv heads
    (``kv_heads_split``), the KV cache (L, B, S, kv, hd) with its heads
    over ``MODEL_HEADS``. The reference's step takes them replicated
    over `model` (``cache_specs``) and slices each device's shard for
    free; a state written in place keeps one layout, and a replicated
    one would be gathered whole at every write. Every other leaf keeps
    its spec."""
    M = model_rank(mesh)[1]

    def spec(keys, s: P) -> P:
        name = keys[-1] if keys else None
        if name == "C" and splits_model(mesh):
            return P(*s[:-3], MODEL_HEADS, MODEL_HD, None)
        if name in ("c", "n", "h") and M > 1:
            return P(*s[:-1], MODEL_AX)
        if isinstance(name, int) and len(s) == 5 and s[3] is None \
                and splits_model(mesh):
            return P(*s[:3], MODEL_HEADS, None)
        return s

    return _map_with_path(spec, spec_tree)


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


def _on_mesh(mesh: DeviceMesh, entries) -> tuple:
    """The placements of the spec ``entries`` on ``mesh``, the axes the
    mesh lacks dropped (as the reference's ``maybe_constrain`` drops
    them)."""
    names = {a for axes in mesh_axes(mesh) for a in axes}
    cleaned = []
    for e in entries:
        axes = tuple(a for a in _entry_axes(e) if a in names) if e else ()
        cleaned.append(None if not axes else
                       axes[0] if len(axes) == 1 else axes)
    return placements(P(*cleaned), mesh)


class _Constrain(torch.autograd.Function):
    """A DTensor brought to placements ``want``, and its gradient too: a
    sharding constraint pins the cotangent as well (its transpose in
    JAX is the same constraint). Where x was a partial sum, its gradient
    comes back whole on that mesh dim, as GSPMD transposes the reduction
    (a row-parallel product's output gradient is gathered, so its input
    and weight gradients run on each device's shards)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = tuple(Replicate() if isinstance(p, Partial) else w
                         for p, w in zip(x.placements, want))
        if tuple(x.placements) == want:
            return x.view_as(x)
        return redistribute(x, want)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.want:
            g = redistribute(g, ctx.want)
        return g, None


def redistribute(x: DTensor, want: tuple) -> DTensor:
    """``x`` brought to placements ``want``. A partial sum bound for
    shards of the same mesh dim is all-reduced and then sliced, as XLA's
    partitioner lowers it on the CPU (the reference's programs hold no
    reduce-scatter): DTensor would reduce-scatter it, which the op
    counters weigh by its result, a 1/M shard, where the reference's
    all-reduce weighs twice the whole."""
    via = tuple(Replicate() if isinstance(p, Partial) and isinstance(w, Shard)
                else w for p, w in zip(x.placements, want))
    if via != want:
        x = x.redistribute(x.device_mesh, via)
    return x.redistribute(x.device_mesh, want)


def maybe_constrain(x, *entries):
    """Identity on a plain tensor. On a DTensor whose mesh has the named
    axes, redistribute it, and in a backward its gradient, to the spec
    of ``entries`` (axes the mesh lacks are dropped, as in the
    reference), so layers can call it unconditionally; single-device
    paths are unaffected. An entry whose shards do not divide its dim is
    dropped (``fit``), as ``sanitize_spec`` drops it from an input: a
    batch of 1 stays whole, where DTensor would shard it unevenly and
    gather its padded shards back."""
    if not isinstance(x, DTensor):
        return x
    entries = [fit(x, i, e) for i, e in enumerate(entries)]
    return _pin(x, _on_mesh(x.device_mesh, entries))


def _pin(x: DTensor, want: tuple) -> DTensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, want)
    if tuple(x.placements) == want:
        return x
    return redistribute(x, want)


def residual_add(x, y):
    """``x + y``, a residual add. On DTensors y is first brought to x's
    layout (a partial y is all-reduced, as GSPMD reduces it; DTensor
    would reduce-scatter it onto the sequence and carry that layout
    into the next block), and so is its gradient."""
    if isinstance(x, DTensor) and isinstance(y, DTensor):
        y = _pin(y, tuple(x.placements))
    return x + y


def reduced_like(v, x):
    """``v``, a reduction of ``x`` over its last dim (kept, of size 1),
    brought to x's layout with that dim whole, and its gradient too: a
    partial sum is all-reduced, as GSPMD reduces it (a norm's variance);
    DTensor would reduce-scatter it onto another dim and carry that
    layout into the normalized output and its backward."""
    if not (isinstance(v, DTensor) and isinstance(x, DTensor)):
        return v
    last = x.dim() - 1
    return _pin(v, tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                         else p for p in x.placements))


def model_rank(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this device's rank along `model`, the size of `model`): over
    every mesh dim carrying it, the first outermost (a split `model`'s
    ``MODEL_HEADS`` and ``MODEL_HD``); (0, 1) on a mesh without it."""
    r, n = 0, 1
    for i, axes in enumerate(mesh_axes(mesh)):
        if MODEL_AX in axes:
            r, n = r * mesh.size(i) + mesh.get_local_rank(i), n * mesh.size(i)
    return r, n


def splits_model(mesh: DeviceMesh) -> bool:
    """Whether ``mesh`` splits `model` into ``MODEL_HEADS`` and
    ``MODEL_HD``."""
    return MODEL_HD in mesh.mesh_dim_names


def model_group(mesh: DeviceMesh):
    """The group of a collective over the whole of `model` on ``mesh``, as
    the functional collectives take it: its `model` dim, or the flattened
    one that ``launch.mesh.split_model`` keeps for a split `model`."""
    if MODEL_AX in mesh.mesh_dim_names:
        return (mesh, mesh.mesh_dim_names.index(MODEL_AX))
    return _FLAT_MODEL[mesh]


# A split mesh's flattened `model` dim, kept as torch asks (slicing it
# from the root mesh by name is deprecated)
_FLAT_MODEL: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def keep_model_group(mesh: DeviceMesh, flat: DeviceMesh) -> None:
    """Record ``flat``, ``mesh``'s `model` flattened to one dim."""
    _FLAT_MODEL[mesh] = flat


def _partial(pl, mesh: DeviceMesh, entry) -> tuple:
    """``pl`` with each replicated mesh dim of more than one device that
    carries an axis of ``entry`` made a partial sum."""
    over = set(_entry_axes(entry))
    return tuple(Partial() if isinstance(p, Replicate) and over & set(axes)
                 and size > 1 else p
                 for p, axes, size in zip(pl, mesh_axes(mesh), mesh.shape))


def fit(x: DTensor, dim: int, entry):
    """``entry`` if the shards it makes on ``x``'s mesh divide ``x``'s
    dim ``dim``, else None: ``sanitize_spec`` for one entry."""
    if not entry:
        return None
    names = set(_entry_axes(entry))
    n = math.prod(s for s, axes in zip(x.device_mesh.shape,
                                       mesh_axes(x.device_mesh))
                  if names & set(axes))
    return entry if x.shape[dim] % n == 0 else None


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a local gradient
    handed back to DTensor (a transposed one from a matmul's backward)
    must take the views DTensor's later ops put on it."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_shards(fn, args, specs, out_specs, partial_grads=None,
              partial_out=False):
    """``fn(*args)`` on each device's shards: the port's ``shard_map``.

    Each DTensor of ``args`` is brought to its spec in ``specs`` (entries
    as ``maybe_constrain`` takes them) and handed to ``fn`` as its local
    tensor; plain arguments join as replicated. ``fn`` returns a tensor,
    or a tuple when ``out_specs`` is a list, and each comes back as a
    DTensor of its spec. ``partial_grads``: {argument index: an entry of
    mesh axes} for arguments replicated there whose local gradients are
    partial sums there, because each device reads another part of them
    (another kv head, another batch shard). ``partial_out``: the outputs
    are partial sums over `model` (each device adds its part); or, with
    a list of outputs, a list of an entry for each (None: not partial).

    DTensor propagates layouts op by op and may shard a replicated dim
    on the way (a split costs no communication), where GSPMD keeps the
    layout its constraints give. A block run on its shards keeps the
    layout its specs state, and no collective runs inside it."""
    lead = next((a for a in args if isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*args)
    mesh = lead.device_mesh
    local = []
    for i, (a, spec) in enumerate(zip(args, specs)):
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) and any(
                spec):
            # a plain tensor joins as replicated (``replicate_plain``)
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim)
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        a = maybe_constrain(a, *spec)
        grad = None
        if i in (partial_grads or {}):
            grad = _partial(a.placements, mesh, partial_grads[i])
        local.append(_ContiguousGrad.apply(a.to_local(grad_placements=grad)))

    def wrap(o, spec, over):
        pl = _on_mesh(mesh, spec)
        if over:
            pl = _partial(pl, mesh, over)
        return DTensor.from_local(o, mesh, pl)

    out = fn(*local)
    whole = MODEL_AX if partial_out is True else None
    if not isinstance(out_specs, list):
        return wrap(out, out_specs, whole)
    overs = partial_out if isinstance(partial_out, list) else \
        [whole] * len(out_specs)
    return tuple(wrap(o, s, w) for o, s, w in zip(out, out_specs, overs))


def gqa_on_shards(attn, q, k, v, *rest):
    """``attn(q, k, v, *rest)``, an attention over q (B, S, H, hd) and
    k, v (B, T, Hkv, hd), on each device's shards in the layout the
    rules give: the batch over (`pod`, `data`), and the heads over
    `model` where their count divides it, else replicated there, as the
    reference's attention runs under GSPMD (``wq``, ``wk`` and ``wv``
    are column-parallel only where the heads divide). Where q's heads
    divide `model` and the kv heads do not, each device takes the one
    kv head its q heads share. Identity on plain tensors. A cache
    sharded on its sequence takes ``seq_on_shards``; one sharded on its
    head dim (the ``kv_shard_hd`` option) is left to DTensor's
    propagation."""
    if not isinstance(q, DTensor) or any(
            isinstance(p, Shard) and p.dim not in (0, 2)
            for p in k.placements):
        return attn(q, k, v, *rest)
    dp = fit(q, 0, ("pod", "data"))
    (spec_q, spec_kv), fn, partial = _heads_on_shards(attn, q, k, dp)
    return on_shards(fn, (q, k, v) + rest,
                     (spec_q, spec_kv, spec_kv) + (P(),) * len(rest),
                     spec_q, partial)


def _heads_on_shards(attn, q, k, dp):
    """((q's spec, k's and v's), ``attn`` on a device's heads, partial
    gradients) of an attention over q (B, S, H, hd) and k, v (B, T, Hkv,
    hd) whose heads the rules shard over `model` where their count
    divides it (``gqa_on_shards``); the kv heads' specs leave dim 1
    whole."""
    hq, hk = fit(q, 2, MODEL_AX), fit(k, 2, MODEL_AX)
    H, Hkv = q.shape[2], k.shape[2]
    g = H // Hkv
    r, M = model_rank(q.device_mesh)
    n_loc = H // M if hq else H
    if hq and not hk and _on_kv_split(k):
        # a cache holding its kv heads over ``MODEL_HEADS``: each device's
        # slice is the one kv head its q heads share
        spec_kv = P(dp, None, MODEL_HEADS, None)
        return ((P(dp, None, hq, None), spec_kv), attn,
                {1: MODEL_HD, 2: MODEL_HD})
    if hq and not hk and g % n_loc:
        hq = None                 # a device's q heads span two kv heads
    fn, partial = attn, None
    if hq and not hk:
        lo = r * n_loc // g

        def fn(q_l, k_l, v_l, *rest):
            return attn(q_l, k_l[:, :, lo:lo + 1], v_l[:, :, lo:lo + 1], *rest)

        partial = {1: MODEL_AX, 2: MODEL_AX}
    return (P(dp, None, hq, None), P(dp, None, hk, None)), fn, partial


def _on_kv_split(k) -> bool:
    """Whether ``k`` (B, T, Hkv, hd) holds its kv heads over
    ``MODEL_HEADS`` (``kv_whole`` on a mesh split over them)."""
    if not (isinstance(k, DTensor) and splits_model(k.device_mesh)):
        return False
    i = k.device_mesh.mesh_dim_names.index(MODEL_HEADS)
    p = k.placements[i]
    return isinstance(p, Shard) and p.dim == 2


def seq_sharded(cache) -> bool:
    """Whether ``cache`` (B, T, ...) is a DTensor sharded on its sequence
    (a batch-1 cell's KV cache, ``cache_specs``)."""
    return isinstance(cache, DTensor) and any(
        isinstance(p, Shard) and p.dim == 1 for p in cache.placements)


def _seq_slice(cache: DTensor) -> Tuple[int, int, Tuple[int, ...]]:
    """(first position, positions) of this device's slice of ``cache``'s
    sequence (dim 1), and the mesh dims that shard it (the first
    outermost, as DTensor lays them out)."""
    mesh, idx, n = cache.device_mesh, 0, 1
    dims = tuple(i for i, p in enumerate(cache.placements)
                 if isinstance(p, Shard) and p.dim == 1)
    for i in dims:
        idx, n = idx * mesh.size(i) + mesh.get_local_rank(i), n * mesh.size(i)
    if cache.shape[1] % n:
        raise ValueError(f"{n} shards do not divide the sequence "
                         f"{cache.shape[1]}")
    T = cache.shape[1] // n
    return idx * T, T, dims


def write_at(cache, index: int, value) -> None:
    """``cache[:, index:index + 1] = value``, in place: a decode step's
    new key or value (B, 1, ...) into its cache (B, T, ...). A cache
    sharded on its sequence is written on the device whose slice holds
    ``index``, and nowhere else, as XLA's dynamic-update-slice of a
    sharded dim writes; DTensor would gather the whole cache to write
    it."""
    if not seq_sharded(cache):
        cache[:, index:index + 1] = value
        return
    start, T, dims = _seq_slice(cache)
    value = _pin(value, tuple(Replicate() if i in dims else p
                              for i, p in enumerate(cache.placements)))
    if start <= index < start + T:
        cache.to_local()[:, index - start:index - start + 1] = value.to_local()


def seq_on_shards(parts, q, k, v, cache_index: int):
    """A decode step's attention of q (B, 1, H, hd) over a KV cache k, v
    (B, T, Hkv, hd) sharded on its sequence, on each device's slice: the
    flash-decoding combine, as GSPMD partitions the reference's softmax
    over a sharded sequence. Each device scores q against its own keys,
    their positions offset by its slice's start and masked past
    ``cache_index``; ``parts(q, k, v, valid)`` returns its running max m,
    the sum of exp(s - m) l and the unnormalised p·v o, all fp32. An
    all-reduce max of m over the mesh dims that shard the sequence, then
    all-reduced sums of l and o rescaled by exp(m - max), give the
    softmax's output. The heads are laid out as ``gqa_on_shards`` lays
    them out. ``cache_index`` is a host int."""
    dp = fit(q, 0, ("pod", "data"))
    (spec_q, spec_kv), fn, partial = _heads_on_shards(parts, q, k, dp)
    start, T, dims = _seq_slice(k)
    mesh = k.device_mesh
    seq = tuple(mesh.mesh_dim_names[i] for i in dims)

    def local(q_l, k_l, v_l):
        pos = start + torch.arange(T, device=k_l.device)
        m, l, o = fn(q_l, k_l, v_l, pos <= cache_index)
        top = m
        for i in dims:
            top = funcol.all_reduce(top, "max", (mesh, i))
        scale = torch.exp(m - top)
        l, o = l * scale, o * scale[..., None].movedim(-2, 1)
        for i in dims:
            l = funcol.all_reduce(l, "sum", (mesh, i))
            o = funcol.all_reduce(o, "sum", (mesh, i))
        out = o / l[..., None].movedim(-2, 1)
        return out.reshape(q_l.shape).to(q_l.dtype)

    spec_k = P(dp, seq if len(seq) > 1 else seq[0], *spec_kv[2:])
    return on_shards(local, (q, k, v), (spec_q, spec_k, spec_k), spec_q,
                     partial)


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
    the same guard (the gradient arrives with its own placements) and
    returns it in the input's layout, as GSPMD lays a cotangent out like
    its primal."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.old, ctx.placements = tuple(x.shape), tuple(x.placements)
        return _gathered_for(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        g = _gathered_for(g, ctx.old).reshape(ctx.old)
        if tuple(g.placements) != ctx.placements and not any(
                isinstance(p, Partial) for p in ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


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


def split_heads(t, n_heads: int):
    """``t`` (b, s, H*hd) viewed as (b, s, H, hd). A DTensor keeps the
    rules' layout, its features over `model`: where each device holds
    whole heads, ``reshape`` keeps them; where the heads span several
    devices (an mLSTM's 4 heads on 16), the mesh must split `model` over
    the heads (``launch.mesh.dtensor_mesh(..., model_heads=H)``) and each
    device's features are its slice of one head's dims, the heads over
    ``MODEL_HEADS`` and hd over ``MODEL_HD``: GSPMD carries the feature
    split through the reshape as a 2-D split, where DTensor's view would
    gather the heads. Raises for a layout neither holds."""
    b, s, f = t.shape
    hd = f // n_heads
    if not (isinstance(t, DTensor) and fit(t, 2, MODEL_AX)):
        return reshape(t, b, s, n_heads, hd)
    mesh = t.device_mesh
    M = model_rank(mesh)[1]
    if not splits_model(mesh):
        if n_heads % M:
            raise ValueError(
                f"{n_heads} heads split over `model` {M}: place them on a "
                f"mesh whose `model` is split over the heads")
        return reshape(t, b, s, n_heads, hd)
    if mesh.size(mesh.mesh_dim_names.index(MODEL_HEADS)) != n_heads:
        raise ValueError(f"{n_heads} heads on a `model` split "
                         f"{tuple(mesh.shape)} {mesh.mesh_dim_names}")
    dp = fit(t, 0, ("pod", "data"))
    return on_shards(lambda x: x.reshape(x.shape[0], s, 1, hd * n_heads // M),
                     (t,), (P(dp, None, MODEL_AX),),
                     P(dp, None, MODEL_HEADS, MODEL_HD))


def head_whole(t):
    """``t`` (b, s, H, x) with each head's last dim whole on its devices:
    on a mesh whose `model` is split over the heads, gathered (or, a
    partial sum, all-reduced) over ``MODEL_HD``, the rest as it is;
    anything else comes back as it is."""
    if not (isinstance(t, DTensor) and splits_model(t.device_mesh)):
        return t
    dp = fit(t, 0, ("pod", "data"))
    return maybe_constrain(t, dp, *([None] * (t.dim() - 3)), MODEL_HEADS,
                           None)


def merge_heads(t):
    """``t`` (b, s, H, hd) viewed as (b, s, H*hd), the inverse of
    ``split_heads``: on a mesh whose `model` is split over the heads,
    each device keeps its slice of its head's dims (a slice of a whole
    head, no communication), its features over `model`."""
    b, s, H, hd = t.shape
    if not (isinstance(t, DTensor) and splits_model(t.device_mesh)):
        return reshape(t, b, s, H * hd)
    dp = fit(t, 0, ("pod", "data"))
    M = model_rank(t.device_mesh)[1]
    return on_shards(lambda x: x.reshape(x.shape[0], s, H * hd // M), (t,),
                     (P(dp, None, MODEL_HEADS, MODEL_HD),),
                     P(dp, None, MODEL_AX))


def embed(table, tokens):
    """``table[tokens]``, the rows of an embedding table. A sharded
    table is read on each device's shards, as GSPMD partitions the
    lookup: a vocab-sharded table looks up the tokens in its own slice
    and the rows add up across `model` (a partial sum, reduced where
    the residual stream is pinned); a table sharded on d returns rows
    sharded on d. DTensor's own masked lookup, and the backward of an
    indexed read, carry placements its redistribution refuses."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    dims = {p.dim for p in table.placements if isinstance(p, Shard)}
    dp = fit(tokens, 0, ("pod", "data"))
    lead = P(dp, *([None] * (tokens.dim() - 1)))
    grads = {0: dp} if dp else None
    if 0 in dims:
        lo, n = _vocab_slice(mesh, table.shape[0])

        def look(tab, idx):
            i, inside = _in_slice(idx, lo, n)
            rows = torch.nn.functional.embedding(i, tab)
            return rows * inside[..., None].to(rows.dtype)

        return on_shards(look, (table, tokens), (P(MODEL_AX, None), lead),
                         P(*lead, None), grads, partial_out=True)
    d = MODEL_AX if 1 in dims else None
    return on_shards(lambda tab, idx: torch.nn.functional.embedding(idx, tab),
                     (table, tokens), (P(None, d), lead), P(*lead, d), grads)


def pin_batch(x):
    """``maybe_constrain`` to batch shards over (`pod`, `data`) and every
    other dim whole: where the models pin the residual stream after the
    embedding. DTensor propagates layouts op by op, with no global pass
    like GSPMD's, and left alone it keeps a vocab-sharded table's lookup
    sharded on d_model and spreads that through every layer."""
    return maybe_constrain(x, ("pod", "data"), *([None] * (x.dim() - 1)))


class _Gather(torch.autograd.Function):
    """A DTensor brought to placements ``want``, its gradient returned in
    the input's layout: the transpose of an all-gather is a
    reduce-scatter, as GSPMD transposes it. Pinned to ``want`` instead
    (``maybe_constrain``), the gradient would reach a column-parallel
    product replicated, and DTensor would gather the weight for it."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.placements = tuple(x.placements)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def gather_features(x):
    """``x`` (b, ..., f) with its batch over (`pod`, `data`) and every
    other dim whole, gathered for a column-parallel product (the sLSTM's
    input path before ``w_gates``); its gradient comes back in x's own
    layout. Identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    want = _on_mesh(x.device_mesh, [fit(x, 0, ("pod", "data"))]
                    + [None] * (x.dim() - 1))
    if tuple(x.placements) == want:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, want)
    return x.redistribute(x.device_mesh, want)


def pin_residual(x, table):
    """``maybe_constrain`` of the residual stream (B, S, d) to the layout
    GSPMD gives it from the embedding table: batch shards over (`pod`,
    `data`), and d over `model` where the rules shard the table on d
    (the vocab does not divide), else whole. Where the models pin it:
    after the embedding and after each layer. DTensor propagates
    layouts op by op, with no global pass like GSPMD's, and left alone
    it spreads whatever layout an op picks through every layer."""
    if not isinstance(x, DTensor):
        return x
    d = MODEL_AX if _d_sharded(table) else None
    return maybe_constrain(x, ("pod", "data"), *([None] * (x.dim() - 2)), d)


def unembed(x, w):
    """``x @ w`` of the unembedding w (d, V). Where the rules shard w on
    d (the vocab does not divide `model`), x is pinned to d shards
    first, so the backward's weight gradient (xᵀ · dlogits) runs on
    them too, as GSPMD propagates it from the weight; DTensor would
    run it whole."""
    if isinstance(w, DTensor) and any(
            isinstance(p, Shard) and p.dim == 0 for p in w.placements):
        x = maybe_constrain(x, ("pod", "data"), *([None] * (x.dim() - 2)),
                            MODEL_AX)
    return x @ w


def project(x, w, out_like=None):
    """``x @ w`` for a projection whose weight the rules replicate over
    `model` (attention's, where the heads do not divide it). GSPMD
    splits such a weight to follow the residual stream: where x is
    sharded on d (``pin_residual``), w is split on its rows, and the
    partial sums are all-reduced once, as the reference reduces q, k and
    v right after their products (a prefill reads k and v twice, for
    its attention and its cache); where ``out_like`` is, on its columns.
    DTensor would run the product whole, and its backward too."""
    if isinstance(w, DTensor) and isinstance(x, DTensor) and not any(
            isinstance(p, Shard) for p in w.placements):
        if _d_sharded(x):
            y = x @ maybe_constrain(w, MODEL_AX, None)
            return _pin(y, tuple(Replicate() if isinstance(p, Partial)
                                 else p for p in y.placements))
        if out_like is not None and _d_sharded(out_like):
            w = maybe_constrain(w, None, MODEL_AX)
    return x @ w


def _d_sharded(x) -> bool:
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim == x.dim() - 1 and MODEL_AX in axes
        for p, axes in zip(x.placements, mesh_axes(x.device_mesh)))


def pin_vocab(logits):
    """``maybe_constrain`` of logits (B, S, ..., V) to the rules' layout:
    batch shards over (`pod`, `data`), the vocab over `model` where the
    unembedding is vocab-parallel, every other dim whole. The loss reads
    them there (``registry.cross_entropy``), so no device gathers the
    vocab. An audio model's logits (B, S, K, V) on a mesh whose `model`
    is split over its codebooks (``codebooks_split``) keep the codebooks
    over ``MODEL_HEADS`` and the vocab over ``MODEL_HD``
    (``split_codebooks``)."""
    if not isinstance(logits, DTensor):
        return logits
    mesh = logits.device_mesh
    if logits.dim() == 4 and splits_model(mesh) and logits.shape[2] == \
            mesh.size(mesh.mesh_dim_names.index(MODEL_HEADS)):
        return maybe_constrain(logits, ("pod", "data"), None, MODEL_HEADS,
                               fit(logits, 3, MODEL_HD))
    return maybe_constrain(logits, ("pod", "data"),
                           *([None] * (logits.dim() - 2)),
                           fit(logits, logits.dim() - 1, MODEL_AX))


def codebooks_split(cfg: ModelConfig, M: int) -> int:
    """The codebooks a serving cell's mesh splits `model` over (0: none):
    an audio model's vocab-parallel logits (B, S, K*V), each device's
    slice of one codebook's vocab, are viewed as (B, S, K, V) with the
    codebooks over ``MODEL_HEADS`` and the vocab over ``MODEL_HD``
    (``split_codebooks``), as the reference hands them back
    (musicgen-large's ``bf16[2,32768,1,512]`` a device on 16)."""
    K = cfg.n_codebooks
    if cfg.family == "audio" and 1 < K < M and not M % K and not (
            K * cfg.vocab_padded) % M:
        return K
    return 0


def split_codebooks(logits, K: int):
    """Logits (B, S, K*V) viewed as (B, S, K, V): on a mesh whose `model`
    is split over the K codebooks (``codebooks_split``) as ``split_heads``
    views heads, with no collective; elsewhere through ``reshape``."""
    if isinstance(logits, DTensor) and splits_model(logits.device_mesh):
        return split_heads(logits, K)
    b, s, kv = logits.shape
    return reshape(logits, b, s, K, kv // K)


def kv_heads(n_heads: int, n_kv: int, hd: int, *ws):
    """(kv heads, the kv projection weights (d, n_kv*hd) and biases
    (n_kv*hd,) in ``ws``) for an attention whose q heads the rules shard
    over `model` and whose kv heads they replicate there (qwen2-72b's 64
    and 8 on 16 devices): each device needs only the one kv head its q
    heads share, and GSPMD projects only that. The weights come back as
    ``model``-size virtual kv heads sharded over `model`, device r's
    being kv head r * n_kv // model, so k and v are projected per device
    and ``gqa_on_shards`` pairs them with the q heads there. Anything
    else (plain tensors, other head counts) comes back as it is."""
    w0 = ws[0]
    if not isinstance(w0, DTensor):
        return (n_kv, *ws)
    r, M = model_rank(w0.device_mesh)
    if n_heads % M or not n_kv % M or (n_heads // n_kv) % (n_heads // M):
        return (n_kv, *ws)
    lo = r * n_kv // M

    def virtual(w):
        if w is None:
            return None
        lead = (None,) * (w.dim() - 1)
        return on_shards(lambda t: t[..., lo * hd:(lo + 1) * hd], (w,),
                         (P(*lead, None),), P(*lead, MODEL_AX),
                         {0: MODEL_AX})

    return (M, *(virtual(w) for w in ws))


def kv_heads_split(cfg: ModelConfig, M: int) -> int:
    """The kv heads a serving cell's mesh splits `model` over (0: none):
    where ``kv_heads`` gives each device the one kv head its q heads
    share, each kv head spans ``M // n_kv`` devices, and the cache holds
    the kv heads over ``MODEL_HEADS`` (``carried_specs``), as the
    reference's step hands it back (qwen2-72b's ``bf16[80,8,32768,1,128]``
    a device from a cache it took replicated over `model`)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if not h % M and kv % M and not M % kv and not (h // kv) % (h // M):
        return kv
    return 0


def kv_whole(k, n_kv: int):
    """k or v (B, S, heads, hd) with its ``n_kv`` kv heads whole, from
    ``kv_heads``' virtual heads (each kv head repeated over the devices
    that share it), as the cache holds them: on a mesh whose `model` is
    split over the kv heads (``kv_heads_split``) each device's virtual
    head is its kv head, so the heads come back over ``MODEL_HEADS``
    with no collective; on any other mesh they are gathered over `model`
    and one of each kept. Anything else comes back as it is."""
    if not isinstance(k, DTensor) or k.shape[2] == n_kv:
        return k
    mesh = k.device_mesh
    if splits_model(mesh) and mesh.size(
            mesh.mesh_dim_names.index(MODEL_HEADS)) == n_kv:
        dp = fit(k, 0, ("pod", "data"))
        return on_shards(lambda t: t, (k,), (P(dp, None, MODEL_AX, None),),
                         P(dp, None, MODEL_HEADS, None))
    k = maybe_constrain(k, ("pod", "data"), None, None, None)
    return k[:, :, ::k.shape[2] // n_kv]


def cp_on_shards(attn, q, k, v, chunk):
    """``attn(q, k, v, chunk, q_start=...)``, a causal attention, with
    q's sequence over `model` and K/V whole: the reference's context-
    parallel constraint on q (its batch whole too), on each device's
    shards, each device's q rows starting at their own key position.
    The output comes back in q's layout (an older DTensor cannot merge a
    sharded sequence into the batch for the out-projection). Identity
    on plain tensors."""
    if not isinstance(q, DTensor):
        return attn(q, k, v, chunk)
    r, M = model_rank(q.device_mesh)
    seq = fit(q, 1, MODEL_AX)
    start = r * (q.shape[1] // M) if seq else 0
    spec_q, whole = P(None, seq, None, None), P(None, None, None, None)
    out = on_shards(lambda q_l, k_l, v_l: attn(q_l, k_l, v_l, chunk,
                                               q_start=start),
                    (q, k, v), (spec_q, whole, whole), spec_q,
                    {1: MODEL_AX, 2: MODEL_AX} if seq else None)
    return _pin(out, tuple(q.placements))


def pick_vocab(logits, index):
    """``logits.gather(-1, index[..., None])[..., 0]``: each row's logit
    at ``index``. Where the vocab is sharded over `model`, each device
    picks from its own slice and the picks add up across `model` (the
    vocab-parallel read; DTensor's own masked gather trips on the
    trailing dim)."""
    if not _d_sharded(logits):
        return logits.gather(-1, index[..., None])[..., 0]
    lo, n = _vocab_slice(logits.device_mesh, logits.shape[-1])

    def pick(lg, idx):
        i, inside = _in_slice(idx, lo, n)
        got = lg.gather(-1, i[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    lead = (fit(index, 0, ("pod", "data")),) + (None,) * (index.dim() - 1)
    return on_shards(pick, (logits, index),
                     (P(*lead, MODEL_AX), P(*lead)), P(*lead),
                     partial_out=True)


def _vocab_slice(mesh: DeviceMesh, vocab: int) -> Tuple[int, int]:
    """(first id, ids) of this device's slice of a vocab sharded over
    `model`."""
    r, M = model_rank(mesh)
    n = vocab // M
    return r * n, n


def _in_slice(idx, lo: int, n: int):
    """(ids made local to the slice [lo, lo + n) and clamped into it,
    whether each id lies in it)."""
    i = idx.long() - lo
    return i.clamp(0, n - 1), (i >= 0) & (i < n)


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
