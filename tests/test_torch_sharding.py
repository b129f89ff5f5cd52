"""The port's sharding rules (``repro_torch.distributed.sharding``) and
the dry run's shape cells, held to the reference's on the CPU.

``param_specs`` is compared leaf for leaf with the reference's on every
one of the 10 ``ARCHS`` on the 16x16 and 2x16x16 meshes: the port's
parameters come from a ``FakeTensorMode`` init (nothing is allocated),
the reference's from ``jax.eval_shape``, and each per-layer spec must be
its stacked leaf's spec without the stacked axes (which the rules never
shard). ``cache_specs`` is compared on every live prefill and decode
cell, with ``kv_hd_shard`` on and off, and ``batch_specs`` for every
family and kind. Then the reference's own sharding tests, run on the
port, and the spec -> DTensor placements conversion on a 3-D mesh.
Equality is exact: specs are names.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro import configs as j_configs
from repro.distributed import sharding as j_sharding
from repro.models.registry import build_model as j_build_model
from repro_torch import configs
from repro_torch.configs import ARCHS, SMOKES, TRAIN_4K, dryrun_cells
from repro_torch.convert import _reference_key
from repro_torch.distributed.sharding import (
    P, batch_specs, cache_specs, dp_axes, explain_params, maybe_constrain,
    param_specs, placements, sanitize_spec, sanitize_tree, shardings_for,
    state_specs)
from repro_torch.launch.mesh import make_production_mesh, process_group
from repro_torch.models.registry import build_model

MESH16 = {"data": 16, "model": 16}
MESHPOD = {"pod": 2, "data": 16, "model": 16}
MESHES = [MESH16, MESHPOD]


class _FakeMesh:
    """The reference's shape-only mesh stand-in."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _port_params(cfg):
    with FakeTensorMode():
        return build_model(cfg).init(torch.Generator().manual_seed(0),
                                     torch.bfloat16, device="cpu")


def _ref_leaves(tree):
    """{"a.b.c": leaf} of a reference tree of PartitionSpecs (or shapes);
    a sequence index is its number."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


# ----------------------------------------------------------------------
def test_shape_cells_match_the_reference():
    """``ShapeCell``, the four cells and ``shape_applicable`` field for
    field; the 32 live (arch x shape) cells of ``dryrun_cells``."""
    assert [f.name for f in dataclasses.fields(configs.ShapeCell)] == \
        [f.name for f in dataclasses.fields(j_configs.ShapeCell)]
    for ours, ref in zip(configs.ALL_SHAPES, j_configs.ALL_SHAPES,
                         strict=True):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.tokens == ref.tokens
    assert list(configs.SHAPES_BY_NAME) == list(j_configs.SHAPES_BY_NAME)
    ours = [(a, c.name, ok, why) for a, _, c, ok, why in dryrun_cells()]
    ref = [(a, c.name, ok, why)
           for a, _, c, ok, why in j_configs.dryrun_cells()]
    assert ours == ref
    assert sum(ok for *_, ok, _ in ours) == 32


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh", MESHES, ids=["single", "multi"])
def test_param_specs_match_the_reference(arch, mesh):
    cfg = ARCHS[arch]
    params = _port_params(cfg)
    ours = param_specs(cfg, params, mesh)
    jm = j_build_model(j_configs.ARCHS[arch])
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    ref = _ref_leaves(j_sharding.param_specs(j_configs.ARCHS[arch], shapes,
                                             _FakeMesh(mesh)))
    used = set()
    for name, t in params.named_parameters():
        key, idx = _reference_key(params, name)
        want = tuple(ref[key])
        assert want[:len(idx)] == (None,) * len(idx), (name, want)
        assert tuple(ours[name]) == want[len(idx):], (name, ours[name], want)
        assert len(ours[name]) == t.dim()
        used.add(key)
    assert used == set(ref)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh", MESHES, ids=["single", "multi"])
def test_cache_specs_match_the_reference(arch, mesh):
    """Every live prefill and decode cell, kv_hd_shard on and off."""
    cfg, jcfg = ARCHS[arch], j_configs.ARCHS[arch]
    n = 0
    for a, _, cell, ok, _ in dryrun_cells():
        if a != arch or not ok or cell.kind == "train":
            continue
        with FakeTensorMode():
            cache = build_model(cfg).init_cache(
                cell.global_batch, cell.seq_len, torch.bfloat16,
                device="cpu")
        shapes = jax.eval_shape(lambda: j_build_model(jcfg).init_cache(
            cell.global_batch, cell.seq_len, jnp.bfloat16))
        for hd in (False, True):
            ours = _port_leaves(cache_specs(cfg, cell, mesh, cache,
                                            kv_hd_shard=hd))
            ref = _ref_leaves(j_sharding.cache_specs(
                jcfg, j_configs.SHAPES_BY_NAME[cell.name], _FakeMesh(mesh),
                shapes, kv_hd_shard=hd))
            assert {k: tuple(v) for k, v in ours.items()} == \
                {k: tuple(v) for k, v in ref.items()}, (cell.name, hd)
            n += 1
    assert n >= 4


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh", MESHES, ids=["single", "multi"])
def test_batch_specs_match_the_reference(arch, mesh):
    for kind in ("train", "prefill", "decode"):
        ours = batch_specs(ARCHS[arch], kind, mesh)
        ref = j_sharding.batch_specs(j_configs.ARCHS[arch], kind,
                                     _FakeMesh(mesh))
        assert {k: tuple(v) for k, v in ours.items()} == \
            {k: tuple(v) for k, v in ref.items()}, kind
    assert dp_axes(mesh) == j_sharding.dp_axes(_FakeMesh(mesh))


# ---- the reference's tests/test_sharding.py, on the port ----
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh", MESHES, ids=["single", "multi"])
def test_param_specs_divisible(arch, mesh):
    """Every sharded dim must be divisible by its mesh axes."""
    cfg = ARCHS[arch]
    params = _port_params(cfg)
    specs = param_specs(cfg, params, mesh)
    for name, t in params.named_parameters():
        for i, entry in enumerate(specs[name]):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            k = int(np.prod([mesh[a] for a in axes]))
            assert t.shape[i] % k == 0, (name, t.shape, specs[name])


def test_tp_actually_shards_big_matrices():
    """For every arch, a majority of the parameters' bytes are
    model-sharded."""
    for arch, cfg in ARCHS.items():
        params = _port_params(cfg)
        specs = param_specs(cfg, params, MESH16)
        tot = shd = 0
        for name, t in params.named_parameters():
            tot += t.numel()
            if any(e is not None for e in specs[name]):
                shd += t.numel()
        assert shd / tot > 0.5, f"{arch}: only {shd/tot:.0%} params sharded"


def test_sanitize_spec():
    assert sanitize_spec((1, 1), P("data", None), MESH16) == P(None, None)
    assert sanitize_spec((32, 32), P("data", "model"), MESH16) == \
        P("data", "model")
    assert sanitize_spec((32, 17), P("data", "model"), MESH16) == \
        P("data", None)


def test_batch_specs_kinds():
    bs = batch_specs(ARCHS["qwen2-0.5b"], "train", MESH16)
    assert bs["tokens"] == P("data", None)
    bs = batch_specs(ARCHS["musicgen-large"], "decode", MESH16)
    assert bs["tokens"] == P("data", None, None)
    assert bs["cache_index"] == P()


# ---- the port's own ----
def test_placements_on_a_3d_mesh():
    """A spec becomes one placement per mesh dim, in mesh order; a
    ("pod", "data") entry shards its dim on both."""
    with process_group("fake", 512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert placements(P(("pod", "data"), None, "model"), mesh) == \
            (Shard(0), Shard(0), Shard(2))
        assert placements(P(None, "model"), mesh) == \
            (Replicate(), Replicate(), Shard(1))
        assert placements(P(), mesh) == (Replicate(),) * 3
        assert placements(P("data", None), mesh) == \
            (Replicate(), Shard(0), Replicate())
        with pytest.raises(ValueError, match="shards two dims"):
            placements(P("model", "model"), mesh)
        # sanitized first: dim 3 (4) does not divide over `model`
        cache = {"kv_k": torch.empty(2, 64, 16, 4, 16, device="meta")}
        assert shardings_for(cache, {"kv_k": P(None, ("pod", "data"),
                                                 "model", "model", None)},
                             mesh) == {"kv_k": (Shard(1), Shard(1),
                                                Shard(2))}


def test_state_specs_explain_and_sanitize_tree():
    cfg = SMOKES["qwen2-0.5b"]
    params = _port_params(cfg)
    specs = param_specs(cfg, params, MESH16)
    st = state_specs(cfg, MESH16, specs)
    assert st["m"] is specs and st["v"] is specs and st["step"] == P()
    text = explain_params(cfg, params, MESH16)
    assert text["embed"] == f"{tuple(params.embed.shape)} -> {specs['embed']}"
    cache = (torch.zeros(2, 3, 16, 2, 16), torch.zeros(2, 3, 16, 2, 16))
    out = sanitize_tree(cache, (P(None, "data"), P(None, None, "model")),
                        MESH16)
    assert out == (P(None, None, None, None, None),
                   P(None, None, "model", None, None))


def test_maybe_constrain_is_identity_on_plain_tensors():
    x = torch.arange(6.0).reshape(2, 3)
    assert maybe_constrain(x, ("pod", "data"), None) is x


def test_long_context_cell_shards_the_sequence():
    """long_500k (batch 1): the KV cache's sequence over `data`."""
    cfg = ARCHS["zamba2-7b"]
    cell = configs.LONG_500K
    with FakeTensorMode():
        cache = build_model(cfg).init_cache(1, cell.seq_len, torch.bfloat16,
                                            device="cpu")
    specs = cache_specs(cfg, cell, MESH16, cache)
    assert specs["kv_k"][2] == "data" and specs["kv_k"][1] is None
    assert TRAIN_4K.tokens == 4096 * 256
