"""Elastic scaling: reshard a checkpoint for a different mesh.

Port of the reference package's ``checkpoint/elastic.py``. When a pod
(or hosts) drop out, the surviving cluster rebuilds a smaller mesh and
the coordinator replays the newest checkpoint with new placements.
Parameters are topology-independent (full logical tensors in the
checkpoint: a sharded state is gathered on save), so resharding is:
load into a host state -> ``reshard_state`` onto the new mesh ->
resume. The DATA order is also preserved: the synthetic pipeline keys
batches on (step, shard), and ``plan_elastic_restart`` recomputes shard
assignments for the new world size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.sharding import named


def reshard_state(state, mesh: DeviceMesh, spec_tree) -> Any:
    """Place a host-memory state (or any tree of dicts, tuples and
    tensors) onto ``mesh`` under ``spec_tree`` (a tree of specs in its
    structure), with ``distribute_tensor``:
    every rank of the mesh calls it with the same state. Works for both
    grow and shrink. A params module has its parameters replaced in
    place by sharded ones (``requires_grad`` kept) and is returned in
    the new tree; tensors come back as new DTensors."""
    place = named(mesh, spec_tree)

    def put(t: torch.Tensor, pl) -> torch.Tensor:
        return distribute_tensor(t.detach(), mesh, pl)

    def walk(node, pl):
        if isinstance(node, nn.Module):
            for name, p in list(node.named_parameters()):
                mod_name, _, leaf = name.rpartition(".")
                mod = node.get_submodule(mod_name) if mod_name else node
                setattr(mod, leaf, nn.Parameter(
                    put(p, pl[name]), requires_grad=p.requires_grad))
            return node
        if isinstance(node, Mapping):
            return {k: walk(v, pl[k]) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, q) for v, q in zip(node, pl))
        return put(node, pl)

    return walk(state, place)


@dataclass
class ElasticPlan:
    old_world: int
    new_world: int
    new_data_axis: int
    new_global_batch: int
    restart_step: int


def plan_elastic_restart(
    old_world: int,
    surviving: int,
    model_parallel: int,
    global_batch: int,
    last_step: int,
) -> ElasticPlan:
    """Compute the largest viable mesh from surviving chips: the
    model axis is fixed (sharded params must fit), data axis shrinks
    to the largest multiple that divides the batch."""
    if surviving < model_parallel:
        raise RuntimeError(
            f"cannot rebuild: {surviving} chips < model axis "
            f"{model_parallel}")
    new_data = surviving // model_parallel
    while new_data > 0 and global_batch % new_data != 0:
        new_data -= 1
    if new_data == 0:
        raise RuntimeError("no data-axis size divides the global batch")
    return ElasticPlan(
        old_world=old_world,
        new_world=new_data * model_parallel,
        new_data_axis=new_data,
        new_global_batch=global_batch,
        restart_step=last_step,
    )
