"""Meshes and the process groups under them.

Port of the reference package's ``launch/mesh.py``. The reference forces
512 host devices and builds its meshes over them; the port builds
``DeviceMesh``es over a process group that ``process_group`` makes and
destroys:

- ``"fake"``: a fake group of 256 or 512 ranks in this one process (its
  collectives do nothing), for the dry run;
- ``"nccl"`` on the card, ``"gloo"`` on the CPU: a real group, at world
  size 1 from a local store unless the caller (or the environment's
  ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``) gives another.

No function here leaves a process group alive: each group lives inside
its ``with`` block, so fake, real and group-less code can follow one
another in one process.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (MODEL_HD, MODEL_HEADS,
                                              keep_model_group)

SINGLE_POD: Tuple[Tuple[int, ...], Tuple[str, ...]] = ((16, 16),
                                                        ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _fake_store():
    # The one import of torch's private testing package: its FakeStore
    # is the store a "fake" process group takes.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


@contextlib.contextmanager
def process_group(backend: str, world_size: int = 1, rank: int = 0,
                  init_method: Optional[str] = None) -> Iterator[None]:
    """A default process group for the ``with`` block, destroyed on the
    way out whatever happens inside.

    ``backend`` "fake" makes a fake group of ``world_size`` ranks in
    this process; "nccl" or "gloo" a real one, from ``init_method``
    (``file://...`` or ``tcp://...``), else from the environment when it
    names a rank, else from a local store at world size 1. Raises if a
    group is already alive."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already alive")
    if backend == "fake":
        dist.init_process_group("fake", store=_fake_store(), rank=rank,
                                world_size=world_size)
    elif init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size)
    elif "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        if world_size != 1:
            raise ValueError("world_size > 1 needs an init_method or the "
                             "environment's RANK / MASTER_ADDR")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The (16, 16) (`data`, `model`) mesh, or with ``multi_pod`` the
    (2, 16, 16) (`pod`, `data`, `model`) one, over the running fake
    group of 256 or 512 ranks (``process_group("fake", 256)``)."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the {shape} mesh needs a running process group "
                           f"of {n} ranks: process_group('fake', {n})")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def dtensor_mesh(mesh: DeviceMesh, model_heads: int = 0,
                 flatten_dp: bool = True) -> DeviceMesh:
    """The mesh a production mesh's DTensors live on, over the same ranks
    in the same order.

    - The (2, 16, 16) mesh becomes a (32, 16) one whose first dim
      "pod_data" carries both data-parallel axes (the rules shard them
      together): DTensor's redistribution planner takes minutes a cell
      on three mesh dims, on two seconds. ``flatten_dp=False`` keeps
      `pod` and `data` apart, for a cell whose rules name `data` alone
      (a batch-1 cell's KV cache, sharded 16 ways on its sequence and
      replicated over `pod`, as the reference shards it).
    - ``model_heads`` (0: none) splits `model` into "model_h"
      (``model_heads`` devices, outermost) and "model_d" (the rest): an
      mLSTM whose heads each span several devices of `model` runs on
      (head, head-dim) shards, one placement on each."""
    names, shape = list(mesh.mesh_dim_names), list(mesh.shape)
    if names == list(MULTI_POD[1]) and flatten_dp:
        names, shape = ["pod_data"] + names[2:], [shape[0] * shape[1]] + shape[2:]
    if not model_heads and len(names) == mesh.ndim:
        return mesh
    return _model_split(mesh.device_type, shape, names, model_heads)


def _model_split(device_type: str, shape, names, model_heads: int
                 ) -> DeviceMesh:
    """A mesh of ``shape`` and ``names`` over the running group's ranks
    in order, its "model" dim split in two when ``model_heads``."""
    if model_heads:
        i = names.index("model")
        if shape[i] % model_heads:
            raise ValueError(f"{model_heads} heads do not divide model "
                             f"{shape[i]}")
        shape = shape[:i] + [model_heads, shape[i] // model_heads] + shape[i + 1:]
        names = names[:i] + [MODEL_HEADS, MODEL_HD] + names[i + 1:]
    out = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
    return split_model(out) if model_heads else out


def split_model(mesh: DeviceMesh) -> DeviceMesh:
    """``mesh``, its "model_h" and "model_d" dims also flattened into one
    "model" dim (``sharding.model_group``): the group of a collective
    over the whole of `model`."""
    keep_model_group(mesh, mesh[MODEL_HEADS, MODEL_HD]._flatten("model"))
    return mesh


def make_local_mesh(model: int = 1, device: DeviceLike = None,
                    model_heads: int = 0) -> DeviceMesh:
    """A (`data`, `model`) mesh over the ranks of the running group
    (``data`` = world size // ``model``), on ``cuda`` unless
    ``device="cpu"``; raises without a card. ``model_heads`` splits
    `model` as ``dtensor_mesh`` does."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs a running process group: "
                           "with process_group(...)")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return _model_split(dev.type, [n // model, model], ["data", "model"],
                        model_heads)
