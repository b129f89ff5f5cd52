"""Random weights drawn from the seed in a few large calls, in the
dtype they are served in, and handed by name to the port's parameter
module.

The reference of a configuration's family lists its parameters
(``param_specs``: name, shape, init). All of them live in one flat
buffer, laid out by init so that each distinct normal scale is one
contiguous run, drawn by one ``normal_`` call from a generator on the
device; constants are one ``fill_`` each. The same seed, device and
dtype give the same bits, so the check of outputs draws them again
after the program has been freed.
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, List, Tuple

import torch
from torch import nn

ALIGN = 64  # elements: every tensor starts 128-byte aligned in bf16


def _layout(specs) -> Tuple[int, List[Tuple[str, Tuple[int, ...], int]],
                            List[list]]:
    """(total elements, [(name, shape, offset)], [[init, start, end]]):
    the specs sorted by init, each init one contiguous run."""
    order = sorted(range(len(specs)), key=lambda i: (specs[i][2], i))
    placed, runs, off = [], [], 0
    for i in order:
        name, shape, init = specs[i]
        if not runs or runs[-1][0] != init:
            runs.append([init, off, off])
        placed.append((name, tuple(shape), off))
        off += -(-math.prod(shape) // ALIGN) * ALIGN
        runs[-1][2] = off
    return off, placed, runs


def draw(specs, seed: int, dtype: torch.dtype,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: tensor}, views of one buffer drawn from ``seed``."""
    total, placed, runs = _layout(specs)
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for (kind, value), a, b in runs:
        if kind == "normal":
            buf[a:b].normal_(0.0, value, generator=gen)
        elif kind == "const":
            buf[a:b].fill_(value)
        else:
            raise ValueError(f"unknown init {kind!r}")
    return {name: buf[off:off + math.prod(shape)].view(shape)
            for name, shape, off in placed}


def port_module(path: str, model_cfg, tensors: Dict[str, torch.Tensor],
                dtype: torch.dtype) -> nn.Module:
    """The port's parameter module ``path`` ("module:Class", built as
    ``Class(cfg, dtype, device)``) with ``tensors`` as its parameters,
    by name, without a copy. Every parameter has to be given, at its
    shape, and nothing else."""
    mod_name, cls_name = path.split(":")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    module = cls(model_cfg, dtype, torch.device("meta"))
    want = {n: tuple(p.shape) for n, p in module.named_parameters()}
    got = {n: tuple(t.shape) for n, t in tensors.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the port's {path} and the reference's parameters "
                         f"differ: {diff[:8]}")
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner) if owner else module, leaf,
                nn.Parameter(t, requires_grad=False))
    return module
