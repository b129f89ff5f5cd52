"""Convert the reference package's params, KV caches and recurrent
states into the port's.

The reference keeps params as a nested dict with stacked blocks: the
transformer's ``layers`` and Zamba2's ``mamba`` on a leading n_layers
axis, xLSTM's ``mlstm``/``slstm`` on (reps, inner) axes. The port keeps
one module per layer or block with the same attribute names (a moe
layer's ``moe.{router,w_gate,w_up,w_down,shared.*}`` and Zamba2's
``shared_*`` block included; xLSTM's ``blocks`` in pattern order). Leaves
are taken as numpy arrays (``np.asarray`` of a reference array works
without importing its framework); the ``x @ W`` (d_in, d_out)
orientation, the cache shape (n_layers, B, S_max, n_kv, hd) and the
states' stacked shapes are kept as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import stacks
from repro_torch.models.registry import stack_kind
from repro_torch.models.transformer import Cache, Transformer


def to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _reference_key(module: nn.Module, name: str) -> Tuple[str, Tuple[int, ...]]:
    """The reference leaf of the port's parameter ``name``, and the index
    of its block in the leaf's stacked leading axes."""
    head, _, rest = name.partition(".")
    if head not in ("layers", "mamba", "blocks"):
        return name, ()
    i, _, rest = rest.partition(".")
    if head == "blocks":    # xLSTM: blocks in pattern order
        kind, r, j = module.slots[int(i)]
        return f"{kind}.{rest}", (r, j)
    return f"{head}.{rest}", (int(i),)


def load_(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a reference param (sub)tree into ``module`` by name: the
    tree's stacks are split over the module's blocks. Every parameter
    must be matched, and every leaf used."""
    dev = next(module.parameters()).device
    flat = {k: to_tensor(v, dev) for k, v in _flatten(tree).items()}
    used = set()
    with torch.no_grad():
        for name, param in module.named_parameters():
            key, idx = _reference_key(module, name)
            src = flat[key][idx]
            if src.shape != param.shape:
                raise ValueError(f"{name}: reference shape "
                                 f"{tuple(src.shape)} != {tuple(param.shape)}")
            param.copy_(src)
            used.add(key)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"reference params with no counterpart: {unused}")
    return module


def params_from_jax(cfg: ModelConfig, tree: Mapping[str, Any],
                    device: DeviceLike = None) -> nn.Module:
    """The port's params module (``Transformer``, ``XLSTM`` or
    ``Zamba2``) holding the weights of a reference param tree, in its
    dtype."""
    dtype = to_tensor(tree["embed"], torch.device("cpu")).dtype
    module = {"transformer": Transformer, "xlstm": stacks.XLSTM,
              "zamba2": stacks.Zamba2}[stack_kind(cfg)]
    return load_(module(cfg, dtype, resolve_device(device)), tree)


def cache_from_jax(cache: Tuple[Any, Any], device: DeviceLike = None) -> Cache:
    dev = resolve_device(device)
    return (to_tensor(cache[0], dev), to_tensor(cache[1], dev))


def state_from_jax(state: Mapping[str, Any], device: DeviceLike = None
                   ) -> Dict[str, Any]:
    """An xLSTM or Zamba2 state (``xlstm_state`` / ``zamba2_state``
    layout) with each leaf a tensor on ``device``."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, Mapping):
            return {k: conv(v) for k, v in t.items()}
        return to_tensor(t, dev)

    return conv(state)
