"""Convert the reference package's params and KV cache into the port's.

The reference keeps params as a nested dict with the layer params
stacked on a leading n_layers axis; the port keeps one ``Block`` per
layer with the same attribute names (a moe layer's
``moe.{router,w_gate,w_up,w_down,shared.*}`` included). Leaves are
taken as numpy arrays (``np.asarray`` of a reference array works
without importing its framework); the ``x @ W`` (d_in, d_out)
orientation and the cache shape (n_layers, B, S_max, n_kv, hd) are kept
as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
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


def load_(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a reference param (sub)tree into ``module`` by name: the
    tree's ``layers`` stack is split over ``module.layers``. Every
    parameter must be matched, and every leaf used."""
    dev = next(module.parameters()).device
    flat = {k: to_tensor(v, dev) for k, v in _flatten(tree).items()}
    used = set()
    with torch.no_grad():
        for name, param in module.named_parameters():
            if name.startswith("layers."):
                _, idx, rest = name.split(".", 2)
                key = f"layers.{rest}"
                src = flat[key][int(idx)]
            else:
                key = name
                src = flat[key]
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
                    device: DeviceLike = None) -> Transformer:
    """The port's ``Transformer`` holding the weights of a reference
    param tree (``transformer.init_params`` layout), in its dtype."""
    dtype = to_tensor(tree["embed"], torch.device("cpu")).dtype
    return load_(Transformer(cfg, dtype, resolve_device(device)), tree)


def cache_from_jax(cache: Tuple[Any, Any], device: DeviceLike = None) -> Cache:
    dev = resolve_device(device)
    return (to_tensor(cache[0], dev), to_tensor(cache[1], dev))
