"""Convert the reference package's params, KV caches, recurrent states
and training states into the port's, and the port's params and training
states back into the reference's trees.

The reference keeps params as a nested dict with stacked blocks: the
transformer's ``layers`` and Zamba2's ``mamba`` on a leading n_layers
axis, xLSTM's ``mlstm``/``slstm`` on (reps, inner) axes. The port keeps
one module per layer or block with the same attribute names (a moe
layer's ``moe.{router,w_gate,w_up,w_down,shared.*}`` and Zamba2's
``shared_*`` block included; xLSTM's ``blocks`` in pattern order). Leaves
are taken as numpy arrays (``np.asarray`` of a reference array works
without importing its framework); the ``x @ W`` (d_in, d_out)
orientation, the cache shape (n_layers, B, S_max, n_kv, hd) and the
states' stacked shapes are kept as they are. Going back
(``params_to_jax``, ``state_to_jax``) restacks the blocks, so a port
checkpoint is keyed and shaped as the reference's.
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
    if isinstance(a, torch.Tensor):
        return a.to(device)
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


def _restack(module: nn.Module, named: Mapping[str, torch.Tensor]
             ) -> Dict[str, Any]:
    """The reference tree of per-parameter tensors ``named`` (keyed by
    the module's parameter names): blocks stacked on their leading axes
    in the reference's order, leaves as CPU tensors that share no memory
    with ``named``."""
    groups: Dict[str, Dict[Tuple[int, ...], torch.Tensor]] = {}
    for name, t in named.items():
        key, idx = _reference_key(module, name)
        groups.setdefault(key, {})[idx] = t.detach()
    tree: Dict[str, Any] = {}
    for key, parts in groups.items():
        if list(parts) == [()]:
            leaf = parts[()].to("cpu", copy=True)
        else:
            shape = tuple(max(i[a] for i in parts) + 1
                          for a in range(len(next(iter(parts)))))
            first = next(iter(parts.values()))
            leaf = torch.empty(shape + first.shape, dtype=first.dtype)
            for idx, t in parts.items():
                leaf[idx] = t
        node = tree
        *path, last = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def params_to_jax(module: nn.Module) -> Dict[str, Any]:
    """The reference param tree of the port's params module (the inverse
    of ``params_from_jax``), leaves as CPU tensors in the params' dtype."""
    return _restack(module, dict(module.named_parameters()))


def state_to_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference training state (``launch.steps.init_train_state``'s
    tree: params, AdamW moments ``m``/``v``, ``step``) of a port training
    state, leaves as CPU tensors that share no memory with it."""
    module = state["params"]
    return {"params": params_to_jax(module),
            "m": _restack(module, state["m"]),
            "v": _restack(module, state["v"]),
            "step": state["step"].detach().to("cpu", copy=True)}


def load_state_(state: Mapping[str, Any], tree: Mapping[str, Any]
                ) -> Mapping[str, Any]:
    """Copy a reference training-state tree into the port's training
    state in place (the inverse of ``state_to_jax``)."""
    module = state["params"]
    load_(module, tree["params"])
    with torch.no_grad():
        for part in ("m", "v"):
            dst = state[part]
            flat = _flatten(tree[part])
            for name, t in dst.items():
                key, idx = _reference_key(module, name)
                t.copy_(to_tensor(flat[key], t.device)[idx])
        state["step"].copy_(to_tensor(tree["step"], state["step"].device))
    return state


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
