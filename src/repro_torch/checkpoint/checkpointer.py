"""Fault-tolerant checkpointing: msgpack tensor store with atomic
rename, async (background-thread) saves, integrity manifest, and
keep-last-k retention.

Port of the reference package's ``checkpoint/checkpointer.py``, with the
same files and keys, so either package restores the other's checkpoints.

Layout:  <dir>/step_<N>/arrays.msgpack   (+ manifest.json)
A save is visible only after the atomic directory rename, so a crash
mid-save never corrupts the restore point — the restart path picks
the newest complete step.

The payload maps each leaf's tree path ("params/layers/attn/wq", the
blocks stacked on leading axes as the reference stacks them, then
"m/...", "step", "v/...", in ``jax.tree_util``'s sorted-key order) to
{"dtype": name, "shape": [...], "data": raw bytes}. A port training
state (``launch.steps.init_train_state``) is restacked on save and
unstacked on restore (``convert.state_to_jax`` / ``load_state_``); any
other state is a nested dict of tensors. A sharded training state is
gathered whole on save, so every rank of its group calls ``save``; only
rank 0 writes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.checkpoint.codec import pack_chunks, unpackb
from repro_torch.convert import load_state_, state_to_jax


def _is_train_state(state: Any) -> bool:
    return isinstance(state, Mapping) and isinstance(state.get("params"),
                                                     nn.Module)


def _flatten(tree: Mapping[str, Any], prefix: str = ""
             ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs with keys sorted at every level."""
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.extend(_flatten(v, f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _host_tree(state: Any) -> Dict[str, torch.Tensor]:
    """{path: CPU tensor} of ``state``, sharing no memory with it: a
    snapshot the caller may go on updating."""
    if _is_train_state(state):
        return dict(_flatten(state_to_jax(state)))
    return {k: torch.as_tensor(v).detach().to("cpu", copy=True)
            for k, v in _flatten(state)}


def _pack_array(t: torch.Tensor) -> Dict[str, Any]:
    data = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return {"dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape), "data": memoryview(data)}


def _unpack_array(d: Mapping[str, Any]) -> torch.Tensor:
    # by dtype name, so bfloat16 needs no ml_dtypes
    dtype = getattr(torch, d["dtype"])
    data = d["data"]
    if len(data) == 0:
        return torch.empty(d["shape"], dtype=dtype)
    return torch.frombuffer(data, dtype=dtype).reshape(d["shape"])


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Synchronous atomic save. Returns the final directory path."""
    return _write(ckpt_dir, step, _host_tree(state))


def _write(ckpt_dir: str, step: int, arrays: Dict[str, torch.Tensor]) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if dist.is_initialized() and dist.get_rank() != 0:
        return final                     # rank 0 writes for the group
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    payload = {k: _pack_array(v) for k, v in arrays.items()}
    sha, n = hashlib.sha256(), 0
    with open(os.path.join(tmp, "arrays.msgpack"), "wb") as f:
        for chunk in pack_chunks(payload):
            sha.update(chunk)
            n += f.write(chunk)
    manifest = {
        "step": step,
        "n_arrays": len(arrays),
        "bytes": n,
        "sha256": sha.hexdigest(),
        "keys": list(arrays),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_checkpoints(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def restore_checkpoint(ckpt_dir: str, like, step: Optional[int] = None):
    """Restore into the structure of ``like``: a port training state is
    filled in place and returned; a nested dict of tensors comes back as
    a new one with ``like``'s dtypes and devices. Verifies the
    integrity hash."""
    steps = list_checkpoints(ckpt_dir)
    if not steps:
        return None, -1
    step = step if step is not None else steps[-1]
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    fname = os.path.join(path, "arrays.msgpack")
    blob = bytearray(os.path.getsize(fname))
    with open(fname, "rb") as f:
        f.readinto(blob)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if hashlib.sha256(blob).hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint {path} failed integrity check")
    payload = unpackb(blob)
    if _is_train_state(like):
        tree = _nest({k: _unpack_array(v) for k, v in payload.items()})
        return load_state_(like, tree), step
    out = {}
    for key, leaf in _flatten(like):
        leaf = torch.as_tensor(leaf)
        out[key] = _unpack_array(payload[key]).to(leaf.device, leaf.dtype,
                                                  copy=True)
    return _nest(out), step


class Checkpointer:
    """Async checkpointer: ``save()`` snapshots to host memory on the
    caller thread and writes in a background thread, so the train loop
    never blocks on disk. ``keep`` newest checkpoints are retained."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, step: int, state, blocking: bool = False) -> None:
        self.wait()
        host_state = _host_tree(state)

        def work():
            try:
                _write(self.dir, step, host_state)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._err = e

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def restore(self, like, step: Optional[int] = None):
        return restore_checkpoint(self.dir, like, step)

    def _gc(self) -> None:
        steps = list_checkpoints(self.dir)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
