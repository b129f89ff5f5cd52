"""Per-device op accounting for the roofline's three terms: the port's
counterpart of the reference package's ``launch/hlo_analysis.py``.

The reference parses the compiled, partitioned HLO text. torch has no
HLO, so the port counts the ops it runs: ``OpCounter`` is a dispatch
mode that sees every op below autograd, on the tensors each device
holds, and sums

  flops        every matmul-family op (mm, addmm, bmm, baddbmm, mv,
               dot): 2 * |result| * K, the rule of the reference's
               ``_dot_flops`` (matmul only: elementwise flops are
               ignored, as there);
  bytes        the result sizes of the ops that materialise one: every
               op but views, allocations (``empty*``) and collectives,
               an in-place op counting the tensor it writes (the
               reference's post-fusion buffer writes; nothing here is
               fused, so this reads higher);
  collectives  the local result of each functional collective, weighted
               as the reference weighs them per participating device:
                 all-reduce         2x result (reduce-scatter + all-gather)
                 all-gather         1x result
                 reduce-scatter     1x result
                 all-to-all         1x result
                 collective-permute 1x result (torch's ``broadcast``: no
                                    functional collective is a permute)

**Per device, not logical.** A DTensor op reaches the mode first with
DTensor arguments; the counter declines it (returns ``NotImplemented``),
so DTensor runs its own dispatch with the counter still active and the
counter sees what one device runs: the local ops on the local shards
and the collectives DTensor issues. The ops DTensor runs on fake
tensors of global shape to propagate shapes (in the ambient fake mode,
if there is one) are skipped: the counter finds DTensor's propagation
function among its callers' frames.

**No trip counts, no ``branch_scale``.** The reference multiplies loop
bodies by their trip counts and scales conditional branches, because XLA
prints a scanned layer once. The port's layers are unrolled modules and
every op is counted each time it runs (Zamba2's shared block each of
its applications), so its counts are exact where the reference's are
scaled.

The counter also keeps the peak of the bytes live in the tensors its
ops allocated (``peak_bytes``): the dry run's ``temp_bytes``.
"""
from __future__ import annotations

import sys
import weakref
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_FACTORS = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
            "all-to-all": 1.0, "collective-permute": 1.0}
_COLL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional")

_aten = torch.ops.aten
# matmul family: (index of the lhs operand), the rest read K from it
_DOT_LHS = {_aten.mm.default: 0, _aten.addmm.default: 1,
            _aten.bmm.default: 0, _aten.baddbmm.default: 1,
            _aten.mv.default: 0, _aten.dot.default: 0}
# DTensor's shape propagation (``ShardingPropagator``), by function name
_PROPAGATION = frozenset({"_propagate_tensor_meta_non_cached",
                          "_propagate_tensor_meta"})
_NO_WRITE = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten._unsafe_view.default,
             _aten.lift_fresh.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts, per device, the ops run while it is active (see the
    module docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = {k: 0.0 for k in COLLECTIVES}
        self.coll_count = {k: 0 for k in COLLECTIVES}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0

    @staticmethod
    def _propagation() -> bool:
        """Whether the op is DTensor's shape propagation, not local work:
        its function is a few frames up (the op's call, its fake args)."""
        f = sys._getframe(2)
        for _ in range(6):
            if f is None:
                return False
            if f.f_code.co_name in _PROPAGATION:
                return True
            f = f.f_back
        return False

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor dispatches to local ops
        if self._propagation():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self.ops += 1
        if func.namespace in _COLL_NAMESPACES:
            # waits and autograd wrappers move no bytes
            kind = _COLL_KIND.get(func._opname)
            if kind is not None:
                b = sum(_nbytes(t) for t in _tensors(out))
                self.coll_bytes[kind] += b * _FACTORS[kind]
                self.coll_count[kind] += 1
            return out
        lhs = _DOT_LHS.get(func)
        if lhs is not None:
            res = _tensors(out)[0]
            self.flops += 2.0 * res.numel() * args[lhs].shape[-1]
        if func in _NO_WRITE:
            return out
        rets = func._schema.returns
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in rets):
            return out                  # a view
        fresh = not any(r.alias_info is not None for r in rets)
        for t in _tensors(out):
            n = _nbytes(t)
            self.bytes += n
            if fresh:
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                weakref.finalize(t, self._release, n)
        return out

    def metrics(self) -> Dict[str, float]:
        """The keys of the reference's ``hlo_metrics``."""
        res = {f"{k}_bytes": v for k, v in self.coll_bytes.items()}
        res.update({f"{k}_count": float(v)
                    for k, v in self.coll_count.items()})
        res["total_weighted_bytes"] = sum(self.coll_bytes.values())
        res["hlo_flops"] = self.flops
        res["hlo_bytes"] = self.bytes
        return res

