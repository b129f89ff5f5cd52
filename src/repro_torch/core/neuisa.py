"""NeuISA (§III-D): μTOps, μTOp groups, the execution table, and the
control-flow instructions.

A μTOp is a slice of a tensor operator whose instructions drive ONE
ME (plus the n_y VE slots needed to drain/post-process it), or a pure
VE μTOp with no ME slot. μTOps within a group may run concurrently
and in any order; groups execute sequentially unless a
``uTop.nextGroup`` retargets control flow (loops/branches across
groups). μTOps sharing identical code use one snippet (the paper's
code-inflation mitigation) — we track snippet ids to report code
size.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ME = "me"
VE = "ve"

# -- control instructions (Fig. 14) ------------------------------------
# Modeled as (opcode, operand) pairs appended to a μTOp's snippet.
UTOP_FINISH = "uTop.finish"
UTOP_NEXT_GROUP = "uTop.nextGroup"
UTOP_GROUP = "uTop.group"
UTOP_INDEX = "uTop.index"


@dataclass
class MuTOp:
    """One μTOp: VLIW snippet metadata + its simulated cost."""

    kind: str                   # ME | VE
    cycles: float               # engine-cycles of work in this μTOp
    hbm_bytes: float = 0.0
    op_name: str = ""
    snippet: int = -1           # shared code-snippet id
    # control: executed at μTOp end. None -> implicit uTop.finish.
    next_group: Optional[int] = None

    def control_instructions(self) -> List[Tuple[str, Optional[int]]]:
        ins: List[Tuple[str, Optional[int]]] = []
        if self.next_group is not None:
            ins.append((UTOP_NEXT_GROUP, self.next_group))
        ins.append((UTOP_FINISH, None))
        return ins


@dataclass
class MuTOpGroup:
    """Up to n_x ME μTOps + up to one VE μTOp (with n_y VE slots)."""

    me_utops: List[MuTOp] = field(default_factory=list)
    ve_utop: Optional[MuTOp] = None
    op_name: str = ""

    def all_utops(self) -> List[MuTOp]:
        out = list(self.me_utops)
        if self.ve_utop is not None:
            out.append(self.ve_utop)
        return out

    @property
    def me_work(self) -> float:
        return sum(u.cycles for u in self.me_utops)

    @property
    def ve_work(self) -> float:
        return self.ve_utop.cycles if self.ve_utop else 0.0


@dataclass
class NeuISAProgram:
    """A compiled NeuISA binary: μTOp snippets + the execution table.

    ``exec_table()`` reproduces Fig. 15's structure: one row per
    group with n_x ME entries + 1 VE entry (snippet start addresses;
    None = no μTOp in that slot).
    """

    name: str
    groups: List[MuTOpGroup]
    n_x: int                    # MEs on the physical core
    n_y: int                    # VEs on the physical core
    loop_trips: Dict[int, int] = field(default_factory=dict)
    # per-op metadata for analysis
    source_ops: int = 0

    def validate(self) -> None:
        for gi, g in enumerate(self.groups):
            if len(g.me_utops) > self.n_x:
                raise ValueError(
                    f"group {gi}: {len(g.me_utops)} ME μTOps > n_x={self.n_x}")
            # all μTOps setting next_group must agree (else: exception
            # raised by hardware, Fig. 14 semantics)
            targets = {u.next_group for u in g.all_utops()
                       if u.next_group is not None}
            if len(targets) > 1:
                raise ValueError(
                    f"group {gi}: conflicting uTop.nextGroup targets {targets}")
            tgt = next(iter(targets), None)
            if tgt is not None and not (0 <= tgt < len(self.groups)):
                raise ValueError(f"group {gi}: nextGroup {tgt} out of range")

    def exec_table(self) -> List[List[Optional[int]]]:
        rows: List[List[Optional[int]]] = []
        for g in self.groups:
            row: List[Optional[int]] = [None] * (self.n_x + 1)
            for i, u in enumerate(g.me_utops):
                row[i] = u.snippet
            if g.ve_utop is not None:
                row[self.n_x] = g.ve_utop.snippet
            rows.append(row)
        return rows

    # -- code-size accounting (the §III-D inflation discussion) --
    def n_utops(self) -> int:
        return sum(len(g.all_utops()) for g in self.groups)

    def n_snippets(self) -> int:
        return len({u.snippet for g in self.groups for u in g.all_utops()})

    def code_inflation(self) -> float:
        """μTOps per distinct snippet — 1.0 means perfect sharing."""
        n = self.n_snippets()
        return self.n_utops() / n if n else 0.0

    def total_work(self) -> Tuple[float, float, float]:
        me = sum(g.me_work for g in self.groups)
        ve = sum(g.ve_work for g in self.groups)
        hbm = sum(u.hbm_bytes for g in self.groups for u in g.all_utops())
        return me, ve, hbm

    def with_loop(self, start: int, end: int, trips: int) -> "NeuISAProgram":
        """Wire a loop: after `end` runs, jump back to `start`
        (trips-1) times via uTop.nextGroup on the group's μTOps."""
        if trips > 1:
            for u in self.groups[end].all_utops():
                u.next_group = start
            self.loop_trips[end] = trips
        self.validate()
        return self


@dataclass
class FusedIssueGroup:
    """A cross-tenant issue group (Fig. 6 co-scheduling).

    While one tenant's prefill(-chunk) ME μTOps grind through the
    systolic arrays, its VE slots are mostly idle (the drain work is
    pipelined into the ME span). A fused issue group co-issues
    co-tenant *decode* VE μTOps into that window: the ME μTOps keep
    their engines, the decode μTOps ride the idle VE slots, and —
    like μTOps of one compile-time group — members run to completion
    without preempting each other (the scheduler's reclaim pass skips
    fused members). This is purely an issue-time pairing formed by the
    scheduler; it adds no instructions to either program."""

    me_tenant: int                       # tenant whose prefill MEs anchor
    op_name: str                         # the anchoring ME operator
    ve_members: List[Tuple[int, str]] = field(default_factory=list)
                                         # (tenant idx, op name) co-issued

    @property
    def fused(self) -> bool:
        return bool(self.ve_members)


def form_fused_group(
    me_tenant: int,
    op_name: str,
    candidates: Sequence[Tuple[int, str, str]],
    max_ve: int = 1,
) -> FusedIssueGroup:
    """Form a fused issue group under a tenant's in-flight prefill ME
    μTOps. ``candidates`` are (tenant idx, op name, phase) tuples of
    ready VE μTOps; only *decode*-phase μTOps from OTHER tenants fuse
    (same-tenant VE work already shares the compile-time group, and
    non-decode work has no latency claim on the window). At most
    ``max_ve`` members join — one per donated VE slot."""
    g = FusedIssueGroup(me_tenant=me_tenant, op_name=op_name)
    for tenant, op, phase in candidates:
        if len(g.ve_members) >= max_ve:
            break
        if phase == "decode" and tenant != me_tenant:
            g.ve_members.append((tenant, op))
    return g


@dataclass
class VLIWOp:
    """Baseline ISA unit (Fig. 8 left): one tensor operator whose
    VLIW instruction stream couples the control flow of all
    ``n_me_static`` MEs it was compiled for."""

    op_name: str
    n_me_static: int            # compiled-in ME count (0 = VE-only op)
    me_cycles: float            # total ME work
    ve_cycles: float
    hbm_bytes: float

    @property
    def duration_me(self) -> float:
        """ME busy span when granted its static allocation."""
        return self.me_cycles / max(self.n_me_static, 1)


@dataclass
class VLIWProgram:
    name: str
    ops: List[VLIWOp]
    n_x: int
    n_y: int

    def total_work(self) -> Tuple[float, float, float]:
        return (
            sum(o.me_cycles for o in self.ops),
            sum(o.ve_cycles for o in self.ops),
            sum(o.hbm_bytes for o in self.ops),
        )
