"""vNPU: the paper's new system abstraction (§III-A).

A vNPU is a virtual NPU device exposed to a tenant: a number of MEs
and VEs, SRAM/HBM allocations, and a lifecycle
(CREATE -> MAP -> ACTIVE -> DESTROYED). The guest-visible hierarchy
(chips/cores) mirrors a physical board; the control-plane calls here
correspond to the paper's hypercalls (create / reconfigure /
deallocate) routed to the vNPU manager.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig


class VNPUState(enum.Enum):
    CREATED = "created"
    MAPPED = "mapped"
    ACTIVE = "active"
    DESTROYED = "destroyed"


@dataclass
class VNPUConfig:
    """User-facing pay-as-you-go spec (Fig. 10)."""

    n_me: int
    n_ve: int
    sram_bytes: int = 0        # 0 -> proportional to MEs (§III-B)
    hbm_bytes: int = 0
    n_cores: int = 1
    n_chips: int = 1
    priority: float = 1.0      # temporal-sharing fair-share weight

    @property
    def n_eus(self) -> int:
        return self.n_me + self.n_ve

    def validate(self, core: NPUCoreConfig = DEFAULT_CORE) -> None:
        if self.n_me < 1 or self.n_ve < 1:
            raise ValueError("each vNPU gets at least 1 ME and 1 VE (§III-B)")
        if self.n_me > core.n_me or self.n_ve > core.n_ve:
            raise ValueError(
                f"vNPU ({self.n_me}ME/{self.n_ve}VE) exceeds pNPU core "
                f"({core.n_me}ME/{core.n_ve}VE); allocate more vNPU cores instead"
            )


# preset sizes the paper suggests cloud providers expose (§III-A)
PRESETS = {
    "small": VNPUConfig(n_me=1, n_ve=1),
    "medium": VNPUConfig(n_me=4, n_ve=4),
    "large": VNPUConfig(n_me=8, n_ve=8, n_cores=2),
}


@dataclass
class MemorySegments:
    """Fixed-size-segment address-space isolation (§III-C)."""

    sram_segments: Tuple[int, ...] = ()
    hbm_segments: Tuple[int, ...] = ()
    sram_segment_size: int = DEFAULT_CORE.sram_segment
    hbm_segment_size: int = DEFAULT_CORE.hbm_segment

    def translate(self, space: str, vaddr: int) -> int:
        """Virtual -> physical: base-plus-offset within the segment
        list. Raises (page fault) on out-of-range access."""
        segs, size = (
            (self.sram_segments, self.sram_segment_size)
            if space == "sram"
            else (self.hbm_segments, self.hbm_segment_size)
        )
        idx, off = divmod(vaddr, size)
        if vaddr < 0 or idx >= len(segs):
            raise MemoryError(
                f"vNPU page fault: {space} vaddr {vaddr:#x} outside the "
                f"{len(segs)}-segment allocation"
            )
        return segs[idx] * size + off

    @property
    def sram_bytes(self) -> int:
        return len(self.sram_segments) * self.sram_segment_size

    @property
    def hbm_bytes(self) -> int:
        return len(self.hbm_segments) * self.hbm_segment_size


class KVLedgerError(RuntimeError):
    """A ledger operation violated its bookkeeping contract
    (double-free, unknown allocation, over-reservation)."""


class KVLedger:
    """Live HBM accounting for one vNPU's segment allocation.

    Tracks per-request KV-cache bytes against the vNPU's HBM capacity
    so decode context growth consumes memory *live* instead of hiding
    behind a static ``hbm_footprint`` max. ``reserved`` bytes model
    the resident working set that is not per-request (weights); every
    other byte is owned by exactly one request id.

    Beyond per-request entries the ledger carries two optional pools,
    both empty (and cost-free) unless a control plane turns them on:

    * SHARED entries — refcounted segments keyed by prefix hash
      (cross-request KV prefix caching). The FIRST ``acquire_shared``
      of a key charges its bytes all-or-nothing; later acquires only
      bump the refcount; ``release_shared`` frees the bytes exactly
      when the last holder lets go.
    * BORROWED/LENT bytes — cross-tenant segment borrowing
      (:meth:`VNPUManager.borrow_hbm`): ``lend`` parks idle bytes of
      THIS ledger for a co-resident borrower (they stop being
      allocatable here), ``grant`` extends the borrower's effective
      capacity by the same amount. The manager keeps the loan table;
      the ledger only carries the two counters.

    Invariants (proven by the property tests):

    * ``reserved + in_use + shared_in_use + lent <= capacity +
      borrowed`` at all times — an ``alloc``/``acquire_shared``/
      ``lend`` that would exceed returns False and changes nothing;
    * frees are exact: ``free(rid)`` returns precisely the bytes
      ``rid`` holds and removes the entry; freeing an unknown rid
      raises :class:`KVLedgerError` (no silent double-free);
    * refcounts never go negative: ``release_shared`` of an unknown
      key raises; a key's entry disappears exactly when its refcount
      reaches zero;
    * conservation: ``sum(entries) == in_use`` and
      ``sum(shared bytes) == shared_in_use`` across any sequence of
      alloc/grow/free/acquire/release/clear/migrate.

    Units: every quantity is BYTES except ``used_segments`` /
    ``peak_segments`` (counts of ``segment_bytes``-sized isolation
    segments, §III-C)."""

    def __init__(self, capacity_bytes: int, segment_bytes: int,
                 reserved_bytes: int = 0):
        if capacity_bytes < 0 or segment_bytes <= 0:
            raise ValueError("ledger needs capacity >= 0 and segment > 0")
        self.capacity = int(capacity_bytes)
        self.segment_bytes = int(segment_bytes)
        self.reserved = 0
        self.in_use = 0
        self.entries: Dict[int, int] = {}
        # refcounted cross-request prefix segments: key -> [bytes, refs]
        self.shared: Dict[int, List[int]] = {}
        self.shared_in_use = 0
        # LRU retention: a shared entry whose last holder left is
        # parked here (key -> [bytes, expires_at]) for up to
        # ``retention_window`` cycles before its bytes free; retired
        # entries are evicted FIRST under pressure. Window 0 (the
        # default) disables retention entirely — last release frees
        # immediately, exactly the pre-retention behaviour.
        self.retention_window = 0.0
        self.retired: Dict[int, List[float]] = {}
        # cross-tenant segment borrowing (manager-mediated)
        self.borrowed = 0      # extra capacity granted BY co-residents
        self.lent = 0          # own bytes parked FOR co-residents
        self.peak_bytes = 0
        self.peak_segments = 0
        if reserved_bytes:
            self.reserve(reserved_bytes)

    # ------------------------------------------------------------------
    @property
    def available(self) -> int:
        """Bytes still allocatable: effective capacity (own segments
        plus borrowed ones) minus everything resident or lent away."""
        return (self.capacity + self.borrowed - self.reserved
                - self.in_use - self.shared_in_use - self.lent)

    @property
    def occupancy(self) -> int:
        """Bytes a resize must keep: weights + per-request KV + shared
        prefix segments + bytes lent to co-residents (lent segments
        host ANOTHER tenant's live KV — they cannot be shrunk away
        until the loan is reclaimed)."""
        return self.reserved + self.in_use + self.shared_in_use + self.lent

    @property
    def used_segments(self) -> int:
        """HBM isolation segments the live occupancy covers."""
        return -(-self.occupancy // self.segment_bytes)

    def fits(self, nbytes: float) -> bool:
        return nbytes <= self.available

    def reserve(self, nbytes: int) -> None:
        """Set the non-per-request resident share (weights) to
        ``nbytes`` absolute; raises if it cannot fit next to the live
        allocations."""
        nbytes = int(nbytes)
        live = self.in_use + self.shared_in_use + self.lent
        if nbytes < 0 or nbytes + live > self.capacity + self.borrowed:
            raise KVLedgerError(
                f"cannot reserve {nbytes} B: {live} B live KV in a "
                f"{self.capacity} B ledger")
        self.reserved = nbytes
        self._mark()

    def alloc(self, rid: int, nbytes: float) -> bool:
        """Allocate (or grow by) ``nbytes`` for request ``rid``.
        All-or-nothing: returns False — and changes nothing — when the
        ledger would exceed its capacity."""
        n = int(nbytes)
        if n < 0:
            raise KVLedgerError(f"negative allocation ({n} B) for rid {rid}")
        if n > self.available:
            return False
        self.entries[rid] = self.entries.get(rid, 0) + n
        self.in_use += n
        self._mark()
        return True

    def bytes_of(self, rid: int) -> int:
        return self.entries.get(rid, 0)

    def free(self, rid: int) -> int:
        """Release ``rid``'s allocation exactly; raises
        :class:`KVLedgerError` on an unknown rid (double-free)."""
        if rid not in self.entries:
            raise KVLedgerError(f"free of unknown/already-freed rid {rid}")
        n = self.entries.pop(rid)
        self.in_use -= n
        return n

    def release(self, rid: int) -> int:
        """Lenient free: 0 for an unknown rid (used on teardown paths
        where a request may legitimately hold nothing)."""
        if rid not in self.entries:
            return 0
        return self.free(rid)

    # ------------------------------------------------------------------
    # refcounted shared prefix entries
    # ------------------------------------------------------------------
    def acquire_shared(self, key: int, nbytes: float) -> bool:
        """Attach one holder to the shared entry ``key``.

        A resident key only bumps its refcount — a prefix HIT costs no
        bytes. An absent key is FIRST-FILLED all-or-nothing: ``nbytes``
        are charged (False — and nothing changes — when they don't
        fit), then the entry starts at refcount 1. ``nbytes`` of later
        acquires must match the resident size (the prefix hash keys
        the exact token range, so a size mismatch is a caller bug)."""
        n = int(nbytes)
        if n <= 0:
            raise KVLedgerError(
                f"shared entry {key} needs positive bytes, got {n}")
        ent = self.shared.get(key)
        if ent is not None:
            if ent[0] != n:
                raise KVLedgerError(
                    f"shared entry {key} holds {ent[0]} B; acquire asked "
                    f"for {n} B (prefix-hash collision?)")
            ent[1] += 1
            return True
        parked = self.retired.get(key)
        if parked is not None:
            # retention HIT: the bytes never left — revive the entry
            # at refcount 1 with zero fill cost.
            if parked[0] != n:
                raise KVLedgerError(
                    f"retired entry {key} holds {int(parked[0])} B; acquire "
                    f"asked for {n} B (prefix-hash collision?)")
            del self.retired[key]
            self.shared[key] = [n, 1]
            return True
        if n > self.available:
            return False
        self.shared[key] = [n, 1]
        self.shared_in_use += n
        self._mark()
        return True

    def release_shared(self, key: int, now: Optional[float] = None) -> int:
        """Drop one holder of ``key``. The last release frees the
        entry's bytes exactly and returns them; earlier releases
        return 0. Raises on an unknown key (refcount underflow).

        With a positive ``retention_window`` and a ``now`` timestamp,
        the last release instead PARKS the entry in the retired table
        until ``now + retention_window`` — its bytes stay charged (a
        re-``acquire_shared`` before expiry revives it for free) and
        the release returns 0; the bytes free later via
        :meth:`expire_retired` / :meth:`evict_retired`."""
        ent = self.shared.get(key)
        if ent is None:
            raise KVLedgerError(
                f"release of unknown/already-freed shared key {key}")
        ent[1] -= 1
        if ent[1] > 0:
            return 0
        n = ent[0]
        del self.shared[key]
        if self.retention_window > 0 and now is not None:
            self.retired[key] = [n, now + self.retention_window]
            return 0
        self.shared_in_use -= n
        return n

    def shared_refs(self, key: int) -> int:
        """Holders of shared entry ``key`` (0 when absent)."""
        ent = self.shared.get(key)
        return 0 if ent is None else ent[1]

    def shared_bytes_of(self, key: int) -> int:
        ent = self.shared.get(key)
        return 0 if ent is None else ent[0]

    @property
    def retired_bytes(self) -> int:
        """Bytes held by retired (zero-holder, retained) entries."""
        return sum(int(v[0]) for v in self.retired.values())

    def expire_retired(self, now: float) -> int:
        """Free every retired entry whose retention window has lapsed
        (``expires_at <= now``); returns the bytes freed."""
        freed = 0
        for key in [k for k, v in self.retired.items() if v[1] <= now]:
            n = int(self.retired.pop(key)[0])
            self.shared_in_use -= n
            freed += n
        return freed

    def evict_retired(self, nbytes: float, now: Optional[float] = None) -> int:
        """Free retired entries under pressure — expired ones first,
        then oldest-expiry-first — until at least ``nbytes`` are freed
        or the table is empty. Returns the bytes freed. Retired
        entries are strictly cheaper victims than live KV (no holder
        loses state), so callers try this before PREMA eviction."""
        freed = 0
        if now is not None:
            freed = self.expire_retired(now)
        if freed >= nbytes:
            return freed
        for key in sorted(self.retired, key=lambda k: (self.retired[k][1], k)):
            if freed >= nbytes:
                break
            n = int(self.retired.pop(key)[0])
            self.shared_in_use -= n
            freed += n
        return freed

    def flush_retired(self) -> int:
        """Free ALL retired entries regardless of expiry (drain /
        teardown); returns the bytes freed."""
        n = self.retired_bytes
        self.retired.clear()
        self.shared_in_use -= n
        return n

    # ------------------------------------------------------------------
    # cross-tenant borrowing (counters only; the VNPUManager owns the
    # loan table and pairs every lend() with a grant() on the borrower)
    # ------------------------------------------------------------------
    def lend(self, nbytes: int) -> bool:
        """Park ``nbytes`` of THIS ledger's idle capacity for a
        co-resident borrower. All-or-nothing against ``available``."""
        n = int(nbytes)
        if n < 0:
            raise KVLedgerError(f"negative lend ({n} B)")
        if n > self.available:
            return False
        self.lent += n
        self._mark()
        return True

    def reclaim_lent(self, nbytes: int) -> None:
        """Take back ``nbytes`` previously lent (the borrower's grant
        was revoked first — manager-ordered, so the segments are idle
        again by the time they return)."""
        n = int(nbytes)
        if n < 0 or n > self.lent:
            raise KVLedgerError(
                f"reclaim of {n} B exceeds the {self.lent} B lent out")
        self.lent -= n

    def grant(self, nbytes: int) -> None:
        """Extend effective capacity by ``nbytes`` borrowed from a
        co-resident ledger (paired with that ledger's ``lend``)."""
        n = int(nbytes)
        if n < 0:
            raise KVLedgerError(f"negative grant ({n} B)")
        self.borrowed += n

    def revoke(self, nbytes: int) -> int:
        """Give back up to ``nbytes`` of borrowed capacity — only what
        is IDLE (not holding live KV) can leave. Returns the bytes
        actually revoked; the manager reclaims exactly that much on
        the lender side."""
        n = int(nbytes)
        if n < 0:
            raise KVLedgerError(f"negative revoke ({n} B)")
        take = min(n, self.borrowed, max(self.available, 0))
        self.borrowed -= take
        return take

    def clear(self) -> int:
        """Release every per-request allocation AND every shared
        prefix entry (tenant teardown); ``reserved`` stays until the
        vNPU itself is destroyed, and any loan counters stay until the
        manager settles them."""
        n = self.in_use + self.shared_in_use
        self.entries.clear()
        self.in_use = 0
        self.shared.clear()
        self.retired.clear()
        self.shared_in_use = 0
        return n

    def migrate_from(self, other: "KVLedger") -> None:
        """Adopt ``other``'s live state (vNPU reconfigure carries the
        ledger to the re-placed vNPU). Raises when the live occupancy
        — per-request KV, shared prefix segments, AND bytes lent to
        co-residents — does not fit the new capacity: shrinking a
        refcounted or lent segment out from under its holders would
        corrupt state, so the caller must drain/reclaim or reject the
        resize first. Borrowed capacity carries over (the manager
        re-keys its loan table to the new vNPU)."""
        need = (other.reserved + other.in_use + other.shared_in_use
                + other.lent)
        if need > self.capacity + other.borrowed:
            raise KVLedgerError(
                f"live occupancy {need} B exceeds the resized capacity "
                f"{self.capacity} B; evict or reject the resize")
        self.reserved = other.reserved
        self.in_use = other.in_use
        self.entries = dict(other.entries)
        self.shared = {k: list(v) for k, v in other.shared.items()}
        self.shared_in_use = other.shared_in_use
        self.retention_window = other.retention_window
        self.retired = {k: list(v) for k, v in other.retired.items()}
        self.borrowed = other.borrowed
        self.lent = other.lent
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)
        self.peak_segments = max(self.peak_segments, other.peak_segments)
        self._mark()

    def migrate_entry_to(self, dst: "KVLedger", rid: int,
                         dst_rid: Optional[int] = None) -> int:
        """Cross-ledger transfer of ONE request's allocation (the
        fabric's prefill->decode hand-off between cores): the
        DESTINATION ledger is charged first, all-or-nothing, and only
        then does the source free — a crash or reject mid-protocol
        can never leak or double-count segments.

        Returns the bytes moved, or -1 when the destination cannot
        hold them (destination pressure: nothing changed on either
        side — the caller falls back to local decode). Raises
        :class:`KVLedgerError` for an unknown source rid, exactly
        like :meth:`free`."""
        if rid not in self.entries:
            raise KVLedgerError(
                f"migrate of unknown/already-freed rid {rid}")
        n = self.entries[rid]
        if dst is self:
            return n                   # same ledger: nothing to move
        if dst_rid is None:
            dst_rid = rid
        if dst_rid in dst.entries:
            # a silent alloc here would MERGE into the resident
            # entry's bytes and the later free would release both
            # requests' KV at once — refuse before touching anything.
            raise KVLedgerError(
                f"migrate target rid {dst_rid} already live in the "
                f"destination ledger; both ledgers untouched")
        if not dst.alloc(dst_rid, n):
            return -1                  # reject: both ledgers untouched
        self.free(rid)
        return n

    def shrink_capacity(self, nbytes: int) -> None:
        """Permanently remove ``nbytes`` of capacity (an HBM segment
        fault). Raises when the live occupancy would no longer fit —
        the caller must evict/flush down to the new size first, or
        escalate to evacuation."""
        n = int(nbytes)
        if n < 0 or n > self.capacity:
            raise KVLedgerError(
                f"cannot shrink {self.capacity} B ledger by {n} B")
        if self.occupancy > self.capacity - n + self.borrowed:
            raise KVLedgerError(
                f"occupancy {self.occupancy} B exceeds the faulted "
                f"capacity {self.capacity - n} B; evict first")
        self.capacity -= n

    def _mark(self) -> None:
        used = self.occupancy
        if used > self.peak_bytes:
            self.peak_bytes = used
        segs = self.used_segments
        if segs > self.peak_segments:
            self.peak_segments = segs


_ids = itertools.count()


@dataclass
class VNPU:
    """A vNPU instance tracked by the vNPU manager."""

    config: VNPUConfig
    name: str = ""
    vnpu_id: int = field(default_factory=lambda: next(_ids))
    state: VNPUState = VNPUState.CREATED
    # filled in by the mapper
    pnpu_id: Optional[int] = None
    core_id: Optional[int] = None
    me_ids: Tuple[int, ...] = ()
    ve_ids: Tuple[int, ...] = ()
    segments: Optional[MemorySegments] = None
    mapping: str = "spatial"  # "spatial" (hw-isolated) | "temporal"
    # live HBM accounting against this vNPU's segment allocation
    # (created by the mapper; carried across reconfigures)
    kv_ledger: Optional[KVLedger] = None

    def __post_init__(self):
        if not self.name:
            self.name = f"vnpu{self.vnpu_id}"

    def destroy(self) -> None:
        self.state = VNPUState.DESTROYED
        self.me_ids = ()
        self.ve_ids = ()
        self.segments = None
        self.kv_ledger = None
