"""vNPU -> pNPU mapping (§III-C).

The vNPU manager tracks every physical NPU's free MEs/VEs and
SRAM/HBM segments, and places vNPUs under two schemes:

* ``spatial``  (hardware-isolated): dedicated EUs + segments. A set of
  vNPUs is collocatable iff total EU/memory demand fits the pNPU.
* ``temporal`` (software-isolated): EUs oversubscribed; placement
  load-balances total demand across pNPUs.

The default placement is the paper's greedy rule: balance the
*fraction* of EUs vs memory consumed on each core, so EU-hungry
vNPUs land next to memory-hungry ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.vnpu import (KVLedger, KVLedgerError, MemorySegments, VNPU,
                             VNPUConfig, VNPUState)
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig


class ReconfigureError(RuntimeError):
    """A vNPU reconfigure could not be placed; the original mapping
    was restored and is available as ``.restored``."""

    def __init__(self, msg: str, restored: VNPU):
        super().__init__(msg)
        self.restored = restored


@dataclass
class CoreState:
    """Bookkeeping for one physical NPU core."""

    core: NPUCoreConfig
    pnpu_id: int
    core_id: int
    free_mes: List[int] = field(default_factory=list)
    free_ves: List[int] = field(default_factory=list)
    free_sram_segs: List[int] = field(default_factory=list)
    free_hbm_segs: List[int] = field(default_factory=list)
    residents: List[int] = field(default_factory=list)  # vnpu ids
    # temporal mode: cumulative oversubscribed demand
    demand_me: int = 0
    demand_ve: int = 0
    # fault state: a failed core accepts no placements until restored;
    # faulted HBM segments are permanently out of every free list
    failed: bool = False
    faulted_hbm_segs: List[int] = field(default_factory=list)

    def __post_init__(self):
        c = self.core
        self.free_mes = list(range(c.n_me))
        self.free_ves = list(range(c.n_ve))
        self.free_sram_segs = list(range(c.sram_bytes // c.sram_segment))
        self.free_hbm_segs = list(range(c.hbm_bytes // c.hbm_segment))

    # -- utilization fractions for the greedy balance rule --
    @property
    def eu_used_frac(self) -> float:
        c = self.core
        used = (c.n_me - len(self.free_mes)) + (c.n_ve - len(self.free_ves))
        return used / (c.n_me + c.n_ve)

    @property
    def mem_used_frac(self) -> float:
        c = self.core
        total = c.hbm_bytes // c.hbm_segment
        return (total - len(self.free_hbm_segs)) / max(total, 1)

    def fits_spatial(self, cfg: VNPUConfig) -> bool:
        if self.failed:
            return False
        c = self.core
        n_sram = -(-max(cfg.sram_bytes, c.sram_segment) // c.sram_segment)
        n_hbm = -(-max(cfg.hbm_bytes, c.hbm_segment) // c.hbm_segment)
        return (
            len(self.free_mes) >= cfg.n_me
            and len(self.free_ves) >= cfg.n_ve
            and len(self.free_sram_segs) >= n_sram
            and len(self.free_hbm_segs) >= n_hbm
        )


class VNPUManager:
    """Host-side vNPU manager (the paper's kernel-module control
    plane, minus the KVM plumbing — see DESIGN.md §3)."""

    def __init__(self, n_pnpus: int = 1, cores_per_pnpu: int = 1,
                 core: NPUCoreConfig = DEFAULT_CORE):
        self.core_cfg = core
        self.cores: List[CoreState] = [
            CoreState(core, p, c)
            for p in range(n_pnpus)
            for c in range(cores_per_pnpu)
        ]
        self.vnpus: Dict[int, VNPU] = {}
        # cross-tenant HBM loans: (lender vnpu_id, borrower vnpu_id)
        # -> bytes. The ledgers carry only their lent/borrowed totals;
        # this table is the authority on who owes whom.
        self._loans: Dict[Tuple[int, int], int] = {}

    # ------------------------------------------------------------------
    def create(self, cfg: VNPUConfig, name: str = "",
               mapping: str = "spatial",
               core_hint: Optional[int] = None) -> VNPU:
        """``core_hint`` pins placement to one core index (the fabric
        control plane's topology-aware choice; a live per-core
        simulation also pins resizes so a tenant cannot silently hop
        cores). ``None`` keeps the unrestricted greedy rule."""
        cfg.validate(self.core_cfg)
        v = VNPU(config=cfg, name=name, mapping=mapping)
        self.vnpus[v.vnpu_id] = v
        self._map(v, core_hint=core_hint)
        return v

    def destroy(self, v: VNPU, _settle_loans: bool = True) -> None:
        """vNPU deallocation: clean the context, release EUs+segments,
        tear down the (modeled) DMA mappings. Outstanding HBM loans
        are settled first (``reconfigure`` opts out: the re-placed
        vNPU inherits them via the ledger migration + loan re-key)."""
        if v.state == VNPUState.DESTROYED:
            return
        if _settle_loans:
            self._settle_loans(v)
        cs = self._core_of(v)
        if cs is not None:
            if v.mapping == "spatial":
                cs.free_mes.extend(v.me_ids)
                cs.free_ves.extend(v.ve_ids)
                cs.free_mes.sort()
                cs.free_ves.sort()
            else:
                cs.demand_me -= v.config.n_me
                cs.demand_ve -= v.config.n_ve
            if v.segments is not None:
                cs.free_sram_segs.extend(
                    s for s in v.segments.sram_segments)
                cs.free_hbm_segs.extend(
                    s for s in v.segments.hbm_segments)
                cs.free_sram_segs.sort()
                cs.free_hbm_segs.sort()
            cs.residents.remove(v.vnpu_id)
        v.destroy()

    def reconfigure(self, v: VNPU, cfg: VNPUConfig,
                    core_hint: Optional[int] = None) -> VNPU:
        """Paper hypercall (2): change an existing vNPU's config.

        All-or-nothing: if the new config cannot be placed, the old
        mapping is restored and :class:`ReconfigureError` is raised
        carrying the restored vNPU (live control planes must keep a
        valid handle — a failed grow must not kill the tenant).

        The vNPU's KV ledger (live per-request HBM occupancy) is
        carried to the new mapping. A resize whose HBM allocation
        cannot hold the live occupancy is REJECTED the same
        all-or-nothing way: callers must evict/swap the excess first —
        shrinking segments out from under resident KV would corrupt
        tenant state."""
        mapping = v.mapping
        old_cfg = v.config
        old_ledger = v.kv_ledger
        old_id = v.vnpu_id
        self.destroy(v, _settle_loans=False)

        def _restore() -> VNPU:
            restored = self.create(old_cfg, name=v.name, mapping=mapping,
                                   core_hint=core_hint)
            if old_ledger is not None:
                restored.kv_ledger.migrate_from(old_ledger)
            self._rekey_loans(old_id, restored.vnpu_id)
            return restored

        try:
            nv = self.create(cfg, name=v.name, mapping=mapping,
                             core_hint=core_hint)
        except RuntimeError as exc:
            raise ReconfigureError(
                f"reconfigure of vNPU {v.name!r} to "
                f"{cfg.n_me}ME/{cfg.n_ve}VE failed ({exc}); "
                f"previous mapping restored", _restore()) from exc
        if old_ledger is not None:
            try:
                nv.kv_ledger.migrate_from(old_ledger)
            except KVLedgerError as exc:
                self.destroy(nv, _settle_loans=False)
                raise ReconfigureError(
                    f"reconfigure of vNPU {v.name!r} rejected: {exc}; "
                    f"previous mapping restored", _restore()) from exc
        self._rekey_loans(old_id, nv.vnpu_id)
        return nv

    # ------------------------------------------------------------------
    def _core_of(self, v: VNPU) -> Optional[CoreState]:
        for cs in self.cores:
            if v.vnpu_id in cs.residents:
                return cs
        return None

    def core_index_of(self, v: VNPU) -> int:
        """Fabric-facing: index (into ``self.cores``) of the core a
        vNPU is mapped on. Raises for an unmapped/destroyed vNPU."""
        for i, cs in enumerate(self.cores):
            if v.vnpu_id in cs.residents:
                return i
        raise ValueError(f"vNPU {v.name!r} is not mapped on any core")

    def _alloc_segments(self, cs: CoreState, cfg: VNPUConfig) -> MemorySegments:
        c = cs.core
        n_sram = -(-max(cfg.sram_bytes, c.sram_segment) // c.sram_segment)
        n_hbm = -(-max(cfg.hbm_bytes, c.hbm_segment) // c.hbm_segment)
        if len(cs.free_sram_segs) < n_sram or len(cs.free_hbm_segs) < n_hbm:
            raise RuntimeError("out of memory segments")
        sram = tuple(cs.free_sram_segs[:n_sram])
        hbm = tuple(cs.free_hbm_segs[:n_hbm])
        del cs.free_sram_segs[:n_sram]
        del cs.free_hbm_segs[:n_hbm]
        return MemorySegments(sram, hbm, c.sram_segment, c.hbm_segment)

    def _map(self, v: VNPU, core_hint: Optional[int] = None) -> None:
        cfg = v.config
        pool = self.cores
        if core_hint is not None:
            if not 0 <= core_hint < len(self.cores):
                raise ValueError(
                    f"core_hint {core_hint} out of range for "
                    f"{len(self.cores)} cores")
            if self.cores[core_hint].failed:
                raise RuntimeError(
                    f"core {core_hint} has failed; place elsewhere")
            pool = [self.cores[core_hint]]
        elif any(cs.failed for cs in pool):
            pool = [cs for cs in pool if not cs.failed]
            if not pool:
                raise RuntimeError("every core in the pool has failed")
        if v.mapping == "spatial":
            # greedy §III-C: among cores that fit, pick the one where
            # adding this vNPU best balances EU-frac vs mem-frac.
            def imbalance(cs: CoreState) -> float:
                c = cs.core
                eu = cs.eu_used_frac + cfg.n_eus / (c.n_me + c.n_ve)
                total_hbm = c.hbm_bytes // c.hbm_segment
                mem = cs.mem_used_frac + (
                    -(-max(cfg.hbm_bytes, c.hbm_segment) // c.hbm_segment)
                    / max(total_hbm, 1)
                )
                return abs(eu - mem)

            candidates = [cs for cs in pool if cs.fits_spatial(cfg)]
            if not candidates:
                raise RuntimeError(
                    f"no pNPU core fits vNPU {cfg.n_me}ME/{cfg.n_ve}VE "
                    f"(spatial); free up resources or use temporal mapping"
                )
            cs = min(candidates, key=imbalance)
            v.me_ids = tuple(cs.free_mes[: cfg.n_me])
            v.ve_ids = tuple(cs.free_ves[: cfg.n_ve])
            del cs.free_mes[: cfg.n_me]
            del cs.free_ves[: cfg.n_ve]
        else:
            # temporal: least-loaded core by oversubscribed demand
            cs = min(pool, key=lambda c: c.demand_me + c.demand_ve)
            cs.demand_me += cfg.n_me
            cs.demand_ve += cfg.n_ve
            v.me_ids = tuple(range(cfg.n_me))   # logical ids
            v.ve_ids = tuple(range(cfg.n_ve))
        v.segments = self._alloc_segments(cs, cfg)
        # live HBM accounting over exactly the segments this vNPU owns
        v.kv_ledger = KVLedger(v.segments.hbm_bytes, cs.core.hbm_segment)
        cs.residents.append(v.vnpu_id)
        v.pnpu_id, v.core_id = cs.pnpu_id, cs.core_id
        v.state = VNPUState.MAPPED

    # ------------------------------------------------------------------
    # fault injection
    # ------------------------------------------------------------------
    def fail_core(self, idx: int) -> List[int]:
        """Mark core ``idx`` failed: no new placements land on it
        until :meth:`restore_core`. Residents stay mapped (the control
        plane evacuates or suspends them). Returns the resident vNPU
        ids at fault time."""
        cs = self.cores[idx]
        cs.failed = True
        return list(cs.residents)

    def restore_core(self, idx: int) -> None:
        """A transient core fault healed: accept placements again."""
        self.cores[idx].failed = False

    def healthy_cores(self) -> List[int]:
        """Indices of cores currently accepting placements."""
        return [i for i, cs in enumerate(self.cores) if not cs.failed]

    def fault_hbm_segments(self, v: VNPU, n: int = 1) -> int:
        """``n`` of vNPU ``v``'s HBM isolation segments fault away
        (a bad HBM row inside its allocation). All-or-nothing: the
        ledger capacity shrinks FIRST — raising
        :class:`~repro_torch.core.vnpu.KVLedgerError` untouched when the
        live occupancy would no longer fit, so the caller evicts down
        (or escalates to evacuation) and retries — and only then do
        the physical segments leave the vNPU, parked on the core's
        ``faulted_hbm_segs`` list (never returned to a free list).
        Returns the bytes removed."""
        if v.segments is None or v.kv_ledger is None:
            raise ValueError(f"vNPU {v.name!r} is not mapped")
        cs = self._core_of(v)
        if cs is None:
            raise ValueError(f"vNPU {v.name!r} is not resident on any core")
        n = min(n, len(v.segments.hbm_segments))
        if n <= 0:
            return 0
        seg = v.kv_ledger.segment_bytes
        v.kv_ledger.shrink_capacity(n * seg)   # raises before any mutation
        hbm = v.segments.hbm_segments
        lost, kept = hbm[-n:], hbm[:-n]
        cs.faulted_hbm_segs.extend(lost)
        cs.faulted_hbm_segs.sort()
        v.segments = MemorySegments(
            v.segments.sram_segments, kept,
            v.segments.sram_segment_size, v.segments.hbm_segment_size)
        return n * seg

    def fault_free_hbm_segments(self, idx: int, n: int = 1) -> int:
        """``n`` HBM segments fault out of core ``idx``'s FREE pool —
        a bad row outside any allocation, or the segments a vNPU
        vacated when its HBM fault escalated to whole-vNPU failover.
        Clamped to the free list; returns the segments faulted."""
        cs = self.cores[idx]
        n = min(n, len(cs.free_hbm_segs))
        if n <= 0:
            return 0
        lost = cs.free_hbm_segs[-n:]
        del cs.free_hbm_segs[-n:]
        cs.faulted_hbm_segs.extend(lost)
        cs.faulted_hbm_segs.sort()
        return n

    def hbm_census(self) -> List[Tuple[int, int, int, int]]:
        """Per-core ``(free, resident, faulted, total)`` HBM segment
        counts — conservation holds iff ``free + resident + faulted ==
        total`` on every core at all times."""
        out = []
        for cs in self.cores:
            total = cs.core.hbm_bytes // cs.core.hbm_segment
            resident = sum(
                len(self.vnpus[i].segments.hbm_segments)
                for i in cs.residents
                if self.vnpus[i].segments is not None)
            out.append((len(cs.free_hbm_segs), resident,
                        len(cs.faulted_hbm_segs), total))
        return out

    # ------------------------------------------------------------------
    def collocated(self, v: VNPU) -> List[VNPU]:
        cs = self._core_of(v)
        if cs is None:
            return []
        return [self.vnpus[i] for i in cs.residents if i != v.vnpu_id]

    # ------------------------------------------------------------------
    # cross-tenant HBM borrowing (reclaim-on-pressure protocol)
    # ------------------------------------------------------------------
    def borrow_hbm(self, v: VNPU, nbytes: int) -> int:
        """Borrow up to ``nbytes`` (rounded up to whole isolation
        segments) of IDLE HBM from co-resident vNPUs' ledgers for
        ``v``. Deterministic: lenders are scanned in vnpu_id order,
        each granting as many idle segments as it can spare. Returns
        the bytes actually granted (0 when no co-resident has an idle
        segment)."""
        led = v.kv_ledger
        if led is None or nbytes <= 0:
            return 0
        seg = led.segment_bytes
        need_segs = -(-int(nbytes) // seg)
        got = 0
        for peer in sorted(self.collocated(v), key=lambda p: p.vnpu_id):
            if need_segs <= 0:
                break
            plend = peer.kv_ledger
            if plend is None:
                continue
            idle_segs = max(plend.available, 0) // seg
            take_segs = min(need_segs, idle_segs)
            if take_segs <= 0:
                continue
            take = take_segs * seg
            if not plend.lend(take):      # pragma: no cover (idle-checked)
                continue
            led.grant(take)
            key = (peer.vnpu_id, v.vnpu_id)
            self._loans[key] = self._loans.get(key, 0) + take
            got += take
            need_segs -= take_segs
        return got

    def reclaim_hbm(self, v: VNPU, nbytes: int) -> int:
        """Reclaim-on-pressure: pull back up to ``nbytes`` that ``v``
        lent out, BEFORE its own admission blocks. Only the idle share
        of each loan can return (live KV on a borrowed segment stays
        until the borrower frees it). Returns the bytes reclaimed."""
        led = v.kv_ledger
        if led is None or nbytes <= 0 or led.lent <= 0:
            return 0
        got = 0
        for key in sorted(k for k in self._loans if k[0] == v.vnpu_id):
            if got >= nbytes:
                break
            borrower = self.vnpus.get(key[1])
            bled = None if borrower is None else borrower.kv_ledger
            if bled is None:
                continue
            back = bled.revoke(min(self._loans[key], int(nbytes) - got))
            if back <= 0:
                continue
            led.reclaim_lent(back)
            self._loans[key] -= back
            if self._loans[key] <= 0:
                del self._loans[key]
            got += back
        return got

    def return_borrowed(self, v: VNPU) -> int:
        """Give back every byte ``v`` borrowed from co-residents (a
        loan cannot follow a vNPU off its core, so evacuation unwinds
        the borrower side first). Only IDLE borrowed capacity can
        leave — the caller evicts ``v``'s KV down to its own segments
        before calling; live KV still riding borrowed capacity raises,
        loans untouched past the ones already returned. Returns the
        bytes returned."""
        led = v.kv_ledger
        got = 0
        for key in sorted(k for k in self._loans if k[1] == v.vnpu_id):
            n = self._loans[key]
            back = 0 if led is None else led.revoke(n)
            if back < n:
                if led is not None:
                    led.grant(back)     # undo the partial revoke
                raise KVLedgerError(
                    f"vNPU {v.name!r} still holds live KV on {n - back} B "
                    f"of borrowed capacity; evict before evacuating")
            lender = self.vnpus.get(key[0])
            if lender is not None and lender.kv_ledger is not None:
                lender.kv_ledger.reclaim_lent(back)
            del self._loans[key]
            got += back
        return got

    def borrowers_of(self, v: VNPU) -> List[int]:
        """vnpu_ids currently borrowing capacity from ``v`` (sorted;
        failover force-drains them before evacuating the lender)."""
        return sorted(b for (l, b) in self._loans if l == v.vnpu_id)

    def loans_of(self, v: VNPU) -> Tuple[int, int]:
        """(bytes lent out, bytes borrowed) per the loan table."""
        lent = sum(n for (l, _), n in self._loans.items()
                   if l == v.vnpu_id)
        borrowed = sum(n for (_, b), n in self._loans.items()
                       if b == v.vnpu_id)
        return lent, borrowed

    def _settle_loans(self, v: VNPU) -> None:
        """Unwind every loan involving ``v`` (destroy path). As a
        borrower, its grant vanishes with it — the lender gets its
        bytes back in full. As a lender, the borrower must be able to
        give the idle bytes back; live KV stranded on a dying lender's
        segments is a control-plane bug and raises."""
        for key in sorted(k for k in self._loans if v.vnpu_id in k):
            n = self._loans.pop(key)
            lender = self.vnpus.get(key[0])
            borrower = self.vnpus.get(key[1])
            if key[1] == v.vnpu_id:       # v borrowed: return in full
                if v.kv_ledger is not None:
                    v.kv_ledger.borrowed = max(v.kv_ledger.borrowed - n, 0)
                if lender is not None and lender.kv_ledger is not None:
                    lender.kv_ledger.reclaim_lent(n)
                continue
            # v lent: the borrower must release the idle capacity now
            bled = None if borrower is None else borrower.kv_ledger
            back = 0 if bled is None else bled.revoke(n)
            if bled is not None and back < n:
                raise KVLedgerError(
                    f"vNPU {v.name!r} destroyed with {n - back} B of its "
                    f"segments still holding live borrowed KV; drain the "
                    f"borrower first")
            if v.kv_ledger is not None:
                v.kv_ledger.reclaim_lent(n if bled is None else back)

    def _rekey_loans(self, old_id: int, new_id: int) -> None:
        """Reconfigure carried a ledger (and its loan counters) to a
        new vNPU id: move the loan-table keys with it. Session resizes
        are core-pinned, so co-residency — the physical premise of a
        loan — survives the re-placement."""
        for key in [k for k in self._loans if old_id in k]:
            n = self._loans.pop(key)
            nk = (new_id if key[0] == old_id else key[0],
                  new_id if key[1] == old_id else key[1])
            self._loans[nk] = self._loans.get(nk, 0) + n
