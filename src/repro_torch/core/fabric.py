"""Multi-pNPU cluster fabric: the inter-core link topology and the
cross-core phase-migration protocol (cluster-scale vNPU serving).

The paper virtualizes one pNPU; its pay-as-you-go model only pays off
at cloud scale when vNPUs map onto a *fleet* of cores connected by an
inter-core fabric ("Topology-Aware Virtualization over Inter-Core
Connected NPUs"; DistServe-style prefill/decode disaggregation). This
module provides the pieces the control plane composes:

* :class:`FabricTopology` — a link graph over the cluster's cores
  (ring / 2-D mesh / fully-connected builders, or any custom edge
  set), each link carrying a bandwidth (bytes/cycle) and a latency
  (cycles). A transfer is priced store-and-forward over the shortest
  path: ``sum over hops of (link latency + bytes / link bandwidth)``
  — for uniform links exactly ``hops x (latency + bytes/bw)``, the
  hop-count x KV-bytes cost model.
* :class:`Placement` — the ``register_generative(placement=...)``
  request: where a tenant's prefill pool and decode pool land
  (explicit cores, or ``"topo"`` / ``"random"`` auto strategies) and
  how the EU budget splits between them.
* :func:`random_phase_pair` — the seeded random-placement baseline
  the fabric benchmark compares the topology-aware allocator
  (:func:`repro_torch.core.allocator.place_phase_pair`) against.

The migration protocol itself (destination KV ledger charged before
the source frees, all-or-nothing, reject-to-local-decode under
destination pressure) is :meth:`repro_torch.core.vnpu.KVLedger.
migrate_entry_to` driven by the serving session's migration hook; one
:class:`~repro_torch.core.simulator.Simulator` per core is advanced in
lockstep by :class:`repro_torch.serve.session.ServingSession`.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.npu.hw_config import DEFAULT_CORE

# Default link model: one inter-core interconnect lane per link,
# expressed in the simulator's cycle domain, plus a per-hop launch
# latency (DMA descriptor + switch traversal). The link rate is the
# simulated fabric's, taken from the reference package (its TPU-v5e ICI
# lane, 50e9 B/s) so that both packages simulate the same fabric; it is
# not a rate of the GPU the port runs on.
SIM_LINK_BYTES_PER_S = 50e9
DEFAULT_LINK_BW = SIM_LINK_BYTES_PER_S / DEFAULT_CORE.freq_hz  # B/cycle
DEFAULT_LINK_LATENCY = 2_000.0                                  # cycles


@dataclass(frozen=True)
class FabricLink:
    """One bidirectional inter-core link. ``bandwidth`` is bytes per
    cycle of the core clock; ``latency`` is cycles per traversal."""

    bandwidth: float = DEFAULT_LINK_BW
    latency: float = DEFAULT_LINK_LATENCY

    def __post_init__(self):
        if self.bandwidth <= 0 or self.latency < 0:
            raise ValueError(
                f"link needs bandwidth > 0 B/cycle and latency >= 0 "
                f"cycles, got {self.bandwidth}/{self.latency}")


class FabricTopology:
    """Link graph over ``n_cores`` pNPU cores.

    Edges are undirected and keyed on the sorted core pair; cores with
    no path between them are unreachable (``hops`` returns ``inf`` and
    transfers are unpriceable — placement never pairs them). Shortest
    paths are hop-count BFS, cached per source."""

    def __init__(self, n_cores: int,
                 links: Dict[Tuple[int, int], FabricLink],
                 kind: str = "custom"):
        if n_cores < 1:
            raise ValueError(f"topology needs >= 1 core, got {n_cores}")
        self.n_cores = n_cores
        self.kind = kind
        self.links: Dict[Tuple[int, int], FabricLink] = {}
        self._adj: List[List[int]] = [[] for _ in range(n_cores)]
        for (a, b), link in links.items():
            a, b = int(a), int(b)
            if not (0 <= a < n_cores and 0 <= b < n_cores) or a == b:
                raise ValueError(f"bad link endpoints ({a}, {b}) for "
                                 f"{n_cores} cores")
            key = (min(a, b), max(a, b))
            if key in self.links:
                continue
            self.links[key] = link
            self._adj[a].append(b)
            self._adj[b].append(a)
        for nbrs in self._adj:
            nbrs.sort()
        self._paths: Dict[int, Dict[int, Tuple[int, ...]]] = {}
        # pristine link set, kept so fault injection can restore a
        # degraded/failed link to its exact base parameters
        self._base_links: Dict[Tuple[int, int], FabricLink] = dict(self.links)

    # ---------------- builders ----------------
    @classmethod
    def single(cls) -> "FabricTopology":
        """Degenerate one-core fabric (no links; the single-pNPU
        engine path — every transfer cost is zero)."""
        return cls(1, {}, kind="single")

    @classmethod
    def ring(cls, n: int, link: FabricLink = FabricLink()
             ) -> "FabricTopology":
        """Bidirectional ring: core i links to (i+1) mod n."""
        if n == 1:
            return cls.single()
        links = {(i, (i + 1) % n): link for i in range(n)}
        return cls(n, links, kind="ring")

    @classmethod
    def mesh(cls, n: int, link: FabricLink = FabricLink()
             ) -> "FabricTopology":
        """2-D mesh on the most-square r x c grid with r*c == n
        (degenerates to a line for prime n)."""
        if n == 1:
            return cls.single()
        r = int(math.isqrt(n))
        while n % r:
            r -= 1
        c = n // r
        links = {}
        for i in range(n):
            y, x = divmod(i, c)
            if x + 1 < c:
                links[(i, i + 1)] = link
            if y + 1 < r:
                links[(i, i + c)] = link
        return cls(n, links, kind="mesh")

    @classmethod
    def fully_connected(cls, n: int, link: FabricLink = FabricLink()
                        ) -> "FabricTopology":
        """Every core one hop from every other (switched fabric)."""
        if n == 1:
            return cls.single()
        links = {(a, b): link
                 for a in range(n) for b in range(a + 1, n)}
        return cls(n, links, kind="fully_connected")

    # ---------------- fault injection ----------------
    def _rebuild_adj(self) -> None:
        self._adj = [[] for _ in range(self.n_cores)]
        for a, b in self.links:
            self._adj[a].append(b)
            self._adj[b].append(a)
        for nbrs in self._adj:
            nbrs.sort()
        self._paths.clear()

    def _base_key(self, a: int, b: int) -> Tuple[int, int]:
        key = (min(a, b), max(a, b))
        if key not in self._base_links:
            raise ValueError(f"no link ({a}, {b}) in this topology")
        return key

    def degrade_link(self, a: int, b: int, bw_scale: float) -> None:
        """Scale link (a, b)'s bandwidth to ``bw_scale`` x its BASE
        bandwidth. ``bw_scale == 0`` is a full outage: the link drops
        out of the graph and routes re-plan around it (a pair left
        with no path prices transfers at ``inf`` — migration hooks
        reject and decode locally). Idempotent per absolute scale."""
        key = self._base_key(a, b)
        base = self._base_links[key]
        if bw_scale < 0:
            raise ValueError(f"bw_scale must be >= 0, got {bw_scale}")
        if bw_scale == 0:
            self.links.pop(key, None)
        else:
            self.links[key] = FabricLink(bandwidth=base.bandwidth * bw_scale,
                                         latency=base.latency)
        self._rebuild_adj()

    def fail_link(self, a: int, b: int) -> None:
        """Full link outage — shorthand for ``degrade_link(a, b, 0)``."""
        self.degrade_link(a, b, 0.0)

    def restore_link(self, a: int, b: int) -> None:
        """Return link (a, b) to its pristine base parameters."""
        key = self._base_key(a, b)
        self.links[key] = self._base_links[key]
        self._rebuild_adj()

    # ---------------- queries ----------------
    def neighbors(self, core: int) -> Tuple[int, ...]:
        return tuple(self._adj[core])

    def link(self, a: int, b: int) -> FabricLink:
        return self.links[(min(a, b), max(a, b))]

    def _bfs(self, src: int) -> Dict[int, Tuple[int, ...]]:
        """Shortest path (as the visited-core sequence src..dst) to
        every reachable core; deterministic (lowest-id tie-break)."""
        paths = self._paths.get(src)
        if paths is not None:
            return paths
        paths = {src: (src,)}
        q = deque([src])
        while q:
            u = q.popleft()
            for v in self._adj[u]:
                if v not in paths:
                    paths[v] = paths[u] + (v,)
                    q.append(v)
        self._paths[src] = paths
        return paths

    def hops(self, src: int, dst: int) -> float:
        """Shortest-path hop count (0 for src==dst, inf when
        unreachable)."""
        path = self._bfs(src).get(dst)
        return math.inf if path is None else float(len(path) - 1)

    def path_links(self, src: int, dst: int) -> List[Tuple[int, int]]:
        """The (a, b) link sequence of the shortest src->dst path."""
        path = self._bfs(src).get(dst)
        if path is None:
            raise ValueError(f"cores {src} and {dst} are not connected")
        return [(path[i], path[i + 1]) for i in range(len(path) - 1)]

    def transfer_cycles(self, src: int, dst: int, nbytes: float) -> float:
        """Cycles to move ``nbytes`` from core ``src`` to ``dst``:
        store-and-forward over the shortest path, each hop paying its
        link latency plus the serialization time ``nbytes /
        bandwidth`` — hop count x KV bytes over the link model.
        ``inf`` for unreachable pairs (placement skips them)."""
        if src == dst:
            return 0.0
        if self._bfs(src).get(dst) is None:
            return math.inf
        total = 0.0
        for a, b in self.path_links(src, dst):
            link = self.link(a, b)
            total += link.latency + float(nbytes) / link.bandwidth
        return total

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FabricTopology(kind={self.kind!r}, "
                f"n_cores={self.n_cores}, links={len(self.links)})")


# ----------------------------------------------------------------------
@dataclass
class Placement:
    """Where a generative tenant's phase pools land on the fabric
    (``ServingSession.register_generative(placement=...)``).

    ``prefill_core`` / ``decode_core`` pin cores explicitly; left
    ``None``, ``strategy`` picks them: ``"topo"`` routes through the
    topology-aware allocator (chatty phase pairs on neighboring
    cores, load-balanced — :func:`repro_torch.core.allocator.
    place_phase_pair`), ``"random"`` through the seeded baseline
    (:func:`random_phase_pair`). ``prefill_eus`` / ``decode_eus``
    split the tenant's EU budget between the pools (0 = half each);
    the ``*_hbm_bytes`` pins override the per-side HBM allocation
    (bytes), e.g. to squeeze the decode pool for reject testing."""

    prefill_core: Optional[int] = None
    decode_core: Optional[int] = None
    strategy: str = "topo"       # "topo" | "random"
    seed: int = 0                # random-strategy draw
    prefill_eus: int = 0         # 0 -> eu_budget // 2
    decode_eus: int = 0          # 0 -> eu_budget - eu_budget // 2
    prefill_hbm_bytes: Optional[int] = None
    decode_hbm_bytes: Optional[int] = None

    def __post_init__(self):
        if self.strategy not in ("topo", "random"):
            raise ValueError(
                f"unknown placement strategy {self.strategy!r}; "
                f"use 'topo' or 'random'")


def random_phase_pair(topology: FabricTopology, seed: int = 0
                      ) -> Tuple[int, int]:
    """Seeded random-placement baseline: a uniform draw of two
    DISTINCT cores (distinct like the topology-aware rule, so the
    comparison isolates *which* cores, not whether the pools share
    one) with no regard for link distance."""
    n = topology.n_cores
    rng = np.random.default_rng(seed)
    a = int(rng.integers(n))
    if n == 1:
        return a, a
    b = int(rng.integers(n))
    while b == a:
        b = int(rng.integers(n))
    return a, b
