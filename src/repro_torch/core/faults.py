"""Deterministic fault injection for the cluster fabric.

Production NPU pools lose cores, links, and HBM rows; the serving
stack's job is to keep tenants alive through it. This module is the
*chaos source*: a :class:`FaultSchedule` is a seeded, pre-materialised
list of :class:`FaultEvent`\\ s that :class:`repro_torch.serve.session.ServingSession`
interleaves with simulator progress at exact times — two runs with
the same schedule replay the same faults, so every failover path is
reproducible and testable. Times are unit-agnostic here; the serving
session interprets ``at`` / ``recovery`` as SECONDS of simulated time
(its public API domain) and converts to cycles on ingest.

Fault taxonomy (mirrors the failure modes of real multi-chip boards):

* ``core_down`` — a pNPU core stops executing. Transient faults carry
  a ``recovery`` horizon (the core returns that many cycles later via
  an auto-generated ``core_up``); ``recovery == 0`` means permanent.
* ``core_up`` — a previously failed core rejoins the pool.
* ``link_degrade`` — a fabric link's bandwidth is scaled by
  ``bw_scale`` (``0`` removes the link entirely: an outage).
* ``link_restore`` — the link returns to its base bandwidth.
* ``hbm_fault`` — ``n_segments`` HBM isolation segments of the vNPU
  resident on ``core`` fault away; the tenant shrinks through the
  constrained-resize path instead of dying.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

__all__ = ["FaultEvent", "FaultSchedule"]

_KINDS = frozenset({
    "core_down", "core_up", "link_degrade", "link_restore", "hbm_fault",
})


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault, pinned to an absolute time (seconds of
    simulated time when consumed through the serving session)."""

    at: float                       # time the fault fires
    kind: str                       # member of the taxonomy above
    core: int = -1                  # core_down/core_up/hbm_fault target
    link: Tuple[int, int] = (-1, -1)   # link_degrade/link_restore target
    bw_scale: float = 0.0           # link_degrade: 0 -> outage
    recovery: float = 0.0           # core_down: delay until auto core_up
    n_segments: int = 1             # hbm_fault: segments lost

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {sorted(_KINDS)}")
        if self.at < 0:
            raise ValueError(f"fault time must be >= 0, got {self.at}")
        if self.kind in ("core_down", "core_up", "hbm_fault") and self.core < 0:
            raise ValueError(f"{self.kind} needs a core index")
        if self.kind in ("link_degrade", "link_restore"):
            a, b = self.link
            if a < 0 or b < 0 or a == b:
                raise ValueError(f"{self.kind} needs a (src, dst) link")
        if self.kind == "link_degrade" and self.bw_scale < 0:
            raise ValueError("bw_scale must be >= 0 (0 = outage)")
        if self.kind == "hbm_fault" and self.n_segments < 1:
            raise ValueError("hbm_fault needs n_segments >= 1")

    @property
    def transient(self) -> bool:
        return self.kind == "core_down" and self.recovery > 0


class FaultSchedule:
    """An ordered, replayable list of :class:`FaultEvent`."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.at, e.kind, e.core, e.link))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    @classmethod
    def chaos(cls, *, horizon: float, n_cores: int,
              links: Sequence[Tuple[int, int]] = (),
              seed: int = 0,
              core_fault_rate: float = 0.0,
              link_fault_rate: float = 0.0,
              hbm_fault_rate: float = 0.0,
              transient_frac: float = 1.0,
              recovery: float = 0.0,
              bw_scale: float = 0.25,
              link_outage_frac: float = 0.0,
              start: float = 0.0) -> "FaultSchedule":
        """Seeded Poisson chaos over ``[start, horizon)``.

        Each ``*_fault_rate`` is an expected fault count per
        ``horizon - start`` cycles (a rate of 2.0 injects ~2 such
        faults over the window). ``transient_frac`` of core faults
        are transient with the given ``recovery`` horizon; degraded
        links are scaled to ``bw_scale`` except a ``link_outage_frac``
        share that go fully dark, and every link fault auto-restores
        halfway to the horizon end. Same seed -> same schedule."""
        if horizon <= start:
            raise ValueError("chaos needs horizon > start")
        rng = random.Random(seed)
        span = horizon - start
        out: List[FaultEvent] = []

        def _times(rate: float) -> List[float]:
            if rate <= 0:
                return []
            ts, t = [], start
            while True:
                t += rng.expovariate(rate / span)
                if t >= horizon:
                    return ts
                ts.append(t)

        for t in _times(core_fault_rate):
            core = rng.randrange(n_cores)
            rec = recovery if rng.random() < transient_frac else 0.0
            out.append(FaultEvent(at=t, kind="core_down", core=core,
                                  recovery=rec))
        for t in _times(link_fault_rate):
            if not links:
                break
            link = links[rng.randrange(len(links))]
            scale = 0.0 if rng.random() < link_outage_frac else bw_scale
            out.append(FaultEvent(at=t, kind="link_degrade", link=link,
                                  bw_scale=scale))
            t_up = t + (horizon - t) * 0.5
            if t_up < horizon:
                out.append(FaultEvent(at=t_up, kind="link_restore",
                                      link=link))
        for t in _times(hbm_fault_rate):
            out.append(FaultEvent(at=t, kind="hbm_fault",
                                  core=rng.randrange(n_cores)))
        return cls(out)
