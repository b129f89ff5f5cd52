"""Fault tolerance runtime helpers: straggler detection and the
failure/restart state machine used by the train loop.

On real clusters step times are collected per host via the
coordination service; here the monitor consumes whatever step-time
stream the loop feeds it (the tests feed synthetic distributions).
Policy mirrors production practice:

* straggler: host's EMA step time > `threshold` x median EMA
  -> flagged; after `grace` consecutive flags it is declared failed
  (the scheduler would then evict + trigger elastic restart).
* failure: missing heartbeat for `heartbeat_timeout` steps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set


@dataclass
class StragglerMonitor:
    n_hosts: int
    threshold: float = 1.5
    grace: int = 3
    ema_alpha: float = 0.3
    _ema: Dict[int, float] = field(default_factory=dict)
    _flags: Dict[int, int] = field(default_factory=dict)
    _last_seen: Dict[int, int] = field(default_factory=dict)
    heartbeat_timeout: int = 10

    def observe(self, step: int, host: int, step_time: float) -> None:
        prev = self._ema.get(host, step_time)
        self._ema[host] = (self.ema_alpha * step_time
                           + (1 - self.ema_alpha) * prev)
        self._last_seen[host] = step

    def stragglers(self) -> Set[int]:
        if len(self._ema) < 2:
            return set()
        med = sorted(self._ema.values())[len(self._ema) // 2]
        out = set()
        for h, t in self._ema.items():
            if t > self.threshold * med:
                self._flags[h] = self._flags.get(h, 0) + 1
                if self._flags[h] >= self.grace:
                    out.add(h)
            else:
                self._flags[h] = 0
        return out

    def failed(self, now_step: int) -> Set[int]:
        return {
            h for h in range(self.n_hosts)
            if now_step - self._last_seen.get(h, now_step)
            > self.heartbeat_timeout
        }

    def healthy_hosts(self, now_step: int) -> List[int]:
        bad = self.failed(now_step) | self.stragglers()
        return [h for h in range(self.n_hosts) if h not in bad]
