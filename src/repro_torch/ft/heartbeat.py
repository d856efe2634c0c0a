"""Heartbeat / straggler detection for worker fleets (copy of
``repro.ft.heartbeat``).

At 1000+ nodes the question is never *whether* a worker dies mid-step but
*when*.  The monitor tracks per-worker beat timestamps; a worker is a
STRAGGLER when its gap exceeds ``straggler_factor`` x the fleet median
inter-beat interval, and DEAD past ``dead_after`` seconds.  The alignment
service uses this to re-dispatch work items whose worker went quiet
(deadline re-dispatch).

Pure bookkeeping over injected timestamps — deterministic to test, and the
same logic drives real wall-clock use (``now=None`` -> time.time()).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

ALIVE, STRAGGLER, DEAD = "alive", "straggler", "dead"


@dataclasses.dataclass
class HeartbeatMonitor:
    dead_after: float = 30.0
    straggler_factor: float = 3.0
    min_interval: float = 0.05

    def __post_init__(self):
        self._last: Dict[str, float] = {}
        self._intervals: Dict[str, List[float]] = {}
        self._median: Optional[float] = None   # cache; None = recompute

    def beat(self, worker: str, now: Optional[float] = None):
        now = time.time() if now is None else now
        prev = self._last.get(worker)
        if prev is not None:
            self._intervals.setdefault(worker, []).append(now - prev)
            self._intervals[worker] = self._intervals[worker][-32:]
            self._median = None
        self._last[worker] = now

    def forget(self, worker: str) -> bool:
        """Drop a departed worker's bookkeeping.

        Without this, a worker that died (or was elastically replaced)
        keeps its historical inter-beat intervals in the fleet median
        forever, skewing straggler detection for every surviving worker.
        Call on worker departure (the gateway does, on redispatch and on
        thread exit).  Returns True if the worker was tracked.
        """
        known = self._last.pop(worker, None) is not None
        if self._intervals.pop(worker, None) is not None:
            self._median = None
        return known

    def _median_interval(self) -> float:
        if self._median is None:
            all_iv = sorted(iv for ivs in self._intervals.values()
                            for iv in ivs)
            self._median = self.min_interval if not all_iv else \
                max(all_iv[len(all_iv) // 2], self.min_interval)
        return self._median

    def status(self, worker: str, now: Optional[float] = None) -> str:
        now = time.time() if now is None else now
        last = self._last.get(worker)
        if last is None:
            return DEAD
        gap = now - last
        if gap > self.dead_after:
            return DEAD
        if gap > self.straggler_factor * self._median_interval():
            return STRAGGLER
        return ALIVE

    def fleet(self, now: Optional[float] = None) -> Dict[str, str]:
        return {w: self.status(w, now) for w in self._last}

    def alive_workers(self, now: Optional[float] = None) -> List[str]:
        return [w for w, s in self.fleet(now).items() if s == ALIVE]

    def dead_workers(self, now: Optional[float] = None) -> List[str]:
        """*Tracked* workers past ``dead_after`` (fleet introspection).

        A pipelined dispatcher beats once per launch and once per harvest,
        so a worker wedged inside a device sync stops beating mid-batch
        and shows up here.  Workers that never beat at all are not
        tracked and therefore absent — redispatch logic should query
        ``status(worker)``, which reports unknown workers as DEAD.
        """
        return [w for w, s in self.fleet(now).items() if s == DEAD]
