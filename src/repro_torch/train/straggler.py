"""Straggler detection and mitigation hooks, ``repro.train.straggler``'s.

On a real cluster, slow hosts show up as step-time outliers (bad memory, a
throttled card, a failing link).  The watchdog keeps a rolling step-time
window; a step above ``threshold x median`` raises a StragglerEvent, which
the trainer logs and counts.  Mitigation at scale: (1) if a host is
persistently slow, checkpoint and restart without it (the checkpoint
layout is unsharded); (2) within a run, the data pipeline's deterministic
(seed, step, shard) batches make it safe for a replacement host to take
over a shard mid-run.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


@dataclass
class StragglerWatchdog:
    window: int = 32
    threshold: float = 3.0
    min_samples: int = 5
    durations: deque = field(default_factory=lambda: deque(maxlen=128))
    events: list = field(default_factory=list)

    def observe(self, step: int, duration: float) -> StragglerEvent | None:
        med = self.median()
        self.durations.append(duration)
        if med is not None and duration > self.threshold * med:
            ev = StragglerEvent(step=step, duration=duration, median=med)
            self.events.append(ev)
            return ev
        return None

    def median(self) -> float | None:
        if len(self.durations) < self.min_samples:
            return None
        vals = sorted(self.durations)
        return vals[len(vals) // 2]
