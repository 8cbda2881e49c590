"""Injectable wall-clock for the observability layer.

Every timestamp the telemetry subsystem records — step-phase spans, launch
latencies, request-lifecycle milestones — flows through one `Clock`
object, so timing-dependent tests swap in a `FakeClock` and assert EXACT
TTFT / ITL / span durations instead of sleeping and hoping (the
differential serving harness does exactly that to keep its telemetry
cross-checks deterministic).
"""
from __future__ import annotations

import time
from typing import Protocol


class Clock(Protocol):
    """Monotonic seconds source (only deltas are ever interpreted)."""

    def now(self) -> float: ...


class PerfCounterClock:
    """The production clock: `time.perf_counter` (monotonic, ns-grained)."""

    __slots__ = ()

    def now(self) -> float:
        return time.perf_counter()


class FakeClock:
    """Deterministic test clock.

    Every `now()` call returns the current time and then advances it by
    `tick`, so a fixed call sequence yields a fixed timeline (spans get
    exactly one tick of duration, consecutive lifecycle events land one
    tick apart).  `advance()` injects extra elapsed time between calls —
    e.g. to make one request's TTFT measurably larger than another's.
    """

    __slots__ = ("_t", "tick")

    def __init__(self, start: float = 0.0, tick: float = 0.001):
        self._t = float(start)
        self.tick = float(tick)

    def now(self) -> float:
        t = self._t
        self._t += self.tick
        return t

    def advance(self, dt: float) -> None:
        assert dt >= 0, dt
        self._t += dt
