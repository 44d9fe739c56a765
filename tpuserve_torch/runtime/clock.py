"""The injectable monotonic-time seam for everything replay-reachable.

Every engine-side timestamp and delta (request arrival, queue delay,
SLO EWMAs, brownout hysteresis, adaptive-window holds, flight-recorder
timelines) flows through ONE seam: an engine's ``clock`` attribute,
defaulting to the process-wide real clock below.  Production pays one
attribute load + one method call over a bare ``time.monotonic()``;
replay (``tpuserve/replay/``) swaps in a :class:`VirtualClock` so a
recorded ten-minute incident re-runs in seconds of wall time *without
distorting* any time-derived policy state — queue-delay EWMAs, brownout
hold timers and admission deadlines all see the same seconds the
incident saw, because virtual time advances by the modelled step cost,
not by however fast a warm CPU happens to replay the dispatches.

The seam is machine-enforced: tpulint P1's ``monotonic-outside-clock-
seam`` rule (tools/tpulint/host_sync.py) errors on any direct
``time.monotonic`` reference in the configured replay-reachable files
(``[tool.tpulint.host_sync] clock_paths``), so a new timing site cannot
silently anchor policy to the wall clock again.  Genuinely wall-bound
sites (watchdog hang detection, client-side queue waits) carry a
reasoned ``sync-ok`` suppression tag.
"""

from __future__ import annotations

import time


class Clock:
    """Real monotonic clock — the production default.  Stateless; one
    shared :data:`MONOTONIC` instance serves every engine."""

    __slots__ = ()

    #: True only on clocks whose time is advanced by a replay harness;
    #: lets the rare caller that must behave differently under virtual
    #: time (e.g. a real sleep) ask, without isinstance checks.
    virtual = False

    def monotonic(self) -> float:
        return time.monotonic()


#: the shared real clock (Engine default when EngineConfig.clock is None)
MONOTONIC = Clock()


class VirtualClock(Clock):
    """Harness-advanced clock for deterministic replay.

    ``monotonic()`` returns the last value the harness set; time moves
    only through :meth:`advance` / :meth:`advance_to` (the replay
    harness advances by the modelled per-step cost, and jumps idle gaps
    to the next scheduled arrival — which is where the >=10x
    storm-in-seconds speedup comes from).  Single-threaded by contract:
    the replay harness owns both the engine loop and the clock.
    """

    __slots__ = ("now_s",)

    virtual = True

    def __init__(self, start: float = 0.0):
        self.now_s = float(start)

    def monotonic(self) -> float:
        return self.now_s

    def advance(self, dt_s: float) -> float:
        """Move time forward by ``dt_s`` seconds (negative is a bug —
        monotonic clocks never rewind)."""
        if dt_s < 0:
            raise ValueError(f"virtual clock cannot rewind ({dt_s=})")
        self.now_s += dt_s
        return self.now_s

    def advance_to(self, t_s: float) -> float:
        """Jump forward to ``t_s`` if it is in the future (no-op when
        already past it — arrivals can only pull time forward)."""
        if t_s > self.now_s:
            self.now_s = t_s
        return self.now_s
