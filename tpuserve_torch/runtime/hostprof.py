"""Host hot-path phase timer: the port of ``tpuserve/runtime/hostprof.py``.

The engine brackets its per-cycle host phases with ``PROF.phase(name)``:

- ``schedule``   the scheduler's pick of the cycle's batch;
- ``block``      block-manager accounting (decode slot charges, window
                 reservations, block tables, the KV commit after a window);
- ``dispatch``   a step's pinned host-to-device copy plus its executable's
                 run (a captured graph's replay on the card);
- ``flush``      the wait on a dispatch's event and the read of its pinned
                 tokens: the cycle's one designated wait on the card;
- ``detokenize`` appending, detokenizing, stop checks and emission.

Each phase is a pair of host ``perf_counter`` reads; nothing here touches
the card.  Disabled, ``phase()`` returns a shared no-op context manager.
Building an engine with the flight recorder on (the default,
``runtime/flight.py``) enables the profiler, so every step record carries
its phase breakdown; ``TPUSERVE_FLIGHT=0`` leaves it off.  ``PROF`` is one
per process: engines that step in one process (twins in a check, tests)
share it, so a step record's phases are exact for a single engine and
approximate across several.
"""

from __future__ import annotations

import time
from collections import defaultdict


class _NoopPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopPhase()


class _Phase:
    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof, name):
        self._prof = prof
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._prof.seconds[self._name] += time.perf_counter() - self._t0
        self._prof.counts[self._name] += 1
        return False


class HostPhaseProfiler:
    """Accumulates wall seconds per named host phase; ``cycles`` is bumped
    once per engine cycle (the denominator for ms-per-cycle)."""

    # canonical phase names, in report order
    PHASES = ("schedule", "block", "dispatch", "detokenize", "flush")
    # the phases that are host time alone ("dispatch" includes the copy to
    # the card and a graph's launch, "flush" the wait on the card):
    # "host_ms_per_cycle" sums only these
    HOST_PHASES = ("schedule", "block", "detokenize")

    def __init__(self):
        self.enabled = False
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.cycles = 0

    def phase(self, name: str):
        if not self.enabled:
            return _NOOP
        return _Phase(self, name)

    def bump_cycle(self) -> None:
        if self.enabled:
            self.cycles += 1

    def reset(self) -> None:
        self.seconds.clear()
        self.counts.clear()
        self.cycles = 0

    def report(self) -> dict:
        """Per-phase breakdown: ms per engine cycle plus totals, in the
        JAX profiler's shape."""
        cycles = max(self.cycles, 1)
        phases = {}
        for name in list(self.PHASES) + sorted(set(self.seconds) - set(self.PHASES)):
            if name not in self.seconds and name not in self.PHASES:
                continue
            phases[name] = {
                "ms_per_cycle": round(1000 * self.seconds[name] / cycles, 4),
                "total_ms": round(1000 * self.seconds[name], 2),
                "calls": self.counts[name],
            }
        total = sum(self.seconds.values())
        host = sum(self.seconds[p] for p in self.HOST_PHASES if p in self.seconds)
        return {
            "cycles": self.cycles,
            "host_ms_per_cycle": round(1000 * host / cycles, 4),
            "all_phases_ms_per_cycle": round(1000 * total / cycles, 4),
            "phases": phases,
        }


# module singleton: one engine loop a process is the common case
PROF = HostPhaseProfiler()
