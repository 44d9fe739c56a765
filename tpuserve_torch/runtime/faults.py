"""Deterministic fault injection for the serving engine: the port of
``tpuserve/runtime/faults.py``.

Named injection sites in the engine's host code, right before a dispatch
is loaded and replayed (or run eagerly), can raise, hang or delay at a
configured per-site probability, so the runner's salvage, poison
bisection and hang watchdog can be checked under seeded chaos.

Sites (``runtime/engine.py``):

- ``prefill_dispatch``: batched prefill and prefill-chunk steps
- ``decode_dispatch``:  decode single steps and fused windows
- ``mixed_dispatch``:   mixed ragged steps
- ``kv_alloc``:         KV block allocation, slot charge, window reserve
- ``window_flush``:     resolving an in-flight pipelined window

A spec string (``EngineConfig.faults`` or the ``TPUSERVE_FAULTS``
environment variable) holds comma-separated rules ``site:mode:prob`` with
optional ``key=value`` suffixes::

    decode_dispatch:raise:0.02                    # 2% of decode dispatches
    prefill_dispatch:hang:1.0:count=1             # one hang
    decode_dispatch:raise:1.0:match=poison        # only dispatches carrying
                                                  # a request id containing
                                                  # "poison"
    kv_alloc:delay:1.0:delay_s=0.2                # +200 ms an allocation
    seed=7                                        # the draws' seed

Modes: ``raise`` (:class:`InjectedFault`); ``hang`` (block until the
watchdog releases it or ``max_hang_s`` passes, then raise, so a released
hang re-enters the fault path); ``delay`` (sleep ``delay_s``, go on).
``count=N`` caps a rule's fires; ``match=S`` restricts it to dispatches
carrying a request id containing S.

With no rules ``check()`` returns at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Optional, Sequence

SITES = ("prefill_dispatch", "decode_dispatch", "mixed_dispatch",
         "kv_alloc", "window_flush")
MODES = ("raise", "hang", "delay")


class InjectedFault(RuntimeError):
    """Raised by an injection site: a dispatch that failed (or, for a
    released hang, never returned)."""


@dataclasses.dataclass
class FaultRule:
    site: str
    mode: str                      # "raise" | "hang" | "delay"
    prob: float
    count: Optional[int] = None    # max fires; None = unlimited
    match: Optional[str] = None    # only dispatches carrying a matching rid
    delay_s: float = 0.05
    max_hang_s: float = 30.0
    fired: int = 0


class FaultInjector:
    """Seeded per-site fault source, one an engine: every draw comes from
    one ``random.Random(seed)``, so a seed and a call order reproduce the
    fault sequence."""

    def __init__(self, rules: Sequence[FaultRule] = (), seed: int = 0):
        self.rules = list(rules)
        self._rng = random.Random(seed)
        self._hang_release = threading.Event()
        self._suspended = 0
        # observer called as on_fire(site, mode, rids) when a rule fires,
        # before it raises, hangs or sleeps; must not raise
        self.on_fire = None

    @property
    def enabled(self) -> bool:
        return bool(self.rules)

    def check(self, site: str, rids: Sequence[str] = ()) -> None:
        """Run the injection point ``site`` for a dispatch carrying the
        request ids ``rids``: may raise InjectedFault, block or sleep; a
        no-op when disabled or suspended."""
        if not self.rules or self._suspended:
            return
        for rule in self.rules:
            if rule.site != site:
                continue
            if rule.count is not None and rule.fired >= rule.count:
                continue
            if rule.match is not None and not any(
                    rule.match in rid for rid in rids):
                continue
            if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                continue
            rule.fired += 1
            if self.on_fire is not None:
                self.on_fire(site, rule.mode, tuple(rids))
            if rule.mode == "delay":
                time.sleep(rule.delay_s)
                continue
            if rule.mode == "hang":
                # block like a wedged dispatch until the runner's watchdog
                # releases it (release_hangs); max_hang_s is a backstop for
                # an engine without a watchdog
                self._hang_release.clear()
                released = self._hang_release.wait(timeout=rule.max_hang_s)
                raise InjectedFault(
                    f"injected hang at {site} "
                    + ("(released by watchdog)" if released
                       else f"(timed out after {rule.max_hang_s}s)"))
            raise InjectedFault(f"injected fault at {site}")

    def release_hangs(self) -> None:
        """Unblock a thread parked in an injected hang (the watchdog calls
        it on a trip; the hang then raises InjectedFault)."""
        self._hang_release.set()

    @contextlib.contextmanager
    def suspended(self):
        """No faults inside: warmup runs the same dispatch sites as
        serving, and a fault there would fail the server before it
        served."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    @classmethod
    def from_spec(cls, spec: Optional[str], seed: int = 0) -> "FaultInjector":
        """Parse a spec string (see the module docstring); None or ""
        disables.  A malformed rule raises ValueError."""
        if not spec:
            return cls((), seed)
        rules: list[FaultRule] = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if item.startswith("seed="):
                seed = int(item[len("seed="):])
                continue
            parts = item.split(":")
            if len(parts) < 3:
                raise ValueError(
                    f"bad fault rule {item!r}: want site:mode:prob"
                    "[:key=value...]")
            site, mode, prob_s = parts[0], parts[1], parts[2]
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; "
                                 f"known: {SITES}")
            if mode not in MODES:
                raise ValueError(f"unknown fault mode {mode!r}; "
                                 f"known: {MODES}")
            try:
                prob = float(prob_s)
            except ValueError:
                raise ValueError(
                    f"bad fault probability {prob_s!r} in {item!r}") from None
            if not 0.0 < prob <= 1.0:
                raise ValueError(f"fault probability must be in (0, 1], "
                                 f"got {prob}")
            rule = FaultRule(site=site, mode=mode, prob=prob)
            for kv in parts[3:]:
                key, sep, val = kv.partition("=")
                if not sep:
                    raise ValueError(f"bad fault option {kv!r} in {item!r}: "
                                     "want key=value")
                if key == "count":
                    rule.count = int(val)
                elif key == "match":
                    rule.match = val
                elif key == "delay_s":
                    rule.delay_s = float(val)
                elif key == "max_hang_s":
                    rule.max_hang_s = float(val)
                else:
                    raise ValueError(f"unknown fault option {key!r} in "
                                     f"{item!r} (count/match/delay_s/"
                                     "max_hang_s)")
            rules.append(rule)
        return cls(rules, seed)
