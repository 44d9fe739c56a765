"""SLO classes, overload estimation and the brownout ladder: the port of
``tpuserve/runtime/slo.py``, the policy layer the scheduler and engine
consult.

- **Classes**: every request carries one of ``interactive`` /
  ``standard`` / ``batch`` (``SamplingParams.slo_class``, from the
  ``X-SLO-Class`` header or the ``slo_class`` body field).  Lower rank is
  a stricter SLO.
- **Load estimator**: queue depth, a padding-waste EWMA (real tokens per
  dispatched token) and per-class queue-delay EWMAs, folded into one
  dimensionless ``pressure``.
- **Brownout ladder**: levels entered as soon as pressure crosses a
  threshold and left *hysteretically* (one level per ``hold_s``, and only
  once pressure is ``exit_margin`` below the entry threshold), so the
  engine never flaps between shedding and admitting at the boundary:

  =====  ==========================================================
  level  effect (cumulative)
  =====  ==========================================================
  0      normal operation
  1      speculation off for dispatches carrying batch rows
  2      batch ``max_tokens`` clamped to ``batch_max_tokens_cap``
  3      new batch work shed (429 + Retry-After)
  4      new standard work shed too; interactive falls back to the
         queue-full 503
  =====  ==========================================================

A shed answers with a retryable status before any prefill is spent.  The
layer is on by default; ``EngineConfig.slo_classes=False`` or
``TPUSERVE_SLO_CLASSES=0`` leaves the controller out and every consumer
runs classless FIFO.

Level 1's consumer is speculative decoding: the engine's spec gate asks
``spec_paused_for`` before a speculative step.  ``flight`` is the engine's flight recorder (``runtime/flight.py``,
None with it off): each level transition's log line quotes its client SLI
percentiles.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from tpuserve_torch.runtime.clock import MONOTONIC

logger = logging.getLogger("tpuserve_torch.slo")

SLO_CLASSES = ("interactive", "standard", "batch")
INTERACTIVE, STANDARD, BATCH = range(3)
_RANK = {name: i for i, name in enumerate(SLO_CLASSES)}


def class_rank(name: str) -> int:
    """Rank of an SLO class name (0 = strictest).  Raises ``ValueError``
    on junk so intake surfaces an error, not a silent default."""
    try:
        return _RANK[name]
    except KeyError:
        raise ValueError(
            f"unknown slo_class {name!r}; one of {'/'.join(SLO_CLASSES)}"
        ) from None


class ShedError(RuntimeError):
    """Raised at intake when the brownout ladder sheds this request's
    class (HTTP: 429 + ``Retry-After``), or sent to a waiting request that
    a queue-full eviction displaced for a stricter arrival.  Retryable by
    contract: nothing was admitted and no prefill was spent."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class SloConfig:
    # Fraction of the prefill / mixed token budget reserved for non-batch
    # classes: batch prefill admits only into the rest.
    reserve_frac: float = 0.25
    # Class preemptions one request may absorb (the re-prefill replay is
    # token-identical; this bounds the recompute and lets batch finish).
    preempt_budget: int = 3
    # Victims preempted for admissions in one engine cycle.
    max_preempt_per_cycle: int = 4
    # Queue-delay target interactive delay is normalised against
    # (standard is held to twice this).
    target_queue_delay_s: float = 1.0
    ewma_alpha: float = 0.2
    # Pressure thresholds entering brownout levels 1..4.
    enter_levels: tuple = (0.5, 0.75, 0.9, 1.2)
    # Step down only once pressure < enter threshold - exit_margin ...
    exit_margin: float = 0.15
    # ... and hold_s after the last level change (hysteresis).
    hold_s: float = 3.0
    # Level-2 clamp on batch max_tokens at admission.
    batch_max_tokens_cap: int = 128
    # Base Retry-After of a shed response (times the level).
    shed_retry_after_s: float = 2.0
    # Every degradation (shed, clamp, spec pause) needs a real queue of at
    # least this fraction of the backpressure cap: ticks stop when the
    # engine stops stepping, so a stale level must not degrade the lone
    # request that arrives later.
    shed_min_queue_frac: float = 0.125


class SloController:
    """Load estimator and brownout ladder, owned by the engine (mutated on
    the engine loop thread only; the runner drains observations from the
    same thread)."""

    def __init__(self, cfg: SloConfig, max_waiting: int, clock=None):
        self.cfg = cfg
        self.max_waiting = max(1, max_waiting)
        # the engine's clock (runtime/clock.py): the hold timer runs in
        # engine time, virtual under a VirtualClock
        self.clock = clock or MONOTONIC
        self.level = 0
        self._level_changed = self.clock.monotonic()
        # per-class queue-delay EWMAs (seconds); None until a first sample
        self._delay_ewma: list[Optional[float]] = [None] * len(SLO_CLASSES)
        # padding efficiency EWMA (real / padded tokens a dispatch): waste
        # derates capacity, so the same depth is more pressure
        self._pad_eff = 1.0
        self._waiting = 0
        # queue-delay observations waiting for the per-class histograms
        # (drained by server/runner.py on the loop thread)
        self.delay_obs: list[tuple[str, float]] = []
        self.shed_total = 0
        # the engine's flight recorder (runtime/flight.py), set by the
        # engine; None with the recorder off
        self.flight = None

    # ---- estimator inputs ------------------------------------------------

    def note_admission(self, rank: int, delay_s: float) -> None:
        """A fresh request left the waiting queue ``delay_s`` after its
        arrival (re-admissions after a preemption do not count)."""
        a = self.cfg.ewma_alpha
        prev = self._delay_ewma[rank]
        self._delay_ewma[rank] = (delay_s if prev is None
                                  else (1 - a) * prev + a * delay_s)
        if len(self.delay_obs) < 4096:      # engines without a runner: bounded
            self.delay_obs.append((SLO_CLASSES[rank], delay_s))

    def note_step(self, actual: int, padded: int) -> None:
        if padded <= 0:
            return
        a = self.cfg.ewma_alpha
        self._pad_eff = (1 - a) * self._pad_eff + a * (actual / padded)

    def drain_delay_obs(self) -> list:
        obs, self.delay_obs = self.delay_obs, []
        return obs

    # ---- pressure + ladder ----------------------------------------------

    def pressure(self) -> float:
        # Queue term: depth against the cap, inflated by padding waste, and
        # capped at 1.0: depth alone climbs at most to shedding batch
        # (level 3 enters below 1.0), never standard.
        queue_term = min(self._waiting / self.max_waiting
                         * (2.0 - self._pad_eff), 1.0)
        # Delay term: the per-class admission delays against their targets;
        # only a sustained delay past level 4's threshold escalates past
        # the queue cap.
        delay_term = 0.0
        tgt = self.cfg.target_queue_delay_s
        if self._delay_ewma[INTERACTIVE] is not None:
            delay_term = self._delay_ewma[INTERACTIVE] / tgt
        if self._delay_ewma[STANDARD] is not None:
            delay_term = max(delay_term,
                             self._delay_ewma[STANDARD] / (2 * tgt))
        return max(queue_term, delay_term)

    def tick(self, waiting: int, now: Optional[float] = None) -> None:
        """Re-evaluate the ladder once per engine cycle.  Entry is
        immediate; exit steps down ONE level per ``hold_s``, and only under
        the entry threshold minus the margin."""
        self._waiting = waiting
        now = self.clock.monotonic() if now is None else now
        if waiting == 0:
            # an empty queue's admission delay is zero: decay the EWMAs
            # toward it, or slow admissions long past would pin the ladder
            # (and a pinned ladder sheds the admissions that would
            # bring fresh samples)
            a = self.cfg.ewma_alpha
            self._delay_ewma = [None if v is None else (1 - a) * v
                                for v in self._delay_ewma]
        p = self.pressure()
        enter = self.cfg.enter_levels
        desired = 0
        for i, thr in enumerate(enter):
            if p >= thr:
                desired = i + 1
        if desired > self.level:
            self._log_transition(self.level, desired, p)
            self.level = desired
            self._level_changed = now
        elif (self.level > 0
              and p < enter[self.level - 1] - self.cfg.exit_margin
              and now - self._level_changed >= self.cfg.hold_s):
            self._log_transition(self.level, self.level - 1, p)
            self.level -= 1
            self._level_changed = now

    def _log_transition(self, old: int, new: int, pressure: float) -> None:
        sli = self.flight.sli_summary() if self.flight is not None else {}
        logger.info(
            "brownout level %d -> %d (pressure %.3f, waiting %d, "
            "pad_eff %.2f, delay_ewma %s, client SLI %s)",
            old, new, pressure, self._waiting, self._pad_eff,
            ["%.3f" % v if v is not None else "-"
             for v in self._delay_ewma], sli or "{}")

    def snapshot(self) -> dict:
        """Plain-scalar controller state: the level, the per-class
        queue-delay EWMAs and the pressure."""
        return {
            "brownout_level": self.level,
            "queue_delay_ewma": {
                SLO_CLASSES[i]: (round(v, 6) if v is not None else None)
                for i, v in enumerate(self._delay_ewma)},
            "pressure": round(self.pressure(), 6),
        }

    # ---- policy queries --------------------------------------------------

    def _queue_pressure_live(self) -> bool:
        """Every degradation bites only while a real queue exists
        (``shed_min_queue_frac`` of the cap)."""
        return self._waiting >= self.cfg.shed_min_queue_frac \
            * self.max_waiting

    def shed_retry_after(self, rank: int) -> Optional[float]:
        """Seconds a shed response asks the client to back off, or None
        when this class is admitted at the current level."""
        if not self._queue_pressure_live():
            return None
        if (self.level >= 4 and rank >= STANDARD) or \
                (self.level >= 3 and rank >= BATCH):
            return self.cfg.shed_retry_after_s * self.level
        return None

    def max_tokens_cap(self, rank: int) -> Optional[int]:
        if (self.level >= 2 and rank >= BATCH
                and self._queue_pressure_live()):
            return self.cfg.batch_max_tokens_cap
        return None

    def spec_paused_for(self, reqs) -> bool:
        """Level 1+: dispatches carrying batch-class rows run without
        speculation (``Engine._spec_eligible``)."""
        return (self.level >= 1 and self._queue_pressure_live()
                and any(class_rank(r.params.slo_class) >= BATCH
                        for r in reqs))
