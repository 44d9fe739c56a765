"""The autoscaling decision layer: engine-emitted SLIs in, replica counts out.

The engine has narrated its own load story since the flight recorder
landed (per-SLO-class TTFT/ITL/e2e SLI reservoirs, the
``tpuserve_brownout_level`` gauge, per-class queue-delay EWMAs) — this
module is the first consumer that *acts* on it, the control-plane
pattern DeepServe (arxiv 2501.14417) and "Adaptive Orchestration"
(arxiv 2503.20074) scale serverless LLM fleets on:

- **scale out before shedding** — the brownout ladder's L1/L2 rungs
  (spec off, max_tokens clamp) are the early-warning band; the policy
  reacts there, so capacity arrives before the ladder reaches its
  shedding rungs (L3/L4).  A rising interactive queue-delay EWMA or
  TTFT p95 triggers the same way for engines that degrade without
  climbing the ladder.
- **scale in only when drained** — a replica is removed only after the
  whole pool has been completely idle (no queued, no running, ladder at
  0) for a sustained window, and the reconciler retires it through the
  existing SIGTERM drain path, so scale-in never costs an in-flight
  stream.
- **scale from zero is a real operating point** — pending demand
  against an empty pool scales out immediately (no cooldown: demand
  with zero capacity cannot wait), and cold starts are cheap because a
  booting replica finds the persistent XLA compile cache, orbax
  weights, and the KV spill tier's warm prefixes on the model PVC.

The policy is a pure function of :class:`PoolSignals` plus its own
hysteresis state, and every timestamp flows through the injectable
clock seam (``runtime/clock.py``, tpulint-P1-enforced for this
package) — so the same policy object runs under ``VirtualClock`` inside
the pool replay harness (``tpuserve_torch/autoscale/pool.py``), and the same
recorded brownout storm + the same config produce the same decision
sequence, byte for byte (the tuning loop).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
from typing import Optional

from tpuserve_torch.runtime.clock import MONOTONIC
from tpuserve_torch.runtime.slo import SLO_CLASSES

logger = logging.getLogger("tpuserve_torch.autoscale")

#: decision actions, in the order the decisions counter documents them
ACTIONS = ("scale_out", "scale_in", "hold")


@dataclasses.dataclass
class ReplicaSignals:
    """One replica's engine-emitted scalars, as scraped from
    ``/debug/engine`` (``signals.py``) or read directly off a simulated
    replica's engine (``pool.py``).  Everything the policy may react
    to, nothing it can't observe in production."""

    name: str
    ready: bool = True                 # past readiness (serving traffic)
    draining: bool = False             # marked for scale-in retirement
    brownout_level: int = 0            # tpuserve_brownout_level
    # per-class admission queue-delay EWMAs, seconds (slo.snapshot());
    # missing/None = no samples yet
    queue_delay_ewma: dict = dataclasses.field(default_factory=dict)
    waiting: int = 0                   # queued for prefill
    running: int = 0                   # in the decode batch
    # flight-recorder SLI summary {class: {kind: {n,p50,p95}}}
    sli: dict = dataclasses.field(default_factory=dict)
    # boot -> first served token, seconds (None until first token)
    cold_start_s: Optional[float] = None


@dataclasses.dataclass
class PoolSignals:
    """Aggregate pool state at one control tick."""

    t: float                           # clock time of the observation
    # scrape-able replicas only — a booting pod can't answer
    # /debug/engine yet, so it is COUNTED in ``booting``, never listed
    # here (live sums the two)
    replicas: list = dataclasses.field(default_factory=list)
    booting: int = 0                   # started but not yet ready
    # demand no replica has admitted: the gateway's unserved/queued
    # count in production, the pool queue length under replay — the
    # scale-from-zero trigger
    pending_demand: int = 0
    # per-model split of pending_demand (gateway unserved_by_model):
    # scale-from-zero uses it to pick WHICH catalog model the booting
    # replica should load warm.  Empty for single-model fleets and old
    # replay traces — decisions (and their digests) are unchanged then.
    pending_by_model: dict = dataclasses.field(default_factory=dict)
    # SLO classes the gateway's black-box canary prober currently
    # reports breached (consecutive probe failures past the threshold,
    # tpuserve_torch/obs/canary.py via /gateway/status) — a scale-out
    # trigger the white-box signals can't replace: a replica that
    # stopped answering entirely emits no queue-delay EWMA at all
    canary_breached: int = 0

    @property
    def ready(self) -> list:
        return [r for r in self.replicas if r.ready and not r.draining]

    @property
    def live(self) -> int:
        """Replicas that count toward the target: serving + booting
        (a booting replica is capacity already paid for — scaling again
        because it hasn't finished booting is the flap the cooldown
        exists to stop)."""
        return len([r for r in self.replicas if not r.draining]) \
            + self.booting

    def max_brownout(self) -> int:
        return max((r.brownout_level for r in self.ready), default=0)

    def worst_queue_delay(self, slo_class: str = "interactive",
                          ) -> Optional[float]:
        vals = [r.queue_delay_ewma.get(slo_class) for r in self.ready]
        vals = [v for v in vals if v is not None]
        return max(vals) if vals else None

    def worst_ttft_p95(self, slo_class: str = "interactive",
                       ) -> Optional[float]:
        vals = []
        for r in self.ready:
            v = (r.sli.get(slo_class) or {}).get("ttft", {}).get("p95")
            if v is not None:
                vals.append(v)
        return max(vals) if vals else None

    def boot_model(self) -> Optional[str]:
        """The catalog model scale-from-zero should boot warm: the one
        with the most unserved demand.  Ties break lexically so replay
        is deterministic; None when no per-model split was observed."""
        if not self.pending_by_model:
            return None
        return max(sorted(self.pending_by_model),
                   key=lambda m: self.pending_by_model[m])

    def idle(self) -> bool:
        """True when NOTHING is happening pool-wide: no pending demand,
        nothing booting, and every serving replica has an empty queue,
        an empty decode batch, and a fully-exited brownout ladder."""
        return (self.pending_demand == 0 and self.booting == 0
                and all(r.waiting == 0 and r.running == 0
                        and r.brownout_level == 0 for r in self.ready))


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    # Replica-count envelope.  min_replicas=0 makes scale-to-zero a
    # real operating point (cold starts are bounded by the PVC caches).
    min_replicas: int = 0
    max_replicas: int = 4
    # Scale out as soon as any replica's brownout ladder reaches this
    # rung — strictly below the shedding rungs (L3 sheds batch, L4
    # standard), so capacity is already booting when the estimator
    # would otherwise start turning work away.
    brownout_out_level: int = 1
    # ... or when the worst interactive queue-delay EWMA breaches this
    # (seconds; the same per-class SLI the brownout estimator steers by).
    queue_delay_out_s: float = 0.5
    # ... or when the worst interactive TTFT p95 from the SLI
    # reservoirs breaches this (seconds; 0 disables the trigger —
    # TTFT includes prefill cost, so the right target is deployment-
    # specific where the other two triggers are not).
    ttft_p95_out_s: float = 0.0
    # ... or when the gateway's synthetic canary reports any SLO class
    # breached (black-box probe failures; False disables the trigger).
    canary_out: bool = True
    # Replicas added per scale-out decision.
    scale_out_step: int = 1
    # No second scale-out within this window of the last one: the
    # booting replica must get a chance to absorb load, or a sustained
    # breach would ladder straight to max_replicas.
    scale_out_cooldown_s: float = 30.0
    # No scale-in within this window of ANY scale event (hysteresis
    # against out/in flapping at the load boundary).
    scale_in_cooldown_s: float = 120.0
    # The pool must be continuously idle (PoolSignals.idle) this long
    # before a replica is retired — "idle + drained" is the only
    # scale-in condition, matching the SIGTERM drain contract.
    idle_in_s: float = 60.0


@dataclasses.dataclass(frozen=True)
class Decision:
    t: float
    action: str                        # one of ACTIONS
    current: int                       # live replicas at decision time
    target: int
    reason: str

    def as_tuple(self) -> tuple:
        return (round(self.t, 6), self.action, self.current,
                self.target, self.reason)


def decisions_digest(decisions: list) -> str:
    """Order-sensitive digest of a decision sequence — the determinism
    pin: same recorded storm + same policy config => same digest."""
    return hashlib.sha256(json.dumps(
        [d.as_tuple() for d in decisions]).encode()).hexdigest()


class AutoscalePolicy:
    """Hysteretic scaling policy over :class:`PoolSignals`.

    Single-threaded by contract: the reconciler (or the pool replay
    harness) owns both the policy and its clock.  ``decide`` always
    returns a :class:`Decision`; non-``hold`` decisions are also
    appended to :attr:`decisions` (the replay-diffable sequence)."""

    def __init__(self, cfg: Optional[PolicyConfig] = None, clock=None):
        self.cfg = cfg or PolicyConfig()
        if self.cfg.min_replicas < 0 or \
                self.cfg.max_replicas < max(1, self.cfg.min_replicas):
            raise ValueError(
                f"need 0 <= min_replicas <= max_replicas (and max >= 1), "
                f"got {self.cfg.min_replicas}..{self.cfg.max_replicas}")
        self.clock = clock or MONOTONIC
        self.decisions: list[Decision] = []
        self._last_scale_out: Optional[float] = None
        self._last_scale_in: Optional[float] = None
        self._idle_since: Optional[float] = None
        # pre-decision hysteresis stamps of the most recent recorded
        # decision, for revert() when applying it failed
        self._undo: Optional[tuple] = None

    # ---- internals -----------------------------------------------------

    def _last_scale_t(self) -> Optional[float]:
        ts = [t for t in (self._last_scale_out, self._last_scale_in)
              if t is not None]
        return max(ts) if ts else None

    def _scale_out_reason(self, sig: PoolSignals) -> Optional[str]:
        cfg = self.cfg
        lvl = sig.max_brownout()
        if lvl >= cfg.brownout_out_level:
            return (f"brownout level {lvl} >= {cfg.brownout_out_level} "
                    "(scale before the ladder sheds)")
        delay = sig.worst_queue_delay("interactive")
        if delay is not None and delay >= cfg.queue_delay_out_s:
            return (f"interactive queue-delay EWMA {delay:.3f}s >= "
                    f"{cfg.queue_delay_out_s:g}s")
        if cfg.ttft_p95_out_s:
            ttft = sig.worst_ttft_p95("interactive")
            if ttft is not None and ttft >= cfg.ttft_p95_out_s:
                return (f"interactive TTFT p95 {ttft:.3f}s >= "
                        f"{cfg.ttft_p95_out_s:g}s")
        if cfg.canary_out and sig.canary_breached:
            return (f"canary breach: {sig.canary_breached} SLO "
                    "class(es) failing black-box probes")
        return None

    # ---- the decision --------------------------------------------------

    def decide(self, sig: PoolSignals) -> Decision:
        cfg = self.cfg
        now = self.clock.monotonic()
        live = sig.live

        # scale from zero: pending demand against an empty pool boots a
        # replica IMMEDIATELY — the cooldown exists to let new capacity
        # absorb load, and a pool with zero capacity has nothing to wait
        # for (every queued second here is raw client TTFT).
        if live == 0 and sig.pending_demand > 0:
            target = max(cfg.min_replicas, 1)
            reason = (f"scale-from-zero: {sig.pending_demand} pending, "
                      "0 replicas")
            # per-model demand (modelpool fleets) names the model the
            # new replica should boot warm; the suffix only appears
            # when the split exists, so single-model replay digests
            # are untouched
            boot = sig.boot_model()
            if boot is not None:
                reason += f", boot model {boot}"
            return self._record(Decision(
                now, "scale_out", live, target, reason))

        # scale out: SLI pressure, gated by the scale-out cooldown
        if live < cfg.max_replicas and (
                self._last_scale_out is None
                or now - self._last_scale_out >= cfg.scale_out_cooldown_s):
            reason = self._scale_out_reason(sig)
            if reason is not None:
                target = min(live + cfg.scale_out_step, cfg.max_replicas)
                return self._record(Decision(
                    now, "scale_out", live, target, reason))

        # scale in: only when the pool has been idle + drained for
        # idle_in_s AND no scale event happened inside the cooldown
        if not sig.idle():
            self._idle_since = None
        else:
            if self._idle_since is None:
                self._idle_since = now
            last = self._last_scale_t()
            if (live > cfg.min_replicas
                    and now - self._idle_since >= cfg.idle_in_s
                    and (last is None
                         or now - last >= cfg.scale_in_cooldown_s)):
                return self._record(Decision(
                    now, "scale_in", live, live - 1,
                    f"pool idle {now - self._idle_since:.1f}s "
                    f">= {cfg.idle_in_s:g}s (drained)"))

        return Decision(now, "hold", live, live, "")

    def revert(self, d: Decision) -> bool:
        """Roll back the most recently recorded decision — the
        reconciler's failed-apply path (kubectl error).  The cooldown
        stamps and the decision sequence return to their pre-decision
        state, so the next tick can retry instead of sitting out a
        cooldown for an action that never took effect."""
        if self._undo is None or self._undo[0] is not d:
            return False
        (_, self._last_scale_out, self._last_scale_in,
         self._idle_since) = self._undo
        if self.decisions and self.decisions[-1] is d:
            self.decisions.pop()
        self._undo = None
        return True

    def _record(self, d: Decision) -> Decision:
        self._undo = (d, self._last_scale_out, self._last_scale_in,
                      self._idle_since)
        if d.action == "scale_out":
            self._last_scale_out = d.t
            self._idle_since = None
        elif d.action == "scale_in":
            self._last_scale_in = d.t
            # one retirement per idle window step: re-arm the timer so
            # draining N surplus replicas takes N idle_in_s confirmations
            self._idle_since = d.t
        self.decisions.append(d)
        logger.info("autoscale %s: %d -> %d (%s)", d.action, d.current,
                    d.target, d.reason)
        return d
