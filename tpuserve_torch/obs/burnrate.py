"""Multi-window multi-burn-rate SLO evaluation (SRE workbook style).

The port's own copy of ``tpuserve/obs/burnrate.py`` (its imports are the port's).

One objective, two windows: an alert fires when the error-budget burn
rate exceeds the window pair's factor over BOTH the long window (so a
blip can't page) and the short window (so a recovered incident resolves
fast).  The same evaluation exists twice, deliberately:

- **in-process** (:class:`BurnRateEvaluator`): fed by the runner's SLI
  stream, timestamps through the injectable clock seam
  (``runtime/clock.py``) — so the identical evaluator runs off a live
  engine in production and off a replayed incident under
  ``VirtualClock`` (``obs/backtest.py``), and a pod knows its own SLO
  state even when the metrics stack is down;
- **compiled to PromQL** (:func:`promql_burn_expr` /
  :func:`alert_rules`): the fleet-level twin, generated into
  PrometheusRule YAML by ``tools/gen_alerts.py`` from the same
  objectives registry, thresholds quantized to the same pinned
  histogram bucket edges.

Burn rate here is the ratio form: (bad events / total events over the
window) / error budget.  1.0 means burning exactly the budget; the
canonical factors (14.4 over 1h+5m, 6 over 6h+30m) are the workbook's
"exhaust 2%/5% of a 30-day budget before a human sees it" points.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

from tpuserve_torch.runtime.clock import MONOTONIC
from tpuserve_torch.obs.objectives import (ALL_CLASSES,
                                     AVAILABILITY_BAD_FAMILIES,
                                     AVAILABILITY_CANARY_FAMILY,
                                     AVAILABILITY_TOTAL_FAMILY,
                                     FAMILY_BY_SLI, SLOObjective)

#: short-window event floor before a pair may fire — shared by the
#: in-process evaluator AND the generated PromQL rules, so the two
#: twins agree that one unlucky request in a quiet hour is not a page
DEFAULT_MIN_EVENTS = 10

#: how often the owner loop advances the evaluator (runner throttle and
#: the backtest observer both use it, so backtest-tuned thresholds
#: reproduce the production evaluation cadence)
EVAL_INTERVAL_S = 1.0


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One multi-window pair: fire when burn >= factor over BOTH
    windows; ``for_s`` is the generated rule's ``for:`` hold."""
    name: str          # "fast" | "slow" (label + runbook anchor part)
    long_s: float
    short_s: float
    factor: float      # burn-rate firing threshold
    for_s: float = 120.0


#: SRE-workbook pairs: fast pages (2% of a 30d budget in 1h), slow
#: tickets (5% in 6h).  The slow pair always routes severity=ticket.
DEFAULT_WINDOWS = (
    BurnWindow("fast", long_s=3600.0, short_s=300.0, factor=14.4,
               for_s=120.0),
    BurnWindow("slow", long_s=21600.0, short_s=1800.0, factor=6.0,
               for_s=900.0),
)


class _Series:
    """Time-bucketed good/bad event counts: O(1) append, window sums by
    scanning only the buckets inside the window (bounded count).  Single
    writer (the engine/runner loop or the replay harness)."""

    __slots__ = ("bucket_s", "span_s", "_buckets")

    def __init__(self, span_s: float, bucket_s: float):
        self.bucket_s = bucket_s
        self.span_s = span_s
        self._buckets: deque = deque()     # [idx, good, bad], idx ascending

    def add(self, t: float, good: int, bad: int) -> None:
        idx = int(t // self.bucket_s)
        if self._buckets and self._buckets[-1][0] == idx:
            b = self._buckets[-1]
            b[1] += good
            b[2] += bad
        else:
            self._buckets.append([idx, good, bad])
            # prune anything older than the longest window we serve
            floor = idx - int(self.span_s / self.bucket_s) - 2
            while self._buckets and self._buckets[0][0] < floor:
                self._buckets.popleft()

    def sums(self, now: float, window_s: float) -> tuple:
        """(good, bad) over [now - window_s, now] — a bucket counts when
        its END falls inside the window."""
        cutoff = now - window_s
        good = bad = 0
        for idx, g, b in reversed(self._buckets):
            if (idx + 1) * self.bucket_s <= cutoff:
                break
            good += g
            bad += b
        return good, bad


class BurnRateEvaluator:
    """In-process multi-window burn-rate evaluation over a live SLI
    stream.  Single-threaded by contract: the owner (runner loop, or the
    replay backtester) both feeds and evaluates; readers get plain-dict
    snapshots via :meth:`state`.

    ``min_events``: the short window must hold at least this many events
    before a pair may fire — a single bad request against a 99.9%
    budget is a burn rate of 1000, not an incident.
    """

    def __init__(self, objectives: Sequence[SLOObjective],
                 windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
                 clock=None, bucket_s: Optional[float] = None,
                 min_events: int = DEFAULT_MIN_EVENTS):
        from tpuserve_torch.obs.objectives import validate_objectives
        validate_objectives(objectives)
        if not windows:
            raise ValueError("need at least one BurnWindow pair")
        self.objectives = tuple(objectives)
        self.windows = tuple(windows)
        self.clock = clock or MONOTONIC
        self.min_events = min_events
        shortest = min(w.short_s for w in self.windows)
        longest = max(w.long_s for w in self.windows)
        self._bucket_s = bucket_s or max(0.05, shortest / 30.0)
        # (kind, class) -> [objectives]; availability indexes under its
        # own kind with per-class wildcarding resolved at observe time
        self._by_sli: dict = {}
        self._series: dict = {}
        for o in self.objectives:
            self._by_sli.setdefault(o.sli, []).append(o)
            self._series[o.name] = _Series(longest, self._bucket_s)
        self._firing: dict = {}            # (objective, window) -> bool
        self.transitions: list[dict] = []  # full FIRING/RESOLVED sequence
        # owner-thread-published snapshot (plain dict, replaced
        # atomically by evaluate()): what serving threads — /debug/
        # engine, the gateway's fleet view — may read without racing
        # the bucket deques
        self.last_state: dict = {}

    # ---- feeding (owner thread) ----------------------------------------

    def observe(self, slo_class: str, kind: str, value: float) -> None:
        """One client-observable latency sample (seconds) — the same
        stream the tpuserve_{ttft,itl,e2e}_seconds histograms export."""
        for o in self._by_sli.get(kind, ()):
            if o.matches(slo_class):
                good = value <= o.threshold_s
                self._series[o.name].add(self.clock.monotonic(),
                                         int(good), int(not good))

    def observe_outcome(self, slo_class: str, ok: bool) -> None:
        """One request outcome for availability objectives: ok = the
        request finished (stop/length); bad = shed, poisoned, errored,
        or deadline-expired."""
        for o in self._by_sli.get("availability", ()):
            if o.matches(slo_class):
                self._series[o.name].add(self.clock.monotonic(),
                                         int(ok), int(not ok))

    # ---- evaluation ----------------------------------------------------

    def _burn(self, objective: SLOObjective, now: float,
              window_s: float) -> tuple:
        """(burn_rate, events) over the window."""
        good, bad = self._series[objective.name].sums(now, window_s)
        events = good + bad
        if not events:
            return 0.0, 0
        return (bad / events) / objective.error_budget, events

    def evaluate(self) -> list[dict]:
        """Advance alert state; returns the NEW transitions (also
        appended to :attr:`transitions`).  Deterministic given the same
        observation stream and clock — the backtest contract."""
        now = self.clock.monotonic()
        new: list[dict] = []
        burns: dict = {}
        for o in self.objectives:
            for w in self.windows:
                burn_long, _ = self._burn(o, now, w.long_s)
                burn_short, n_short = self._burn(o, now, w.short_s)
                burns[f"{o.name}/{w.name}"] = [round(burn_long, 4),
                                               round(burn_short, 4)]
                firing = (burn_long >= w.factor
                          and burn_short >= w.factor
                          and n_short >= self.min_events)
                key = (o.name, w.name)
                if firing != self._firing.get(key, False):
                    self._firing[key] = firing
                    tr = {"t": round(now, 6), "objective": o.name,
                          "window": w.name,
                          "state": "firing" if firing else "resolved",
                          "burn_long": round(burn_long, 4),
                          "burn_short": round(burn_short, 4),
                          "severity": (o.severity if w.name == "fast"
                                       else "ticket")}
                    self.transitions.append(tr)
                    new.append(tr)
        # publish from the burns just computed — no second deque scan
        self.last_state = {
            "objectives": [o.name for o in self.objectives],
            "firing": self.firing(),
            "burn": burns,
            "transitions": len(self.transitions),
        }
        return new

    def burn_rates(self) -> dict:
        """{(objective, window): (burn_long, burn_short)} right now —
        the tpuserve_slo_burn_rate gauge feed."""
        now = self.clock.monotonic()
        out = {}
        for o in self.objectives:
            for w in self.windows:
                out[(o.name, w.name)] = (self._burn(o, now, w.long_s)[0],
                                         self._burn(o, now, w.short_s)[0])
        return out

    def firing(self) -> list[str]:
        return sorted(f"{o}/{w}" for (o, w), on in self._firing.items()
                      if on)

    def state(self) -> dict:
        """Plain-scalar snapshot for /debug/engine and /gateway/slo."""
        return {
            "objectives": [o.name for o in self.objectives],
            "firing": self.firing(),
            "burn": {f"{o}/{w}": [round(bl, 4), round(bs, 4)]
                     for (o, w), (bl, bs) in self.burn_rates().items()},
            "transitions": len(self.transitions),
        }


# ---- PromQL compilation (the fleet-level twin) --------------------------

def _dur(seconds: float) -> str:
    """PromQL duration literal (whole seconds; prefers m/h for
    readability)."""
    s = int(round(seconds))
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"


def _le(threshold: float) -> str:
    """The ``le=`` label value prometheus_client exports for a bucket
    edge (floatToGoString: 0.5 -> "0.5", 30.0 -> "30.0")."""
    return repr(float(threshold))


def _availability_total(window_s: float, fn: str) -> str:
    """The availability denominator over one window: admitted requests
    minus served canary probes PLUS intake sheds — shed requests never
    reach ``vllm_request_total`` (the runner counts admission only), so
    without the shed term a 100%-shed outage would have a near-zero
    denominator and the events floor would suppress the page exactly
    when it matters.  Queue-eviction sheds were admitted and so count
    twice; that slightly dilutes the ratio (conservative) and is rare
    next to intake sheds in a real shed storm.  ``fn`` is ``rate`` or
    ``increase``."""
    w = _dur(window_s)
    return (f"((sum({fn}({AVAILABILITY_TOTAL_FAMILY}[{w}])) - "
            f"(sum({fn}({AVAILABILITY_CANARY_FAMILY}[{w}])) "
            "or vector(0))) + "
            f"sum({fn}(tpuserve_requests_shed_total[{w}])))")


def promql_burn_expr(objective: SLOObjective, window_s: float) -> str:
    """Burn rate over one window as PromQL, reading the same families
    and the same pinned bucket edge the in-process evaluator uses.
    The availability denominator subtracts canary probes — the
    in-process stream excludes them on both sides (the engine also
    keeps canary sheds out of the bad-event counter), and on a quiet
    pod the prober would otherwise dominate the ratio."""
    w = _dur(window_s)
    budget = f"{objective.error_budget:g}"
    if objective.sli == "availability":
        bad = " + ".join(f"sum(rate({fam}[{w}]))"
                         for fam in AVAILABILITY_BAD_FAMILIES)
        total = _availability_total(window_s, "rate")
        return f"(({bad}) / {total}) / {budget}"
    fam = FAMILY_BY_SLI[objective.sli]
    cls = ("" if objective.slo_class == ALL_CLASSES
           else f'slo_class="{objective.slo_class}"')
    sel = f"{{{cls}}}" if cls else ""
    le_sel = (f'{{le="{_le(objective.threshold_s)}"'
              + (f",{cls}" if cls else "") + "}")
    good = f"sum(rate({fam}_bucket{le_sel}[{w}]))"
    total = f"sum(rate({fam}_count{sel}[{w}]))"
    return f"(1 - {good} / {total}) / {budget}"


def promql_events_expr(objective: SLOObjective, window_s: float) -> str:
    """Events observed over one window — the PromQL twin of the
    in-process evaluator's min_events floor (sheds included: a
    full-shed outage IS events)."""
    w = _dur(window_s)
    if objective.sli == "availability":
        return _availability_total(window_s, "increase")
    fam = FAMILY_BY_SLI[objective.sli]
    cls = ("" if objective.slo_class == ALL_CLASSES
           else f'{{slo_class="{objective.slo_class}"}}')
    return f"sum(increase({fam}_count{cls}[{w}]))"


def alert_rules(objectives: Sequence[SLOObjective],
                windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
                min_events: int = DEFAULT_MIN_EVENTS) -> list:
    """PrometheusRule-shaped alert dicts, one per objective x window
    pair.  Every referenced family is in the metrics registry (tpulint
    P5 checks the generated YAML, both directions) and every rule names
    a README runbook anchor (enforced by tests/test_obs.py).  The
    min_events conjunct mirrors the in-process evaluator's floor: one
    unlucky request against a tight budget on a quiet pod is a burn
    rate in the hundreds, not an incident."""
    rules = []
    for o in objectives:
        for w in windows:
            name = f"tpuserve-slo-{o.name}-{w.name}"
            severity = o.severity if w.name == "fast" else "ticket"
            expr = (f"({promql_burn_expr(o, w.long_s)} >= {w.factor}) "
                    f"and ({promql_burn_expr(o, w.short_s)} >= "
                    f"{w.factor}) "
                    f"and ({promql_events_expr(o, w.short_s)} >= "
                    f"{min_events})")
            rules.append({
                "alert": name,
                "expr": expr,
                "for": _dur(w.for_s),
                "labels": {"severity": severity, "objective": o.name,
                           "slo_class": o.slo_class,
                           "window": w.name},
                "annotations": {
                    "summary": (f"{o.name}: burning error budget at "
                                f">= {w.factor}x over {_dur(w.long_s)}"
                                f" and {_dur(w.short_s)}"),
                    "description": (
                        f"SLO {o.name} ({o.slo_class}/{o.sli}, "
                        f"objective {o.objective:g}"
                        + (f", threshold {o.threshold_s:g}s"
                           if o.threshold_s is not None else "")
                        + f") is burning its {_dur(o.window_s)} error "
                          "budget fast enough to breach. The engine "
                          "evaluates the identical condition "
                          "in-process: tpuserve_slo_burn_rate"
                          f'{{objective="{o.name}"}}.'),
                    "runbook": f"README.md#alert-{name}",
                },
            })
    return rules
