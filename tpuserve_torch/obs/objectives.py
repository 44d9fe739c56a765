"""The declarative SLO objectives registry.

The port's own copy of ``tpuserve/obs/objectives.py`` (its imports are the port's).

One list of :class:`SLOObjective` drives everything downstream: the
in-process burn-rate evaluator (``burnrate.py``), the generated
PrometheusRule/Alertmanager YAML (``tools/gen_alerts.py``), the fleet
view the gateway serves on ``/gateway/slo``, and the replay backtester.
An objective that exists in one consumer but not another is exactly the
drift this module exists to prevent, so objectives are VALIDATED, not
trusted:

- latency objectives must target a metric family that exists in the
  parsed ``server/metrics.py`` registry (the same ``registry_from_source``
  fixture tpulint P5 and the dashboard/alert generators share);
- a latency threshold must sit ON a pinned histogram bucket edge
  (``server/metrics.SLI_BUCKETS``) — PromQL evaluates
  ``le="<threshold>"`` literally, so a threshold between edges would
  make the in-process evaluator and the compiled rules disagree about
  what "good" means.  The edges are themselves pinned by
  ``tests/test_obs.py``.

Objectives are loadable from JSON (``TPUSERVE_SLO_OBJECTIVES`` env /
``--slo-objectives``) so a deployment can declare its own targets; the
defaults below match the repo's SLO-class story (interactive pages,
batch tickets).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Sequence

from tpuserve_torch.runtime.slo import SLO_CLASSES

#: latency SLI kinds (match the flight recorder's) + black-box-style
#: availability (good = the request finished, bad = shed/failed/expired)
SLI_KINDS = ("ttft", "itl", "e2e", "availability")

#: objective.slo_class value meaning "every class"
ALL_CLASSES = "*"

#: the exported histogram family each latency SLI lives in
FAMILY_BY_SLI = {
    "ttft": "tpuserve_ttft_seconds",
    "itl": "tpuserve_itl_seconds",
    "e2e": "tpuserve_e2e_seconds",
}

#: families the availability objective's PromQL ratio reads (bad /
#: total).  Bad mirrors what the in-process evaluator's
#: observe_outcome stream counts: shed + poisoned + other terminal
#: engine-decided failures (deadline 504s, salvage errors —
#: tpuserve_requests_failed_total, fed by runner._fail_request).  The
#: denominator subtracts canary probes, which the in-process stream
#: excludes on both sides.
AVAILABILITY_BAD_FAMILIES = ("tpuserve_requests_shed_total",
                             "tpuserve_requests_poisoned_total",
                             "tpuserve_requests_failed_total")
AVAILABILITY_TOTAL_FAMILY = "vllm_request_total"
AVAILABILITY_CANARY_FAMILY = "tpuserve_canary_requests_total"


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    name: str                    # unique slug, e.g. "interactive-ttft"
    slo_class: str               # interactive|standard|batch|*
    sli: str                     # ttft|itl|e2e|availability
    objective: float             # good-event fraction target, e.g. 0.99
    window_s: float              # SLO compliance window (budget period)
    # latency objectives: good = sample <= threshold_s (must be a pinned
    # bucket edge); None for availability
    threshold_s: Optional[float] = None
    severity: str = "page"       # page | ticket (alert routing)

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective

    def families(self) -> tuple:
        """Metric families this objective's PromQL reads."""
        if self.sli == "availability":
            return AVAILABILITY_BAD_FAMILIES + (
                AVAILABILITY_TOTAL_FAMILY, AVAILABILITY_CANARY_FAMILY)
        return (FAMILY_BY_SLI[self.sli],)

    def matches(self, slo_class: str) -> bool:
        return self.slo_class == ALL_CLASSES or self.slo_class == slo_class

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


#: Default fleet objectives.  Thresholds sit on SLI_BUCKETS edges by
#: construction (validated at import-consumer time and pinned in
#: tests/test_obs.py); windows are the SLO budget period the burn-rate
#: factors are computed against.
DEFAULT_OBJECTIVES: tuple = (
    SLOObjective("interactive-ttft", "interactive", "ttft",
                 objective=0.99, window_s=3600.0, threshold_s=0.5),
    SLOObjective("interactive-itl", "interactive", "itl",
                 objective=0.99, window_s=3600.0, threshold_s=0.1),
    SLOObjective("standard-e2e", "standard", "e2e",
                 objective=0.95, window_s=3600.0, threshold_s=30.0),
    SLOObjective("batch-e2e", "batch", "e2e",
                 objective=0.95, window_s=3600.0, threshold_s=120.0,
                 severity="ticket"),
    SLOObjective("availability", ALL_CLASSES, "availability",
                 objective=0.999, window_s=3600.0),
)


def validate_objectives(objectives: Sequence[SLOObjective],
                        families: Optional[set] = None) -> None:
    """Raise ``ValueError`` on the first invalid objective.

    ``families``: the exported metric-family names parsed from
    ``server/metrics.py`` (callers that hold the registry — the alert
    generator, tests — pass it so an objective can never name a ghost
    family; in-process construction may omit it, the bucket-edge check
    still runs).
    """
    from tpuserve_torch.server.metrics import SLI_BUCKETS
    seen = set()
    for o in objectives:
        if o.name in seen:
            raise ValueError(f"duplicate objective name {o.name!r}")
        seen.add(o.name)
        if o.slo_class != ALL_CLASSES and o.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"objective {o.name!r}: unknown slo_class "
                f"{o.slo_class!r} (one of {'/'.join(SLO_CLASSES)} or "
                f"'{ALL_CLASSES}')")
        if o.sli not in SLI_KINDS:
            raise ValueError(f"objective {o.name!r}: unknown sli "
                             f"{o.sli!r} (one of {'/'.join(SLI_KINDS)})")
        if not 0.0 < o.objective < 1.0:
            raise ValueError(f"objective {o.name!r}: objective must be "
                             f"in (0, 1), got {o.objective}")
        if o.window_s <= 0:
            raise ValueError(f"objective {o.name!r}: window_s must be "
                             "> 0")
        if o.severity not in ("page", "ticket"):
            raise ValueError(f"objective {o.name!r}: severity must be "
                             "page or ticket")
        if o.sli == "availability":
            if o.threshold_s is not None:
                raise ValueError(f"objective {o.name!r}: availability "
                                 "takes no threshold_s")
            if o.slo_class != ALL_CLASSES:
                # the white-box bad-event counters (shed/poisoned/
                # failed) carry no slo_class label, so a per-class
                # availability objective would silently compile to a
                # fleet-wide PromQL rule while the in-process
                # evaluator honored the class — reject rather than
                # let the two twins disagree
                raise ValueError(
                    f"objective {o.name!r}: availability objectives "
                    f"must use slo_class '{ALL_CLASSES}' (the shed/"
                    "failed counters are not class-labelled, so the "
                    "compiled PromQL cannot filter by class)")
        else:
            if o.threshold_s is None:
                raise ValueError(f"objective {o.name!r}: latency "
                                 "objectives need threshold_s")
            edges = SLI_BUCKETS[o.sli]
            if o.threshold_s not in edges:
                raise ValueError(
                    f"objective {o.name!r}: threshold {o.threshold_s}s "
                    f"is not a pinned {o.sli} histogram bucket edge — "
                    f"PromQL can only evaluate le=<edge>; pick one of "
                    f"{list(edges)}")
        if families is not None:
            for fam in o.families():
                base = fam[:-6] if fam.endswith("_total") else fam
                if fam not in families and base not in families:
                    raise ValueError(
                        f"objective {o.name!r}: metric family {fam!r} "
                        "is not in the server/metrics.py registry")


def load_objectives(source: Optional[str] = None) -> tuple:
    """Objectives from ``source`` (inline JSON list or a file path),
    falling back to ``TPUSERVE_SLO_OBJECTIVES``, falling back to
    :data:`DEFAULT_OBJECTIVES`.  Always validated (bucket edges at
    least) — a bad objectives file must fail at boot, not silently
    never fire."""
    source = source or os.environ.get("TPUSERVE_SLO_OBJECTIVES")
    if not source:
        objs = DEFAULT_OBJECTIVES
    else:
        text = source
        if not source.lstrip().startswith("["):
            with open(source, "r", encoding="utf-8") as f:
                text = f.read()
        raw = json.loads(text)
        if not isinstance(raw, list) or not raw:
            raise ValueError("objectives config must be a non-empty "
                             "JSON list")
        objs = []
        for item in raw:
            if not isinstance(item, dict):
                raise ValueError("each objective must be an object")
            extra = set(item) - {f.name for f in
                                 dataclasses.fields(SLOObjective)}
            if extra:
                raise ValueError(f"objective {item.get('name')!r}: "
                                 f"unknown keys {sorted(extra)}")
            objs.append(SLOObjective(**item))
        objs = tuple(objs)
    validate_objectives(objs)
    return tuple(objs)


def objectives_digest(objectives: Sequence[SLOObjective]) -> str:
    """Order-sensitive digest of an objectives list — stamped into
    backtest reports and the generated alert YAML so "same objectives"
    is checkable, not assumed."""
    return hashlib.sha256(json.dumps(
        [o.as_dict() for o in objectives], sort_keys=True
    ).encode()).hexdigest()
