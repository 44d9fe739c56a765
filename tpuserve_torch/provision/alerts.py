"""PrometheusRule + Alertmanager config for the port, from its registries.

The port of ``tools/gen_alerts.py`` and of the registry parse it shares
with the dashboard (``tools/tpulint/metrics_consistency.py``
``registry_from_source``), kept inside the provisioner so a deploy needs
nothing outside ``tpuserve_torch``.  The rules are generated from the
port's objectives (``tpuserve_torch/obs/objectives.py``, burn-rate rules
by ``tpuserve_torch/obs/burnrate.py``) and its metric registry, parsed
from the source of ``tpuserve_torch/server/metrics.py`` and
``server/gpu_metrics.py`` (no import: the engine's modules pull in
PyTorch, which a deploy host need not have for this).

Each family carries the scrape job that reads it: the engine pods'
``vllm-metrics`` (the server's families and the DCGM-named gauges it
embeds from NVML), the gateway's, the autoscaler's.  The DCGM exporter
DaemonSet exports the same DCGM names under job ``dcgm-exporter``, so a
query of a DCGM name always selects its job.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re

#: the OTEL collector's scrape jobs (observability.collector_config)
ENGINE_JOB = "vllm-metrics"
DCGM_JOB = "dcgm-exporter"

#: black-box canary alert tuning (tpuserve_torch/obs/canary.py families)
CANARY_FAIL_WINDOW = "10m"
CANARY_FAIL_RATIO = 0.5
CANARY_ABSENT_WINDOW = "15m"

#: HBM-headroom warning threshold (devprof watermark, runtime/devprof.py)
HBM_HEADROOM_RATIO = 0.05

_SERVER_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "server")
#: registry class -> the process that serves its families
_SOURCES = {"ServerMetrics": "engine", "GpuMetricsExporter": "engine",
            "CanaryMetrics": "gateway", "AutoscalerMetrics": "autoscaler"}
_KINDS = {"counter": "counter", "gauge": "gauge", "histogram": "histogram",
          "labelled_class": "histogram"}
_NAME_RE = re.compile(r"\b([A-Za-z_][A-Za-z0-9_]*)\b")


@dataclasses.dataclass(frozen=True)
class Metric:
    family: str
    kind: str         # counter | gauge | histogram
    source: str       # engine | gateway | autoscaler

    @property
    def exported(self) -> str:
        """The sample name: the renderer appends ``_total`` to counters."""
        if self.kind == "counter" and not self.family.endswith("_total"):
            return self.family + "_total"
        return self.family


def _call_kind(call: ast.Call) -> str | None:
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
    if name in _KINDS:
        return _KINDS[name]
    if name in ("family", "labelled") and len(call.args) >= 3 \
            and isinstance(call.args[2], ast.Constant):
        return call.args[2].value
    return None


def registry() -> list[Metric]:
    """Every family the port's registries declare, in source order: each
    call of a registry helper (``counter``, ``gauge``, ``histogram``,
    ``labelled``, ``labelled_class``, ``family``) with a literal name,
    inside one of the registry classes."""
    out: list[Metric] = []
    for fname in ("metrics.py", "gpu_metrics.py"):
        with open(os.path.join(_SERVER_DIR, fname), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for cls in tree.body:
            if not isinstance(cls, ast.ClassDef) or cls.name not in _SOURCES:
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                first = node.args[0]
                kind = _call_kind(node)
                if kind and isinstance(first, ast.Constant) \
                        and isinstance(first.value, str):
                    out.append(Metric(first.value, kind, _SOURCES[cls.name]))
    return out


def registry_digest() -> str:
    """Digest of the parsed registry (families + kinds): the stamp shared
    by the alert rules and the dashboard, so one regenerated against a
    different registry than the other is detectable."""
    fams = sorted((m.exported, m.kind) for m in registry())
    return hashlib.sha256(json.dumps(fams).encode()).hexdigest()


def canary_rules() -> list:
    """Black-box prober alerts: failing probes and a silent prober."""
    return [
        {
            "alert": "tpuserve-canary-failures",
            "expr": (f"sum(rate(tpuserve_canary_failures_total"
                     f"[{CANARY_FAIL_WINDOW}])) / "
                     f"sum(rate(tpuserve_canary_probes_total"
                     f"[{CANARY_FAIL_WINDOW}])) > {CANARY_FAIL_RATIO}"),
            "for": "5m",
            "labels": {"severity": "page", "objective": "canary"},
            "annotations": {
                "summary": "synthetic canary probes failing through "
                           "the serving path",
                "description": (
                    "More than "
                    f"{int(CANARY_FAIL_RATIO * 100)}% of synthetic "
                    "canary probes failed over the last "
                    f"{CANARY_FAIL_WINDOW} — the black-box view says "
                    "clients cannot get answers, regardless of what "
                    "white-box SLIs claim."),
                "runbook": "README.md#alert-tpuserve-canary-failures",
            },
        },
        {
            "alert": "tpuserve-canary-absent",
            "expr": ("absent(tpuserve_canary_probes_total) or "
                     "sum(rate(tpuserve_canary_probes_total"
                     f"[{CANARY_ABSENT_WINDOW}])) == 0"),
            "for": "5m",
            "labels": {"severity": "ticket", "objective": "canary"},
            "annotations": {
                "summary": "canary prober stopped probing",
                "description": (
                    "No canary probes recorded for "
                    f"{CANARY_ABSENT_WINDOW}: the prober is dead or "
                    "its metrics pipeline is — either way the fleet "
                    "is flying without black-box coverage."),
                "runbook": "README.md#alert-tpuserve-canary-absent",
            },
        },
    ]


def hbm_rules() -> list:
    """Device-memory alert: the card's memory headroom near the edge
    (the devprof watermark, runtime/devprof.py)."""
    return [
        {
            "alert": "tpuserve-hbm-headroom-low",
            "expr": ("tpuserve_hbm_headroom_bytes / "
                     "(tpuserve_hbm_headroom_bytes + "
                     "sum by (model_name) (tpuserve_hbm_bytes)) "
                     f"< {HBM_HEADROOM_RATIO}"),
            "for": "10m",
            "labels": {"severity": "ticket", "objective": "hbm"},
            "annotations": {
                "summary": "device HBM headroom nearly exhausted",
                "description": (
                    "Less than "
                    f"{int(HBM_HEADROOM_RATIO * 100)}% of the card's "
                    "memory budget is left after weights + KV reservation "
                    "+ workspace (tpuserve_hbm_bytes watermark, "
                    "runtime/devprof.py) — the next captured-graph "
                    "bucket, draft model, or cache resize risks an "
                    "OOM.  Shrink the bucket ladder or the cache before "
                    "it does."),
                "runbook": "README.md#alert-tpuserve-hbm-headroom-low",
            },
        },
    ]


def all_rules() -> list:
    from tpuserve_torch.obs.burnrate import alert_rules
    from tpuserve_torch.obs.objectives import (DEFAULT_OBJECTIVES,
                                               validate_objectives)
    fams = set()
    for m in registry():
        fams.add(m.family)
        fams.add(m.exported)
    validate_objectives(DEFAULT_OBJECTIVES, families=fams)
    return alert_rules(DEFAULT_OBJECTIVES) + canary_rules() + hbm_rules()


def prometheus_rule(namespace: str = "monitoring") -> dict:
    """The PrometheusRule CR the provisioner applies — labelled so the
    kube-prometheus-stack's default rule selector (release label) picks
    it up."""
    return {
        "apiVersion": "monitoring.coreos.com/v1",
        "kind": "PrometheusRule",
        "metadata": {"name": "tpuserve-slo-burn",
                     "namespace": namespace,
                     "labels": {"app": "tpuserve",
                                "release": "prometheus"}},
        "spec": {"groups": [{"name": "tpuserve-slo",
                             "rules": all_rules()}]},
    }


def alertmanager_config() -> dict:
    """Severity-routed Alertmanager config: page -> oncall webhook,
    everything else -> tickets; a firing page inhibits the same
    objective's ticket-severity twin."""
    return {
        "route": {
            "receiver": "tpuserve-tickets",
            "group_by": ["alertname", "objective"],
            "group_wait": "30s",
            "group_interval": "5m",
            "repeat_interval": "4h",
            "routes": [{"matchers": ['severity="page"'],
                        "receiver": "tpuserve-oncall"}],
        },
        "receivers": [
            {"name": "tpuserve-oncall", "webhook_configs": [
                {"url": "http://tpuserve-oncall-webhook:9093/alert",
                 "send_resolved": True}]},
            {"name": "tpuserve-tickets", "webhook_configs": [
                {"url": "http://tpuserve-ticket-webhook:9093/alert",
                 "send_resolved": True}]},
        ],
        "inhibit_rules": [{
            "source_matchers": ['severity="page"'],
            "target_matchers": ['severity="ticket"'],
            "equal": ["objective"],
        }],
    }


def families_in(expr: str, metrics: list[Metric] | None = None) -> set:
    """The registry families a PromQL expression reads (by family or
    sample name; a histogram's ``_bucket`` / ``_count`` / ``_sum`` series
    count as its family)."""
    names = {}
    for m in metrics if metrics is not None else registry():
        names[m.family] = names[m.exported] = m
        if m.kind == "histogram":
            for suffix in ("_bucket", "_count", "_sum"):
                names[m.family + suffix] = m
    return {names[t].family for t in _NAME_RE.findall(expr) if t in names}


def engine_families(exprs: list[str]) -> set:
    """The families among ``exprs`` that the engine's own ``/metrics``
    serves: every engine-sourced family an expression reads, except a
    DCGM name selected on the DaemonSet's job."""
    metrics = registry()
    by_family = {m.family: m for m in metrics}
    out = set()
    for expr in exprs:
        for fam in families_in(expr, metrics):
            if by_family[fam].source != "engine":
                continue
            if re.search(re.escape(fam) + r'\{[^}]*job="' + DCGM_JOB + '"', expr):
                continue
            out.add(fam)
    return out
