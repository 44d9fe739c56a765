"""The Grafana dashboard JSON of the port, from its metric registry.

The port of ``tools/gen_dashboard.py``: one panel a family of the port's
registry (``alerts.registry``), in registry order, two a row:

- counter    -> timeseries of ``rate(<family>_total[5m])``
- gauge      -> timeseries of the raw family
- histogram  -> timeseries of p50/p95 ``histogram_quantile`` over
                ``rate(<family>_bucket[5m])``

The DCGM-named gauges the engine embeds (``server/gpu_metrics.py``) select
the engine pods' job, and the DCGM exporter DaemonSet's own utilisation,
memory and power get panels of their own on its job: both export the same
names.  The provisioner ships the JSON as a ConfigMap labelled
``grafana_dashboard: "1"`` (observability.py), which the Grafana sidecar of
the kube-prometheus-stack imports.
"""

from __future__ import annotations

import json

from tpuserve_torch.provision.alerts import (DCGM_JOB, ENGINE_JOB, registry,
                                             registry_digest)

DATASOURCE = {"type": "prometheus", "uid": "${DS_PROMETHEUS}"}
RANGE_WINDOW = "5m"
#: the DaemonSet's default counters among the names the engine embeds
DCGM_DAEMONSET_FAMILIES = ("DCGM_FI_DEV_GPU_UTIL", "DCGM_FI_DEV_FB_USED",
                           "DCGM_FI_DEV_POWER_USAGE")


def _selector(metric) -> str:
    return (f'{{job="{ENGINE_JOB}"}}' if metric.family.startswith("DCGM_")
            else "")


def _targets(metric) -> list[dict]:
    fam, sel = metric.family, _selector(metric)
    if metric.kind == "counter":
        return [{"refId": "A", "datasource": DATASOURCE,
                 "expr": f"rate({metric.exported}{sel}[{RANGE_WINDOW}])",
                 "legendFormat": "{{model_name}}/s"}]
    if metric.kind == "gauge":
        return [{"refId": "A", "datasource": DATASOURCE,
                 "expr": fam + sel, "legendFormat": "{{model_name}}"}]
    return [
        {"refId": "A", "datasource": DATASOURCE,
         "expr": (f"histogram_quantile(0.5, "
                  f"rate({fam}_bucket{sel}[{RANGE_WINDOW}]))"),
         "legendFormat": "p50"},
        {"refId": "B", "datasource": DATASOURCE,
         "expr": (f"histogram_quantile(0.95, "
                  f"rate({fam}_bucket{sel}[{RANGE_WINDOW}]))"),
         "legendFormat": "p95"},
    ]


def _panel(i: int, title: str, description: str, targets: list) -> dict:
    return {
        "id": i + 1,
        "type": "timeseries",
        "title": title,
        "description": description,
        "datasource": DATASOURCE,
        "gridPos": {"h": 8, "w": 12, "x": (i % 2) * 12, "y": (i // 2) * 8},
        "fieldConfig": {"defaults": {"custom": {"fillOpacity": 8}},
                        "overrides": []},
        "targets": targets,
    }


def build_dashboard() -> dict:
    """Deterministic dashboard dict: panel order is registry order, then
    the DCGM exporter's panels."""
    panels = []
    for metric in registry():
        panels.append(_panel(
            len(panels), metric.exported,
            f"{metric.kind} from the tpuserve_torch registry "
            f"({metric.source}); generated by "
            "tpuserve_torch/provision/dashboard.py — edit the registry, "
            "not this panel", _targets(metric)))
    for fam in DCGM_DAEMONSET_FAMILIES:
        panels.append(_panel(
            len(panels), f"{fam} (DCGM exporter)",
            "gauge from the DCGM exporter DaemonSet on every GPU node",
            [{"refId": "A", "datasource": DATASOURCE,
              "expr": f'{fam}{{job="{DCGM_JOB}"}}',
              "legendFormat": "{{Hostname}} gpu {{gpu}}"}]))
    return {
        "uid": "tpuserve-torch-engine",
        "title": "tpuserve_torch engine (generated)",
        "description": "Generated from the tpuserve_torch/server metric "
                       "registries by tpuserve_torch/provision/dashboard.py. "
                       f"registry-digest: {registry_digest()}",
        "schemaVersion": 39,
        "editable": True,
        "timezone": "browser",
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "tags": ["tpuserve", "generated"],
        "templating": {"list": []},
        "panels": panels,
    }


def render() -> str:
    """Canonical serialisation (what the ConfigMap carries)."""
    return json.dumps(build_dashboard(), indent=2, sort_keys=True) + "\n"


def exprs() -> list[str]:
    """Every query the dashboard runs."""
    return [t["expr"] for p in build_dashboard()["panels"] for t in p["targets"]]
