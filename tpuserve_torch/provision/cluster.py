"""Cluster layer: device-plugin checks, storage, RBAC, metrics stack.

The port of ``tpuserve/provision/cluster.py``, the analog of
kubernetes-single-node.yaml's six plays (reference:
kubernetes-single-node.yaml:1-504).  On GKE the OS-prep / CRI-O / kubeadm /
Flannel plays (:1-319) are managed by the platform, and the NVIDIA GPU
Operator play (:321-348) by GKE's managed driver and ``nvidia.com/gpu``
device plugin — what remains is storage (:350-401), the
kube-prometheus-stack play (:404-504), and the DCGM exporter's
ServiceMonitor (:447-504).
"""

from __future__ import annotations

import logging

from tpuserve_torch.provision import manifests
from tpuserve_torch.provision.config import DeployConfig
from tpuserve_torch.provision.infra import GPU_RESOURCE, KubeCtl

logger = logging.getLogger("tpuserve_torch.provision")

#: the DCGM exporter's app label, Service name and scrape job
DCGM_EXPORTER = "dcgm-exporter"


def bootstrap(cfg: DeployConfig, kube: KubeCtl) -> None:
    """Idempotent cluster bootstrap: namespaces → storage → metrics stack →
    DCGM exporter ServiceMonitor."""
    _namespaces(cfg, kube)
    _storage(cfg, kube)
    _prometheus_stack(cfg, kube)
    _dcgm_monitor(cfg, kube)


def _namespaces(cfg: DeployConfig, kube: KubeCtl) -> None:
    # dry-run | apply idempotent namespace creation, the reference's own
    # trick (otel-observability-setup.yaml:15-37).
    for ns in (cfg.namespace, cfg.monitoring_namespace):
        kube.apply_manifest(manifests.render(manifests.namespace(ns)))


def storage_class_manifest(cfg: DeployConfig) -> dict:
    """Default StorageClass for provider=local (kubernetes-single-node.
    yaml:364-373 installs rancher local-path by hand; kind/minikube bundle
    the same provisioner)."""
    return {
        "apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
        "metadata": {"name": cfg.storage_class, "annotations": {
            "storageclass.kubernetes.io/is-default-class": "true"}},
        "provisioner": "rancher.io/local-path",
        "volumeBindingMode": "WaitForFirstConsumer",
    }


def dcgm_servicemonitor_manifest(cfg: DeployConfig) -> dict:
    """ServiceMonitor for the DCGM exporter at the reference's 5s cadence
    (kubernetes-single-node.yaml:447-504)."""
    return {
        "apiVersion": "monitoring.coreos.com/v1", "kind": "ServiceMonitor",
        "metadata": {"name": DCGM_EXPORTER,
                     "namespace": cfg.monitoring_namespace,
                     "labels": {"release": "prometheus"}},
        "spec": {
            "namespaceSelector": {"matchNames": [cfg.namespace]},
            "selector": {"matchLabels": {"app": DCGM_EXPORTER}},
            "endpoints": [{"port": "metrics",
                           "interval": f"{cfg.gpu_metrics_interval_s}s"}],
        },
    }


def _storage(cfg: DeployConfig, kube: KubeCtl) -> None:
    """Default StorageClass + PVCs (kubernetes-single-node.yaml:360-401).
    GKE ships standard-rwo; for provider=local install a hostPath-style
    default class analog only if none exists."""
    if cfg.provider == "local":
        res = kube.kubectl("get", "storageclass", "-o",
                           "jsonpath={.items[*].metadata.name}", check=False)
        if cfg.storage_class not in (res.stdout or "").split():
            kube.apply_manifest(manifests.render(storage_class_manifest(cfg)))
    kube.apply_manifest(manifests.render(manifests.namespace(cfg.namespace),
                                         *manifests.storage_pvcs(cfg)))


def _prometheus_stack(cfg: DeployConfig, kube: KubeCtl) -> None:
    """kube-prometheus-stack via Helm with the reference's values: Grafana
    admin password, 15d retention (kubernetes-single-node.yaml:420-432);
    then wait for the ServiceMonitor CRD (:434-444)."""
    check = kube.helm("status", "prometheus", "-n", cfg.monitoring_namespace,
                      check=False)
    if not check.ok:
        kube.helm("repo", "add", "prometheus-community",
                  "https://prometheus-community.github.io/helm-charts",
                  check=False)
        kube.helm("repo", "update", check=False)
        kube.helm(
            "install", "prometheus",
            "prometheus-community/kube-prometheus-stack",
            "-n", cfg.monitoring_namespace, "--create-namespace",
            "--set", f"grafana.adminPassword={cfg.grafana_admin_password}",
            "--set", f"prometheus.prometheusSpec.retention={cfg.prometheus_retention}",
            "--wait", "--timeout", "15m", timeout=1200.0)
    kube.runner.retry(
        kube._base("kubectl") + ["get", "crd",
                                 "servicemonitors.monitoring.coreos.com"],
        retries=30, delay=10.0)


def _dcgm_monitor(cfg: DeployConfig, kube: KubeCtl) -> None:
    """ServiceMonitor for the DCGM exporter at the reference's 5s cadence
    (kubernetes-single-node.yaml:447-504)."""
    res = kube.apply_manifest(
        manifests.render(dcgm_servicemonitor_manifest(cfg)), check=False)
    if not res.ok:
        # CRD may be absent on a bare local cluster without the stack —
        # a soft assertion, like the reference's ignore_errors waits
        # (SURVEY.md §4.3).
        logger.warning("ServiceMonitor apply failed (no prometheus CRDs?): %s",
                       res.stderr.strip()[:500])


def verify_gpu_schedulable(cfg: DeployConfig, kube: KubeCtl) -> bool:
    """Post-bootstrap check that pods can actually request nvidia.com/gpu —
    the crictl/CRI-O preflight analog (kubernetes-single-node.yaml:228-238)."""
    res = kube.kubectl("get", "nodes", "-o", "json", check=False)
    if not res.ok:
        return False
    import json
    try:
        nodes = json.loads(res.stdout)["items"]
    except (ValueError, KeyError):
        return False
    return any(
        int(n.get("status", {}).get("allocatable", {}).get(GPU_RESOURCE, 0))
        for n in nodes)
