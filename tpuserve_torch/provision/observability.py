"""Observability layer: OTEL collector → dedicated Prometheus, DCGM metrics.

The port of ``tpuserve/provision/observability.py``, itself the port of
otel-observability-setup.yaml:1-782.  Same two-Prometheus topology as the
reference (kube-prometheus-stack in ``monitoring`` from the cluster layer +
a dedicated remote-write instance in ``otel-monitoring``,
otel-observability-setup.yaml:10-11,179-283), the reference's own NVIDIA
DCGM exporter DaemonSet and its scrape jobs (:393-468), and the vLLM
pod-SD job (:337-391) kept as-is — the engine exports vllm_*-named metrics
precisely so this scrape config carries over.  The alert rules and the
dashboard come from the port's own generators (alerts.py, dashboard.py).
"""

from __future__ import annotations

import json
import logging
from urllib.parse import quote

from tpuserve_torch.provision import manifests
from tpuserve_torch.provision.alerts import DCGM_JOB, ENGINE_JOB
from tpuserve_torch.provision.config import DeployConfig
from tpuserve_torch.provision.infra import GPU_RESOURCE, KubeCtl

logger = logging.getLogger("tpuserve_torch.provision")

OTEL_PROM_VERSION = "v2.47.0"   # otel-observability-setup.yaml:214 pin
DCGM_EXPORTER_IMAGE = "nvcr.io/nvidia/k8s/dcgm-exporter:3.3.5-3.4.1-ubuntu22.04"
DCGM_PORT = 9400


def setup(cfg: DeployConfig, kube: KubeCtl) -> None:
    _namespaces(cfg, kube)
    _dcgm_exporter(cfg, kube)
    _collector_rbac(cfg, kube)
    _otel_prometheus(cfg, kube)
    _collector(cfg, kube)
    _grafana_dashboard(cfg, kube)
    _alerting(cfg, kube)
    _wait_ready(cfg, kube)


def _namespaces(cfg: DeployConfig, kube: KubeCtl) -> None:
    # --dry-run=client -o yaml | kubectl apply idempotent creation
    # (otel-observability-setup.yaml:15-37).
    for ns in (cfg.observability_namespace, cfg.otel_namespace):
        kube.apply_manifest(manifests.render(
            {"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": ns}}))


# --- DCGM exporter (:393-468) ----------------------------------------------

def dcgm_exporter_manifests(cfg: DeployConfig) -> list[dict]:
    """DaemonSet + Service for NVIDIA's DCGM exporter on every GPU node, at
    the reference's 5 s cadence; the service port is named ``metrics`` so
    service-SD matches by port name like the reference's ``gpu-metrics``
    match (otel-observability-setup.yaml:410-414).  The pods carry no
    scrape annotation: only the ``dcgm-exporter`` jobs read them, so the
    DCGM names the engine embeds (job ``vllm-metrics``) and the
    DaemonSet's stay apart by job.  It takes no ``nvidia.com/gpu`` (that
    would starve the engine): privileged, it reads every card of its node
    through the driver's libraries, and maps cards to pods through the
    kubelet's pod-resources socket."""
    labels = {"app": DCGM_JOB}
    env = [{"name": "DCGM_EXPORTER_LISTEN", "value": f":{DCGM_PORT}"},
           {"name": "DCGM_EXPORTER_KUBERNETES", "value": "true"},
           {"name": "DCGM_EXPORTER_INTERVAL",
            "value": str(cfg.gpu_metrics_interval_s * 1000)}]
    mounts = [{"name": "pod-resources",
               "mountPath": "/var/lib/kubelet/pod-resources"}]
    volumes = [{"name": "pod-resources",
                "hostPath": {"path": "/var/lib/kubelet/pod-resources"}}]
    pod_spec = {
        "containers": [{
            "name": "exporter",
            "image": DCGM_EXPORTER_IMAGE,
            "env": env,
            "securityContext": {"privileged": True},
            "ports": [{"containerPort": DCGM_PORT, "name": "metrics"}],
            "volumeMounts": mounts,
        }],
        "volumes": volumes,
    }
    if cfg.provider == "gke":
        # GKE installs the driver under /home/kubernetes/bin/nvidia on the
        # node; a pod that takes no card mounts it itself
        env.append({"name": "LD_LIBRARY_PATH",
                    "value": "/usr/local/nvidia/lib64"})
        mounts.append({"name": "nvidia-driver", "mountPath": "/usr/local/nvidia"})
        volumes.append({"name": "nvidia-driver",
                        "hostPath": {"path": "/home/kubernetes/bin/nvidia"}})
        pod_spec["nodeSelector"] = {
            "cloud.google.com/gke-accelerator": cfg.accelerator}
        pod_spec["tolerations"] = [{"key": GPU_RESOURCE, "operator": "Exists",
                                    "effect": "NoSchedule"}]
    else:
        # a local cluster's GPU nodes carry NVIDIA's feature-discovery
        # label; a CPU kind node (the smoke) gets no exporter pod
        pod_spec["nodeSelector"] = {"nvidia.com/gpu.present": "true"}
    ds = {
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "metadata": {"name": DCGM_JOB, "namespace": cfg.namespace,
                     "labels": labels},
        "spec": {
            "selector": {"matchLabels": labels},
            "template": {"metadata": {"labels": labels}, "spec": pod_spec},
        },
    }
    svc = {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": DCGM_JOB, "namespace": cfg.namespace,
                     "labels": labels},
        "spec": {"selector": labels,
                 "ports": [{"name": "metrics", "port": DCGM_PORT,
                            "targetPort": DCGM_PORT}]},
    }
    return [ds, svc]


def _dcgm_exporter(cfg: DeployConfig, kube: KubeCtl) -> None:
    kube.apply_manifest(manifests.render(*dcgm_exporter_manifests(cfg)))


# --- collector RBAC (:107-168) --------------------------------------------

def collector_rbac_manifests(cfg: DeployConfig) -> list[dict]:
    sa = {"apiVersion": "v1", "kind": "ServiceAccount",
          "metadata": {"name": "otel-collector",
                       "namespace": cfg.observability_namespace}}
    role = {
        "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
        "metadata": {"name": "otel-collector"},
        "rules": [
            {"apiGroups": [""],
             "resources": ["pods", "namespaces", "nodes", "services",
                           "endpoints", "nodes/proxy", "nodes/metrics",
                           "nodes/stats"],
             "verbs": ["get", "list", "watch"]},
            {"apiGroups": ["apps"],
             "resources": ["replicasets", "deployments", "daemonsets",
                           "statefulsets"],
             "verbs": ["get", "list", "watch"]},
            {"nonResourceURLs": ["/metrics", "/metrics/cadvisor"],
             "verbs": ["get"]},
        ],
    }
    binding = {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRoleBinding",
        "metadata": {"name": "otel-collector"},
        "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                    "kind": "ClusterRole", "name": "otel-collector"},
        "subjects": [{"kind": "ServiceAccount", "name": "otel-collector",
                      "namespace": cfg.observability_namespace}],
    }
    return [sa, role, binding]


def _collector_rbac(cfg: DeployConfig, kube: KubeCtl) -> None:
    kube.apply_manifest(manifests.render(*collector_rbac_manifests(cfg)))


# --- dedicated Prometheus with remote-write receiver (:179-283) -----------

def otel_prometheus_manifests(cfg: DeployConfig) -> list[dict]:
    labels = {"app": "otel-prometheus"}
    dep = {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "otel-prometheus",
                     "namespace": cfg.otel_namespace, "labels": labels},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels},
                "spec": {
                    "containers": [{
                        "name": "prometheus",
                        "image": f"prom/prometheus:{OTEL_PROM_VERSION}",
                        "args": [
                            "--config.file=/etc/prometheus/prometheus.yml",
                            "--storage.tsdb.path=/prometheus",
                            # remote-write receiver is the whole point
                            # (otel-observability-setup.yaml:224-231)
                            "--web.enable-remote-write-receiver",
                            f"--storage.tsdb.retention.time={cfg.otel_prometheus_retention}",
                            f"--storage.tsdb.retention.size={cfg.otel_prometheus_retention_size}",
                        ],
                        "ports": [{"containerPort": 9090, "name": "web"}],
                        "volumeMounts": [
                            {"name": "config",
                             "mountPath": "/etc/prometheus"},
                            {"name": "storage", "mountPath": "/prometheus"},
                        ],
                    }],
                    "volumes": [
                        {"name": "config",
                         "configMap": {"name": "otel-prometheus-config"}},
                        # emptyDir, like the reference (:278-280)
                        {"name": "storage", "emptyDir": {}},
                    ],
                },
            },
        },
    }
    cm = {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "otel-prometheus-config",
                     "namespace": cfg.otel_namespace},
        "data": {"prometheus.yml": _config_text({
            "global": {"scrape_interval": "15s"},
            "scrape_configs": [{
                "job_name": "prometheus",
                "static_configs": [{"targets": ["localhost:9090"]}],
            }],
        })},
    }
    svc = {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "otel-prometheus",
                     "namespace": cfg.otel_namespace, "labels": labels},
        "spec": {"selector": labels,
                 "ports": [{"name": "web", "port": 9090,
                            "targetPort": 9090}]},
    }
    return [cm, dep, svc]


def _otel_prometheus(cfg: DeployConfig, kube: KubeCtl) -> None:
    kube.apply_manifest(manifests.render(*otel_prometheus_manifests(cfg)))


# --- OTEL collector (:297-642) --------------------------------------------

def collector_config(cfg: DeployConfig) -> dict:
    """Collector pipeline config.  Scrape jobs mirror the reference's:
    ``vllm-metrics`` pod SD gated on prometheus.io/scrape in the serving
    namespace (otel-observability-setup.yaml:337-391) — unchanged because
    the engine exports vllm_* names; the DCGM service/pod jobs (:393-468)
    scrape the DCGM exporter; nodes + cadvisor via API-server proxy
    (:471-501); OTLP receiver for traces (:504-509)."""
    interval = f"{cfg.otel_scrape_interval_s}s"
    pod_sd = [{"role": "pod", "namespaces": {"names": [cfg.namespace]}}]
    relabel_scrape_gate = [
        {"source_labels": ["__meta_kubernetes_pod_annotation_prometheus_io_scrape"],
         "action": "keep", "regex": "true"},
        {"source_labels": ["__meta_kubernetes_pod_annotation_prometheus_io_path"],
         "action": "replace", "target_label": "__metrics_path__",
         "regex": "(.+)"},
        {"source_labels": ["__address__",
                           "__meta_kubernetes_pod_annotation_prometheus_io_port"],
         "action": "replace", "regex": r"([^:]+)(?::\d+)?;(\d+)",
         "replacement": "$$1:$$2", "target_label": "__address__"},
        {"source_labels": ["__meta_kubernetes_pod_name"],
         "target_label": "pod"},
        {"source_labels": ["__meta_kubernetes_namespace"],
         "target_label": "namespace"},
    ]
    return {
        "receivers": {
            "prometheus": {"config": {"global": {"scrape_interval": interval},
                                      "scrape_configs": [
                {"job_name": ENGINE_JOB,
                 "kubernetes_sd_configs": pod_sd,
                 "relabel_configs": relabel_scrape_gate},
                {"job_name": DCGM_JOB,
                 "kubernetes_sd_configs": [
                     {"role": "service",
                      "namespaces": {"names": [cfg.namespace]}}],
                 "relabel_configs": [
                     {"source_labels": ["__meta_kubernetes_service_port_name"],
                      "action": "keep", "regex": "metrics"},
                     {"source_labels": ["__meta_kubernetes_service_name"],
                      "action": "keep", "regex": DCGM_JOB},
                 ]},
                {"job_name": f"{DCGM_JOB}-pods",   # backup pod SD (:427-468)
                 "kubernetes_sd_configs": pod_sd,
                 "relabel_configs": [
                     {"source_labels": ["__meta_kubernetes_pod_label_app"],
                      "action": "keep", "regex": DCGM_JOB},
                 ]},
                {"job_name": "kubernetes-nodes",
                 "scheme": "https",
                 "tls_config": {"ca_file": "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt",
                                "insecure_skip_verify": True},
                 "bearer_token_file": "/var/run/secrets/kubernetes.io/serviceaccount/token",
                 "kubernetes_sd_configs": [{"role": "node"}],
                 "relabel_configs": [
                     {"target_label": "__address__",
                      "replacement": "kubernetes.default.svc:443"},
                     {"source_labels": ["__meta_kubernetes_node_name"],
                      "regex": "(.+)", "target_label": "__metrics_path__",
                      "replacement": "/api/v1/nodes/$$1/proxy/metrics"},
                 ]},
                {"job_name": "kubernetes-cadvisor",
                 "scheme": "https",
                 "tls_config": {"ca_file": "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt",
                                "insecure_skip_verify": True},
                 "bearer_token_file": "/var/run/secrets/kubernetes.io/serviceaccount/token",
                 "kubernetes_sd_configs": [{"role": "node"}],
                 "relabel_configs": [
                     {"target_label": "__address__",
                      "replacement": "kubernetes.default.svc:443"},
                     {"source_labels": ["__meta_kubernetes_node_name"],
                      "regex": "(.+)", "target_label": "__metrics_path__",
                      "replacement": "/api/v1/nodes/$$1/proxy/metrics/cadvisor"},
                 ]},
            ]}},
            "otlp": {"protocols": {"grpc": {"endpoint": "0.0.0.0:4317"},
                                   "http": {"endpoint": "0.0.0.0:4318"}}},
        },
        "processors": {
            "memory_limiter": {"check_interval": "1s", "limit_mib": 512,
                               "spike_limit_mib": 128},
            "resource": {"attributes": [
                {"key": "cluster", "value": cfg.cluster_name,
                 "action": "upsert"}]},
            # metricstransform cluster-label injection (:543-554)
            "metricstransform": {"transforms": [{
                "include": ".*", "match_type": "regexp", "action": "update",
                "operations": [{"action": "add_label",
                                "new_label": "k8s_cluster",
                                "new_value": cfg.cluster_name}]}]},
            "k8sattributes": {"auth_type": "serviceAccount",
                              "extract": {"metadata": [
                                  "k8s.pod.name", "k8s.namespace.name",
                                  "k8s.node.name",
                                  "k8s.deployment.name"]}},
            "resourcedetection": {"detectors": ["env", "system"]},
            "batch": {"timeout": "10s", "send_batch_size": 1024},
        },
        "exporters": {
            "prometheusremotewrite": {
                "endpoint": f"http://otel-prometheus.{cfg.otel_namespace}"
                            f".svc.cluster.local:9090/api/v1/write",
                "tls": {"insecure": True}},
            "debug": {"verbosity": "basic"},
        },
        "service": {"pipelines": {
            "metrics": {"receivers": ["prometheus", "otlp"],
                        "processors": ["memory_limiter", "resource",
                                       "metricstransform", "k8sattributes",
                                       "resourcedetection", "batch"],
                        "exporters": ["prometheusremotewrite", "debug"]},
            # traces pipeline only hits debug, like the reference (:633-636)
            "traces": {"receivers": ["otlp"],
                       "processors": ["memory_limiter", "batch"],
                       "exporters": ["debug"]},
        }},
    }


def collector_manifests(cfg: DeployConfig) -> list[dict]:
    """Collector as a plain DaemonSet (mode: daemonset like the reference's
    OpenTelemetryCollector CR, otel-observability-setup.yaml:297-300 — but
    without requiring the OTEL operator + cert-manager install the
    reference needs at :39-105)."""
    labels = {"app": "otel-collector"}
    cm = {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "otel-collector-config",
                     "namespace": cfg.observability_namespace},
        "data": {"collector.yaml": _config_text(collector_config(cfg))},
    }
    ds = {
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "metadata": {"name": "otel-collector",
                     "namespace": cfg.observability_namespace,
                     "labels": labels},
        "spec": {
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels},
                "spec": {
                    "serviceAccountName": "otel-collector",
                    "containers": [{
                        "name": "collector",
                        # contrib image, like :87-91
                        "image": "otel/opentelemetry-collector-contrib:0.96.0",
                        "args": ["--config=/conf/collector.yaml"],
                        "ports": [
                            {"containerPort": 4317, "name": "otlp-grpc"},
                            {"containerPort": 4318, "name": "otlp-http"},
                        ],
                        "volumeMounts": [{"name": "config",
                                          "mountPath": "/conf"}],
                    }],
                    "volumes": [{"name": "config", "configMap": {
                        "name": "otel-collector-config"}}],
                },
            },
        },
    }
    return [cm, ds]


def _collector(cfg: DeployConfig, kube: KubeCtl) -> None:
    kube.apply_manifest(manifests.render(*collector_manifests(cfg)))


# --- Grafana dashboard (closes the reference's Grafana parity gap: its
#     observability playbook prints a query cookbook, :754-775, but ships
#     no dashboard) ---------------------------------------------------------

def grafana_dashboard_manifests(cfg: DeployConfig) -> list[dict]:
    """The generated engine dashboard (dashboard.py — derived from the
    port's metric registry) as a ConfigMap labelled
    ``grafana_dashboard: "1"``: the Grafana sidecar shipped by the
    kube-prometheus-stack the cluster layer installs imports every
    ConfigMap carrying that label."""
    from tpuserve_torch.provision.dashboard import render as render_dashboard
    return [{
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "tpuserve-grafana-dashboard",
                     "namespace": cfg.monitoring_namespace,
                     "labels": {"grafana_dashboard": "1",
                                "app": "tpuserve"}},
        "data": {"tpuserve-engine.json": render_dashboard()},
    }]


def _grafana_dashboard(cfg: DeployConfig, kube: KubeCtl) -> None:
    objs = grafana_dashboard_manifests(cfg)
    kube.apply_manifest(manifests.render(
        {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": cfg.monitoring_namespace}}, *objs))


def alerting_manifests(cfg: DeployConfig) -> list[dict]:
    """SLO burn-rate alert rules + Alertmanager routing, generated from
    the port's objectives + metrics registries (alerts.py).  The
    PrometheusRule carries the kube-prometheus-stack's release label so
    the stack's default rule selector adopts it; the Alertmanager config
    ships as a ConfigMap for the operator to point their Alertmanager at
    (receiver webhooks are placeholders by design)."""
    from tpuserve_torch.provision.alerts import (alertmanager_config,
                                                 prometheus_rule)
    am = {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "tpuserve-alertmanager-config",
                     "namespace": cfg.monitoring_namespace,
                     "labels": {"app": "tpuserve"}},
        "data": {"alertmanager.yaml": _config_text(
            alertmanager_config(), sort_keys=True)},
    }
    return [prometheus_rule(namespace=cfg.monitoring_namespace), am]


def _alerting(cfg: DeployConfig, kube: KubeCtl) -> None:
    objs = alerting_manifests(cfg)
    kube.apply_manifest(manifests.render(
        {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": cfg.monitoring_namespace}}, *objs))


def _wait_ready(cfg: DeployConfig, kube: KubeCtl) -> None:
    """Pod readiness waits with soft failure (otel-observability-setup.yaml:
    644-673 uses ignore_errors-style waits)."""
    for ns, selector in ((cfg.otel_namespace, "app=otel-prometheus"),
                         (cfg.observability_namespace, "app=otel-collector")):
        res = kube.kubectl("wait", "--for=condition=Ready", "pods",
                           "-l", selector, "-n", ns, "--timeout=300s",
                           check=False, timeout=360.0)
        if not res.ok:
            logger.warning("pods %s in %s not Ready (continuing): %s",
                           selector, ns, res.stderr.strip()[:300])


# --- verification (:699-781) ----------------------------------------------

def _query_has_data(out: str) -> bool:
    """True iff the Prometheus API response succeeded AND carries data —
    handles both /query responses ({"data":{"result":[...]}}) and
    /label/.../values responses ({"data":[...]})."""
    import json as _json
    try:
        payload = _json.loads(out)
    except ValueError:
        return False
    if payload.get("status") != "success":
        return False
    data = payload.get("data")
    if isinstance(data, dict):
        return bool(data.get("result"))
    return bool(data)


VERIFY_QUERIES = [
    # (description, PromQL / API path, soft-failure hint)
    ("cluster label present", "/api/v1/label/k8s_cluster/values",
     "normal if no metrics have flowed yet"),
    ("engine request metric", "/api/v1/query?query=vllm_request_total",
     "normal if no requests have been served yet"),   # :728 analog
    # URL-quoted: curl would read the selector's braces as a glob
    ("GPU utilization metric",
     "/api/v1/query?query=" + quote(f'DCGM_FI_DEV_GPU_UTIL{{job="{DCGM_JOB}"}}'),
     "normal if the DCGM exporter just started"),     # :758-761
]


def verify(cfg: DeployConfig, kube: KubeCtl, fetch=None) -> dict[str, bool]:
    """Port-forward otel-prometheus and curl the label/query API, printing
    'this is normal if…' soft-failure messages like the reference
    (otel-observability-setup.yaml:730-743).  ``fetch(path) -> str`` may be
    injected for tests; default uses an in-cluster curl pod."""
    results: dict[str, bool] = {}
    if fetch is None and kube.runner.dry_run:
        logger.info("dry-run: skipping observability verification")
        return results
    base = (f"http://otel-prometheus.{cfg.otel_namespace}"
            f".svc.cluster.local:9090")
    for desc, path, hint in VERIFY_QUERIES:
        try:
            if fetch is not None:
                out = fetch(path)
            else:
                res = kube.kubectl(
                    "run", f"curl-verify-{abs(hash(path)) % 10**6:06d}",
                    "-n", cfg.otel_namespace, "--rm", "-i",
                    "--restart=Never", "--image=curlimages/curl", "--",
                    "curl", "-s", "--max-time", "15", f"{base}{path}",
                    check=False, timeout=90.0)
                out = res.stdout
            ok = _query_has_data(out)
            results[desc] = ok
            if ok:
                logger.info("verify OK: %s", desc)
            else:
                logger.info("verify MISSING: %s — %s", desc, hint)
        except Exception as e:
            results[desc] = False
            logger.info("verify ERROR: %s (%s) — %s", desc, e, hint)
    # Grafana query cookbook print (:754-775 analog)
    logger.info(
        "Grafana queries:\n"
        "  rate(vllm_request_total[5m])           # request rate\n"
        "  vllm_active_requests                    # in-flight requests\n"
        "  histogram_quantile(0.5, rate(vllm_time_to_first_token_seconds_bucket[5m]))\n"
        f'  DCGM_FI_DEV_GPU_UTIL{{job="{DCGM_JOB}"}}   # GPU utilization\n'
        f'  DCGM_FI_DEV_FB_USED{{job="{DCGM_JOB}"}}    # frame buffer MiB used')
    return results


def _config_text(obj, sort_keys: bool = True) -> str:
    """A config file for a ConfigMap, as JSON: JSON is YAML, which
    Prometheus, the collector and Alertmanager read, and the builders need
    no PyYAML."""
    return json.dumps(obj, indent=2, sort_keys=sort_keys) + "\n"
