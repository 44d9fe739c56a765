"""Kubernetes manifest builders for the serving + storage + test layers.

The port of ``tpuserve/provision/manifests.py``: the same objects, names,
labels, Services, probes and drain/grace coupling (so the port's gateway
and ``KubePool`` find the Deployments they patch), running the port's
modules on GKE H100 nodes: the engine asks for ``nvidia.com/gpu`` from
GKE's device plugin, selects ``cloud.google.com/gke-accelerator`` nodes
and tolerates their ``nvidia.com/gpu`` taint; on provider=local it runs
``--device cpu``.  The builders return dicts; only :func:`render` needs
PyYAML.

The reference embeds raw YAML manifests inside playbook strings
(PVCs kubernetes-single-node.yaml:375-401, model PVC llm-d-deploy.yaml:
195-215, chat-template ConfigMaps templates/*.yaml, test pods
llm-d-test.yaml:32-78).  Here they are built as Python dicts from the one
shared DeployConfig and rendered with yaml — no duplicated literals.
"""

from __future__ import annotations

from typing import Optional

from tpuserve_torch.provision.config import DeployConfig
from tpuserve_torch.provision.validate import GPU_RESOURCE

#: the port the multihost replicas' torchrun rendezvous on (ordinal 0)
MULTIHOST_MASTER_PORT = 29500


def render(*objs: dict) -> str:
    """Serialize manifests for kubectl apply — after pushing each through
    the vendored strict schemas (provision/validate.py), so an invalid
    manifest fails HERE with a readable error instead of at the API
    server (or worse, passes a lenient server and misbehaves)."""
    import yaml
    from tpuserve_torch.provision.validate import validate_manifest
    objs = [o for o in objs if o]
    for o in objs:
        validate_manifest(o)
    return yaml.safe_dump_all(objs, sort_keys=False)


def namespace(name: str) -> dict:
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name}}


# --- storage (kubernetes-single-node.yaml:360-401 analog) -----------------

def _pvc(cfg: DeployConfig, name: str, size: str) -> dict:
    return {
        "apiVersion": "v1", "kind": "PersistentVolumeClaim",
        "metadata": {"name": name, "namespace": cfg.namespace},
        "spec": {
            "accessModes": ["ReadWriteOnce"],
            "storageClassName": cfg.storage_class,
            "resources": {"requests": {"storage": size}},
        },
    }


def storage_pvcs(cfg: DeployConfig) -> list[dict]:
    """General model-storage PVCs created at the cluster layer
    (kubernetes-single-node.yaml:385-400).  Sized by ``storage_size``
    when set; unset tracks ``model_pvc_size``, which is what every
    pre-existing cluster was provisioned with — K8s PVC requests can
    only grow, so the fallback keeps re-provisioning idempotent."""
    size = cfg.storage_size or cfg.model_pvc_size
    return [_pvc(cfg, "model-storage-1", size),
            _pvc(cfg, "model-storage-2", size)]


def model_pvc(cfg: DeployConfig) -> dict:
    """The PVC the serving workloads actually mount — the reference adds it
    as a deploy-layer workaround (llm-d-deploy.yaml:195-215)."""
    return _pvc(cfg, "model-pvc", cfg.model_pvc_size)


def hf_token_secret(cfg: DeployConfig, token: str) -> dict:
    """HF token as a Secret — the reference slurps ~/.cache/huggingface/token
    on the control host and passes it via env (llm-d-deploy.yaml:117-132,
    187-189)."""
    return {
        "apiVersion": "v1", "kind": "Secret",
        "metadata": {"name": "hf-token", "namespace": cfg.namespace},
        "type": "Opaque",
        "stringData": {"token": token},
    }


# --- chat templates (templates/phi-chat-template.yaml:1-25,
#     templates/opt-chat-template.yaml:1-25 analog) ------------------------

PHI_CHAT_TEMPLATE = """\
{% for message in messages %}{% if message['role'] == 'system' %}<|system|>
{{ message['content'] }}<|end|>
{% elif message['role'] == 'user' %}<|user|>
{{ message['content'] }}<|end|>
{% elif message['role'] == 'assistant' %}<|assistant|>
{{ message['content'] }}<|end|>
{% endif %}{% endfor %}{% if add_generation_prompt %}<|assistant|>
{% endif %}"""

OPT_CHAT_TEMPLATE = """\
{% if messages and messages[0]['role'] == 'system' %}{{ messages[0]['content'] }}

{% set messages = messages[1:] %}{% endif %}{% for message in messages %}\
{% if message['role'] == 'user' %}Human: {{ message['content'] }}
{% elif message['role'] == 'assistant' %}Assistant: {{ message['content'] }}
{% endif %}{% endfor %}{% if add_generation_prompt %}Assistant:{% endif %}"""

CHAT_TEMPLATES = {"phi": PHI_CHAT_TEMPLATE, "opt": OPT_CHAT_TEMPLATE}


def chat_template_configmap(cfg: DeployConfig, name: str) -> dict:
    """ConfigMap `<name>-chat-template` holding template.jinja, for models
    that ship without one — same mechanism as the reference's manual
    kubectl-apply assets (templates/*.yaml; SURVEY.md §2.1 item 8)."""
    return {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": f"{name}-chat-template",
                     "namespace": cfg.namespace},
        "data": {"template.jinja": CHAT_TEMPLATES[name]},
    }


# --- serving workloads (llm-d-deploy.yaml:140-193 replacement: the engine
#     is in-repo, not a cloned installer) ----------------------------------

def model_download_job(cfg: DeployConfig) -> dict:
    """Weight-fetch Job (`--download-model` analog, llm-d-deploy.yaml:184):
    downloads the HF checkpoint onto model-pvc before the engine starts."""
    return {
        "apiVersion": "batch/v1", "kind": "Job",
        "metadata": {"name": "model-download", "namespace": cfg.namespace},
        "spec": {
            "backoffLimit": 3,
            "template": {
                "spec": {
                    "restartPolicy": "OnFailure",
                    "containers": [{
                        "name": "download",
                        "image": cfg.image,
                        "command": ["python", "-m", "tpuserve_torch.models.download",
                                    "--model", cfg.model,
                                    "--out", "/models"],
                        "env": [{"name": "HF_TOKEN", "valueFrom": {
                            "secretKeyRef": {"name": "hf-token",
                                             "key": "token",
                                             "optional": True}}}],
                        "volumeMounts": [{"name": "models",
                                          "mountPath": "/models"}],
                    }],
                    "volumes": [{"name": "models", "persistentVolumeClaim": {
                        "claimName": "model-pvc"}}],
                },
            },
        },
    }


def _engine_container(cfg: DeployConfig, *, role: Optional[str] = None,
                      extra_args: Optional[list[str]] = None) -> dict:
    args = ["python", "-m", "tpuserve_torch.server",
            "--model", cfg.model,
            "--checkpoint-dir", f"/models/{cfg.model}",
            "--port", str(cfg.engine_port)]
    if cfg.provider != "gke":
        # the CPU smoke: the engine runs the kernels' plain versions
        args += ["--device", "cpu"]
    if cfg.pipeline_parallel > 1:
        # pp replica: cards become pipeline stages (layers + KV pages
        # split by stage) instead of tensor ranks
        args += ["--pp", str(cfg.pipeline_parallel)]
    else:
        args += ["--tp", str(cfg.tensor_parallel)]
    if cfg.quantization:
        args += ["--quantization", cfg.quantization]
    if cfg.kv_cache_dtype != "bfloat16":
        args += ["--kv-cache-dtype", cfg.kv_cache_dtype]
    if cfg.speculative_k:
        args += ["--speculative-k", str(cfg.speculative_k)]
    if cfg.multi_step is not None:
        args += ["--multi-step", str(cfg.multi_step)]
    if cfg.lora_modules:
        args += ["--lora-modules"] + [f"{name}={path}" for name, path
                                      in cfg.lora_modules.items()]
    if not cfg.kv_tiers:
        args += ["--no-kv-tiers"]
    elif cfg.kv_spill_dir:
        # spill tier on the model PVC (mounted at /models): demoted
        # prefixes survive pod restarts
        args += ["--kv-spill-dir", cfg.kv_spill_dir]
    if cfg.kv_tiers and cfg.kv_host_bytes:
        args += ["--kv-host-bytes", str(cfg.kv_host_bytes)]
    if cfg.max_waiting:
        args += ["--max-waiting", str(cfg.max_waiting)]
    if not cfg.slo_classes:
        args += ["--no-slo-classes"]
    if cfg.step_watchdog_s:
        # hang watchdog: fail+salvage a wedged dispatch instead of waiting
        # for the liveness probe to kill the whole pod (which loses every
        # stream the salvage path exists to save)
        args += ["--step-watchdog-s", str(cfg.step_watchdog_s)]
    # always emitted: the config value and the pod's grace period are
    # derived together — relying on the server's CLI default here would
    # let the two skew if that default ever moves
    args += ["--drain-timeout", str(cfg.drain_timeout_s)]
    args += extra_args or []
    gpu_req = {GPU_RESOURCE: str(cfg.gpus_per_replica)} \
        if cfg.provider == "gke" else {}
    # No compile-cache directory on the PVC (the JAX engine's
    # JAX_COMPILATION_CACHE_DIR): the image carries the kernels nvcc built
    # at image build, and the step graphs are captured in process memory
    # at warmup, where no cache could hold them.
    env = [{"name": "HF_TOKEN", "valueFrom": {"secretKeyRef": {
        "name": "hf-token", "key": "token", "optional": True}}},
           # Persistent grammar-FSM compile cache on the same PVC
           # (runtime/grammar/cache.py): a production-vocab guided spec
           # compiles once per fleet; every later pod/request loads the
           # .npz tables instead of walking 151k token texts inline.
           {"name": "TPUSERVE_FSM_CACHE_DIR",
            "value": "/models/.fsm-cache"}]
    if not cfg.slo_burn:
        # kill switch for the in-process burn-rate evaluator (the env
        # twin of --no-slo-burn; default on)
        env.append({"name": "TPUSERVE_SLO_BURN", "value": "0"})
    if not cfg.flight:
        # kill switch for the engine flight recorder (the --recorder-ab
        # measured-overhead lever; default on)
        env.append({"name": "TPUSERVE_FLIGHT", "value": "0"})
    elif cfg.flight_dir:
        # post-mortem bundles (watchdog trips, fault storms, poison
        # isolation) land on the model PVC and survive the pod
        env.append({"name": "TPUSERVE_FLIGHT_DIR",
                    "value": cfg.flight_dir})
    if not cfg.devprof:
        # kill switch for device telemetry (runtime/devprof.py; the
        # bench.py --devprof measured-overhead lever; default on —
        # profiler traces share flight_dir with the bundles)
        env.append({"name": "TPUSERVE_DEVPROF", "value": "0"})
    if cfg.faults:
        # chaos drill: arm the engine's deterministic fault-injection
        # layer (runtime/faults.py) so recovery claims are verified
        # in-cluster under seeded chaos, not just in unit tests
        env.append({"name": "TPUSERVE_FAULTS", "value": cfg.faults})
    if cfg.tenants is not None:
        # per-tenant metering + rate limits (server/tenants.py);
        # validated at deploy time by DeployConfig like the chaos spec
        import json as _json
        env.append({"name": "TPUSERVE_TENANTS",
                    "value": _json.dumps(cfg.tenants, sort_keys=True)})
    if cfg.model_catalog:
        # model pool (tpuserve_torch/modelpool): the replica's catalog, as
        # a canonical JSON object (deploy-time validated like faults/
        # tenants).  Weight spill rides the model PVC so demoted param
        # sets survive pod restarts.
        import json as _json
        from tpuserve_torch.modelpool.pool import parse_catalog
        env.append({"name": "TPUSERVE_MODEL_CATALOG",
                    "value": _json.dumps(
                        parse_catalog(cfg.model_catalog),
                        sort_keys=True)})
        env.append({"name": "TPUSERVE_WEIGHT_SPILL_DIR",
                    "value": "/models/.weight-spill"})
        if cfg.weight_host_bytes:
            env.append({"name": "TPUSERVE_WEIGHT_HOST_BYTES",
                        "value": str(cfg.weight_host_bytes)})
    if cfg.chat_template:
        args += ["--chat-template", "/chat-template/template.jinja"]
    container = {
        "name": role or "engine",
        "image": cfg.image,
        "command": args,
        # preStop sleep: K8s removes the pod from Service endpoints
        # concurrently with termination; holding SIGTERM for a few
        # seconds lets that propagate so new requests stop ARRIVING
        # before the drain starts 503ing them (no client-visible errors
        # on a routine rollout)
        "lifecycle": {"preStop": {"exec": {
            "command": ["sleep", "5"]}}},
        "ports": [{"containerPort": cfg.engine_port, "name": "http"}],
        "env": env,
        "resources": {"limits": dict(gpu_req)} if gpu_req else {},
        # Probes — the reference has none in-repo (delegated to llm-d
        # charts, SURVEY.md §5 failure-detection note); here they are
        # first-class.
        "readinessProbe": {"httpGet": {"path": "/readyz", "port": "http"},
                           "initialDelaySeconds": 10, "periodSeconds": 5},
        "livenessProbe": {"httpGet": {"path": "/healthz", "port": "http"},
                          "initialDelaySeconds": 60, "periodSeconds": 10},
        "volumeMounts": [{"name": "models", "mountPath": "/models"}],
    }
    if cfg.chat_template:
        container["volumeMounts"].append(
            {"name": "chat-template", "mountPath": "/chat-template"})
    return container


def engine_deployment(cfg: DeployConfig, *, role: Optional[str] = None,
                      replicas: Optional[int] = None,
                      extra_args: Optional[list[str]] = None) -> dict:
    """Engine Deployment.  Pods carry the prometheus.io/scrape annotations
    the OTEL collector's pod-SD job gates on
    (otel-observability-setup.yaml:337-391)."""
    name = f"tpuserve-{role}" if role else "tpuserve-engine"
    labels = {"app": "tpuserve", "component": role or "engine"}
    volumes = [{"name": "models",
                "persistentVolumeClaim": {"claimName": "model-pvc"}}]
    if cfg.chat_template:
        volumes.append({"name": "chat-template", "configMap": {
            "name": f"{cfg.chat_template}-chat-template"}})
    spec = {
        "replicas": replicas if replicas is not None else cfg.replicas,
        "selector": {"matchLabels": labels},
        "template": {
            "metadata": {
                "labels": labels,
                "annotations": {
                    "prometheus.io/scrape": "true",
                    "prometheus.io/port": str(cfg.engine_port),
                    "prometheus.io/path": "/metrics",
                },
            },
            "spec": {
                "containers": [_engine_container(cfg, role=role,
                                                 extra_args=extra_args)],
                "volumes": volumes,
                # rolling updates: the server drains on SIGTERM (readyz
                # flips, in-flight streams finish) inside
                # drain_timeout_s; the grace period is DERIVED from it
                # (+ the 5 s preStop + 35 s headroom) so K8s never
                # SIGKILLs mid-drain
                "terminationGracePeriodSeconds": cfg.drain_timeout_s + 40,
            },
        },
    }
    if cfg.provider == "gke":
        spec["template"]["spec"].update(_gpu_placement(cfg))
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": cfg.namespace,
                         "labels": labels},
            "spec": spec}


def _gpu_placement(cfg: DeployConfig) -> dict:
    """GKE places GPU pods by the node pool's accelerator label and taints
    GPU nodes ``nvidia.com/gpu=present:NoSchedule``, which the pods
    tolerate."""
    return {"nodeSelector": {"cloud.google.com/gke-accelerator": cfg.accelerator},
            "tolerations": [{"key": GPU_RESOURCE, "operator": "Exists",
                             "effect": "NoSchedule"}]}


def engine_service(cfg: DeployConfig, *, role: Optional[str] = None) -> dict:
    name = f"tpuserve-{role}" if role else "tpuserve-engine"
    return {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": name, "namespace": cfg.namespace,
                     "labels": {"app": "tpuserve"}},
        "spec": {
            "selector": {"app": "tpuserve", "component": role or "engine"},
            "ports": [{"name": "http", "port": cfg.engine_port,
                       "targetPort": cfg.engine_port}],
        },
    }


def multihost_headless_service(cfg: DeployConfig, replica_idx: int) -> dict:
    """Headless Service giving each replica's pods a stable DNS name (the
    torchrun master address is pod ordinal 0)."""
    name = f"tpuserve-mh-{replica_idx}"
    return {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": name, "namespace": cfg.namespace,
                     "labels": {"app": "tpuserve"}},
        "spec": {
            "clusterIP": "None",
            # followers never pass an HTTP readiness probe; DNS must still
            # resolve so the ranks can rendezvous
            "publishNotReadyAddresses": True,
            "selector": {"app": "tpuserve", "component": name},
            "ports": [{"name": "http", "port": cfg.engine_port}],
        },
    }


def multihost_command(cfg: DeployConfig, replica_idx: int, hosts: int,
                      engine_args: list[str]) -> list[str]:
    """torchrun around the engine command: ``--nproc-per-node`` ranks a pod
    (one a card: each takes ``LOCAL_RANK``'s card), the node rank from the
    pod's ordinal (``$(POD_INDEX)``, which the kubelet expands from the
    env), the master at ordinal 0's headless-Service name.  ``--multihost``
    reads torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``; global rank 0 serves HTTP, every other rank follows
    its steps (parallel/multihost.py)."""
    name = f"tpuserve-mh-{replica_idx}"
    master = f"{name}-0.{name}.{cfg.namespace}.svc.cluster.local"
    return (["python", "-m", "torch.distributed.run",
             "--nnodes", str(hosts),
             "--nproc-per-node", str(cfg.gpus_per_node),
             "--node-rank", "$(POD_INDEX)",
             "--master-addr", master,
             "--master-port", str(MULTIHOST_MASTER_PORT)]
            + ["-m"] + engine_args[2:])


def multihost_engine_statefulset(cfg: DeployConfig, replica_idx: int) -> dict:
    """One serving replica spanning several GPU nodes (the JAX preset
    "Qwen2-72B TP=8 multi-host"): a StatefulSet with one pod a node, each
    running :func:`multihost_command`'s torchrun with ``--multihost``.
    """
    name = f"tpuserve-mh-{replica_idx}"
    hosts = -(-cfg.tensor_parallel // cfg.gpus_per_node)
    labels = {"app": "tpuserve", "component": name}
    container = _engine_container(
        cfg, role="engine", extra_args=["--multihost"])
    container["command"] = multihost_command(cfg, replica_idx, hosts,
                                             container["command"])
    # the pod's ordinal is torchrun's node rank
    container["env"].append({"name": "POD_INDEX", "valueFrom": {"fieldRef": {
        "fieldPath": "metadata.labels['apps.kubernetes.io/pod-index']"}}})
    # per-pod GPU request is one NODE's cards, not the whole replica
    if cfg.provider == "gke":
        container["resources"] = {"limits": {GPU_RESOURCE:
                                             str(cfg.gpus_per_node)}}
    # only ordinal 0 answers HTTP; followers would fail HTTP probes forever
    container.pop("readinessProbe", None)
    container.pop("livenessProbe", None)
    volumes = [{"name": "models",
                "persistentVolumeClaim": {"claimName": "model-pvc"}}]
    if cfg.chat_template:
        volumes.append({"name": "chat-template", "configMap": {
            "name": f"{cfg.chat_template}-chat-template"}})
    pod_spec = {"containers": [container], "volumes": volumes,
                "subdomain": name}
    if cfg.provider == "gke":
        pod_spec.update(_gpu_placement(cfg))
    return {
        "apiVersion": "apps/v1", "kind": "StatefulSet",
        "metadata": {"name": name, "namespace": cfg.namespace,
                     "labels": labels},
        "spec": {
            "serviceName": name,
            "replicas": hosts,
            "podManagementPolicy": "Parallel",   # all hosts must rendezvous
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels, "annotations": {
                    "prometheus.io/scrape": "true",
                    "prometheus.io/port": str(cfg.engine_port),
                    "prometheus.io/path": "/metrics"}},
                "spec": pod_spec,
            },
        },
    }


def gateway_deployment(cfg: DeployConfig, backends: list[str],
                       backends_url: Optional[str] = None) -> dict:
    """Gateway Deployment — replaces the llm-d inference gateway the
    reference discovers at llm-d-test.yaml:14-26.  ``backends_url``
    (autoscaled topologies): a poll-able source of the live backend
    set — the static ``--backend`` list is just the bootstrap, replaced
    by the first successful poll, so the gateway tracks scale events
    (including down to an EMPTY pool, where it starts counting the
    unserved demand the scaler's from-zero trigger reads)."""
    labels = {"app": "tpuserve", "component": "gateway"}
    args = ["python", "-m", "tpuserve_torch.server.gateway",
            "--port", str(cfg.gateway_port)]
    for b in backends:
        args += ["--backend", b]
    if backends_url:
        args += ["--backends-url", backends_url]
    if cfg.canary_interval_s > 0:
        # embedded black-box prober (tpuserve_torch/obs/canary.py): tagged
        # probes through the gateway's own relay path; the scrape
        # annotations below pick up its tpuserve_canary_* families
        args += ["--canary-interval", str(cfg.canary_interval_s)]
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "tpuserve-gateway", "namespace": cfg.namespace,
                     "labels": labels},
        "spec": {
            "replicas": cfg.gateway_replicas,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels, "annotations": {
                    "prometheus.io/scrape": "true",
                    "prometheus.io/port": str(cfg.gateway_port),
                    "prometheus.io/path": "/metrics"}},
                "spec": {"containers": [{
                    "name": "gateway",
                    "image": cfg.image,
                    "command": args,
                    "ports": [{"containerPort": cfg.gateway_port,
                               "name": "http"}],
                    "readinessProbe": {
                        "httpGet": {"path": "/healthz", "port": "http"},
                        "initialDelaySeconds": 2, "periodSeconds": 5},
                }]},
            },
        },
    }


def gateway_api_manifests(cfg: DeployConfig) -> list[dict]:
    """Optional Gateway API front (gateway.networking.k8s.io/v1): the
    llm-d stack fronts serving with a Gateway the smoke tests discover
    FIRST (reference: llm-d-test.yaml:14-18).  Applied only when the
    cluster has the Gateway API CRDs (provision/serving.py soft-applies,
    like the ServiceMonitor); traffic routes to the tpuserve-gateway
    Service, which load-balances the HA gateway replicas."""
    return [
        {
            "apiVersion": "gateway.networking.k8s.io/v1", "kind": "Gateway",
            "metadata": {"name": "tpuserve", "namespace": cfg.namespace,
                         "labels": {"app": "tpuserve"}},
            "spec": {
                "gatewayClassName": cfg.gateway_class,
                "listeners": [{"name": "http", "port": 80,
                               "protocol": "HTTP"}],
            },
        },
        {
            "apiVersion": "gateway.networking.k8s.io/v1",
            "kind": "HTTPRoute",
            "metadata": {"name": "tpuserve-routes",
                         "namespace": cfg.namespace,
                         "labels": {"app": "tpuserve"}},
            "spec": {
                "parentRefs": [{"name": "tpuserve"}],
                "rules": [{
                    "matches": [{"path": {"type": "PathPrefix",
                                          "value": "/"}}],
                    "backendRefs": [{"name": "tpuserve-gateway",
                                     "port": 80}],
                }],
            },
        },
    ]


def gateway_service(cfg: DeployConfig) -> dict:
    return {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "tpuserve-gateway", "namespace": cfg.namespace,
                     "labels": {"app": "tpuserve"}},
        "spec": {
            "type": "LoadBalancer" if cfg.provider == "gke" else "ClusterIP",
            "selector": {"app": "tpuserve", "component": "gateway"},
            "ports": [{"name": "http", "port": 80,
                       "targetPort": cfg.gateway_port}],
        },
    }


def autoscaler_rbac(cfg: DeployConfig) -> list[dict]:
    """ServiceAccount + Role + RoleBinding for the scaler Deployment:
    it lists engine pods (signal scrape targets) and scales the engine
    Deployment — nothing else (least privilege; the reference has no
    control plane to authorize at all)."""
    labels = {"app": "tpuserve", "component": "autoscaler"}
    return [
        {"apiVersion": "v1", "kind": "ServiceAccount",
         "metadata": {"name": "tpuserve-autoscaler",
                      "namespace": cfg.namespace, "labels": labels}},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role",
         "metadata": {"name": "tpuserve-autoscaler",
                      "namespace": cfg.namespace, "labels": labels},
         "rules": [
             {"apiGroups": [""], "resources": ["pods"],
              "verbs": ["get", "list", "watch"]},
             {"apiGroups": ["apps"], "resources": ["deployments",
                                                   "deployments/scale"],
              "verbs": ["get", "patch", "update"]},
         ]},
        {"apiVersion": "rbac.authorization.k8s.io/v1",
         "kind": "RoleBinding",
         "metadata": {"name": "tpuserve-autoscaler",
                      "namespace": cfg.namespace, "labels": labels},
         "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                     "kind": "Role", "name": "tpuserve-autoscaler"},
         "subjects": [{"kind": "ServiceAccount",
                       "name": "tpuserve-autoscaler",
                       "namespace": cfg.namespace}]},
    ]


AUTOSCALER_PORT = 9090


def autoscaler_service(cfg: DeployConfig) -> dict:
    """ClusterIP for the scaler: the gateway polls its /backends
    endpoint (live ready-replica list) and Prometheus can scrape
    /metrics through a stable name."""
    return {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "tpuserve-autoscaler",
                     "namespace": cfg.namespace,
                     "labels": {"app": "tpuserve"}},
        "spec": {
            "selector": {"app": "tpuserve", "component": "autoscaler"},
            "ports": [{"name": "http", "port": AUTOSCALER_PORT,
                       "targetPort": AUTOSCALER_PORT}],
        },
    }


def autoscaler_deployment(cfg: DeployConfig) -> dict:
    """The scaler Deployment (tpuserve_torch/autoscale): scrapes engine
    pods' /debug/engine scalars, drives `kubectl scale` on the engine
    Deployment, and serves its own /metrics with the
    tpuserve_autoscaler_* families + the cold-start histogram."""
    labels = {"app": "tpuserve", "component": "autoscaler"}
    metrics_port = AUTOSCALER_PORT
    args = ["python", "-m", "tpuserve_torch.autoscale",
            "--namespace", cfg.namespace,
            "--deployment", "tpuserve-engine",
            "--selector", "app=tpuserve,component=engine",
            "--engine-port", str(cfg.engine_port),
            "--gateway-url",
            f"http://tpuserve-gateway.{cfg.namespace}.svc.cluster.local",
            "--interval", str(cfg.autoscale_interval_s),
            "--min-replicas", str(cfg.autoscale_min_replicas),
            "--max-replicas", str(cfg.autoscale_max_replicas),
            "--port", str(metrics_port)]
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "tpuserve-autoscaler",
                     "namespace": cfg.namespace, "labels": labels},
        "spec": {
            # exactly ONE scaler: the policy is stateful (cooldowns,
            # idle timers) and two would fight over the replica count
            "replicas": 1,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels, "annotations": {
                    "prometheus.io/scrape": "true",
                    "prometheus.io/port": str(metrics_port),
                    "prometheus.io/path": "/metrics"}},
                "spec": {
                    "serviceAccountName": "tpuserve-autoscaler",
                    "containers": [{
                        "name": "autoscaler",
                        "image": cfg.image,
                        "command": args,
                        "ports": [{"containerPort": metrics_port,
                                   "name": "http"}],
                        "readinessProbe": {
                            "httpGet": {"path": "/healthz",
                                        "port": "http"},
                            "initialDelaySeconds": 2,
                            "periodSeconds": 5},
                    }],
                },
            },
        },
    }


def serving_manifests(cfg: DeployConfig) -> list[dict]:
    """Everything the serving layer applies, in order."""
    objs: list[dict] = [namespace(cfg.namespace), model_pvc(cfg)]
    for name in CHAT_TEMPLATES:
        objs.append(chat_template_configmap(cfg, name))
    objs.append(model_download_job(cfg))
    if cfg.multihost:
        # TP spans nodes: one StatefulSet per replica, gateway routes to
        # each replica's rank-0 pod (ordinal 0).
        backends = []
        for r in range(cfg.replicas):
            objs.append(multihost_headless_service(cfg, r))
            objs.append(multihost_engine_statefulset(cfg, r))
            backends.append(
                f"http://tpuserve-mh-{r}-0.tpuserve-mh-{r}."
                f"{cfg.namespace}.svc.cluster.local:{cfg.engine_port}")
        objs.append(gateway_deployment(cfg, backends))
        objs.append(gateway_service(cfg))
        return objs
    if cfg.disaggregated and cfg.disagg_cross_pod:
        # Cross-pod disaggregation: SEPARATE prefill and decode pools,
        # independently scalable (llm-d's actual deployment shape,
        # llm-d-deploy.yaml:147-151).  Completions hit the prefill pool;
        # each sequence's KV migrates to the decode pool over the pod
        # network via /internal/migrate (parallel/disagg_net.py), and the
        # decode pod streams tokens back through the same connection.
        decode_url = (f"http://tpuserve-decode.{cfg.namespace}"
                      f".svc.cluster.local:{cfg.engine_port}")
        objs.append(engine_deployment(
            cfg, role="decode", replicas=cfg.decode_replicas,
            extra_args=["--role", "decode"]))
        objs.append(engine_service(cfg, role="decode"))
        objs.append(engine_deployment(
            cfg, role="prefill", replicas=cfg.prefill_replicas,
            extra_args=["--role", "prefill", "--decode-url", decode_url]))
        objs.append(engine_service(cfg, role="prefill"))
        backends = [f"http://tpuserve-prefill.{cfg.namespace}"
                    f".svc.cluster.local:{cfg.engine_port}"]
    elif cfg.disaggregated:
        # Disaggregated prefill/decode (llm-d's headline topology, SURVEY.md
        # §2.2).  Default form: each pod runs BOTH engines in-process with
        # the KV pages copied on the card (parallel/disagg.py); set
        # disagg_cross_pod for independent pool scaling at the cost of a
        # network KV hop.
        objs.append(engine_deployment(cfg, role="disagg",
                                      extra_args=["--disagg"]))
        objs.append(engine_service(cfg, role="disagg"))
        backends = [f"http://tpuserve-disagg.{cfg.namespace}.svc.cluster.local:{cfg.engine_port}"]
    else:
        objs.append(engine_deployment(cfg))
        objs.append(engine_service(cfg))
        backends = [f"http://tpuserve-engine.{cfg.namespace}.svc.cluster.local:{cfg.engine_port}"]
        backends_url = None
        if cfg.autoscale:
            # the scaler rides only the plain single-Deployment
            # topology (DeployConfig.validate enforces it); the gateway
            # polls the scaler's live replica list so scale events —
            # including scale-to-zero, whose unserved counter closes
            # the from-zero loop — reach routing without a restart
            objs.extend(autoscaler_rbac(cfg))
            objs.append(autoscaler_deployment(cfg))
            objs.append(autoscaler_service(cfg))
            backends_url = (f"http://tpuserve-autoscaler.{cfg.namespace}"
                            f".svc.cluster.local:{AUTOSCALER_PORT}"
                            "/backends")
        objs.append(gateway_deployment(cfg, backends,
                                       backends_url=backends_url))
        objs.append(gateway_service(cfg))
        return objs
    objs.append(gateway_deployment(cfg, backends))
    objs.append(gateway_service(cfg))
    return objs
