"""One shared deploy config for the whole pipeline.

The port of ``tpuserve/provision/config.py``: every layer reads the same
``DeployConfig``, loadable from a YAML file with ``TPUSERVE_*`` env-var
overrides.  The accelerator fields describe a GKE node pool of NVIDIA H100s
(``a3-highgpu-Ng`` machines, N cards a node) in place of a TPU slice, and
``gpus_per_replica`` takes the place of ``chips_per_replica``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

#: GKE's GPU machine shapes whose name carries the card count
_MACHINE_GPUS_RE = re.compile(r"^a3-(?:high|mega|edge)gpu-(\d+)g$")


@dataclasses.dataclass
class DeployConfig:
    # --- infra (launch-instance.yaml:6-13 analog: instance/AMI/region) ----
    provider: str = "gke"                  # "gke" | "local" (existing kubeconfig / kind)
    project: str = ""                      # GCP project (like AWS account implied by creds)
    region: str = "us-central1"            # reference: us-east-2 (launch-instance.yaml:7)
    zone: str = "us-central1-a"            # reference: us-east-2b availability zone
    cluster_name: str = "tpu-serve"
    # GKE accelerator type of the node pool's cards (the reference runs a
    # g6.4xlarge with one L4, launch-instance.yaml:8)
    accelerator: str = "nvidia-h100-80gb"
    gpus_per_node: int = 1                 # cards on one node of the pool
    machine_type: str = "a3-highgpu-1g"    # a3-highgpu-Ng carries N H100s
    num_nodes: int = 1                     # single-node by design, like the reference
    disk_size_gb: int = 500                # reference: 500GB gp3 (launch-instance.yaml:12)
    gke_version: Optional[str] = None      # reference pins K8s 1.33 (kubernetes-single-node.yaml:7)

    # --- serving (llm-d-deploy.yaml:113-119 analog) -----------------------
    namespace: str = "tpu-serve"           # reference: llm-d
    model: str = "Qwen/Qwen3-0.6B"         # reference: llm-d-deploy.yaml:118
    replicas: int = 1                      # DP via replica count + gateway LB
    tensor_parallel: int = 1               # cards per replica, one rank a card
    disaggregated: bool = False            # prefill/decode pool split (llm-d topology)
    # Cross-pod disaggregation: SEPARATE prefill and decode Deployments,
    # independently scalable (llm-d's actual topology; KV rides the pod
    # network via /internal/migrate — parallel/disagg_net.py).  False keeps
    # both pools in one pod with the KV pages copied on the card
    # (parallel/disagg.py).
    disagg_cross_pod: bool = False
    prefill_replicas: int = 1              # cross-pod: prefill pool size
    decode_replicas: int = 1               # cross-pod: decode pool size
    # Engine performance knobs, forwarded to `python -m tpuserve_torch.server`:
    # the deploy layer must be able to express every serving-perf feature
    # the engine has, or clusters ship with the slow defaults.
    quantization: Optional[str] = None     # "int8" weight-only quant
    kv_cache_dtype: str = "bfloat16"       # "int8" = quantized KV cache
    speculative_k: int = 0                 # n-gram speculative decoding
    multi_step: Optional[int] = None       # fused decode window override
    # Pipeline parallelism: stage count per replica (mutually exclusive
    # with tensor_parallel > 1; parallel/pipeline.py).  Cards per replica
    # become pipeline_parallel instead of tensor_parallel.
    pipeline_parallel: int = 1
    # Multi-LoRA serving: {adapter_name: path-inside-model-pvc}; forwarded
    # as --lora-modules so requests pick adapters by the "model" field
    lora_modules: Optional[dict] = None
    # Model pool (tpuserve_torch/modelpool): catalog of models one replica
    # may serve by weight tiering + hot-swap.  A YAML mapping
    # {name: checkpoint-dir-or-null}, a JSON object string, or a comma
    # list of names; exported as TPUSERVE_MODEL_CATALOG to the engine
    # pods.  None/empty = no pool.
    model_catalog: Optional[str] = None
    # Host-DRAM weight tier byte budget for demoted param sets
    # (TPUSERVE_WEIGHT_HOST_BYTES); 0 = engine default (2 GiB)
    weight_host_bytes: int = 0
    # Tiered KV cache (runtime/kv_tiers.py): demote evicted prefix KV to
    # host DRAM and from there to a spill dir on the model PVC instead of
    # destroying it; restore asynchronously ahead of admission.
    kv_tiers: bool = True
    # host-DRAM tier byte budget (server --kv-host-bytes); 0 = engine
    # default (TPUSERVE_KV_HOST_BYTES or 1 GiB)
    kv_host_bytes: int = 0
    # PVC spill dir for the third tier (server --kv-spill-dir); lives on
    # the model PVC so demoted prefixes survive pod restarts.  Empty = no
    # spill tier.
    kv_spill_dir: str = "/models/.kv-spill"
    # Admission backpressure cap (server --max-waiting); 0 = auto
    max_waiting: int = 0
    # SLO class scheduling + brownout ladder (runtime/slo.py).  False
    # emits --no-slo-classes (classless FIFO).
    slo_classes: bool = True
    # Per-tenant token metering + rate limits (server/tenants.py),
    # exported as TPUSERVE_TENANTS to the engine pods.  None = no tenancy
    # config (metering under 'default').
    tenants: Optional[dict] = None
    # In-process SLO burn-rate evaluator (tpuserve_torch/obs).  False
    # exports TPUSERVE_SLO_BURN=0 to the engine pods.
    slo_burn: bool = True
    # Engine flight recorder (runtime/flight.py).  False exports
    # TPUSERVE_FLIGHT=0.
    flight: bool = True
    # Post-mortem bundle directory on the model PVC, so bundles survive
    # the pod that wrote them (exported as TPUSERVE_FLIGHT_DIR); the
    # /debug/profile traces land beside them.
    flight_dir: str = "/models/.flight"
    # Device telemetry (runtime/devprof.py: CUDA-event device time, the
    # captured-graph ladder, the HBM watermark).  False exports
    # TPUSERVE_DEVPROF=0.
    devprof: bool = True
    # Hang watchdog threshold (server --step-watchdog-s); 0 disables.
    step_watchdog_s: float = 0.0
    # Chaos drills: fault-injection spec exported as TPUSERVE_FAULTS to
    # the engine pods (runtime/faults.py).  None = no injection.
    faults: Optional[str] = None
    # SLI-driven autoscaler (tpuserve_torch/autoscale): a scaler
    # Deployment that scrapes every engine pod's /debug/engine scalars and
    # drives `kubectl scale` on the engine Deployment.  Plain
    # single-Deployment engine topologies only.
    autoscale: bool = False
    autoscale_min_replicas: int = 0        # 0 = scale-to-zero allowed
    autoscale_max_replicas: int = 4
    autoscale_interval_s: int = 5          # control-loop cadence
    # Synthetic canary (tpuserve_torch/obs/canary.py): the gateway probes
    # itself once per SLO class every this-many seconds.  0 disables.
    canary_interval_s: float = 15.0
    # Graceful-drain budget on SIGTERM (server --drain-timeout); the pod
    # spec's terminationGracePeriodSeconds is derived from it (+40 s)
    drain_timeout_s: int = 25
    storage_class: str = "standard-rwo"    # reference: local-path (llm-d-deploy.yaml:115)
    # General model-storage PVC size (reference: llm-d-deploy.yaml:116).
    # None = track model_pvc_size (a PVC request can only grow).
    storage_size: Optional[str] = None
    model_pvc_size: str = "100Gi"          # reference workaround PVC (llm-d-deploy.yaml:207)
    image: str = "tpuserve-torch:latest"   # engine container image (tag)
    # Registry prefix the image is pushed to and pulled from (e.g.
    # "us-central1-docker.pkg.dev/PROJECT/tpuserve").  Required for
    # provider=gke; empty on provider=local, where the image is
    # side-loaded into kind/minikube.
    image_registry: str = ""
    # Build+push/load the image during deploy (provision/image.py).
    build_image: bool = True
    hf_token_file: str = "~/.cache/huggingface/token"  # reference: llm-d-deploy.yaml:117
    chat_template: Optional[str] = None    # name of a bundled template (phi/opt)
    engine_port: int = 8000                # vLLM-compatible metrics port (otel-observability-setup.yaml:379)
    gateway_port: int = 8080
    # HA gateway pool: affinity is stateless rendezvous hashing, so every
    # replica computes the same prefix->backend mapping.
    gateway_replicas: int = 2
    # Gateway API class for the optional Gateway/HTTPRoute front (applied
    # only when the cluster has the CRDs; GKE ships this class built in).
    gateway_class: str = "gke-l7-regional-external-managed"

    # --- observability (otel-observability-setup.yaml:7-12 analog) --------
    monitoring_namespace: str = "monitoring"
    observability_namespace: str = "observability"
    otel_namespace: str = "otel-monitoring"
    gpu_metrics_interval_s: int = 5        # reference: DCGM 5s (kubernetes-single-node.yaml:487)
    otel_scrape_interval_s: int = 15       # reference: otel-observability-setup.yaml:190
    prometheus_retention: str = "15d"      # reference: kubernetes-single-node.yaml:428
    otel_prometheus_retention: str = "30d" # reference: otel-observability-setup.yaml:236
    otel_prometheus_retention_size: str = "10GB"
    grafana_admin_password: str = "admin"  # reference: kubernetes-single-node.yaml:427

    # --- timeouts (reference envelope, SURVEY.md §6) ----------------------
    install_timeout_s: int = 1800          # llm-d-deploy.yaml:192
    pods_ready_timeout_s: int = 1800       # llm-d-deploy.yaml:232
    # Node-Ready poll budget, the reference's SSH-up analog
    # (launch-instance.yaml:69 waits 300)
    node_ready_timeout_s: int = 600

    def validate(self) -> None:
        if self.provider not in ("gke", "local"):
            raise ValueError(f"unknown provider {self.provider!r}")
        if self.tensor_parallel < 1 or self.replicas < 1:
            raise ValueError("replicas and tensor_parallel must be >= 1")
        if self.gpus_per_node < 1:
            raise ValueError("gpus_per_node must be >= 1")
        m = _MACHINE_GPUS_RE.match(self.machine_type)
        if m and int(m.group(1)) != self.gpus_per_node:
            raise ValueError(
                f"machine_type {self.machine_type} carries {m.group(1)} GPUs, "
                f"but gpus_per_node is {self.gpus_per_node}")
        if self.prefill_replicas < 1 or self.decode_replicas < 1:
            raise ValueError("prefill_replicas and decode_replicas must "
                             "be >= 1")
        if self.gateway_replicas < 1:
            raise ValueError("gateway_replicas must be >= 1")
        # Engine knobs are forwarded verbatim to the server's argparse:
        # reject HERE what it would reject, or an invalid value passes the
        # build-time manifest validation and only surfaces as an
        # in-cluster CrashLoopBackOff.
        if self.quantization not in (None, "int8"):
            raise ValueError(f"quantization must be int8 or unset, "
                             f"got {self.quantization!r}")
        if self.kv_cache_dtype not in ("bfloat16", "float32", "int8"):
            raise ValueError(f"kv_cache_dtype must be bfloat16/float32/"
                             f"int8, got {self.kv_cache_dtype!r}")
        if self.speculative_k < 0:
            raise ValueError("speculative_k must be >= 0")
        if self.multi_step is not None and self.multi_step < 1:
            raise ValueError("multi_step must be >= 1 when set")
        if self.pipeline_parallel < 1:
            raise ValueError("pipeline_parallel must be >= 1")
        if self.step_watchdog_s < 0:
            raise ValueError("step_watchdog_s must be >= 0 (0 disables)")
        if self.faults:
            # parse at deploy time: a typo'd chaos spec must fail HERE,
            # not as an in-cluster CrashLoopBackOff
            from tpuserve_torch.runtime.faults import FaultInjector
            FaultInjector.from_spec(self.faults)
        if self.tenants is not None:
            # same deploy-time-parse rule as faults
            from tpuserve_torch.server.tenants import TenantRegistry
            TenantRegistry.from_config(self.tenants)
        if self.pipeline_parallel > 1 and self.tensor_parallel > 1:
            raise ValueError("pipeline_parallel and tensor_parallel are "
                             "mutually exclusive (the server rejects "
                             "--pp with --tp)")
        if self.pipeline_parallel > 1 and (self.disaggregated
                                           or self.disagg_cross_pod):
            raise ValueError("pipeline_parallel is incompatible with "
                             "disaggregated topologies")
        if self.pipeline_parallel > self.gpus_per_node:
            # the multihost StatefulSet path is tp-only (the server
            # rejects --pp with --multihost)
            raise ValueError(
                f"pipeline_parallel={self.pipeline_parallel} exceeds the "
                f"{self.gpus_per_node} GPUs of one {self.machine_type} node "
                "(pipeline stages are single-host)")
        if (self.disaggregated or self.disagg_cross_pod) \
                and self.tensor_parallel > 1:
            # the port's server refuses --disagg / --role on a --tp mesh
            raise ValueError("disaggregated topologies run tp 1 replicas "
                             "(the server rejects --disagg/--role with --tp)")
        if self.lora_modules is not None:
            if not isinstance(self.lora_modules, dict) or not all(
                    isinstance(k, str) and isinstance(v, str) and k and v
                    and "=" not in k
                    for k, v in self.lora_modules.items()):
                raise ValueError("lora_modules must map adapter names "
                                 "(no '=') to paths")
        if self.lora_modules:      # empty dict = no adapters = no limits
            if self.model in self.lora_modules:
                raise ValueError(f"adapter name {self.model!r} collides "
                                 "with the served model name")
            if self.tensor_parallel > 1 or self.pipeline_parallel > 1 \
                    or self.disaggregated or self.disagg_cross_pod \
                    or self.speculative_k:
                raise ValueError("lora_modules needs plain single-GPU "
                                 "replicas (the engine rejects multi-LoRA "
                                 "with tp/pp/disagg/speculation)")
        if self.kv_host_bytes < 0:
            raise ValueError("kv_host_bytes must be >= 0 (0 = engine "
                             "default)")
        if self.weight_host_bytes < 0:
            raise ValueError("weight_host_bytes must be >= 0 (0 = "
                             "engine default)")
        if self.model_catalog:
            from tpuserve_torch.modelpool.pool import parse_catalog
            parse_catalog(self.model_catalog)
            if self.disaggregated or self.disagg_cross_pod:
                raise ValueError("model_catalog needs a plain engine "
                                 "topology (the pool swaps ONE engine; "
                                 "disagg replicas are two)")
        if self.max_waiting < -1:
            raise ValueError("max_waiting must be >= -1")
        if self.drain_timeout_s < 0:
            raise ValueError("drain_timeout_s must be >= 0")
        if self.canary_interval_s < 0:
            raise ValueError("canary_interval_s must be >= 0 "
                             "(0 disables the gateway canary)")
        if self.autoscale:
            if not (0 <= self.autoscale_min_replicas
                    <= self.autoscale_max_replicas) \
                    or self.autoscale_max_replicas < 1:
                raise ValueError(
                    "need 0 <= autoscale_min_replicas <= "
                    "autoscale_max_replicas (and max >= 1), got "
                    f"{self.autoscale_min_replicas}.."
                    f"{self.autoscale_max_replicas}")
            if self.autoscale_interval_s < 1:
                raise ValueError("autoscale_interval_s must be >= 1")
            if self.disaggregated or self.disagg_cross_pod:
                raise ValueError(
                    "autoscale targets the plain engine Deployment; "
                    "disaggregated pools are not a scalable unit here")
            if self.multihost:
                raise ValueError(
                    "autoscale does not cover multihost StatefulSet "
                    "replicas (one replica = N pods there)")
            if not self.slo_classes or not self.flight:
                # the policy's scale-out triggers ARE the SLO
                # controller's scalars and the recorder's SLIs
                raise ValueError(
                    "autoscale consumes the SLO controller's brownout/"
                    "queue-delay scalars and the flight recorder's "
                    "SLIs — it requires slo_classes and flight enabled")
        # NOTE: the GCP-project requirement is enforced at provision time
        # (infra._provision_gke), not here — subcommands like `test` read
        # cluster identity from the inventory file and need no project.

    @property
    def gpus_per_replica(self) -> int:
        """Cards one engine replica takes — pipeline stages or tensor
        ranks, whichever parallelism is active: the ONE place the pp-vs-tp
        arithmetic lives (manifests + CLI consume it)."""
        return (self.pipeline_parallel if self.pipeline_parallel > 1
                else self.tensor_parallel)

    @property
    def multihost(self) -> bool:
        """A replica's tp ranks span nodes: one StatefulSet pod a node."""
        return self.tensor_parallel > self.gpus_per_node

    @property
    def parallelism_desc(self) -> str:
        return (f"pp={self.pipeline_parallel}"
                if self.pipeline_parallel > 1
                else f"tp={self.tensor_parallel}")


_ENV_PREFIX = "TPUSERVE_"


def load_config(path: Optional[str] = None, preset: Optional[str] = None,
                **overrides) -> DeployConfig:
    """Load config from preset (if given), then YAML, env vars, overrides.

    Env override example: TPUSERVE_MODEL=facebook/opt-1.3b.
    """
    data: dict = {}
    if path:
        import yaml
        with open(os.path.expanduser(path)) as f:
            data.update(yaml.safe_load(f) or {})
    fields = {f.name: f for f in dataclasses.fields(DeployConfig)}
    for name, field in fields.items():
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            data[name] = _coerce(env, field.type)
    data.update({k: v for k, v in overrides.items() if v is not None})
    if preset:
        data = apply_preset(data, preset)
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    cfg = DeployConfig(**data)
    cfg.validate()
    return cfg


def _coerce(value: str, typ) -> object:
    t = str(typ)
    if "int" in t:
        return int(value)
    if "float" in t:
        return float(value)
    if "bool" in t:
        return value.lower() in ("1", "true", "yes", "on")
    return value


# --------------------------------------------------------------------------
# Deploy presets: one for each of the JAX provisioner's, on H100 node pools
# --------------------------------------------------------------------------

_H100_1 = {"accelerator": "nvidia-h100-80gb", "gpus_per_node": 1,
           "machine_type": "a3-highgpu-1g"}
_H100_4 = {"accelerator": "nvidia-h100-80gb", "gpus_per_node": 4,
           "machine_type": "a3-highgpu-4g"}

#: Named presets: each is a dict of DeployConfig overrides applied under
#: the YAML/env/CLI layers.  The models are the JAX presets'; a TPU slice's
#: tp 4 came from 16 GB chips, and one 80 GB card holds each of these
#: models but Qwen2-72B whole, so those replicas run tp 1.
PRESETS: dict[str, dict] = {
    # default single-card serve target (llm-d-deploy.yaml:118)
    "qwen3-0.6b-h100": {
        "model": "Qwen/Qwen3-0.6B", **_H100_1, "tensor_parallel": 1,
    },
    # alternate models (kubernetes-single-node.yaml:15, templates/*.yaml)
    "phi3-mini-h100": {
        "model": "microsoft/Phi-3-mini-4k-instruct", **_H100_1,
        "tensor_parallel": 1, "chat_template": "phi",
    },
    "opt-1.3b-h100": {
        "model": "facebook/opt-1.3b", **_H100_1, "tensor_parallel": 1,
        "chat_template": "opt",
    },
    # sliding-window serving with int8 weights + KV, as the JAX preset
    "mistral-7b-h100": {
        "model": "mistralai/Mistral-7B-Instruct-v0.1", **_H100_1,
        "tensor_parallel": 1, "quantization": "int8",
        "kv_cache_dtype": "int8",
    },
    # in-process disaggregation on one card: the server refuses --disagg
    # with --tp, so both engines share the replica's one card
    "llama3-8b-disagg-h100": {
        "model": "meta-llama/Meta-Llama-3-8B-Instruct", **_H100_1,
        "tensor_parallel": 1, "disaggregated": True,
    },
    # cross-pod disaggregation: a prefill and a decode Deployment, one
    # card each, on two nodes; KV rides the pod network
    "llama3-8b-disagg-xpod-h100": {
        "model": "meta-llama/Meta-Llama-3-8B-Instruct", **_H100_1,
        "num_nodes": 2, "tensor_parallel": 1,
        "disaggregated": True, "disagg_cross_pod": True,
        "prefill_replicas": 1, "decode_replicas": 1,
    },
    # multihost tp 8: each replica two a3-highgpu-4g nodes (a StatefulSet
    # of two pods, four torchrun ranks each), two replicas on four nodes
    "qwen2-72b-tp8-h100x8": {
        "model": "Qwen/Qwen2-72B-Instruct", **_H100_4, "num_nodes": 4,
        "tensor_parallel": 8, "replicas": 2, "model_pvc_size": "300Gi",
    },
    # pipeline stages on one a3-highgpu-4g: ~145 GB of bf16 weights do
    # not fit one 80 GB card; four stages hold ~36 GB of layers each
    "qwen2-72b-pp4-h100x4": {
        "model": "Qwen/Qwen2-72B-Instruct", **_H100_4,
        "tensor_parallel": 1, "pipeline_parallel": 4,
        "model_pvc_size": "300Gi",
    },
    # harness-friendly CPU smoke path (kind/minikube, --device cpu)
    "cpu-smoke": {
        "provider": "local", "model": "tiny-qwen3",
        "tensor_parallel": 1, "replicas": 1,
    },
}


def apply_preset(data: dict, preset: str) -> dict:
    """Overlay a named preset under explicit YAML/env/override values."""
    if preset not in PRESETS:
        raise ValueError(
            f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
    merged = dict(PRESETS[preset])
    merged.update(data)
    return merged
