"""The port's provisioner (``tpuserve_torch/provision``): the cases of
``tests/test_provision.py``, ``tests/test_manifest_schema.py`` and
``tests/test_e2e_gate.py`` run on the port, on GKE H100 node pools.

A fake command runner stands in for gcloud / kubectl / helm / docker, so
the whole pipeline runs without cloud credentials.  The JAX file's three
``TpuMetricsExporter`` cases have no counterpart: a GPU node's DaemonSet
is NVIDIA's DCGM exporter, whose manifests are held here, and the engine's
own NVML gauges are held by ``tests/test_torch_devprof.py``.  The last case
runs the rendered ``cpu-smoke`` engine and gateway commands as processes
and passes the provisioner's own smoke tests through them.
"""

import copy
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import yaml

from tpuserve_torch.provision import cluster as cluster_layer
from tpuserve_torch.provision import e2e, infra, manifests, observability, serving, smoke
from tpuserve_torch.provision.config import PRESETS, DeployConfig, load_config
from tpuserve_torch.provision.inventory import (ClusterRecord, details_path,
                                                extract_cluster_id, find_inventories,
                                                generated_files, latest_inventory,
                                                parse_details, read_inventory,
                                                write_details, write_inventory)
from tpuserve_torch.provision.runner import (CommandError, CommandResult, CommandRunner,
                                             DryRunRunner)
from tpuserve_torch.provision.validate import (ManifestError, validate_all,
                                               validate_manifest)

ROOT = Path(__file__).resolve().parent.parent


class FakeRunner(CommandRunner):
    """Canned-response runner: first matching (predicate, result) wins."""

    def __init__(self, responses=()):
        self.responses = list(responses)
        self.commands = []
        self.slept = 0.0

    def run(self, argv, *, check=True, timeout=600.0, input_text=None):
        argv = tuple(argv)
        self.commands.append((argv, input_text))
        for match, result in self.responses:
            joined = " ".join(argv)
            if (match(joined) if callable(match) else match in joined):
                res = CommandResult(argv, *result) if isinstance(result, tuple) \
                    else CommandResult(argv, 0, result, "")
                if check and not res.ok:
                    raise CommandError(res)
                return res
        return CommandResult(argv, 0, "", "")

    def sleep(self, seconds):
        self.slept += seconds

    def argvs(self):
        return [" ".join(a) for a, _ in self.commands]


# --- inventory contract ---------------------------------------------------

def _rec(cid="tpu-serve-abc123"):
    return ClusterRecord(cluster_id=cid, cluster_name="tpu-serve",
                         project="proj", region="us-central1",
                         zone="us-central1-a", accelerator="nvidia-h100-80gb-x1",
                         endpoint="1.2.3.4")


def test_inventory_roundtrip(tmp_path):
    rec = _rec()
    path = write_inventory(rec, str(tmp_path))
    assert os.path.basename(path) == "gpu-inventory-tpu-serve-abc123.ini"
    got = read_inventory(path)
    assert got.cluster_id == rec.cluster_id
    assert got.project == "proj"
    assert got.zone == "us-central1-a"
    assert got.accelerator == "nvidia-h100-80gb-x1"
    assert got.kubeconfig_file == "kubeconfig-tpu-serve-abc123"


def test_latest_inventory_is_newest_by_mtime(tmp_path):
    a = write_inventory(_rec("old-1"), str(tmp_path))
    b = write_inventory(_rec("new-2"), str(tmp_path))
    os.utime(a, (1000, 1000))
    os.utime(b, (2000, 2000))
    assert latest_inventory(str(tmp_path)) == b
    assert [os.path.basename(p) for p in find_inventories(str(tmp_path))] == [
        "gpu-inventory-old-1.ini", "gpu-inventory-new-2.ini"]


def test_extract_cluster_id_content_and_filename_fallback(tmp_path):
    p = tmp_path / "gpu-inventory-namedfile.ini"
    p.write_text("[gpu_cluster]\nhost cluster_id=from-content x=y\n")
    assert extract_cluster_id(str(p)) == "from-content"
    q = tmp_path / "gpu-inventory-from-filename.ini"
    q.write_text("[gpu_cluster]\njunk-without-id\n")
    assert extract_cluster_id(str(q)) == "from-filename"


def test_details_file_roundtrip(tmp_path):
    rec = _rec()
    write_details(rec, str(tmp_path), extra={"Model": "Qwen/Qwen3-0.6B"})
    path = details_path(rec.cluster_id, str(tmp_path))
    assert os.path.basename(path) == "instance-tpu-serve-abc123-details.txt"
    got = parse_details(path)
    assert got["Cluster ID"] == rec.cluster_id
    assert got["Model"] == "Qwen/Qwen3-0.6B"
    assert got["Accelerator"] == "nvidia-h100-80gb-x1"


# --- config ---------------------------------------------------------------

def test_config_yaml_env_and_override(tmp_path, monkeypatch):
    f = tmp_path / "cfg.yaml"
    f.write_text("model: facebook/opt-1.3b\nreplicas: 2\nprovider: local\n")
    monkeypatch.setenv("TPUSERVE_TENSOR_PARALLEL", "8")
    monkeypatch.setenv("TPUSERVE_GPUS_PER_NODE", "8")
    monkeypatch.setenv("TPUSERVE_MACHINE_TYPE", "a3-highgpu-8g")
    monkeypatch.setenv("TPUSERVE_STEP_WATCHDOG_S", "2.5")
    cfg = load_config(str(f), namespace="custom-ns")
    assert cfg.model == "facebook/opt-1.3b"
    assert cfg.replicas == 2
    assert cfg.tensor_parallel == 8 and cfg.gpus_per_node == 8
    assert cfg.step_watchdog_s == 2.5
    assert cfg.namespace == "custom-ns"


def test_config_rejects_unknown_keys_and_bad_values(tmp_path):
    f = tmp_path / "cfg.yaml"
    f.write_text("no_such_key: 1\n")
    with pytest.raises(ValueError):
        load_config(str(f))
    with pytest.raises(ValueError):
        load_config(None, provider="nope")
    # the JAX config's TPU fields are not the port's
    with pytest.raises(ValueError, match="unknown config keys"):
        load_config(None, tpu_type="v5litepod-4")
    # project requirement is enforced at provision time, not load time
    cfg = load_config(None, provider="gke", project="")
    with pytest.raises(ValueError, match="project"):
        infra.provision(cfg, FakeRunner(), "/tmp/nonexistent-ok")


def test_gpus_per_replica_and_machine_shape():
    assert DeployConfig(tensor_parallel=4, gpus_per_node=4,
                        machine_type="a3-highgpu-4g").gpus_per_replica == 4
    assert DeployConfig(pipeline_parallel=4, gpus_per_node=4).gpus_per_replica == 4
    assert DeployConfig(tensor_parallel=8, gpus_per_node=4).multihost
    assert not DeployConfig(tensor_parallel=4, gpus_per_node=4).multihost
    with pytest.raises(ValueError, match="carries 4 GPUs"):
        DeployConfig(gpus_per_node=1, machine_type="a3-highgpu-4g").validate()


# --- infra: provision + cleanup -------------------------------------------

KUBECONFIG_YAML = "apiVersion: v1\nkind: Config\nclusters: []\n"
GPU_NODES_OUT = "gke-gpu-node-1 1\n"


def gke_fake():
    return FakeRunner([
        ("clusters describe", (1, "", "not found")),
        ("node-pools describe", (1, "", "not found")),
        ("config view", KUBECONFIG_YAML),
        ("kubectl wait --for=condition=Ready nodes", (0, "ok", "")),
        ("get nodes -o jsonpath", GPU_NODES_OUT),
    ])


def test_provision_gke_sequences_and_writes_contract(tmp_path):
    cfg = load_config(None, provider="gke", project="proj")
    runner = gke_fake()
    rec = infra.provision(cfg, runner, str(tmp_path))
    argvs = runner.argvs()
    assert any("container clusters create tpu-serve" in a for a in argvs)
    assert any("node-pools create gpu-pool" in a
               and "--machine-type a3-highgpu-1g" in a
               and "--accelerator type=nvidia-h100-80gb,count=1,"
                   "gpu-driver-version=latest" in a for a in argvs)
    assert any("get-credentials" in a for a in argvs)
    assert any("allocatable.nvidia\\.com/gpu" in a for a in argvs)
    inv = latest_inventory(str(tmp_path))
    assert inv and extract_cluster_id(inv) == rec.cluster_id
    assert rec.cluster_id.startswith("tpu-serve-")
    assert os.path.exists(tmp_path / f"kubeconfig-{rec.cluster_id}")
    assert os.path.exists(details_path(rec.cluster_id, str(tmp_path)))


def test_provision_gke_adopts_existing_cluster(tmp_path):
    cfg = load_config(None, provider="gke", project="proj")
    runner = FakeRunner([
        ("clusters describe tpu-serve --project", (0, "34.1.2.3\n", "")),
        ("node-pools describe", (0, "exists", "")),
        ("config view", KUBECONFIG_YAML),
        ("kubectl wait --for=condition=Ready nodes", (0, "ok", "")),
        ("get nodes -o jsonpath", GPU_NODES_OUT),
    ])
    rec = infra.provision(cfg, runner, str(tmp_path))
    assert rec.endpoint == "34.1.2.3"
    assert not any("clusters create" in a for a in runner.argvs())
    assert not any("node-pools create" in a for a in runner.argvs())


def test_provision_gke_fails_without_gpu_resource(tmp_path):
    cfg = load_config(None, provider="gke", project="proj")
    runner = FakeRunner([
        ("clusters describe", (1, "", "nope")),
        ("config view", KUBECONFIG_YAML),
        ("kubectl wait --for=condition=Ready nodes", (0, "ok", "")),
        ("get nodes -o jsonpath", "node-1 \n"),   # no nvidia.com/gpu
    ])
    with pytest.raises(RuntimeError, match="nvidia.com/gpu|device plugin"):
        infra.provision(cfg, runner, str(tmp_path))


def test_provision_local_adopts_kubeconfig(tmp_path):
    cfg = load_config(None, provider="local")
    runner = FakeRunner([
        ("config view", KUBECONFIG_YAML),
        ("current-context", "kind-kind\n"),
        ("kubectl wait --for=condition=Ready nodes", (0, "ok", "")),
        ("get nodes -o jsonpath", "node-1 \n"),   # soft: no GPU on local
    ])
    rec = infra.provision(cfg, runner, str(tmp_path))
    assert rec.endpoint == "kind-kind"
    assert rec.accelerator == "cpu"
    assert not any(a.startswith("gcloud") for a in runner.argvs())


def test_cleanup_terminates_and_removes_files(tmp_path):
    rec = _rec()
    write_inventory(rec, str(tmp_path))
    write_details(rec, str(tmp_path))
    (tmp_path / rec.kubeconfig_file).write_text("kc")
    runner = FakeRunner([("clusters describe", (0, "RUNNING\n", ""))])
    removed = infra.cleanup(runner, str(tmp_path))
    assert removed == [rec.cluster_id]
    assert any("clusters delete tpu-serve" in a and "--quiet" in a
               for a in runner.argvs())
    assert generated_files(rec.cluster_id, str(tmp_path)) == []


def test_cleanup_skips_cloud_when_cluster_gone(tmp_path):
    rec = _rec()
    write_inventory(rec, str(tmp_path))
    runner = FakeRunner([("clusters describe", (
        1, "", "ERROR: ResponseError: code=404, message=Not found: "
               "projects/proj/zones/us-central1-a/clusters/tpu-serve."))])
    removed = infra.cleanup(runner, str(tmp_path))
    assert removed == [rec.cluster_id]
    assert not any("clusters delete" in a for a in runner.argvs())


def test_cleanup_keeps_files_when_cloud_unverifiable(tmp_path):
    rec = _rec()
    write_inventory(rec, str(tmp_path))
    runner = FakeRunner([("clusters describe", (1, "", "ERROR: token expired"))])
    assert infra.cleanup(runner, str(tmp_path)) == []


def test_cleanup_keeps_files_when_project_not_found(tmp_path):
    rec = _rec()
    write_inventory(rec, str(tmp_path))
    runner = FakeRunner([
        ("clusters describe", (
            1, "", "ERROR: ResponseError: code=404, "
                   "message=Not found: projects/proj.")),
    ])
    assert infra.cleanup(runner, str(tmp_path)) == []
    assert generated_files(rec.cluster_id, str(tmp_path)) != []


def test_download_job_failure_fails_fast(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_TOKEN", raising=False)
    cfg = _cfg(hf_token_file=str(tmp_path / "missing"))
    runner = FakeRunner([
        ("wait --for=condition=complete", (1, "", "timed out")),
        ('jsonpath={.status.conditions[?(@.type=="Failed")].status}',
         (0, "True", "")),
        ("logs job/model-download", (0, "401 unauthorized", "")),
    ])
    with pytest.raises(RuntimeError, match="401 unauthorized"):
        serving.deploy(cfg, infra.KubeCtl(runner, "kc"))
    waits = sum("wait --for=condition=complete" in a for a in runner.argvs())
    assert waits == 1


def test_cleanup_noop_without_inventories(tmp_path):
    runner = FakeRunner()
    assert infra.cleanup(runner, str(tmp_path)) == []
    assert runner.commands == []


# --- manifests ------------------------------------------------------------

def _cfg(**kw):
    kw.setdefault("provider", "gke")
    kw.setdefault("project", "proj")
    return load_config(None, **kw)


def _engine_container(cfg, name="tpuserve-engine"):
    objs = manifests.serving_manifests(cfg)
    dep = next(o for o in objs if o["metadata"]["name"] == name
               and o["kind"] in ("Deployment", "StatefulSet"))
    return dep, dep["spec"]["template"]["spec"]["containers"][0]


def test_serving_manifests_colocated():
    cfg = _cfg()
    text = manifests.render(*manifests.serving_manifests(cfg))
    parsed = list(yaml.safe_load_all(text))
    kinds = [(o["kind"], o["metadata"]["name"]) for o in parsed]
    assert ("Namespace", cfg.namespace) in kinds
    assert ("Job", "model-download") in kinds
    assert ("Deployment", "tpuserve-engine") in kinds
    assert ("Deployment", "tpuserve-gateway") in kinds
    assert ("Service", "tpuserve-gateway") in kinds
    assert [n for k, n in kinds if k == "PersistentVolumeClaim"] == ["model-pvc"]
    cms = [n for k, n in kinds if k == "ConfigMap"]
    assert "phi-chat-template" in cms and "opt-chat-template" in cms
    job = next(o for o in parsed if o["kind"] == "Job")
    assert job["spec"]["template"]["spec"]["containers"][0]["command"][:3] == [
        "python", "-m", "tpuserve_torch.models.download"]


def test_serving_manifests_autoscaled():
    cfg = _cfg(autoscale=True, autoscale_min_replicas=0, autoscale_max_replicas=5)
    parsed = list(yaml.safe_load_all(manifests.render(*manifests.serving_manifests(cfg))))
    kinds = [(o["kind"], o["metadata"]["name"]) for o in parsed]
    for want in (("ServiceAccount", "tpuserve-autoscaler"),
                 ("Role", "tpuserve-autoscaler"),
                 ("RoleBinding", "tpuserve-autoscaler"),
                 ("Deployment", "tpuserve-autoscaler"),
                 ("Service", "tpuserve-autoscaler")):
        assert want in kinds
    gw = next(o for o in parsed if o["kind"] == "Deployment"
              and o["metadata"]["name"] == "tpuserve-gateway")
    gw_cmd = gw["spec"]["template"]["spec"]["containers"][0]["command"]
    assert gw_cmd[:3] == ["python", "-m", "tpuserve_torch.server.gateway"]
    assert gw_cmd[gw_cmd.index("--backends-url") + 1].endswith("/backends")
    scaler = next(o for o in parsed if o["kind"] == "Deployment"
                  and o["metadata"]["name"] == "tpuserve-autoscaler")
    assert scaler["spec"]["replicas"] == 1
    pod = scaler["spec"]["template"]["spec"]
    assert pod["serviceAccountName"] == "tpuserve-autoscaler"
    cmd = pod["containers"][0]["command"]
    assert cmd[:3] == ["python", "-m", "tpuserve_torch.autoscale"]
    assert cmd[cmd.index("--max-replicas") + 1] == "5"
    assert cmd[cmd.index("--min-replicas") + 1] == "0"
    # the deployment and selector the port's KubePool patches
    assert cmd[cmd.index("--deployment") + 1] == "tpuserve-engine"
    base = [(o["kind"], o["metadata"]["name"]) for o in
            yaml.safe_load_all(manifests.render(*manifests.serving_manifests(_cfg())))]
    assert ("Deployment", "tpuserve-autoscaler") not in base


def test_autoscale_config_validation():
    with pytest.raises(ValueError, match="autoscale_min_replicas"):
        _cfg(autoscale=True, autoscale_min_replicas=3, autoscale_max_replicas=2)
    with pytest.raises(ValueError, match="disaggregated"):
        _cfg(autoscale=True, disaggregated=True)
    with pytest.raises(ValueError, match="multihost"):
        _cfg(autoscale=True, tensor_parallel=8, gpus_per_node=4,
             machine_type="a3-highgpu-4g")
    with pytest.raises(ValueError, match="slo_classes"):
        _cfg(autoscale=True, slo_classes=False)
    with pytest.raises(ValueError, match="flight"):
        _cfg(autoscale=True, flight=False)
    assert _cfg(autoscale_min_replicas=9).autoscale is False


def test_engine_deployment_gpu_resources_and_probes():
    cfg = _cfg(tensor_parallel=4, gpus_per_node=4, machine_type="a3-highgpu-4g")
    dep, c = _engine_container(cfg)
    pod = dep["spec"]["template"]
    assert c["resources"]["limits"]["nvidia.com/gpu"] == "4"
    assert "google.com/tpu" not in json.dumps(dep)
    assert pod["metadata"]["annotations"]["prometheus.io/scrape"] == "true"
    assert pod["metadata"]["annotations"]["prometheus.io/port"] == "8000"
    assert c["readinessProbe"]["httpGet"]["path"] == "/readyz"
    assert c["livenessProbe"]["httpGet"]["path"] == "/healthz"
    assert pod["spec"]["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert pod["spec"]["tolerations"] == [
        {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"}]
    assert c["command"][:3] == ["python", "-m", "tpuserve_torch.server"]
    assert c["command"][c["command"].index("--tp") + 1] == "4"
    assert "--device" not in c["command"]       # the card is the default
    env = {e["name"]: e.get("value") for e in c["env"]}
    # the image carries the built kernels: no compile cache on the PVC
    assert "JAX_COMPILATION_CACHE_DIR" not in env and "JAX_PLATFORMS" not in env
    assert env["TPUSERVE_FSM_CACHE_DIR"] == "/models/.fsm-cache"
    mounts = {m["name"]: m["mountPath"] for m in c["volumeMounts"]}
    assert mounts["models"] == "/models"
    # the drain/grace coupling
    assert dep["spec"]["template"]["spec"]["terminationGracePeriodSeconds"] == \
        cfg.drain_timeout_s + 40


def test_serving_manifests_disaggregated():
    cfg = _cfg(disaggregated=True)
    objs = manifests.serving_manifests(cfg)
    deps = {o["metadata"]["name"]: o for o in objs if o["kind"] == "Deployment"}
    assert "tpuserve-engine" not in deps
    c = deps["tpuserve-disagg"]["spec"]["template"]["spec"]["containers"][0]
    assert "--disagg" in c["command"]
    assert c["resources"]["limits"]["nvidia.com/gpu"] == "1"
    gw = deps["tpuserve-gateway"]["spec"]["template"]["spec"]["containers"][0]
    assert any("tpuserve-disagg" in a for a in gw["command"])


def test_multihost_statefulset_runs_torchrun_a_node():
    cfg = load_config(preset="qwen2-72b-tp8-h100x8", project="p")
    objs = manifests.serving_manifests(cfg)
    sts = [o for o in objs if o["kind"] == "StatefulSet"]
    assert [o["metadata"]["name"] for o in sts] == ["tpuserve-mh-0", "tpuserve-mh-1"]
    s = sts[0]
    assert s["spec"]["replicas"] == 2             # 8 ranks over 4-GPU nodes
    pod = s["spec"]["template"]["spec"]
    c = pod["containers"][0]
    assert c["resources"]["limits"]["nvidia.com/gpu"] == "4"
    assert "readinessProbe" not in c and "livenessProbe" not in c
    cmd = c["command"]
    assert cmd[:3] == ["python", "-m", "torch.distributed.run"]
    assert cmd[cmd.index("--nproc-per-node") + 1] == "4"
    assert cmd[cmd.index("--nnodes") + 1] == "2"
    assert cmd[cmd.index("--node-rank") + 1] == "$(POD_INDEX)"
    assert cmd[cmd.index("--master-addr") + 1] == \
        "tpuserve-mh-0-0.tpuserve-mh-0.tpu-serve.svc.cluster.local"
    i = cmd.index("-m", 3)
    assert cmd[i + 1] == "tpuserve_torch.server" and cmd[-1] == "--multihost"
    env = {e["name"]: e for e in c["env"]}
    assert env["POD_INDEX"]["valueFrom"]["fieldRef"]["fieldPath"] == \
        "metadata.labels['apps.kubernetes.io/pod-index']"
    gw = next(o for o in objs if o["metadata"]["name"] == "tpuserve-gateway")
    gcmd = gw["spec"]["template"]["spec"]["containers"][0]["command"]
    assert "http://tpuserve-mh-1-0.tpuserve-mh-1.tpu-serve.svc.cluster.local:8000" in gcmd
    validate_all(objs)


def test_local_provider_omits_gpu_bits():
    cfg = _cfg(provider="local", project="")
    dep, c = _engine_container(cfg)
    pod = dep["spec"]["template"]
    assert "nodeSelector" not in pod["spec"] and "tolerations" not in pod["spec"]
    assert c["resources"] == {}
    cmd = c["command"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert not any(e["name"] == "JAX_PLATFORMS" for e in c["env"])


def test_chat_templates_render():
    import jinja2
    msgs = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Hi"},
            {"role": "assistant", "content": "Hello"},
            {"role": "user", "content": "Who are you?"}]
    phi = jinja2.Template(manifests.PHI_CHAT_TEMPLATE).render(
        messages=msgs, add_generation_prompt=True)
    assert "<|system|>" in phi and phi.rstrip().endswith("<|assistant|>")
    opt = jinja2.Template(manifests.OPT_CHAT_TEMPLATE).render(
        messages=msgs, add_generation_prompt=True)
    assert "Be brief." in opt and "Human: Hi" in opt
    assert opt.rstrip().endswith("Assistant:")


# --- cluster + serving layers ---------------------------------------------

def test_bootstrap_installs_prometheus_when_absent():
    cfg = _cfg()
    runner = FakeRunner([
        ("helm --kubeconfig kc status prometheus", (1, "", "not found")),
        ("get crd servicemonitors", (0, "ok", "")),
    ])
    cluster_layer.bootstrap(cfg, infra.KubeCtl(runner, "kc"))
    argvs = runner.argvs()
    assert any("helm" in a and "install prometheus" in a and
               f"retention={cfg.prometheus_retention}" in a for a in argvs)
    applied = "\n".join(t or "" for _, t in runner.commands)
    assert "ServiceMonitor" in applied and "name: dcgm-exporter" in applied
    assert f"interval: {cfg.gpu_metrics_interval_s}s" in applied
    assert "model-storage-1" in applied and "model-storage-2" in applied


def test_bootstrap_skips_prometheus_when_installed():
    cfg = _cfg()
    runner = FakeRunner([
        ("status prometheus", (0, "deployed", "")),
        ("get crd servicemonitors", (0, "ok", "")),
    ])
    cluster_layer.bootstrap(cfg, infra.KubeCtl(runner, "kc"))
    assert not any("install prometheus" in a for a in runner.argvs())


def test_verify_gpu_schedulable():
    nodes = {"items": [{"status": {"allocatable": {"nvidia.com/gpu": "8"}}}]}
    ok = FakeRunner([("get nodes -o json", json.dumps(nodes))])
    assert cluster_layer.verify_gpu_schedulable(_cfg(), infra.KubeCtl(ok, "kc"))
    none = FakeRunner([("get nodes -o json", json.dumps({"items": [{"status": {}}]}))])
    assert not cluster_layer.verify_gpu_schedulable(_cfg(), infra.KubeCtl(none, "kc"))


def test_serving_deploy_waits_and_secret(tmp_path, monkeypatch):
    token_file = tmp_path / "token"
    token_file.write_text("hf_secret_token\n")
    monkeypatch.delenv("HF_TOKEN", raising=False)
    cfg = _cfg(hf_token_file=str(token_file))
    runner = FakeRunner([
        ("wait --for=condition=complete job/model-download", (0, "ok", "")),
        ("wait --for=condition=Ready pods", (0, "ok", "")),
    ])
    serving.deploy(cfg, infra.KubeCtl(runner, "kc"))
    applied = "\n".join(t or "" for _, t in runner.commands)
    assert "hf_secret_token" in applied and "model-download" in applied
    argvs = runner.argvs()
    assert any("job/model-download" in a for a in argvs)
    assert any("wait --for=condition=Ready pods" in a and "--timeout=30s" in a
               for a in argvs)


def test_serving_redeploy_deletes_immutable_job(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_TOKEN", raising=False)
    cfg = _cfg(hf_token_file=str(tmp_path / "missing"))
    runner = FakeRunner([
        ("wait --for=condition=complete job/model-download", (0, "ok", "")),
        ("wait --for=condition=Ready pods", (0, "ok", "")),
    ])
    serving.deploy(cfg, infra.KubeCtl(runner, "kc"))
    argvs = runner.argvs()
    delete_idx = next(i for i, a in enumerate(argvs) if "delete job model-download" in a)
    apply_idx = next(i for i, (a, t) in enumerate(runner.commands)
                     if "apply" in " ".join(a) and "model-download" in (t or ""))
    assert delete_idx < apply_idx


def test_discover_gateway_fallbacks():
    cfg = _cfg()
    r1 = FakeRunner([("loadBalancer", "34.9.9.9")])
    assert serving.discover_gateway(cfg, infra.KubeCtl(r1, "kc")) == "34.9.9.9"
    r2 = FakeRunner([("loadBalancer", ""), ("clusterIP", "10.0.0.5")])
    assert serving.discover_gateway(cfg, infra.KubeCtl(r2, "kc")) == "10.0.0.5"
    r3 = FakeRunner()
    assert serving.discover_gateway(cfg, infra.KubeCtl(r3, "kc")) == \
        f"tpuserve-gateway.{cfg.namespace}.svc.cluster.local"


# --- smoke tests ----------------------------------------------------------

def smoke_fake(models_body, completion_body):
    return FakeRunner([
        ("clusterIP", "10.0.0.5"),
        (lambda j: "logs curl-gw-models" in j, (0, models_body, "")),
        (lambda j: "logs curl-gw-completion" in j, (0, completion_body, "")),
        ("wait pod/", (0, "ok", "")),
    ])


def test_smoke_tests_pass_and_cleanup_pods():
    cfg = _cfg()
    models = json.dumps({"data": [{"id": cfg.model}]})
    completion = json.dumps({"choices": [{"text": "I am tpuserve."}]})
    runner = smoke_fake(models, completion)
    out = smoke.run_smoke_tests(cfg, infra.KubeCtl(runner, "kc"))
    assert cfg.model in out["models"]
    argvs = runner.argvs()
    assert any("run curl-gw-models" in a and "curlimages/curl" in a for a in argvs)
    assert any(smoke.SMOKE_PROMPT in a for a in argvs)
    assert sum("delete pod curl-gw-" in a for a in argvs) >= 2


def test_smoke_tests_fail_on_wrong_model():
    runner = smoke_fake(json.dumps({"data": [{"id": "other-model"}]}), "{}")
    with pytest.raises(smoke.SmokeTestFailure, match="not in /v1/models"):
        smoke.run_smoke_tests(_cfg(), infra.KubeCtl(runner, "kc"))


def test_smoke_retry_then_fail():
    runner = FakeRunner([("clusterIP", "10.0.0.5"), ("wait pod/", (1, "", "timed out"))])
    with pytest.raises(smoke.SmokeTestFailure, match="3 attempts"):
        smoke.run_smoke_tests(_cfg(), infra.KubeCtl(runner, "kc"))
    assert runner.slept == pytest.approx(10.0)


# --- observability --------------------------------------------------------

def test_collector_config_structure():
    cfg = _cfg()
    conf = observability.collector_config(cfg)
    jobs = {j["job_name"]
            for j in conf["receivers"]["prometheus"]["config"]["scrape_configs"]}
    assert {"vllm-metrics", "dcgm-exporter", "dcgm-exporter-pods",
            "kubernetes-nodes", "kubernetes-cadvisor"} <= jobs
    mp = conf["service"]["pipelines"]["metrics"]
    assert "prometheusremotewrite" in mp["exporters"]
    assert mp["processors"][0] == "memory_limiter"
    assert conf["service"]["pipelines"]["traces"]["exporters"] == ["debug"]
    assert cfg.otel_namespace in conf["exporters"]["prometheusremotewrite"]["endpoint"]


def test_config_files_are_json_and_yaml():
    """The ConfigMaps' config files are JSON (no PyYAML in the builders),
    which the YAML readers of Prometheus and the collector parse."""
    cfg = _cfg()
    cm = observability.collector_manifests(cfg)[0]
    text = cm["data"]["collector.yaml"]
    assert json.loads(text) == yaml.safe_load(text) == observability.collector_config(cfg)


def test_observability_setup_applies_everything():
    cfg = _cfg()
    runner = FakeRunner([("wait --for=condition=Ready pods", (0, "ok", ""))])
    observability.setup(cfg, infra.KubeCtl(runner, "kc"))
    applied = "\n".join(t or "" for _, t in runner.commands)
    assert "otel-prometheus" in applied
    assert "--web.enable-remote-write-receiver" in applied
    assert "dcgm-exporter" in applied and "tpu-metrics-exporter" not in applied
    assert "otel-collector" in applied and "ClusterRoleBinding" in applied
    assert f"name: {cfg.otel_namespace}" in applied
    # the dashboard and the alert rules ship, never skipped
    assert "tpuserve-grafana-dashboard" in applied
    assert "kind: PrometheusRule" in applied and "tpuserve-alertmanager-config" in applied


def test_observability_verify_with_fetch():
    cfg = _cfg()
    seen = []

    def fetch(path):
        seen.append(path)
        if "label" in path:
            return '{"status":"success","data":["tpu-serve"]}'
        if "vllm_request_total" in path:
            return '{"status":"success","data":{"result":[{"value":[0,"1"]}]}}'
        return '{"status":"success","data":{"result":[]}}'
    res = observability.verify(cfg, infra.KubeCtl(FakeRunner(), "kc"), fetch=fetch)
    assert res["cluster label present"] is True
    assert res["engine request metric"] is True
    assert res["GPU utilization metric"] is False    # soft failure, not raise
    assert "DCGM_FI_DEV_GPU_UTIL%7Bjob%3D%22dcgm-exporter%22%7D" in seen[-1]


def test_dcgm_exporter_manifests():
    cfg = _cfg()
    ds, svc = observability.dcgm_exporter_manifests(cfg)
    assert ds["kind"] == "DaemonSet" and svc["kind"] == "Service"
    assert svc["spec"]["ports"][0]["name"] == "metrics"
    spec = ds["spec"]["template"]["spec"]
    c = spec["containers"][0]
    assert c["image"].startswith("nvcr.io/nvidia/k8s/dcgm-exporter:")
    env = {e["name"]: e["value"] for e in c["env"]}
    assert env["DCGM_EXPORTER_INTERVAL"] == "5000"       # the reference's 5 s
    assert "resources" not in c                           # takes no card
    assert spec["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    # no scrape annotation: only the dcgm-exporter jobs read it
    assert "annotations" not in ds["spec"]["template"]["metadata"]
    local_ds, _ = observability.dcgm_exporter_manifests(_cfg(provider="local"))
    assert local_ds["spec"]["template"]["spec"]["nodeSelector"] == {
        "nvidia.com/gpu.present": "true"}


# --- CLI ------------------------------------------------------------------

def test_cli_dry_run_deploy_full_pipeline(tmp_path, monkeypatch):
    from tpuserve_torch.provision import cli
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TPUSERVE_PROVIDER", "local")
    assert cli.main(["--workdir", str(tmp_path), "--dry-run", "deploy"]) == 0
    assert latest_inventory(str(tmp_path)) is None


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_cli_dry_run_deploy_every_preset(preset, tmp_path, monkeypatch):
    """Every preset's dry-run deploy exits 0 (gke needs a project and a
    registry, as the JAX provisioner does)."""
    from tpuserve_torch.provision import cli
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("TPUSERVE_PROJECT", "proj")
    monkeypatch.setenv("TPUSERVE_IMAGE_REGISTRY", "us-docker.pkg.dev/proj/tpuserve")
    assert cli.main(["--preset", preset, "--workdir", str(tmp_path),
                     "--dry-run", "deploy"]) == 0


def test_cli_requires_subcommand():
    from tpuserve_torch.provision import cli
    assert cli.main([]) == 1


def test_cli_cleanup_no_inventories(tmp_path, capsys):
    from tpuserve_torch.provision import cli
    assert cli.main(["--workdir", str(tmp_path), "--dry-run", "cleanup"]) == 0
    assert "nothing to clean up" in capsys.readouterr().out


def test_cli_test_without_deploy_errors(tmp_path):
    from tpuserve_torch.provision import cli
    assert cli.main(["--workdir", str(tmp_path), "--dry-run", "test"]) != 0


# --- container image path ------------------------------------------------

def test_resolve_image_with_registry():
    from tpuserve_torch.provision import image
    cfg = _cfg(image_registry="us-central1-docker.pkg.dev/proj/tpuserve")
    assert image.resolve_image(cfg) == \
        "us-central1-docker.pkg.dev/proj/tpuserve/tpuserve-torch:latest"
    assert image.resolve_image(_cfg()) == "tpuserve-torch:latest"


def test_ensure_image_gke_builds_the_port_image_and_pushes():
    from tpuserve_torch.provision import image
    cfg = _cfg(image_registry="us-central1-docker.pkg.dev/proj/tpuserve")
    runner = FakeRunner()
    ref = image.ensure_image(cfg, runner, workdir=str(ROOT))
    argvs = runner.argvs()
    assert f"docker build -t {ref} -f {ROOT}/tpuserve_torch/provision/Dockerfile " \
           f"{ROOT}" in argvs
    assert any("gcloud auth configure-docker" in a for a in argvs)
    assert f"docker push {ref}" in argvs


def test_dockerfile_builds_the_kernels_where_the_tree_looks():
    from tpuserve_torch.provision import image
    path = image.find_dockerfile(str(ROOT))
    text = Path(path).read_text()
    assert path == str(ROOT / "tpuserve_torch" / "provision" / "Dockerfile")
    assert "_build.build()" in text and "native_available()" in text
    assert "WORKDIR /opt/tpuserve" in text and "PYTHONPATH=/opt/tpuserve" in text
    assert "-devel" in text.split("FROM ", 1)[1].splitlines()[0]
    assert "jax" not in text


def test_ensure_image_gke_requires_registry():
    from tpuserve_torch.provision import image
    with pytest.raises(RuntimeError, match="image_registry"):
        image.ensure_image(_cfg(), FakeRunner(), workdir=".")


def test_ensure_image_local_kind_load():
    from tpuserve_torch.provision import image
    runner = FakeRunner()
    image.ensure_image(_cfg(provider="local", project=""), runner, workdir=".",
                       context="kind-smoke")
    argvs = runner.argvs()
    assert any(a.startswith("docker build") for a in argvs)
    assert "kind load docker-image tpuserve-torch:latest --name smoke" in argvs


def test_ensure_image_skipped_when_prebuilt():
    from tpuserve_torch.provision import image
    runner = FakeRunner()
    assert image.ensure_image(_cfg(build_image=False, image_registry="gcr.io/proj"),
                              runner) == "gcr.io/proj/tpuserve-torch:latest"
    assert runner.commands == []


def test_wait_pods_fails_fast_on_image_pull_backoff(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_TOKEN", raising=False)
    cfg = _cfg(hf_token_file=str(tmp_path / "missing"))
    runner = FakeRunner([
        ("wait --for=condition=complete", (0, "", "")),
        ("wait --for=condition=Ready", (1, "", "timed out")),
        ("state.waiting.reason", (0, "ImagePullBackOff\n", "")),
    ])
    with pytest.raises(RuntimeError, match="not pullable"):
        serving.deploy(cfg, infra.KubeCtl(runner, "kc"))
    assert sum("wait --for=condition=Ready" in a for a in runner.argvs()) == 1


def test_engine_deployment_pp_lora_backpressure_knobs():
    cfg = _cfg(tensor_parallel=1, pipeline_parallel=4, max_waiting=128,
               gpus_per_node=4, machine_type="a3-highgpu-4g")
    _, c = _engine_container(cfg)
    cmd = c["command"]
    assert ["--pp", "4"] == cmd[cmd.index("--pp"):cmd.index("--pp") + 2]
    assert "--tp" not in cmd
    assert c["resources"]["limits"]["nvidia.com/gpu"] == "4"
    assert ["--max-waiting", "128"] == \
        cmd[cmd.index("--max-waiting"):cmd.index("--max-waiting") + 2]
    _, c = _engine_container(_cfg(tensor_parallel=1,
                                  lora_modules={"sql": "/models/adapters/sql"}))
    cmd = c["command"]
    assert cmd[cmd.index("--lora-modules") + 1] == "sql=/models/adapters/sql"


def _nodes(n: int) -> dict:
    return {"gpus_per_node": n, "machine_type": f"a3-highgpu-{n}g"}


def test_config_rejects_incoherent_parallelism():
    with pytest.raises(ValueError, match="mutually exclusive"):
        DeployConfig(tensor_parallel=4, pipeline_parallel=2, **_nodes(4)).validate()
    with pytest.raises(ValueError, match="disagg"):
        DeployConfig(tensor_parallel=1, pipeline_parallel=2, **_nodes(2),
                     disaggregated=True).validate()
    with pytest.raises(ValueError, match="single-GPU"):
        DeployConfig(tensor_parallel=4, **_nodes(4),
                     lora_modules={"a": "/x"}).validate()
    with pytest.raises(ValueError, match="adapter names"):
        DeployConfig(tensor_parallel=1, lora_modules={"a=b": "/x"}).validate()
    with pytest.raises(ValueError, match="single-host"):
        # one a3-highgpu-1g node has 1 GPU; 4 stages can't schedule
        DeployConfig(tensor_parallel=1, pipeline_parallel=4).validate()
    with pytest.raises(ValueError, match="collides"):
        DeployConfig(tensor_parallel=1, model="m", lora_modules={"m": "/x"}).validate()
    # the port's server refuses --disagg with --tp
    with pytest.raises(ValueError, match="--disagg/--role with --tp"):
        DeployConfig(tensor_parallel=2, **_nodes(2), disaggregated=True).validate()


# --- every manifest against the strict schemas ----------------------------

@pytest.mark.parametrize("provider", ["gke", "local"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_preset_manifest_validates(preset, provider):
    cfg = load_config(preset=preset, provider=provider, project="p")
    assert validate_all(e2e.all_manifests(cfg)) >= 20


def test_gateway_replicas_parameterized():
    cfg = load_config(preset="qwen3-0.6b-h100", gateway_replicas=3)
    objs = manifests.serving_manifests(cfg)
    gw = [o for o in objs if o["kind"] == "Deployment"
          and o["metadata"]["name"] == "tpuserve-gateway"]
    assert gw and gw[0]["spec"]["replicas"] == 3
    validate_all(objs)


def _find(objs, kind, name=None):
    return next(o for o in objs if o["kind"] == kind
                and (name is None or o["metadata"]["name"] == name))


@pytest.fixture(scope="module")
def base_objs():
    return e2e.all_manifests(load_config(preset="cpu-smoke"))


@pytest.fixture(scope="module")
def gke_engine():
    return _find(manifests.serving_manifests(load_config(preset="qwen3-0.6b-h100")),
                 "Deployment", "tpuserve-engine")


def test_validator_rejects_misspelled_field(base_objs):
    dep = copy.deepcopy(_find(base_objs, "Deployment"))
    dep["spec"]["template"]["spec"]["containers"][0]["comand"] = ["x"]
    with pytest.raises(ManifestError, match="comand"):
        validate_manifest(dep)


def test_validator_rejects_selector_mismatch(base_objs):
    dep = copy.deepcopy(_find(base_objs, "Deployment"))
    dep["spec"]["selector"] = {"matchLabels": {
        **dep["spec"]["selector"]["matchLabels"], "app": "other"}}
    with pytest.raises(ManifestError, match="selector"):
        validate_manifest(dep)


def test_validator_rejects_unknown_volume_mount(base_objs):
    dep = copy.deepcopy(_find(base_objs, "Deployment"))
    dep["spec"]["template"]["spec"]["containers"][0].setdefault(
        "volumeMounts", []).append({"name": "ghost", "mountPath": "/g"})
    with pytest.raises(ManifestError, match="ghost"):
        validate_manifest(dep)


def test_validator_rejects_bad_quantity(base_objs):
    pvc = copy.deepcopy(_find(base_objs, "PersistentVolumeClaim"))
    pvc["spec"]["resources"]["requests"]["storage"] = "100 gigs"
    with pytest.raises(ManifestError, match="storage"):
        validate_manifest(pvc)


def test_validator_rejects_unvendored_kind():
    with pytest.raises(ManifestError, match="no vendored schema"):
        validate_manifest({"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": "x", "namespace": "y"}, "spec": {}})


def test_validator_rejects_bad_probe_port(base_objs):
    dep = copy.deepcopy(_find(base_objs, "Deployment"))
    c = dep["spec"]["template"]["spec"]["containers"][0]
    c["readinessProbe"] = {"httpGet": {"path": "/healthz", "port": "nope"}}
    with pytest.raises(ManifestError, match="nope"):
        validate_manifest(dep)


@pytest.mark.parametrize("resources, match", [
    ({"limits": {"nvidia.com/gpu": "0.5"}}, "whole"),
    ({"limits": {"nvidia.com/gpu": "2"}, "requests": {"nvidia.com/gpu": "1"}},
     "overcommitted"),
    ({"requests": {"nvidia.com/gpu": "1"}}, "without a limit"),
])
def test_validator_rejects_bad_gpu_request(gke_engine, resources, match):
    dep = copy.deepcopy(gke_engine)
    dep["spec"]["template"]["spec"]["containers"][0]["resources"] = resources
    with pytest.raises(ManifestError, match=match):
        validate_manifest(dep)


def test_validator_accepts_equal_gpu_request(gke_engine):
    dep = copy.deepcopy(gke_engine)
    dep["spec"]["template"]["spec"]["containers"][0]["resources"] = {
        "limits": {"nvidia.com/gpu": 2}, "requests": {"nvidia.com/gpu": "2"}}
    validate_manifest(dep)


def test_engine_perf_knobs_reach_container_args():
    cfg = load_config(preset="qwen3-0.6b-h100", quantization="int8",
                      kv_cache_dtype="int8", speculative_k=4, multi_step=16)
    objs = manifests.serving_manifests(cfg)
    joined = " ".join(_find(objs, "Deployment", "tpuserve-engine")
                      ["spec"]["template"]["spec"]["containers"][0]["command"])
    assert "--quantization int8" in joined
    assert "--kv-cache-dtype int8" in joined
    assert "--speculative-k 4" in joined
    assert "--multi-step 16" in joined
    validate_all(objs)


def test_gateway_api_manifests_validate():
    cfg = load_config(preset="qwen3-0.6b-h100")
    objs = manifests.gateway_api_manifests(cfg)
    assert [o["kind"] for o in objs] == ["Gateway", "HTTPRoute"]
    validate_all(objs)
    ref = objs[1]["spec"]["rules"][0]["backendRefs"][0]
    assert ref["name"] == "tpuserve-gateway" and ref["port"] == 80
    assert objs[0]["spec"]["gatewayClassName"] == cfg.gateway_class


# --- the environment-gated e2e command ------------------------------------

def test_offline_validates_every_topology(capsys):
    total = e2e.offline_validate()
    out = capsys.readouterr().out
    assert total > 100
    for name in e2e.TOPOLOGIES:
        assert name in out


def test_run_e2e_offline_prints_limitation(monkeypatch, capsys):
    monkeypatch.setattr(e2e, "detect_runtime", lambda: (False, "missing tools: docker"))
    e2e.run_e2e(DeployConfig(), DryRunRunner())
    out = capsys.readouterr().out
    assert "LIMITATION" in out and "no live cluster exercised" in out


class RecordingRunner(DryRunRunner):
    def __init__(self):
        super().__init__()
        self.calls = []

    def run(self, argv, **kw):
        self.calls.append(list(argv))
        return super().run(argv, **kw)


def test_run_e2e_live_branch_creates_and_tears_down(monkeypatch):
    monkeypatch.setattr(e2e, "detect_runtime", lambda: (True, "mocked"))
    deployed = []
    from tpuserve_torch.provision import cli
    monkeypatch.setattr(cli, "deploy", lambda cfg, runner, workdir: deployed.append(cfg))
    runner = RecordingRunner()
    e2e.run_e2e(DeployConfig(), runner)
    assert runner.calls[0][:3] == ["kind", "create", "cluster"]
    assert runner.calls[-1][:3] == ["kind", "delete", "cluster"]
    assert deployed and deployed[0].provider == "local"


def test_live_branch_tears_down_on_deploy_failure(monkeypatch):
    from tpuserve_torch.provision import cli

    def boom(cfg, runner, workdir):
        raise RuntimeError("smoke failed")
    monkeypatch.setattr(cli, "deploy", boom)
    runner = RecordingRunner()
    with pytest.raises(RuntimeError):
        e2e.live_kind_e2e(DeployConfig(), runner)
    assert runner.calls[-1][:3] == ["kind", "delete", "cluster"]


def test_detect_runtime_reports_missing_tools(monkeypatch):
    monkeypatch.setattr(e2e.shutil, "which", lambda t: None)
    ok, reason = e2e.detect_runtime()
    assert not ok and "missing tools" in reason


def test_detect_runtime_requires_live_daemon(monkeypatch):
    monkeypatch.setattr(e2e.shutil, "which", lambda t: "/usr/bin/" + t)

    def fake_run(argv, capture_output=True, timeout=30):
        return subprocess.CompletedProcess(argv, 1, b"", b"Cannot connect to the Docker daemon")
    monkeypatch.setattr(e2e.subprocess, "run", fake_run)
    ok, reason = e2e.detect_runtime()
    assert not ok and "daemon unreachable" in reason


def test_cli_e2e_subcommand_wired(monkeypatch):
    monkeypatch.setattr(e2e, "detect_runtime", lambda: (False, "hermetic test"))
    from tpuserve_torch.provision import cli
    assert cli.main(["e2e"]) == 0


def test_serving_e2e_gate_guided_rides_fused_windows():
    """The serving-side gate of the e2e file, on the port's server and
    engine (CPU): every guided mode through the HTTP surface, SSE
    included, against a fused-window engine, served by grammar-FSM
    windows."""
    import re
    from tpuserve_torch.runtime import CacheConfig, Engine, EngineConfig, SchedulerConfig
    from tpuserve_torch.runtime.guided import JsonStateMachine
    from tpuserve_torch.server.openai_api import OpenAIServer, ServerConfig

    eng = Engine(EngineConfig(
        model="tiny-qwen3",
        cache=CacheConfig(block_size=4, num_blocks=128, max_blocks_per_seq=32),
        scheduler=SchedulerConfig(max_num_seqs=8, min_prefill_bucket=8, min_decode_bucket=2),
        multi_step=4), device="cpu")
    srv = OpenAIServer(eng, ServerConfig(host="127.0.0.1", port=0))
    base = f"http://127.0.0.1:{srv.start(warmup=False)}"

    def post(path, body, stream=False):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = r.read()
        if not stream:
            return json.loads(raw)
        return [json.loads(ln[6:]) for ln in raw.decode().splitlines()
                if ln.startswith("data: ") and not ln.endswith("[DONE]")]

    try:
        body = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "json please"}],
            "response_format": {"type": "json_object"}, "seed": 11, "max_tokens": 32})
        text = body["choices"][0]["message"]["content"]
        JsonStateMachine().feed(text)
        assert text.lstrip().startswith("{")
        chunks = post("/v1/completions", {
            "prompt": "x", "guided_regex": "(yes|no){1,2}", "seed": 4,
            "temperature": 0.8, "max_tokens": 16, "stream": True}, stream=True)
        text = "".join(c["choices"][0]["text"] for c in chunks)
        assert re.fullmatch("(yes|no){1,2}", text), text
        chunks = post("/v1/completions", {
            "prompt": "x", "guided_choice": ["alpha", "beta"], "seed": 8,
            "temperature": 0.9, "max_tokens": 16, "stream": True}, stream=True)
        text = "".join(c["choices"][0]["text"] for c in chunks)
        assert text in ("alpha", "beta")
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
        assert eng.stats.guided_fsm_windows >= 3
        assert eng.stats.guided_fsm_requests >= 3
    finally:
        srv.shutdown()


# --- local mode: the rendered cpu-smoke commands as processes -------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_http(url: str, proc, deadline: float) -> None:
    while time.monotonic() < deadline:
        assert proc.poll() is None, f"process exited with {proc.returncode}"
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                if r.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"{url} never answered")


def test_local_mode_rendered_commands_serve_the_smoke_tests(tmp_path):
    """The ``cpu-smoke`` engine and gateway commands as rendered (``python``
    this interpreter, ``--port`` free, ``/models`` under a temp dir, the
    engine's literal env), ``run_local_smoke_tests`` through the gateway,
    then both out with code 0 on SIGTERM.  ``--no-warmup`` and a small
    cache are the only additions, to keep the case quick."""
    cfg = load_config(preset="cpu-smoke")
    objs = manifests.serving_manifests(cfg)
    eng_c = _find(objs, "Deployment", "tpuserve-engine")["spec"]["template"]["spec"][
        "containers"][0]
    gw_c = _find(objs, "Deployment", "tpuserve-gateway")["spec"]["template"]["spec"][
        "containers"][0]
    models = str(tmp_path / "models")
    eng_port, gw_port = _free_port(), _free_port()

    def local(cmd, **flags):
        cmd = [sys.executable] + cmd[1:]
        for flag, value in flags.items():
            cmd[cmd.index(flag) + 1] = value
        return [models + a[len("/models"):] if a.startswith("/models") else a for a in cmd]
    eng_cmd = local(eng_c["command"], **{"--port": str(eng_port)}) + [
        "--no-warmup", "--block-size", "4", "--num-blocks", "64",
        "--max-blocks-per-seq", "16"]
    assert eng_cmd[eng_cmd.index("--device") + 1] == "cpu"
    gw_cmd = local(gw_c["command"], **{"--port": str(gw_port),
                                       "--backend": f"http://127.0.0.1:{eng_port}"})
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               **{e["name"]: e["value"].replace("/models", models)
                  for e in eng_c["env"] if "value" in e})
    procs = []
    try:
        procs.append(subprocess.Popen(eng_cmd, cwd=tmp_path, env=env,
                                      stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        _wait_http(f"http://127.0.0.1:{eng_port}/readyz", procs[0], time.monotonic() + 120)
        procs.append(subprocess.Popen(gw_cmd, cwd=tmp_path, env=env,
                                      stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        _wait_http(f"http://127.0.0.1:{gw_port}/healthz", procs[1], time.monotonic() + 60)
        res = smoke.run_local_smoke_tests(f"http://127.0.0.1:{gw_port}", cfg.model,
                                          timeout=60)
        assert cfg.model in res["models"]
        assert json.loads(res["completion"])["usage"]["completion_tokens"] == 32
        for proc in reversed(procs):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
