"""The port's provisioner held against the JAX provisioner.

- For ``cpu-smoke``, every manifest and the local deploy's ordered command
  list equal the JAX provisioner's after one declared map (``JAX_TO_PORT``
  below, the whole of it): module names, ``JAX_PLATFORMS=cpu`` -> ``--device
  cpu``, the inventory's name, the image, the exporter.
- The JAX validator accepts every manifest the port renders; the port's
  validator rejects each broken manifest the JAX one rejects.
- Every rendered engine, gateway, autoscaler and download command parses
  with the port's own parsers (the engine's ``build_parser`` then
  ``_check_topology``), so no preset renders a command the port refuses.
- The two rules of tpulint P7 on the port: every ``TPUSERVE_*`` a manifest
  sets is read somewhere in ``tpuserve_torch``, and every ``DeployConfig``
  field is read by a provision module.
- The two packages' ``cleanup``s leave each other's inventories alone; the
  alert rules and the dashboard match the JAX generators'.
"""

import ast
import copy
import dataclasses
import json
import os
import re
from pathlib import Path

import pytest
import yaml

from tpuserve.provision import config as jax_config
from tpuserve.provision import e2e as jax_e2e
from tpuserve.provision import inventory as jax_inventory
from tpuserve.provision import validate as jax_validate
from tpuserve_torch.provision import cluster, e2e, infra, manifests, observability
from tpuserve_torch.provision import inventory, validate
from tpuserve_torch.provision.config import PRESETS, DeployConfig, load_config

from tests.test_torch_provision import FakeRunner

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"


# --------------------------------------------------------------------------
# the declared map, JAX provisioner -> port, for the cpu-smoke deploy
# --------------------------------------------------------------------------

#: whole strings renamed: the modules each container runs, the image, the
#: TPU exporter's objects and app label -> the DCGM exporter's
JAX_TO_PORT = {
    "tpuserve.server": "tpuserve_torch.server",
    "tpuserve.server.gateway": "tpuserve_torch.server.gateway",
    "tpuserve.models.download": "tpuserve_torch.models.download",
    "tpuserve.autoscale": "tpuserve_torch.autoscale",
    "tpuserve:latest": "tpuserve-torch:latest",
    "tpu-metrics": "dcgm-exporter",
    "tpu-metrics-exporter": "dcgm-exporter",
    "tpu-metrics-exporter-pods": "dcgm-exporter-pods",
}
#: env the port's engine does not take: JAX_PLATFORMS=cpu is its
#: ``--device cpu`` (after ``--port``), and the XLA compile cache has no
#: counterpart (the image carries the built kernels)
DROPPED_ENV = ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")
#: the TPU exporter's API-reading RBAC, which the DCGM exporter does not need
DROPPED_OBJECTS = (("ServiceAccount", "tpu-metrics-exporter"),
                   ("ClusterRole", "tpu-metrics-exporter"),
                   ("ClusterRoleBinding", "tpu-metrics-exporter"))
#: the ordered local deploy's command lines, JAX -> port: the preflight reads
#: the GPU resource, the image is the port's (its own Dockerfile), the last
#: verify query reads the DCGM exporter's utilisation
COMMAND_MAP = {
    "{.status.allocatable.google\\.com/tpu}": "{.status.allocatable.nvidia\\.com/gpu}",
    "-t tpuserve:latest -f REPO/Dockerfile REPO":
        "-t tpuserve-torch:latest -f REPO/tpuserve_torch/provision/Dockerfile REPO",
    "docker-image tpuserve:latest": "docker-image tpuserve-torch:latest",
    "query=tpu_duty_cycle_percent": "query=DCGM_FI_DEV_GPU_UTIL%7Bjob%3D%22dcgm-exporter%22%7D",
}


def _rename(x):
    if isinstance(x, str):
        return JAX_TO_PORT.get(x, x)
    if isinstance(x, list):
        return [_rename(v) for v in x]
    if isinstance(x, dict):
        return {k: _rename(v) for k, v in x.items()}
    return x


def _map_container(c: dict) -> None:
    cmd = c.get("command") or []
    if cmd[:3] == ["python", "-m", "tpuserve_torch.server"]:
        names = [e["name"] for e in c.get("env", [])]
        if "JAX_PLATFORMS" in names:
            i = cmd.index("--port") + 2
            c["command"] = cmd[:i] + ["--device", "cpu"] + cmd[i:]
    if "env" in c:
        c["env"] = [e for e in c["env"] if e["name"] not in DROPPED_ENV]


def map_jax_manifest(obj: dict) -> dict:
    """A JAX manifest under the map (a ConfigMap's config files parsed)."""
    obj = _rename(_config_files(obj))
    pod = (obj.get("spec") or {}).get("template", {}).get("spec")
    for c in (pod or {}).get("containers", []):
        _map_container(c)
    return obj


def _config_files(obj: dict) -> dict:
    """A ConfigMap's config files parsed (YAML text on the JAX side, JSON on
    the port's: compared as documents)."""
    out = copy.deepcopy(obj)
    if out["kind"] == "ConfigMap":
        for k, v in (out.get("data") or {}).items():
            if k.endswith((".yml", ".yaml")) and isinstance(v, str):
                out["data"][k] = yaml.safe_load(v)
    return out


def _comparable(obj: dict) -> dict:
    obj = _config_files(obj)
    if obj["kind"] == "DaemonSet" and obj["metadata"]["name"] == "dcgm-exporter":
        # the exporter's pod is NVIDIA's, not the repo's: its name, labels
        # and selector are compared
        obj = copy.deepcopy(obj)
        obj["spec"]["template"] = {"metadata": obj["spec"]["template"]["metadata"]}
        obj["spec"]["template"]["metadata"].pop("annotations", None)
    return obj


def _port_manifests(cfg):
    """The port's objects in the JAX e2e's ``_all_manifests`` order."""
    return ([cluster.storage_class_manifest(cfg), cluster.dcgm_servicemonitor_manifest(cfg)]
            + manifests.serving_manifests(cfg)
            + observability.dcgm_exporter_manifests(cfg)
            + observability.collector_rbac_manifests(cfg)
            + observability.otel_prometheus_manifests(cfg)
            + observability.collector_manifests(cfg))


def test_cpu_smoke_manifests_equal_jax_after_the_map():
    jax_objs = jax_e2e._all_manifests(jax_config.load_config(preset="cpu-smoke"))
    mapped = [map_jax_manifest(o) for o in jax_objs
              if (o["kind"], o["metadata"]["name"]) not in DROPPED_OBJECTS]
    port = _port_manifests(load_config(preset="cpu-smoke"))
    assert [(o["kind"], o["metadata"]["name"]) for o in mapped] == \
        [(o["kind"], o["metadata"]["name"]) for o in port]
    for a, b in zip(mapped, port):
        assert _comparable(a) == _comparable(b), (a["kind"], a["metadata"]["name"])


def test_the_map_is_not_the_identity():
    """The map does change what it claims to: without it the engine
    containers differ."""
    jax_objs = jax_e2e._all_manifests(jax_config.load_config(preset="cpu-smoke"))
    port = _port_manifests(load_config(preset="cpu-smoke"))
    jax_eng = next(o for o in jax_objs if o["metadata"]["name"] == "tpuserve-engine")
    port_eng = next(o for o in port if o["metadata"]["name"] == "tpuserve-engine")
    assert jax_eng != port_eng
    assert map_jax_manifest(jax_eng) == port_eng
    jax_cm = next(o for o in jax_objs if o["metadata"]["name"] == "otel-collector-config")
    assert "tpu-metrics-exporter" in jax_cm["data"]["collector.yaml"]


FAKE_KUBECONFIG = "apiVersion: v1\nkind: Config\ncurrent-context: kind-tpuserve\n"
MODELS_JSON = json.dumps({"object": "list", "data": [{"id": "tiny-qwen3"},
                                                     {"id": "Qwen/Qwen3-0.6B"}]})
COMPLETION_JSON = json.dumps(
    {"id": "cmpl-1", "object": "text_completion",
     "choices": [{"index": 0, "text": " smoke ok", "finish_reason": "length"}]})
PROM_OK = json.dumps({"status": "success",
                      "data": {"result": [{"metric": {}, "value": [0, "1"]}]}})


def deploy_responses(provider: str):
    """Canned outputs that drive every layer down its success path (the
    JAX golden test's, with the GPU preflight's)."""
    common = [
        ("config view --raw --minify", FAKE_KUBECONFIG),
        ("config current-context", "kind-tpuserve\n"),
        ("get storageclass", "standard\n"),
        ("status prometheus", (1, "", "release: not found")),
        ("get crd servicemonitors", "servicemonitors.monitoring.coreos.com\n"),
        ("logs curl-gw-models", MODELS_JSON),
        ("logs curl-gw-completion", COMPLETION_JSON),
        ("jsonpath={.status.loadBalancer.ingress[0].ip}", ""),
        ("jsonpath={.spec.clusterIP}", "10.96.0.10\n"),
        ("get svc -n tpu-serve -o jsonpath",
         "tpuserve ClusterIP 10.96.0.11 8000\n"
         "tpuserve-gateway ClusterIP 10.96.0.10 80\n"),
        ("curl-verify", PROM_OK),
    ]
    if provider == "gke":
        return [
            ("clusters describe", (0, "", "")),
            ("node-pools describe", (1, "", "not found")),
            ("get nodes -o jsonpath", "gke-gpu-node-1 1\n"),
        ] + common
    return [("get nodes -o jsonpath", "kind-control-plane <none>\n")] + common


def normalize(argv: tuple, workdir: str) -> str:
    s = " ".join(argv)
    s = s.replace(workdir, "WORKDIR").replace(str(ROOT), "REPO")
    s = re.sub(r"tpu-serve-[0-9a-f]{8}", "tpu-serve-CLUSTERID", s)
    s = re.sub(r"curl-gw-(models|completion)-\d{6}", r"curl-gw-\1-TESTID", s)
    return re.sub(r"curl-verify-\d{6}", "curl-verify-QUERYID", s)


def run_deploy(provider: str, workdir: str, cfg=None) -> list[str]:
    from tpuserve_torch.provision import cli
    runner = FakeRunner(responses=deploy_responses(provider))
    if cfg is None:
        cfg = (load_config(preset="qwen3-0.6b-h100", project="test-proj",
                           image_registry="us-docker.pkg.dev/test-proj/tpuserve")
               if provider == "gke" else load_config(preset="cpu-smoke"))
    cwd = os.getcwd()
    os.chdir(ROOT)            # the image layer finds the Dockerfile under the checkout
    try:
        cli.deploy(cfg, runner, workdir=workdir)
    finally:
        os.chdir(cwd)
    return [normalize(argv, workdir) for argv, _ in runner.commands]


def test_local_deploy_commands_equal_jax_golden_after_the_map(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    port = run_deploy("local", str(tmp_path))
    jax = (GOLDEN / "deploy_local_commands.txt").read_text().splitlines()
    mapped = []
    for line in jax:
        for a, b in COMMAND_MAP.items():
            line = line.replace(a, b)
        mapped.append(line)
    assert port == mapped
    # the inventory is the port's own name
    inv = inventory.latest_inventory(str(tmp_path))
    assert os.path.basename(inv).startswith("gpu-inventory-")
    assert jax_inventory.latest_inventory(str(tmp_path)) is None


# --------------------------------------------------------------------------
# validators
# --------------------------------------------------------------------------

@pytest.mark.parametrize("provider", ["gke", "local"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_jax_validator_accepts_every_port_manifest(preset, provider):
    objs = e2e.all_manifests(load_config(preset=preset, provider=provider, project="p"))
    assert jax_validate.validate_all(objs) == validate.validate_all(objs)


def _mutations():
    """Broken manifests a strict API server would reject: (id, kind, name,
    mutate)."""
    def c0(o):
        return o["spec"]["template"]["spec"]["containers"][0]

    return [
        ("misspelled-container-field", "Deployment", "tpuserve-engine",
         lambda o: c0(o).__setitem__("comand", ["x"])),
        ("misspelled-top-field", "Service", "tpuserve-gateway",
         lambda o: o.__setitem__("sepc", {})),
        ("selector-mismatch", "Deployment", "tpuserve-gateway",
         lambda o: o["spec"].__setitem__("selector", {"matchLabels": {"app": "other"}})),
        ("unknown-volume", "Deployment", "tpuserve-engine",
         lambda o: c0(o)["volumeMounts"].append({"name": "ghost", "mountPath": "/g"})),
        ("bad-quantity", "PersistentVolumeClaim", "model-pvc",
         lambda o: o["spec"]["resources"]["requests"].__setitem__("storage", "100 gigs")),
        ("bad-probe-port", "Deployment", "tpuserve-engine",
         lambda o: c0(o).__setitem__("readinessProbe", {"httpGet": {"port": "nope"}})),
        ("duplicate-containers", "Deployment", "tpuserve-gateway",
         lambda o: o["spec"]["template"]["spec"]["containers"].append(dict(c0(o)))),
        ("bad-name", "Service", "tpuserve-engine",
         lambda o: o["metadata"].__setitem__("name", "Bad_Name")),
        ("missing-namespace", "ConfigMap", "phi-chat-template",
         lambda o: o["metadata"].pop("namespace")),
        ("bad-port-number", "Service", "tpuserve-gateway",
         lambda o: o["spec"]["ports"][0].__setitem__("port", 70000)),
        ("bad-enum", "Service", "tpuserve-gateway",
         lambda o: o["spec"].__setitem__("type", "Balanced")),
        ("wrong-type", "Deployment", "tpuserve-engine",
         lambda o: o["spec"].__setitem__("replicas", "one")),
        ("empty-containers", "Job", "model-download",
         lambda o: o["spec"]["template"]["spec"].__setitem__("containers", [])),
        ("bad-env-name", "Deployment", "tpuserve-engine",
         lambda o: c0(o)["env"].append({"name": "1BAD", "value": "x"})),
        ("secret-not-base64", "Secret", "hf-token",
         lambda o: o.__setitem__("data", {"token": "not base64!"})),
        ("unvendored-kind", "Service", "tpuserve-engine",
         lambda o: o.__setitem__("kind", "Ingress")),
        ("wrong-api-version", "Deployment", "tpuserve-gateway",
         lambda o: o.__setitem__("apiVersion", "apps/v1beta1")),
        ("bad-label-value", "Deployment", "tpuserve-engine",
         lambda o: o["metadata"]["labels"].__setitem__("app", "-bad-")),
        ("bad-servicemonitor-interval", "ServiceMonitor", "dcgm-exporter",
         lambda o: o["spec"]["endpoints"][0].__setitem__("interval", "5 seconds")),
        ("multiport-unnamed", "Service", "tpuserve-engine",
         lambda o: o["spec"]["ports"].append({"port": 9})),
    ]


@pytest.mark.parametrize("case", _mutations(), ids=lambda c: c[0])
def test_port_validator_rejects_what_jax_rejects(case):
    _, kind, name, mutate = case
    cfg = load_config(preset="qwen3-0.6b-h100", project="p")
    objs = e2e.all_manifests(cfg) + [manifests.hf_token_secret(cfg, "tok")]
    obj = copy.deepcopy(next(o for o in objs if o["kind"] == kind
                             and o["metadata"]["name"] == name))
    validate.validate_manifest(obj)
    mutate(obj)
    with pytest.raises(jax_validate.ManifestError):
        jax_validate.validate_manifest(obj)
    with pytest.raises(validate.ManifestError):
        validate.validate_manifest(obj)


def test_schema_evaluator_matches_jsonschema_on_every_schema():
    """The port's schema evaluator gives jsonschema's verdict on every
    vendored schema, for valid objects and for objects broken at every
    level (a key added to each mapping in turn)."""
    import jsonschema
    cfg = load_config(preset="qwen2-72b-tp8-h100x8", project="p")
    objs = (e2e.all_manifests(cfg) + e2e.all_manifests(load_config(preset="cpu-smoke"))
            + [manifests.hf_token_secret(cfg, "tok")])

    def mappings(x, path=()):
        if isinstance(x, dict):
            yield path
            for k, v in x.items():
                yield from mappings(v, path + (k,))
        elif isinstance(x, list):
            for i, v in enumerate(x):
                yield from mappings(v, path + (i,))
    checked = 0
    for obj in objs:
        schema = validate.SCHEMAS[(obj["apiVersion"], obj["kind"])]
        for path in mappings(obj):
            broken = copy.deepcopy(obj)
            target = broken
            for p in path:
                target = target[p]
            target["zz_unknown"] = 1
            want = not jsonschema.Draft202012Validator(schema).is_valid(broken)
            got = any(True for _ in validate.schema_errors(schema, broken))
            assert want == got, (obj["kind"], path)
            checked += 1
        assert not any(True for _ in validate.schema_errors(schema, obj))
    assert checked > 500


# --------------------------------------------------------------------------
# every rendered command parses with the port's own parsers
# --------------------------------------------------------------------------

def _variants():
    out = [(f"{p}/{prov}", dict(preset=p, provider=prov))
           for p in sorted(PRESETS) for prov in ("gke", "local")]
    out += [(f"topology-{name}", dict(overrides))
            for name, overrides in e2e.TOPOLOGIES.items()]
    out += [("autoscale", dict(autoscale=True)),
            ("knobs", dict(quantization="int8", kv_cache_dtype="int8", speculative_k=4,
                           multi_step=16, max_waiting=64, step_watchdog_s=2.5,
                           kv_host_bytes=1 << 30)),
            ("lora", dict(lora_modules={"sql": "/models/adapters/sql"})),
            ("no-tiers", dict(kv_tiers=False, slo_classes=False, chat_template="phi"))]
    return out


def _render(kw: dict) -> list:
    kw = dict(kw, project="p")
    return manifests.serving_manifests(load_config(**kw))


def _commands(objs) -> list:
    out = []
    for o in objs:
        pod = (o.get("spec") or {}).get("template", {}).get("spec")
        for c in (pod or {}).get("containers", []):
            if c.get("command"):
                out.append(c["command"])
    return out


def _parse_engine(args: list):
    from tpuserve_torch.server import openai_api
    ap = openai_api.build_parser()
    ns = ap.parse_args(args)
    openai_api._check_topology(ap, ns)
    openai_api.engine_config(ns)
    return ns


@pytest.mark.parametrize("variant", _variants(), ids=lambda v: v[0])
def test_every_rendered_command_parses_with_the_port_parsers(variant):
    from tpuserve_torch.autoscale import __main__ as autoscale_main
    from tpuserve_torch.models import download
    from tpuserve_torch.server import gateway
    seen = set()
    for cmd in _commands(_render(variant[1])):
        assert cmd[:2] == ["python", "-m"], cmd
        module, args = cmd[2], cmd[3:]
        seen.add(module)
        if module == "tpuserve_torch.server":
            _parse_engine(args)
        elif module == "torch.distributed.run":
            from torch.distributed.run import get_args_parser
            # the kubelet expands $(POD_INDEX) from the pod's ordinal
            targs = get_args_parser().parse_args(
                [a.replace("$(POD_INDEX)", "1") for a in args])
            assert targs.module and targs.training_script == "tpuserve_torch.server"
            assert targs.node_rank == 1 and targs.nnodes == "2"
            ns = _parse_engine(targs.training_script_args)
            assert ns.multihost and ns.tp == 8
        elif module == "tpuserve_torch.server.gateway":
            ns = gateway.build_parser().parse_args(args)
            assert ns.backend or ns.backends_url
        elif module == "tpuserve_torch.autoscale":
            autoscale_main.build_parser().parse_args(args)
        elif module == "tpuserve_torch.models.download":
            download.build_parser().parse_args(args)
        else:
            raise AssertionError(f"unexpected module {module}")
    assert {"tpuserve_torch.models.download", "tpuserve_torch.server.gateway"} <= seen


def test_a_refused_topology_fails_the_parse():
    """The check above has teeth: the port refuses --disagg with --pp, as
    the JAX server does."""
    with pytest.raises(SystemExit):
        _parse_engine(["--pp", "2", "--disagg"])


# --------------------------------------------------------------------------
# tpulint P7's two rules, on the port
# --------------------------------------------------------------------------

def _env_variants():
    return [dict(preset=p, provider=prov) for p in PRESETS for prov in ("gke", "local")] + [
        dict(faults="decode_dispatch:raise:0.02", tenants={"tenants": {}},
             model_catalog="tiny-qwen3,tiny-llama", weight_host_bytes=1 << 30,
             slo_burn=False, flight=False, devprof=False),
        dict(flight=True, flight_dir="/models/.flight")]


def test_every_manifest_env_var_is_read_by_the_port():
    names = set()
    for kw in _env_variants():
        for o in _render(kw):
            pod = (o.get("spec") or {}).get("template", {}).get("spec")
            for c in (pod or {}).get("containers", []):
                names |= {e["name"] for e in c.get("env", [])}
    tp = {n for n in names if n.startswith("TPUSERVE_")}
    assert len(tp) >= 10
    src = "\n".join(p.read_text() for p in (ROOT / "tpuserve_torch").rglob("*.py")
                    if "provision" not in p.parts)
    unread = sorted(n for n in tp if f'"{n}"' not in src and f"'{n}'" not in src)
    assert not unread, f"manifests set {unread}, which nothing in tpuserve_torch reads"


def test_every_deploy_config_field_is_read_by_a_provision_module():
    reads = set()
    for path in (ROOT / "tpuserve_torch" / "provision").glob("*.py"):
        if path.name == "config.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                reads.add(node.attr)
    unused = sorted(f.name for f in dataclasses.fields(DeployConfig) if f.name not in reads)
    assert not unused, f"DeployConfig fields no provision module reads: {unused}"


# --------------------------------------------------------------------------
# the two cleanups, the alert rules, the dashboard
# --------------------------------------------------------------------------

def _jax_record(cid):
    return jax_inventory.ClusterRecord(cluster_id=cid, cluster_name="tpu-serve",
                                       project="proj", region="r", zone="z",
                                       tpu_type="v5litepod-4")


def _port_record(cid):
    return inventory.ClusterRecord(cluster_id=cid, cluster_name="tpu-serve",
                                   project="proj", region="r", zone="z",
                                   accelerator="nvidia-h100-80gb-x1")


@pytest.mark.parametrize("first", ["port", "jax"])
def test_cleanups_leave_each_other_alone(tmp_path, first):
    from tpuserve.provision import infra as jax_infra
    from tests.test_provision import FakeRunner as JaxFakeRunner
    d = str(tmp_path)
    for mod, rec in ((jax_inventory, _jax_record("tpu-serve-aaaa0001")),
                     (inventory, _port_record("tpu-serve-bbbb0002"))):
        mod.write_inventory(rec, d)
        mod.write_details(rec, d)
        (tmp_path / rec.kubeconfig_file).write_text("kc")
    jax_files = jax_inventory.generated_files("tpu-serve-aaaa0001", d)
    port_files = inventory.generated_files("tpu-serve-bbbb0002", d)
    assert len(jax_files) == len(port_files) == 3
    running = [("clusters describe", (0, "RUNNING\n", ""))]
    if first == "port":
        assert infra.cleanup(FakeRunner(running), d) == ["tpu-serve-bbbb0002"]
        assert all(os.path.exists(p) for p in jax_files)
        assert not any(os.path.exists(p) for p in port_files)
        assert jax_infra.cleanup(JaxFakeRunner(running), d) == ["tpu-serve-aaaa0001"]
    else:
        assert jax_infra.cleanup(JaxFakeRunner(running), d) == ["tpu-serve-aaaa0001"]
        assert all(os.path.exists(p) for p in port_files)
        assert not any(os.path.exists(p) for p in jax_files)
        assert infra.cleanup(FakeRunner(running), d) == ["tpu-serve-bbbb0002"]
    assert os.listdir(d) == []


def test_alert_rules_match_the_jax_generator():
    from tools import gen_alerts
    from tpuserve_torch.provision import alerts

    def key(rules):
        return [(r["alert"], r["expr"], r["for"], r["labels"], r["annotations"]["runbook"])
                for r in rules]
    assert key(alerts.all_rules()) == key(gen_alerts.all_rules())
    assert alerts.alertmanager_config() == gen_alerts.alertmanager_config()


def test_dashboard_holds_every_jax_panel_and_selects_dcgm_by_job():
    from tools import gen_dashboard
    from tpuserve_torch.provision import dashboard
    jax = {p["title"]: p for p in gen_dashboard.build_dashboard()["panels"]}
    port = {p["title"]: p for p in dashboard.build_dashboard()["panels"]}
    assert set(jax) <= set(port)
    for title, panel in jax.items():
        assert [t["expr"] for t in panel["targets"]] == \
            [t["expr"] for t in port[title]["targets"]], title
    dcgm = [t["expr"] for title, p in port.items() if "DCGM_" in title
            for t in p["targets"]]
    assert dcgm and all('{job="' in e for e in dcgm)
    assert any('job="dcgm-exporter"' in e for e in dcgm)
    assert any('job="vllm-metrics"' in e for e in dcgm)


class _FakeNvml:
    pass


def test_registry_parse_matches_the_live_registries():
    from tpuserve_torch.provision import alerts
    from tpuserve_torch.server import metrics as m
    from tpuserve_torch.server.gpu_metrics import GpuMetricsExporter
    engine = m.ServerMetrics("x")
    GpuMetricsExporter(engine, nvml=_FakeNvml())
    live = {("engine", f.name, f.kind) for f in engine._families}
    live |= {("gateway", f.name, f.kind) for f in m.CanaryMetrics()._families}
    live |= {("autoscaler", f.name, f.kind) for f in m.AutoscalerMetrics()._families}
    parsed = {(x.source, x.family, x.kind) for x in alerts.registry()}
    assert parsed == live


def test_engine_metrics_serve_every_family_the_queries_read():
    """What phase provision checks on the card, on the CPU: the engine's
    registry (with the NVML gauges) renders every family the verify
    queries, alert rules and dashboard read from the engine job."""
    from urllib.parse import unquote
    from tpuserve_torch.provision import alerts, dashboard
    from tpuserve_torch.server import metrics as m
    from tpuserve_torch.server.gpu_metrics import GpuMetricsExporter
    engine = m.ServerMetrics("x")
    GpuMetricsExporter(engine, nvml=_FakeNvml())
    text = engine.render().decode()
    verify = [unquote(p.split("query=", 1)[1]) for _, p, _ in observability.VERIFY_QUERIES
              if "query=" in p]
    rules = [r["expr"] for r in alerts.all_rules()]
    exported = {x.family: x.exported for x in alerts.registry()}
    reads = {"verify": alerts.engine_families(verify),
             "alerts": alerts.engine_families(rules),
             "dashboard": alerts.engine_families(dashboard.exprs())}
    assert reads["verify"] == {"vllm_request_total"}   # DCGM's is the DaemonSet's job
    assert "DCGM_FI_DEV_GPU_UTIL" in reads["dashboard"]
    assert "tpuserve_hbm_headroom_bytes" in reads["alerts"]
    for k, fams in reads.items():
        missing = [f for f in fams if f"# TYPE {exported[f]} " not in text]
        assert not missing, (k, missing)
