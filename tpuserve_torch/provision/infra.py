"""Infra layer: GKE GPU cluster / node-pool provisioning and teardown.

The port of ``tpuserve/provision/infra.py``: the analog of the reference's
EC2 instance launcher and terminator (launch-instance.yaml:24-51 launches a
g6.4xlarge with the NVIDIA AMI; cleanup-instance.yaml:88-98 terminates by
ID).  Instead of an AWS AMI + kubeadm bootstrap + the NVIDIA GPU Operator,
GKE provides the control plane, installs the NVIDIA driver
(``gpu-driver-version=latest``) and runs its ``nvidia.com/gpu`` device
plugin on an ``a3-highgpu-Ng`` node pool of H100s.
"""

from __future__ import annotations

import logging
import os
import uuid

from tpuserve_torch.provision.config import DeployConfig
from tpuserve_torch.provision.inventory import (ClusterRecord, extract_cluster_id,
                                                find_inventories, generated_files,
                                                read_inventory, write_details,
                                                write_inventory)
from tpuserve_torch.provision.runner import CommandError, CommandRunner
from tpuserve_torch.provision.validate import GPU_RESOURCE

logger = logging.getLogger("tpuserve_torch.provision")

GPU_POOL = "gpu-pool"


class KubeCtl:
    """kubectl/helm invocations pinned to one kubeconfig (the reference pins
    KUBECONFIG=/etc/kubernetes/admin.conf per task, e.g.
    kubernetes-single-node.yaml:286-292)."""

    def __init__(self, runner: CommandRunner, kubeconfig: str | None = None):
        self.runner = runner
        self.kubeconfig = kubeconfig

    def _base(self, tool: str) -> list[str]:
        cmd = [tool]
        if self.kubeconfig:
            cmd += ["--kubeconfig", self.kubeconfig]
        return cmd

    def kubectl(self, *args: str, check: bool = True, timeout: float = 600.0):
        return self.runner.run(self._base("kubectl") + list(args),
                               check=check, timeout=timeout)

    def helm(self, *args: str, check: bool = True, timeout: float = 900.0):
        return self.runner.run(self._base("helm") + list(args),
                               check=check, timeout=timeout)

    def apply_manifest(self, text: str, check: bool = True):
        """kubectl apply -f - (the reference embeds manifests in playbook
        strings and pipes them the same way, kubernetes-single-node.yaml:375-401)."""
        return self.runner.run(self._base("kubectl") + ["apply", "-f", "-"],
                               check=check, input_text=text)

    def wait_nodes_ready(self, retries: int = 30, delay: float = 10.0) -> bool:
        """``kubectl get nodes`` convergence poll, retries 30 / delay 10
        (kubernetes-single-node.yaml:286-292)."""
        res = self.runner.retry(
            self._base("kubectl") + ["wait", "--for=condition=Ready",
                                     "nodes", "--all", "--timeout=10s"],
            retries=retries, delay=delay)
        return res is not None and res.ok


def new_cluster_id(cfg: DeployConfig) -> str:
    return f"{cfg.cluster_name}-{uuid.uuid4().hex[:8]}"


def provision(cfg: DeployConfig, runner: CommandRunner, workdir: str = ".",
              ) -> ClusterRecord:
    """Create (or adopt) the cluster, write the inventory/details contract,
    and run post-launch GPU preflight checks (launch-instance.yaml:120-162
    analog)."""
    os.makedirs(workdir, exist_ok=True)
    cluster_id = new_cluster_id(cfg)
    rec = ClusterRecord(
        cluster_id=cluster_id, cluster_name=cfg.cluster_name,
        project=cfg.project, region=cfg.region, zone=cfg.zone,
        accelerator=accelerator_desc(cfg), provider=cfg.provider)
    kubeconfig = os.path.join(workdir, rec.kubeconfig_file)

    if cfg.provider == "gke":
        _provision_gke(cfg, runner, rec, kubeconfig)
    else:
        _adopt_local(cfg, runner, rec, kubeconfig)

    kube = KubeCtl(runner, kubeconfig)
    # budget from the shared config (the reference's SSH-up analog,
    # launch-instance.yaml:69): each attempt costs up to 10s of
    # `kubectl wait --timeout=10s` PLUS the 10s retry delay, so the
    # retry count divides by 20 to keep wall clock ~= node_ready_timeout_s
    if not kube.wait_nodes_ready(
            retries=max(cfg.node_ready_timeout_s // 20, 1)):
        raise RuntimeError("nodes did not become Ready within the timeout")
    _preflight_gpu(cfg, kube)

    if not runner.dry_run:
        # No on-disk state for clusters that were never created — a phantom
        # inventory would become a `test`/`cleanup` target.
        write_inventory(rec, workdir)
        write_details(rec, workdir, extra={
            "Model": cfg.model, "Namespace": cfg.namespace,
            "Parallelism": cfg.parallelism_desc,
        })
    logger.info("provisioned cluster %s (%s)", rec.cluster_id, cfg.provider)
    return rec


def _provision_gke(cfg: DeployConfig, runner: CommandRunner,
                   rec: ClusterRecord, kubeconfig: str) -> None:
    if not cfg.project:
        raise ValueError("gke provider requires a GCP project id "
                         "(TPUSERVE_PROJECT or config 'project')")
    proj = ["--project", cfg.project]
    loc = ["--zone", cfg.zone]
    # Control plane (GKE owns kubeadm/CRI-O/CNI — the whole of
    # kubernetes-single-node.yaml:1-319 collapses into this one call).
    create = ["gcloud", "container", "clusters", "create", rec.cluster_name,
              *proj, *loc, "--num-nodes", "1",
              "--machine-type", "e2-standard-4",
              "--disk-size", str(cfg.disk_size_gb)]
    if cfg.gke_version:
        create += ["--cluster-version", cfg.gke_version]
    existing = runner.run(["gcloud", "container", "clusters", "describe",
                           rec.cluster_name, *proj, *loc,
                           "--format", "value(endpoint)"], check=False)
    if existing.ok and existing.stdout.strip():
        logger.info("cluster %s already exists — adopting (idempotency, "
                    "like kubeadm init's admin.conf guard)", rec.cluster_name)
        rec.endpoint = existing.stdout.strip()
    else:
        runner.run(create, timeout=1800.0)
        desc = runner.run(["gcloud", "container", "clusters", "describe",
                           rec.cluster_name, *proj, *loc,
                           "--format", "value(endpoint)"], check=False)
        rec.endpoint = desc.stdout.strip() if desc.ok else ""
    # GPU node pool (launch-instance.yaml:24-43): GKE installs the driver
    # and the nvidia.com/gpu device plugin, the GPU Operator's job in the
    # reference (kubernetes-single-node.yaml:321-348).
    pool = runner.run(["gcloud", "container", "node-pools", "describe",
                       GPU_POOL, "--cluster", rec.cluster_name, *proj, *loc],
                      check=False)
    if not pool.ok:
        runner.run(["gcloud", "container", "node-pools", "create", GPU_POOL,
                    "--cluster", rec.cluster_name, *proj, *loc,
                    "--machine-type", cfg.machine_type,
                    "--accelerator",
                    f"type={cfg.accelerator},count={cfg.gpus_per_node},"
                    "gpu-driver-version=latest",
                    "--num-nodes", str(cfg.num_nodes)],
                   timeout=1800.0)
    # Kubeconfig (admin.conf copy analog, kubernetes-single-node.yaml:267-284).
    runner.run(["gcloud", "container", "clusters", "get-credentials",
                rec.cluster_name, *proj, *loc], check=True)
    # gcloud writes to $KUBECONFIG / default; also export a per-cluster file
    # so parallel clusters never clobber each other.  --minify exports ONLY
    # the just-activated context — never the operator's other credentials.
    view = runner.run(["kubectl", "config", "view", "--raw", "--minify"],
                      check=False)
    if view.ok and view.stdout:
        with open(kubeconfig, "w") as f:
            f.write(view.stdout)
        os.chmod(kubeconfig, 0o600)


def _adopt_local(cfg: DeployConfig, runner: CommandRunner,
                 rec: ClusterRecord, kubeconfig: str) -> None:
    """CPU-smoke path: adopt whatever kubeconfig/kind/minikube cluster is
    already current (SURVEY.md §7: 'keep a kind/minikube path for CPU
    smoke')."""
    view = runner.run(["kubectl", "config", "view", "--raw", "--minify"],
                      check=False)
    if runner.dry_run:
        rec.endpoint = "dry-run"
        return
    if not view.ok or not view.stdout.strip():
        raise RuntimeError(
            "provider=local requires a working kubectl context (kind/minikube)")
    with open(kubeconfig, "w") as f:
        f.write(view.stdout)
    os.chmod(kubeconfig, 0o600)
    cur = runner.run(["kubectl", "config", "current-context"], check=False)
    rec.endpoint = cur.stdout.strip() if cur.ok else "local"


def accelerator_desc(cfg: DeployConfig) -> str:
    """The inventory's accelerator field, e.g. ``nvidia-h100-80gb-x1``
    (``cpu`` on provider=local)."""
    if cfg.provider != "gke":
        return "cpu"
    return f"{cfg.accelerator}-x{cfg.gpus_per_node}"


def _preflight_gpu(cfg: DeployConfig, kube: KubeCtl) -> None:
    """GPU visibility checks — the nvidia-smi / lspci analog
    (launch-instance.yaml:144-162): the nodes' allocatable nvidia.com/gpu.
    Soft on provider=local (no cards on a CPU kind node), hard on gke."""
    res = kube.kubectl(
        "get", "nodes", "-o",
        "jsonpath={range .items[*]}{.metadata.name} "
        "{.status.allocatable.nvidia\\.com/gpu}{\"\\n\"}{end}",
        check=False)
    visible = res.ok and any(
        line.split()[1:] and line.split()[1].isdigit() and int(line.split()[1]) > 0
        for line in res.stdout.splitlines() if line.strip())
    if kube.runner.dry_run:
        return
    if visible:
        logger.info("GPU preflight OK:\n%s", res.stdout.strip())
    elif cfg.provider == "gke":
        raise RuntimeError(
            f"no node advertises {GPU_RESOURCE}; GPU driver or device "
            f"plugin missing?\n{res.stdout}\n{res.stderr}")
    else:
        logger.info("provider=local: no %s resource (expected for CPU smoke)",
                    GPU_RESOURCE)


def _cluster_gone(stderr: str, cluster_name: str) -> bool:
    """True only when gcloud's error says the *cluster* resource is missing.

    A bare "not found" can also mean a missing project or zone (revoked
    access, typo'd config); treating that as "already gone" would delete
    the inventory and orphan a billing cluster, so the 404 must name the
    cluster itself (gcloud 404s carry the resource path, e.g.
    ``message=Not found: projects/p/zones/z/clusters/<name>``).
    """
    err = stderr.lower()
    name = cluster_name.lower()
    if "404" not in err and "not_found" not in err.replace(" ", "_"):
        return False
    return (f"clusters/{name}" in err
            or f'cluster "{name}"' in err
            or f"cluster {name}" in err)


def cleanup(runner: CommandRunner, workdir: str = ".") -> list[str]:
    """Tear down every cluster recorded by an inventory file and delete the
    generated files (cleanup-instance.yaml:1-154 analog).  Never touches the
    cluster over kubectl — pure cloud-API + local files, like the reference
    (SURVEY.md §3.3)."""
    removed: list[str] = []
    invs = find_inventories(workdir)
    if not invs:
        logger.info("no %s files found — nothing to clean up", "gpu-inventory-*.ini")
        return removed
    for inv in invs:
        cluster_id = extract_cluster_id(inv)
        if not cluster_id:
            logger.warning("cannot determine cluster id for %s; skipping", inv)
            continue
        rec = read_inventory(inv)
        logger.info("cleanup target: %s (provider=%s project=%s zone=%s)",
                    cluster_id, rec.provider, rec.project, rec.zone)
        if rec.provider == "gke" and rec.project:
            info = runner.run(["gcloud", "container", "clusters", "describe",
                               rec.cluster_name, "--project", rec.project,
                               "--zone", rec.zone, "--format",
                               "value(status)"], check=False)
            if info.ok and info.stdout.strip():
                try:
                    runner.run(["gcloud", "container", "clusters", "delete",
                                rec.cluster_name, "--project", rec.project,
                                "--zone", rec.zone, "--quiet"],
                               timeout=1800.0)
                except CommandError:
                    logger.warning("cluster delete failed for %s; files kept",
                                   cluster_id)
                    continue
            elif info.ok or _cluster_gone(info.stderr, rec.cluster_name):
                logger.info("cluster %s not found in cloud (already gone)",
                            rec.cluster_name)
            else:
                # Auth/network failure is NOT "already gone" — deleting the
                # inventory here would orphan a billing cluster with no
                # recorded state left to clean it up.
                logger.warning("cannot verify cluster %s (%s); files kept — "
                               "fix gcloud auth and re-run cleanup",
                               rec.cluster_name, info.stderr.strip()[:200])
                continue
        for path in generated_files(cluster_id, workdir):
            os.remove(path)
            logger.info("removed %s", path)
        removed.append(cluster_id)
    return removed
