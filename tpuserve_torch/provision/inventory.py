"""Inventory / details file contract between pipeline layers.

The port of ``tpuserve/provision/inventory.py``.  The reference's only
persistent state between layers is a generated INI inventory plus a
human-readable details file (launch-instance.yaml:83-117); the CLI
discovers the newest inventory with ``ls -rt gpu-inventory-*.ini | tail -1``
(deploy-k8s-cluster.sh:23) and cleanup reverse-engineers instance IDs from
inventory content with a filename-regex fallback (cleanup-instance.yaml:
24-49).  The port keeps the reference's own names:
``gpu-inventory-<cluster_id>.ini`` + ``instance-<cluster_id>-details.txt`` +
``kubeconfig-<cluster_id>``, so its ``cleanup`` never reads or deletes a
cluster the JAX provisioner (``tpu-inventory-*.ini``) recorded in the same
directory, and the JAX ``cleanup`` never touches the port's.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import time
from typing import Optional

INVENTORY_GLOB = "gpu-inventory-*.ini"
_INVENTORY_RE = re.compile(r"gpu-inventory-(.+)\.ini$")
_ID_LINE_RE = re.compile(r"\bcluster_id\s*=\s*(\S+)")


@dataclasses.dataclass
class ClusterRecord:
    cluster_id: str
    cluster_name: str
    project: str
    region: str
    zone: str
    accelerator: str
    endpoint: str = ""
    provider: str = "gke"
    created_unix: float = 0.0

    @property
    def kubeconfig_file(self) -> str:
        return f"kubeconfig-{self.cluster_id}"


def inventory_path(cluster_id: str, workdir: str = ".") -> str:
    return os.path.join(workdir, f"gpu-inventory-{cluster_id}.ini")


def details_path(cluster_id: str, workdir: str = ".") -> str:
    return os.path.join(workdir, f"instance-{cluster_id}-details.txt")


def write_inventory(rec: ClusterRecord, workdir: str = ".") -> str:
    """INI inventory (launch-instance.yaml:105-117 analog).  The host line
    carries key=value vars like the reference's ``<ip> ansible_user=ubuntu
    … instance_id`` content."""
    path = inventory_path(rec.cluster_id, workdir)
    with open(path, "w") as f:
        f.write("[gpu_cluster]\n")
        f.write(
            f"{rec.cluster_name} cluster_id={rec.cluster_id} "
            f"project={rec.project} region={rec.region} zone={rec.zone} "
            f"accelerator={rec.accelerator} provider={rec.provider} "
            f"endpoint={rec.endpoint} kubeconfig={rec.kubeconfig_file}\n")
        f.write("\n[gpu_cluster:vars]\n")
        f.write(f"created_unix={rec.created_unix or time.time()}\n")
    return path


def write_details(rec: ClusterRecord, workdir: str = ".",
                  extra: Optional[dict] = None) -> str:
    """Human-readable summary (launch-instance.yaml:83-103 analog), parsed
    back by the CLI's final summary print (deploy-k8s-cluster.sh:50-74)."""
    path = details_path(rec.cluster_id, workdir)
    lines = {
        "Cluster ID": rec.cluster_id,
        "Cluster Name": rec.cluster_name,
        "Provider": rec.provider,
        "Project": rec.project,
        "Region": rec.region,
        "Zone": rec.zone,
        "Accelerator": rec.accelerator,
        "Endpoint": rec.endpoint,
        "Kubeconfig": rec.kubeconfig_file,
    }
    lines.update(extra or {})
    with open(path, "w") as f:
        f.write("GPU Cluster Details\n===================\n")
        for k, v in lines.items():
            f.write(f"{k}: {v}\n")
    return path


def parse_details(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" in line and not line.startswith("="):
                k, _, v = line.partition(":")
                out[k.strip()] = v.strip()
    return out


def find_inventories(workdir: str = ".") -> list[str]:
    """All inventories, oldest→newest by mtime (``ls -rt`` order,
    deploy-k8s-cluster.sh:23)."""
    paths = glob.glob(os.path.join(workdir, INVENTORY_GLOB))
    return sorted(paths, key=lambda p: (os.path.getmtime(p), p))


def latest_inventory(workdir: str = ".") -> Optional[str]:
    """``ls -rt … | tail -1`` — newest inventory wins."""
    paths = find_inventories(workdir)
    return paths[-1] if paths else None


def read_inventory(path: str) -> ClusterRecord:
    with open(path) as f:
        text = f.read()
    host_vars: dict[str, str] = {}
    cluster_name = ""
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("[", "#", ";")):
            continue
        parts = line.split()
        if "=" not in parts[0]:
            cluster_name = parts[0]
            parts = parts[1:]
        for p in parts:
            if "=" in p:
                k, _, v = p.partition("=")
                host_vars.setdefault(k, v)
    cluster_id = host_vars.get("cluster_id") or extract_cluster_id(path)
    return ClusterRecord(
        cluster_id=cluster_id or "",
        cluster_name=cluster_name or (cluster_id or ""),
        project=host_vars.get("project", ""),
        region=host_vars.get("region", ""),
        zone=host_vars.get("zone", ""),
        accelerator=host_vars.get("accelerator", ""),
        endpoint=host_vars.get("endpoint", ""),
        provider=host_vars.get("provider", "gke"),
        created_unix=float(host_vars.get("created_unix", 0) or 0),
    )


def extract_cluster_id(path: str) -> Optional[str]:
    """ID extraction with the reference's two strategies: match a
    ``cluster_id=`` line in the content, else fall back to the filename
    pattern (cleanup-instance.yaml:24-49)."""
    try:
        with open(path) as f:
            m = _ID_LINE_RE.search(f.read())
        if m:
            return m.group(1)
    except OSError:
        pass
    m = _INVENTORY_RE.search(os.path.basename(path))
    return m.group(1) if m else None


def generated_files(cluster_id: str, workdir: str = ".") -> list[str]:
    """Everything cleanup deletes: inventory, details, kubeconfig-*
    (cleanup-instance.yaml:108-138)."""
    cands = [
        inventory_path(cluster_id, workdir),
        details_path(cluster_id, workdir),
        os.path.join(workdir, f"kubeconfig-{cluster_id}"),
    ]
    return [p for p in cands if os.path.exists(p)]
