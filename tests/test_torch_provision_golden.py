"""Full-pipeline golden of the port's provisioner: the exact ordered
external-command list a gke deploy of ``qwen3-0.6b-h100`` issues (the
non-dry-run path, canned gcloud/kubectl/helm outputs driving every layer
down its success branch), and the multihost replica's container command as
rendered (torchrun around the engine, a node rank from the pod's ordinal).
The local deploy's list is held against the JAX provisioner's golden in
``tests/test_torch_provision_parity.py``.

Regenerate after an intentional pipeline change with:
    python tests/test_torch_provision_golden.py --regen
then review the golden-file diff like any code change.
"""

import json
import os
import sys
from pathlib import Path

import pytest

if __name__ == "__main__":       # --regen from a checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuserve_torch.provision import manifests
from tpuserve_torch.provision.config import load_config
from tpuserve_torch.provision.inventory import (details_path, extract_cluster_id,
                                                latest_inventory, parse_details)

from tests.test_torch_provision_parity import run_deploy

GOLDEN_DIR = Path(__file__).resolve().parent / "golden_torch"
GKE_GOLDEN = GOLDEN_DIR / "deploy_gke_commands.txt"
MULTIHOST_GOLDEN = GOLDEN_DIR / "multihost_engine_command.json"


def multihost_container() -> dict:
    """Replica 0's pod container of ``qwen2-72b-tp8-h100x8``: its command,
    GPU limit and env."""
    cfg = load_config(preset="qwen2-72b-tp8-h100x8", project="test-proj")
    sts = next(o for o in manifests.serving_manifests(cfg)
               if o["kind"] == "StatefulSet" and o["metadata"]["name"] == "tpuserve-mh-0")
    c = sts["spec"]["template"]["spec"]["containers"][0]
    return {"replicas": sts["spec"]["replicas"], "command": c["command"],
            "limits": c["resources"]["limits"], "env": c["env"]}


def test_gke_deploy_command_list_golden(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    commands = run_deploy("gke", str(tmp_path))
    assert commands == GKE_GOLDEN.read_text().splitlines(), (
        "deploy command sequence changed; if intentional, regenerate with "
        "`python tests/test_torch_provision_golden.py --regen` and review the diff")
    details = parse_details(details_path(
        extract_cluster_id(latest_inventory(str(tmp_path))), str(tmp_path)))
    assert details["Model"] == "Qwen/Qwen3-0.6B"
    assert details["Accelerator"] == "nvidia-h100-80gb-x1"


def test_gke_deploy_creates_an_h100_pool_and_pushes_first(tmp_path, monkeypatch):
    """Ordering facts that must hold regardless of golden churn."""
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    cmds = run_deploy("gke", str(tmp_path))
    pool = next(c for c in cmds if c.startswith("gcloud container node-pools create"))
    assert "--machine-type a3-highgpu-1g" in pool
    assert "--accelerator type=nvidia-h100-80gb,count=1,gpu-driver-version=latest" in pool
    i_pool = cmds.index(pool)
    i_preflight = next(i for i, c in enumerate(cmds) if "nvidia\\.com/gpu" in c)
    i_push = next(i for i, c in enumerate(cmds) if c.startswith("docker push"))
    i_apply = next(i for i, c in enumerate(cmds)
                   if c.startswith("kubectl --kubeconfig") and "apply" in c)
    i_smoke = next(i for i, c in enumerate(cmds) if "curl-gw-models" in c)
    i_otel = next(i for i, c in enumerate(cmds) if "app=otel-collector" in c)
    assert i_pool < i_preflight < i_push < i_apply < i_smoke < i_otel
    assert not any(c.startswith("kind load") for c in cmds)
    assert not any("google.com/tpu" in c or "tpu-topology" in c for c in cmds)


def test_multihost_engine_command_golden():
    assert multihost_container() == json.loads(MULTIHOST_GOLDEN.read_text())


def _regen():
    import tempfile
    GOLDEN_DIR.mkdir(exist_ok=True)
    os.environ.pop("HF_TOKEN", None)
    d = tempfile.mkdtemp()
    os.environ["HOME"] = d
    commands = run_deploy("gke", d)
    GKE_GOLDEN.write_text("\n".join(commands) + "\n")
    MULTIHOST_GOLDEN.write_text(json.dumps(multihost_container(), indent=1) + "\n")
    print(f"wrote {GKE_GOLDEN} ({len(commands)} commands) and {MULTIHOST_GOLDEN}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        _regen()
    else:
        print(__doc__)
