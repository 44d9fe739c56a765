"""Provisioner of the port: one command from infra to cluster, serving,
smoke tests and observability, on GKE node pools of NVIDIA H100s.

The port of ``tpuserve/provision``: the same pipeline and CLI
(``python -m tpuserve_torch.provision {deploy,cleanup,test,e2e}``), deploying
the port's server, gateway and autoscaler (``tpuserve_torch``), with GKE's
managed NVIDIA driver and ``nvidia.com/gpu`` device plugin in place of the
TPU device plugin and NVIDIA's DCGM exporter in place of the TPU metrics
DaemonSet — the reference's own GPU stack (SURVEY.md §0).  ``provider=local``
deploys onto an existing kind/minikube cluster for the CPU smoke
(``--device cpu``).  Importing it loads no PyTorch: a deploy host needs no
card.
"""

from tpuserve_torch.provision.config import DeployConfig, load_config
from tpuserve_torch.provision.runner import (CommandError, CommandResult,
                                             CommandRunner, DryRunRunner)

__all__ = [
    "DeployConfig", "load_config",
    "CommandRunner", "DryRunRunner", "CommandResult", "CommandError",
]
