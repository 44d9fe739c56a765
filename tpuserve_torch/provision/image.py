"""Container image build / push / load — the step between "the code exists"
and "the cluster can pull it".

The port of ``tpuserve/provision/image.py``, building the port's own image
(``tpuserve_torch/provision/Dockerfile``: a CUDA devel base with PyTorch,
the kernels built at image build) from the repository root.  The reference
never faces this
because it deploys pullable upstream images (reference:
kubernetes-single-node.yaml:14 pins vllm/vllm-openai:latest;
llm-d-deploy.yaml:140-145 installs upstream charts).  Here:

- ``gke``:   docker build → push to ``image_registry`` (Artifact Registry;
             ``gcloud auth configure-docker`` is invoked for ``*.pkg.dev``).
- ``local``: docker build → side-load into the kind/minikube cluster backing
             the current kubectl context (no registry needed).

``build_image=False`` skips all of it for pre-pushed images, and
``serving._wait_pods_ready`` fails fast on ImagePullBackOff either way.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from tpuserve_torch.provision.config import DeployConfig
from tpuserve_torch.provision.runner import CommandRunner

logger = logging.getLogger("tpuserve_torch.provision")

#: where the port's Dockerfile sits in a checkout
DOCKERFILE = os.path.join("tpuserve_torch", "provision", "Dockerfile")


def resolve_image(cfg: DeployConfig) -> str:
    """Full image reference the manifests should use."""
    if cfg.image_registry:
        return f"{cfg.image_registry.rstrip('/')}/{cfg.image}"
    return cfg.image


def find_dockerfile(workdir: str = ".") -> Optional[str]:
    """Locate the port's Dockerfile: under the workdir first (running from
    a checkout), then beside this module (an editable install)."""
    for base in (workdir, os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))):
        cand = os.path.join(base, DOCKERFILE)
        if os.path.isfile(cand):
            return cand
    return None


def ensure_image(cfg: DeployConfig, runner: CommandRunner,
                 workdir: str = ".", context: str = "") -> str:
    """Build (and push/load) the engine image; returns the full reference
    every manifest must use.  ``context`` is the kubectl context name, used
    to pick the right side-load command on provider=local."""
    image = resolve_image(cfg)
    if not cfg.build_image:
        logger.info("build_image=False: assuming %s is already pullable",
                    image)
        return image
    if cfg.provider == "gke" and not cfg.image_registry:
        # knowable upfront — don't burn a 30-minute build first
        raise RuntimeError(
            "provider=gke needs image_registry (e.g. "
            "REGION-docker.pkg.dev/PROJECT/REPO) so nodes can pull the "
            "engine image — a local-only tag is not pullable from GKE")
    dockerfile = find_dockerfile(workdir)
    if dockerfile is None and not runner.dry_run:
        raise RuntimeError(
            "no Dockerfile found (looked in workdir and the package root); "
            "run from a checkout, or set build_image=false with a "
            "pre-pushed image_registry/image")
    # the build context is the repository root, two levels above the file
    build_ctx = (os.path.dirname(os.path.dirname(os.path.dirname(dockerfile)))
                 if dockerfile else workdir)
    runner.run(["docker", "build", "-t", image,
                "-f", dockerfile or DOCKERFILE, build_ctx],
               timeout=1800.0)

    if cfg.provider == "gke":
        host = cfg.image_registry.split("/", 1)[0]
        if host.endswith("pkg.dev") or host.endswith("gcr.io"):
            runner.run(["gcloud", "auth", "configure-docker", host,
                        "--quiet"], check=False)
        runner.run(["docker", "push", image], timeout=1800.0)
        logger.info("pushed %s", image)
        return image

    # provider=local: side-load into the adopted cluster
    if context.startswith("kind-"):
        runner.run(["kind", "load", "docker-image", image,
                    "--name", context[len("kind-"):]], timeout=600.0)
        logger.info("loaded %s into kind cluster %s", image, context)
    elif context.startswith("minikube"):
        runner.run(["minikube", "image", "load", image], timeout=600.0)
        logger.info("loaded %s into minikube", image)
    else:
        # docker-desktop / k3d / remote contexts share or manage their own
        # image store; nothing to side-load, but say so
        logger.info("context %r: no side-load step known; relying on the "
                    "cluster seeing the local docker image store", context)
    return image
