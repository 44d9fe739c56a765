"""API smoke tests: in-cluster curl pods + direct-HTTP local mode.

A copy of ``tpuserve/provision/smoke.py``.  Port of llm-d-test.yaml:1-83
— ephemeral ``curlimages/curl`` pods exercise the real gateway from inside
the cluster: ``GET /v1/models`` asserting the served model name appears
(llm-d-test.yaml:32-59) and ``POST /v1/completions`` with the reference's
own prompt "Who are you?" (llm-d-test.yaml:61-78).  Each test: run pod →
wait Succeeded 60s → capture logs → delete, with 3 retries / 5s delay
(llm-d-test.yaml:47-48).
"""

from __future__ import annotations

import json
import logging
import random
import urllib.error
import urllib.request

from tpuserve_torch.provision.config import DeployConfig
from tpuserve_torch.provision.infra import KubeCtl
from tpuserve_torch.provision.serving import discover_gateway

logger = logging.getLogger("tpuserve_torch.provision")

SMOKE_PROMPT = "Who are you?"   # llm-d-test.yaml:66


class SmokeTestFailure(AssertionError):
    pass


def run_smoke_tests(cfg: DeployConfig, kube: KubeCtl) -> dict:
    """Run both in-cluster tests; returns captured responses."""
    test_id = random.randint(0, 999999)      # llm-d-test.yaml:10-12
    if kube.runner.dry_run:
        discover_gateway(cfg, kube)
        logger.info("dry-run: skipping smoke-test assertions")
        return {}
    gateway = discover_gateway(cfg, kube)
    base = f"http://{gateway}"
    if ":" not in gateway:
        base = f"http://{gateway}:80"
    logger.info("smoke tests against %s (test id %06d)", base, test_id)

    models_out = _curl_pod(
        cfg, kube, f"curl-gw-models-{test_id:06d}",
        ["curl", "-s", "--max-time", "30", f"{base}/v1/models"])
    if cfg.model not in models_out:
        raise SmokeTestFailure(
            f"model {cfg.model!r} not in /v1/models response: "
            f"{models_out[:500]}")   # llm-d-test.yaml:54-59 assertion
    logger.info("/v1/models OK")

    body = json.dumps({"model": cfg.model, "prompt": SMOKE_PROMPT,
                       "max_tokens": 32})
    completion_out = _curl_pod(
        cfg, kube, f"curl-gw-completion-{test_id:06d}",
        ["curl", "-s", "--max-time", "120", "-X", "POST",
         "-H", "Content-Type: application/json",
         "-d", body, f"{base}/v1/completions"])
    _assert_completion(completion_out)
    logger.info("/v1/completions OK")
    return {"models": models_out, "completion": completion_out}


def _curl_pod(cfg: DeployConfig, kube: KubeCtl, name: str,
              command: list[str]) -> str:
    """run pod → wait Succeeded 60s → logs → delete, 3 retries / 5s
    (llm-d-test.yaml:34-48)."""
    last_err = ""
    for attempt in range(3):
        kube.kubectl("delete", "pod", name, "-n", cfg.namespace,
                     "--ignore-not-found", check=False)
        kube.kubectl("run", name, "-n", cfg.namespace,
                     "--image=curlimages/curl", "--restart=Never",
                     "--", *command, check=False)
        wait = kube.kubectl("wait", f"pod/{name}", "-n", cfg.namespace,
                            "--for=jsonpath={.status.phase}=Succeeded",
                            "--timeout=60s", check=False, timeout=90.0)
        logs = kube.kubectl("logs", name, "-n", cfg.namespace, check=False)
        kube.kubectl("delete", "pod", name, "-n", cfg.namespace,
                     "--ignore-not-found", check=False)
        if wait.ok and logs.ok and logs.stdout.strip():
            return logs.stdout
        last_err = (wait.stderr or "") + (logs.stderr or "")
        if attempt < 2:
            kube.runner.sleep(5.0)
    raise SmokeTestFailure(f"curl pod {name} failed 3 attempts: "
                           f"{last_err[:500]}")


def _assert_completion(out: str) -> None:
    try:
        data = json.loads(out)
    except ValueError:
        raise SmokeTestFailure(f"completion response not JSON: {out[:500]}")
    choices = data.get("choices")
    if not choices or "text" not in choices[0]:
        raise SmokeTestFailure(f"no completion text in response: {out[:500]}")


# --- local mode: same assertions over direct HTTP (no cluster) ------------

def run_local_smoke_tests(base_url: str, model: str,
                          timeout: float = 120.0) -> dict:
    """Direct-HTTP variant for process-mode / port-forwarded deployments —
    identical assertions to the in-cluster path."""
    models_out = _http(f"{base_url}/v1/models", timeout=30.0)
    if model not in models_out:
        raise SmokeTestFailure(
            f"model {model!r} not in /v1/models response: {models_out[:500]}")
    body = json.dumps({"model": model, "prompt": SMOKE_PROMPT,
                       "max_tokens": 32}).encode()
    completion_out = _http(f"{base_url}/v1/completions", data=body,
                           timeout=timeout)
    _assert_completion(completion_out)
    return {"models": models_out, "completion": completion_out}


def _http(url: str, data: bytes | None = None, timeout: float = 30.0) -> str:
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    last: Exception | None = None
    for _ in range(3):                      # retries 3 / delay 5 parity
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read().decode()
        except (urllib.error.URLError, OSError) as e:
            last = e
            import time
            time.sleep(5.0)
    raise SmokeTestFailure(f"HTTP request to {url} failed: {last}")
