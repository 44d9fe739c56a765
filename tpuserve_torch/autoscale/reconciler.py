"""The autoscaler control loop and its production pool backend.

``Reconciler`` is deliberately thin: observe (``backend.signals()``),
decide (``AutoscalePolicy``), act (``backend.scale_to``), export
(decision counter, replica gauge, cold-start histogram, and the
gateway-consumable backends file).  All policy state lives in the
policy; all Kubernetes knowledge lives in :class:`KubePool`; the
simulated pool (``pool.py``) exercises the identical policy object
without either.

Scale-in contract, honestly stated: the reconciler cannot know which
pod the Deployment controller will terminate, so unrouting is
best-effort — the ready-backend list is republished every tick (and
served on the scaler's ``/backends`` endpoint for the gateway's
``--backends-url`` poll), which narrows the stale-route window to one
poll interval.  The *zero-dropped-streams* guarantee comes from the
layer below: the policy only asks for scale-in after the pool sat
completely idle, and the SIGTERMed pod's graceful drain finishes any
stragglers while answering new arrivals with a retryable 503 the
client (or gateway failover) recovers from.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import threading
import urllib.request
from typing import Optional

from tpuserve_torch.autoscale.policy import (AutoscalePolicy, Decision,
                                             PolicyConfig, PoolSignals)
from tpuserve_torch.autoscale.signals import scrape_replica

logger = logging.getLogger("tpuserve_torch.autoscale")


def write_backends_file(path: str, urls: list) -> None:
    """Atomically publish the ready-backend list for the gateway's
    ``--backends-file`` poll loop (JSON list; the gateway also accepts
    newline-separated text)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(sorted(urls), f)
        f.write("\n")
    os.replace(tmp, path)


class KubePool:
    """Kubernetes pool backend: pods via ``kubectl get pods -o json``,
    signals scraped from each pod's ``/debug/engine``, scaling via
    ``kubectl scale deployment``.  Pending demand (the scale-from-zero
    trigger) comes from the gateway's ``/gateway/status`` unserved
    counter when a gateway URL is configured."""

    def __init__(self, namespace: str, deployment: str = "tpuserve-engine",
                 selector: str = "app=tpuserve,component=engine",
                 port: int = 8000, gateway_url: Optional[str] = None,
                 kubectl: str = "kubectl", clock=None,
                 boot_timeout_s: float = 600.0):
        from tpuserve_torch.runtime.clock import MONOTONIC
        self.namespace = namespace
        self.deployment = deployment
        self.selector = selector
        self.port = port
        self.gateway_url = gateway_url
        self.kubectl = kubectl
        self.clock = clock or MONOTONIC
        # a pod unready longer than this stops counting as booting
        # capacity: a CrashLoopBackOff replica must not hold the
        # scale-from-zero trigger (live==0) off forever, nor keep
        # PoolSignals.idle() false so surplus replicas never retire
        self.boot_timeout_s = boot_timeout_s
        self._unready_since: dict = {}
        self._ready_urls: list = []
        self._unserved_last: Optional[int] = None
        self._unserved_by_model_last: dict = {}
        self._pending_by_model: dict = {}
        # replicas whose cold_start_s was already exported (the scalar
        # is stable per pod lifetime; the histogram wants it once)
        self._cold_seen: set = set()
        self._cold_pending: list = []

    def _kubectl_json(self, *args) -> dict:
        out = subprocess.run(
            [self.kubectl, *args, "-n", self.namespace, "-o", "json"],
            capture_output=True, text=True, timeout=30)
        if out.returncode != 0:
            raise RuntimeError(f"kubectl {' '.join(args)} failed: "
                               f"{out.stderr.strip()[:300]}")
        return json.loads(out.stdout)

    def _pending_demand(self) -> int:
        """Unserved-request delta at the gateway since the last poll —
        requests that arrived while no backend could take them.  The
        same fetch also captures the gateway canary's breach state
        (tpuserve_torch/obs/canary.py) into ``_canary_breached`` for the
        policy's black-box scale-out trigger."""
        self._canary_breached = 0
        self._pending_by_model = {}
        if not self.gateway_url:
            return 0
        try:
            with urllib.request.urlopen(
                    self.gateway_url.rstrip("/") + "/gateway/status",
                    timeout=2.0) as resp:
                payload = json.loads(resp.read())
            total = int(payload.get("unserved_total") or 0)
            by_model = {str(k): int(v) for k, v in
                        (payload.get("unserved_by_model") or {}).items()}
            self._canary_breached = len(
                (payload.get("canary") or {}).get("breached_classes")
                or ())
        except Exception as e:
            logger.debug("gateway status scrape failed: %s", e)
            return 0
        prev, self._unserved_last = self._unserved_last, total
        prev_by, self._unserved_by_model_last = (
            self._unserved_by_model_last, by_model)
        # same delta treatment as the total: only demand that arrived
        # since the last poll steers the boot-model pick
        self._pending_by_model = {
            m: d for m, d in
            ((m, v - prev_by.get(m, 0)) for m, v in by_model.items())
            if d > 0} if prev is not None else {}
        return max(0, total - prev) if prev is not None else 0

    def signals(self) -> PoolSignals:
        pods = self._kubectl_json("get", "pods",
                                  "-l", self.selector).get("items", [])
        now = self.clock.monotonic()
        replicas, booting, ready_urls, seen = [], 0, [], set()

        def note_unready(name: str) -> None:
            nonlocal booting
            since = self._unready_since.setdefault(name, now)
            if now - since < self.boot_timeout_s:
                booting += 1           # genuinely booting: counts
            else:
                logger.warning("pod %s unready > %.0fs — no longer "
                               "counted as booting capacity", name,
                               self.boot_timeout_s)

        for pod in pods:
            meta, status = pod.get("metadata", {}), pod.get("status", {})
            name = meta.get("name", "?")
            if meta.get("deletionTimestamp"):
                continue               # terminating: already draining
            seen.add(name)
            ip = status.get("podIP")
            ready = any(c.get("type") == "Ready"
                        and c.get("status") == "True"
                        for c in status.get("conditions", []))
            if not ip or not ready:
                note_unready(name)
                continue
            url = f"http://{ip}:{self.port}"
            sig = scrape_replica(name, url)
            if sig is None:
                # K8s says Ready but the scrape failed (just-booted, or
                # a timeout under the very load the scaler reacts to).
                # Its SIGNALS are unknown — count it like booting
                # capacity (keeps idle() conservative) — but do NOT cut
                # its traffic: dropping a Ready pod from ready_urls
                # would bench a healthy replica on a scrape flap and
                # shift its load onto the others mid-storm.
                note_unready(name)
                ready_urls.append(url)
                continue
            self._unready_since.pop(name, None)
            ready_urls.append(url)
            replicas.append(sig)
            if sig.cold_start_s is not None \
                    and name not in self._cold_seen:
                self._cold_seen.add(name)
                self._cold_pending.append(sig.cold_start_s)
        self._unready_since = {k: v for k, v in
                               self._unready_since.items() if k in seen}
        self._ready_urls = ready_urls
        pending = self._pending_demand()
        return PoolSignals(t=now, replicas=replicas, booting=booting,
                           pending_demand=pending,
                           pending_by_model=dict(self._pending_by_model),
                           canary_breached=getattr(
                               self, "_canary_breached", 0))

    def ready_urls(self) -> list:
        return list(self._ready_urls)

    def drain_cold_starts(self) -> list:
        out, self._cold_pending = self._cold_pending, []
        return out

    def scale_to(self, n: int, reason: str) -> None:
        logger.info("kubectl scale %s/%s -> %d (%s)", self.namespace,
                    self.deployment, n, reason)
        out = subprocess.run(
            [self.kubectl, "scale", f"deployment/{self.deployment}",
             "-n", self.namespace, f"--replicas={n}"],
            capture_output=True, text=True, timeout=30)
        if out.returncode != 0:
            raise RuntimeError(
                f"kubectl scale failed: {out.stderr.strip()[:300]}")


class Reconciler:
    """observe -> decide -> act -> export, once per control interval."""

    def __init__(self, backend, policy: Optional[AutoscalePolicy] = None,
                 metrics=None, backends_file: Optional[str] = None,
                 pool_name: str = "tpuserve-engine"):
        self.backend = backend
        self.policy = policy or AutoscalePolicy(PolicyConfig())
        self.metrics = metrics
        self.backends_file = backends_file
        self.pool_name = pool_name
        self._stop = threading.Event()

    def run_once(self) -> Decision:
        sig = self.backend.signals()
        d = self.policy.decide(sig)
        applied = d.action in ("scale_out", "scale_in")
        if applied:
            try:
                self.backend.scale_to(d.target, d.reason)
            except Exception:
                # roll the policy back: a kubectl blip must not burn a
                # cooldown (and a decisions-counter tick) on an action
                # that never took effect — the next interval retries
                logger.exception("scale action failed — reverting the "
                                 "decision, retrying next interval")
                self.policy.revert(d)
                applied = False
        if self.metrics is not None:
            if applied:
                self.metrics.decisions.labels(action=d.action).inc()
            self.metrics.replicas.labels(pool=self.pool_name).set(
                d.target if applied else d.current)
            drain = getattr(self.backend, "drain_cold_starts", None)
            if drain is not None:
                for v in drain():
                    self.metrics.cold_start.observe(v)
        if self.backends_file:
            try:
                write_backends_file(self.backends_file,
                                    self.backend.ready_urls())
            except Exception:
                logger.exception("backends file publish failed")
        return d

    def serve(self, interval_s: float = 5.0) -> None:
        """Blocking control loop (the scaler Deployment's main thread);
        ``shutdown()`` from any thread stops it."""
        while not self._stop.wait(interval_s):
            try:
                self.run_once()
            except Exception:
                logger.exception("reconcile tick failed")

    def shutdown(self) -> None:
        self._stop.set()
