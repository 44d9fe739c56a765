"""Synthetic canary prober: black-box SLIs through the real serving path.

The port's own copy of ``tpuserve/obs/canary.py`` (its imports are the port's).

Every metric the stack exports so far is white-box — measured by the
process doing the serving.  The canary closes the loop "Adaptive
Orchestration" (arxiv 2503.20074) routes on: a prober periodically
drives one tiny request per SLO class through the SAME path production
traffic takes (gateway -> backend server -> engine, admission control
and brownout ladder included) and exports what a client would actually
see as ``tpuserve_canary_*`` families.

Probe requests are tagged with the ``X-TPUServe-Canary: 1`` header;
the gateway and the engine server both honor the tag by EXCLUDING the
request from tenant metering and from every production SLI histogram
(``server/openai_api.py`` / ``server/runner.py``) — a canary must
observe the system, not steer the brownout estimator, bill a tenant, or
pollute the SLO histograms it exists to cross-check.  The request still
counts in ``tpuserve_canary_requests_total`` server-side, which is how
tests prove the exclusion rather than assume it.

Consecutive probe failures past the configured threshold flip the
``tpuserve_canary_breached`` gauge and the ``breached`` field of
:meth:`CanaryProber.snapshot` — surfaced on ``/gateway/status`` and
consumed by the autoscaler as a scale-out trigger
(``autoscale/policy.py``), and, because probes relay through the normal
gateway path, a backend failing its canaries accumulates the same
consecutive-failure count that drives ejection.

Wall-clock by nature (a real HTTP probe takes real seconds), so this
module is deliberately NOT under the tpulint clock seam.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from tpuserve_torch.runtime.slo import SLO_CLASSES

logger = logging.getLogger("tpuserve_torch.obs")

#: request-tag header; value "1" (or the shared token) marks a probe
CANARY_HEADER = "X-TPUServe-Canary"


def canary_token() -> Optional[str]:
    """Optional shared secret for the canary tag.  The tag bypasses
    tenant metering and rate limits by design, so in deployments with
    tenancy configured the operator sets ``TPUSERVE_CANARY_TOKEN`` on
    gateway + servers + prober: the header must then carry the token,
    and a client sending a bare "1" is billed like anyone else.
    Unset (dev/test, or fleets without tenancy — where there is
    nothing to bypass), "1" is accepted."""
    return os.environ.get("TPUSERVE_CANARY_TOKEN") or None


def is_canary_header(value: Optional[str]) -> bool:
    """True when a request's canary header marks an authorized probe."""
    if not value:
        return False
    token = canary_token()
    return value == token if token is not None else value == "1"


@dataclasses.dataclass(frozen=True)
class CanaryConfig:
    interval_s: float = 15.0          # one probe round per class
    classes: tuple = SLO_CLASSES
    prompt: str = "tpuserve canary ping"
    max_tokens: int = 2
    timeout_s: float = 10.0
    # consecutive failures in ONE class before the prober reports a
    # breach (the scale-out / eject signal)
    breach_failures: int = 3


class CanaryProber:
    """Periodic black-box prober.  ``base_url`` is whatever the fleet's
    clients talk to — the gateway in production (so probes exercise
    routing, ejection and admission), a single server in tests."""

    def __init__(self, base_url: str,
                 config: Optional[CanaryConfig] = None, metrics=None):
        from tpuserve_torch.server.metrics import CanaryMetrics
        self.base_url = base_url.rstrip("/")
        self.config = config or CanaryConfig()
        if self.config.interval_s <= 0:
            raise ValueError("canary interval_s must be > 0")
        if not self.config.classes:
            raise ValueError("canary needs at least one SLO class")
        self.metrics = metrics or CanaryMetrics()
        self._consecutive = {cls: 0 for cls in self.config.classes}
        self._last: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- probing -------------------------------------------------------

    def _probe_class(self, slo_class: str) -> tuple:
        """(ok, latency_s, detail) for one synthetic request."""
        body = json.dumps({
            "model": "canary", "prompt": self.config.prompt,
            "max_tokens": self.config.max_tokens, "stream": False,
            "temperature": 0.0,
        }).encode()
        req = urllib.request.Request(
            self.base_url + "/v1/completions", data=body, method="POST",
            headers={"Content-Type": "application/json",
                     CANARY_HEADER: canary_token() or "1",
                     "X-SLO-Class": slo_class})
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(
                    req, timeout=self.config.timeout_s) as resp:
                payload = json.loads(resp.read())
            latency = time.monotonic() - t0
            if not payload.get("choices"):
                return False, latency, "malformed response (no choices)"
            return True, latency, "ok"
        except urllib.error.HTTPError as e:
            # a shed/rate-limited/erroring class IS the signal: the
            # black-box view doesn't care why the request failed
            return False, time.monotonic() - t0, f"http {e.code}"
        except Exception as e:
            return False, time.monotonic() - t0, str(e) or type(e).__name__

    def probe_once(self) -> dict:
        """One full probe round (every class); returns the snapshot."""
        for cls in self.config.classes:
            ok, latency, detail = self._probe_class(cls)
            self.metrics.probes.labels(slo_class=cls).inc()
            if ok:
                self.metrics.probe_latency.labels(
                    slo_class=cls).observe(latency)
            else:
                self.metrics.failures.labels(slo_class=cls).inc()
                logger.warning("canary probe failed (%s): %s", cls,
                               detail)
            with self._lock:
                self._consecutive[cls] = (0 if ok
                                          else self._consecutive[cls] + 1)
                self._last[cls] = {"ok": ok,
                                   "latency_s": round(latency, 6),
                                   "detail": detail}
        snap = self.snapshot()
        self.metrics.breached.set(1 if snap["breached"] else 0)
        return snap

    # ---- state ---------------------------------------------------------

    def breached_classes(self) -> list:
        with self._lock:
            return sorted(cls for cls, n in self._consecutive.items()
                          if n >= self.config.breach_failures)

    def snapshot(self) -> dict:
        breached = self.breached_classes()
        with self._lock:
            return {
                "breached": bool(breached),
                "breached_classes": breached,
                "consecutive_failures": dict(self._consecutive),
                "last": {cls: dict(v) for cls, v in self._last.items()},
            }

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="tpuserve-canary")
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.probe_once()
            except Exception:
                logger.exception("canary probe round failed")

    def stop(self) -> None:
        self._stop.set()
