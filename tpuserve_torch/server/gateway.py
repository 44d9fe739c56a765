"""Inference gateway: routes OpenAI-API traffic across engine replicas.

The port's own copy of ``tpuserve/server/gateway.py``, with the same wire
format: it fronts the port's servers and the JAX package's alike, and the
JAX gateway fronts the port's (``python -m tpuserve_torch.server.gateway``).

The reference deploys the llm-d inference gateway (Gateway API + Envoy) and
discovers its address three ways in the smoke tests
(reference: llm-d-test.yaml:14-26); the gateway's job there is to spread
requests across model-serving pods and steer prefill/decode traffic.  This
is the in-repo equivalent: a threaded HTTP proxy with

- health-checked backend pools (``/healthz`` probing, auto-eject/readmit),
- least-outstanding-requests load balancing,
- KV-aware session affinity via RENDEZVOUS (highest-random-weight)
  hashing on the prompt prefix: every gateway replica computes the same
  prefix->backend mapping from nothing but the backend list, so affinity
  (and therefore engine prefix-cache hit rate) survives running N gateway
  replicas with no shared state (the llm-d gateway is HA by platform,
  llm-d-test.yaml:14-18).  A load-slack guard diverts
  to the least-loaded backend when the hash target is overloaded,
  trading a cache hit for tail latency under skew,
- pass-through streaming (SSE chunks relayed as they arrive).

DP replicas = multiple backends here + K8s replica count, matching the
reference's llm-d topology (SURVEY.md §2.3 "DP: implicit via K8s replicas +
gateway LB").
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import random
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

logger = logging.getLogger("tpuserve_torch.gateway")

# "not provided" sentinel for pre-parsed request payloads (None is a
# valid parse result: a non-JSON body)
_UNSET = object()


def _is_connect_failure(e: Exception) -> bool:
    """True when the backend never received the request (connection refused
    / unreachable / DNS) — the only failures safe to fail over, since
    retrying a request the backend may already be executing would duplicate
    inference work."""
    import errno
    import socket
    if not isinstance(e, urllib.error.URLError):
        return False
    r = e.reason
    if isinstance(r, (ConnectionRefusedError, socket.gaierror)):
        return True
    return (isinstance(r, OSError) and r.errno in
            (errno.ECONNREFUSED, errno.EHOSTUNREACH, errno.ENETUNREACH))


@dataclasses.dataclass
class Backend:
    url: str                       # http://host:port
    healthy: bool = True
    outstanding: int = 0
    last_checked: float = 0.0
    consecutive_failures: int = 0
    # cache-affinity advertisement parsed off /healthz (kv_digest.py): a
    # bloom digest of the prefix keys this backend has served, windowed
    # to its cache reach across the KV tiers.  Empty until the first
    # probe (selection then falls back to the static rendezvous ring).
    # kv_digest_chars is the backend's OWN key-derivation prefix length:
    # membership probes must hash with the backend's value, not the
    # gateway's, or a non-default affinity_prefix_chars silently turns
    # every probe into a miss.
    kv_digest: str = ""
    kv_digest_bits: int = 0
    kv_digest_chars: int = 0
    # Readmission backoff: consecutive ejection episodes and the time
    # before which the health loop will NOT probe this (ejected)
    # backend.  Exponential + jittered — a sick replica that keeps
    # passing /healthz but failing requests would otherwise be
    # readmitted on a fixed cadence and take a synchronized retry storm
    # every health interval.
    eject_count: int = 0
    backoff_until: float = 0.0
    healthy_since: float = 0.0
    # Probe observability: wall seconds the last
    # /healthz round-trip took and how many CONSECUTIVE probes have
    # failed — /gateway/status previously showed only the binary eject
    # state, which hid both a slowly-degrading backend (rising probe
    # latency) and how close an unhealthy one is to readmission.
    last_probe_latency_s: Optional[float] = None
    probe_failures: int = 0
    # Model-pool catalog advertisement parsed off /healthz
    # (tpuserve_torch/modelpool): name -> warmth tag (serving/resident/host/
    # spill/cold) for every model this backend registers, plus the one
    # it is serving right now.  Empty for pool-less backends — catalog
    # routing then ignores them for named-model requests they can't
    # serve and treats everything else normally.
    models: dict = dataclasses.field(default_factory=dict)
    model_current: str = ""


@dataclasses.dataclass
class GatewayConfig:
    host: str = "0.0.0.0"
    port: int = 8080
    health_interval_s: float = 5.0
    health_timeout_s: float = 2.0
    affinity_prefix_chars: int = 256     # prompt prefix hashed for affinity
    # Divert from the rendezvous target to the least-loaded backend when
    # the target has this many more outstanding requests than the idlest
    # backend — an overloaded replica's queueing delay quickly exceeds
    # what a prefix-cache hit saves.
    affinity_load_slack: int = 8
    upstream_timeout_s: float = 600.0
    # Eject a backend after this many CONSECUTIVE failures — 5xx responses
    # count, not only connect failures: a backend whose engine loop is
    # fail-all-ing every request answers connects just fine.  An ejected
    # backend stops receiving new traffic until the health probe loop
    # sees its /healthz pass again (auto-readmit).
    eject_after_failures: int = 2
    # Jittered exponential readmission backoff: after the Nth ejection
    # episode the health loop waits base * 2^(N-1) seconds (capped,
    # +/- jitter_frac) before even PROBING the backend again, so a
    # flapping replica isn't readmitted on a fixed cadence into a
    # synchronized retry storm.  The count resets once the backend
    # survives a full healthy probe round.
    readmit_backoff_base_s: float = 2.0
    readmit_backoff_max_s: float = 60.0
    readmit_jitter_frac: float = 0.25
    # The episode count resets only after the backend stays healthy this
    # long — a replica that passes /healthz but fails requests (the
    # motivating eject case) would otherwise re-arm the ladder at its
    # base on every flap that outlasts one probe round.
    readmit_reset_healthy_s: float = 30.0
    # Per-tenant token metering + rate limits enforced HERE, in front of
    # the whole replica pool (server/tenants.py): inline JSON or a file
    # path; None = TPUSERVE_TENANTS env (unset: no gateway tenancy).
    tenant_config: Optional[str] = None
    # Dynamic backend set: a poll-able source of backend
    # URLs — a local file (JSON list or newline-separated; the
    # autoscaler's reconciler publishes one) or an HTTP URL.  Re-read
    # every health round: added backends join UNHEALTHY and start
    # receiving traffic after their first passing probe; removed ones
    # stop being selected immediately while in-flight relays finish on
    # the retained Backend object (zero dropped streams).  With a
    # source configured the gateway may start with ZERO backends
    # (scale-from-zero) — requests then get a retryable 503 and are
    # counted in unserved_total, the autoscaler's demand signal.
    backends_file: Optional[str] = None
    backends_url: Optional[str] = None
    # Embedded synthetic canary (tpuserve_torch/obs/canary.py): > 0
    # starts a prober that drives one tagged tiny request per SLO class
    # through THIS gateway every interval — so probes exercise routing,
    # admission and ejection exactly like client traffic, while the
    # canary tag keeps them out of tenant metering and the production
    # SLI histograms.  Black-box tpuserve_canary_* families are served
    # on the gateway's /metrics; breach state rides /gateway/status for
    # the autoscaler.  0 = no prober (default).
    canary_interval_s: float = 0.0


class Gateway:
    def __init__(self, backend_urls: list[str], config: GatewayConfig | None = None):
        self.config = config or GatewayConfig()
        dynamic = bool(self.config.backends_file
                       or self.config.backends_url)
        if not backend_urls and not dynamic:
            raise ValueError("gateway needs at least one backend (or a "
                             "--backends-file/--backends-url source)")
        self.backends = [Backend(url=u.rstrip("/")) for u in backend_urls]
        # requests that arrived while NO backend existed (pool scaled
        # to zero): the autoscaler reads this off /gateway/status as
        # its scale-from-zero demand signal.  The per-model split lets
        # scale-from-zero pick WHICH model to boot warm
        # (tpuserve_torch/modelpool + autoscale/signals.py).
        self.unserved_total = 0
        self.unserved_by_model: dict[str, int] = {}
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._health_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # per-tenant metering/limits for the whole pool (None when not
        # configured — the relay path then skips tenancy entirely)
        from tpuserve_torch.server.tenants import TenantRegistry
        self.tenants = TenantRegistry.load(self.config.tenant_config) \
            if (self.config.tenant_config
                or os.environ.get("TPUSERVE_TENANTS")) else None
        # embedded canary prober: constructed against this gateway's own
        # bound port in start() (port 0 isn't known yet)
        self.canary = None
        if dynamic:
            # synchronous initial load so start() routes immediately
            # when the source already lists backends
            self.reload_backends()

    def _eject_backoff_s(self, eject_count: int) -> float:
        """Jittered exponential delay before the Nth-ejection backend is
        probed for readmission (deterministic growth, random jitter)."""
        cfg = self.config
        base = min(cfg.readmit_backoff_base_s * (2 ** max(eject_count - 1, 0)),
                   cfg.readmit_backoff_max_s)
        return base * (1 + random.uniform(-cfg.readmit_jitter_frac,
                                          cfg.readmit_jitter_frac))

    # ---- dynamic backend set -------------------------------------------

    def _read_backend_source(self) -> Optional[list[str]]:
        """Fetch the configured backend list (file beats URL); None =
        no source configured or the source is currently unreadable (the
        current set stays — a scaler mid-rewrite must not wipe the
        pool)."""
        cfg = self.config
        raw: Optional[str] = None
        if cfg.backends_file:
            try:
                with open(cfg.backends_file, "r", encoding="utf-8") as f:
                    raw = f.read()
            except OSError:
                return None
        elif cfg.backends_url:
            try:
                with urllib.request.urlopen(
                        cfg.backends_url,
                        timeout=cfg.health_timeout_s) as resp:
                    raw = resp.read().decode("utf-8", "replace")
            except Exception:
                return None
        if raw is None:
            return None
        try:
            data = json.loads(raw)
            if isinstance(data, list):
                return [str(u) for u in data
                        if isinstance(u, str)
                        and u.startswith(("http://", "https://"))]
            return None     # JSON but not a list: not a backend file
        except ValueError:
            pass
        urls = [ln.strip() for ln in raw.splitlines()
                if ln.strip().startswith(("http://", "https://"))]
        if urls or not raw.strip():
            return urls     # empty source = a genuinely empty pool
        # non-empty, non-JSON, zero URLs: an HTML error page or other
        # garbage — treat as unreadable, keep the current set (wiping
        # the live pool on a proxy hiccup would 502 every request)
        return None

    def reload_backends(self) -> bool:
        """One poll of the backend source; True when the set changed."""
        urls = self._read_backend_source()
        if urls is None:
            return False
        return self.set_backends(urls)

    def set_backends(self, urls: list[str]) -> bool:
        """Reconcile the live backend set against ``urls`` without a
        restart.  Retained backends keep ALL state (health, digest,
        backoff, outstanding); added ones join unhealthy and are
        admitted by their first passing health probe; removed ones are
        dropped from selection immediately — in-flight relays hold
        their own Backend reference and release it normally, so a
        drained replica finishes its streams with zero drops."""
        wanted = []
        seen = set()
        for u in urls:
            u = u.rstrip("/")
            if u and u not in seen:
                seen.add(u)
                wanted.append(u)
        with self._lock:
            current = {b.url: b for b in self.backends}
            if list(current) == wanted:
                return False
            added = [u for u in wanted if u not in current]
            removed = [u for u in current if u not in seen]
            self.backends = [
                current.get(u) or Backend(url=u, healthy=False)
                for u in wanted]
        if added or removed:
            logger.info("backend set reloaded: +%s -%s (%d total)",
                        added or "[]", removed or "[]", len(wanted))
        return True

    # ---- backend selection ---------------------------------------------

    def _affinity_payload(self, body: bytes) -> Optional[dict]:
        try:
            payload = json.loads(body)
        except Exception:
            return None
        return payload if isinstance(payload, dict) else None

    def _prefix_key(self, body: bytes) -> Optional[str]:
        # shared derivation (server/kv_digest.affinity_key): the backends
        # track the SAME key function into their advertised digests, so a
        # digest probe here and a tracker note there can never hash
        # differently (prefix lengths are reconciled per backend in
        # pick_backend — each advertises its own on /healthz)
        from tpuserve_torch.server.kv_digest import affinity_key
        payload = self._affinity_payload(body)
        if payload is None:
            return None
        return affinity_key(payload, self.config.affinity_prefix_chars)

    @staticmethod
    def _rendezvous_target(key: str, pool: list[Backend]) -> Backend:
        """Highest-random-weight choice: every gateway replica, given the
        same backend list, maps ``key`` to the same backend — no shared
        state, and removing a backend only remaps that backend's keys."""
        return max(pool, key=lambda b: hashlib.sha256(
            f"{key}|{b.url}".encode()).digest())

    def pick_backend(self, body: bytes | None = None,
                     exclude: set[str] | None = None,
                     payload=_UNSET) -> Optional[Backend]:
        """Pick a backend: rendezvous prefix affinity (with a load-slack
        escape to least-loaded), else least-loaded.  ``exclude``: URLs
        already tried this request (connect-failure failover) — skipped
        unless nothing else remains.  ``payload``: the body's
        already-parsed JSON (the relay parses once; failover retries and
        the tenant check must not re-parse a large body).  ``None`` only
        when the dynamic backend set is currently EMPTY (pool scaled to
        zero) — the relay answers a retryable 503 and counts the miss."""
        with self._lock:
            if not self.backends:
                return None
            ex = exclude or set()
            # preference order: healthy+untried > any untried (a backend
            # merely flagged by the health loop beats re-dialing one that
            # just refused THIS request) > anything
            healthy = [b for b in self.backends
                       if b.healthy and b.url not in ex]
            pool = (healthy
                    or [b for b in self.backends if b.url not in ex]
                    or self.backends)
            from tpuserve_torch.server.kv_digest import affinity_key, digest_has
            if payload is _UNSET:
                payload = self._affinity_payload(body) if body else None
            # Catalog-aware narrowing (tpuserve_torch/modelpool): a request
            # naming a model some backend REGISTERS routes within the
            # warmest subset that holds it — serving/resident beats
            # host beats spill beats cold, because a cold replica pays a
            # full weight restore (or 503s under swap_policy=reject)
            # before the first token.  Load-slack guarded like prefix
            # affinity: an overloaded warm replica's queueing delay can
            # exceed what skipping the swap saves.  Backends without the
            # model in their catalog are excluded once ANY backend
            # advertises it (they would serve the wrong weights).
            model = (payload.get("model")
                     if isinstance(payload, dict) else None)
            if isinstance(model, str) and model:
                warmth = {"serving": 0, "resident": 1, "host": 2,
                          "spill": 3, "cold": 4}
                known = [(warmth.get(b.models.get(model), 9), b)
                         for b in pool if model in b.models]
                if known:
                    best = min(rank for rank, _ in known)
                    warm = [b for rank, b in known if rank == best]
                    warm_least = min(warm, key=lambda b: b.outstanding)
                    idlest = min(pool, key=lambda b: b.outstanding)
                    if (warm_least.outstanding - idlest.outstanding
                            <= self.config.affinity_load_slack):
                        pool = warm
            chars = self.config.affinity_prefix_chars
            key = (affinity_key(payload, chars)
                   if payload is not None else None)
            least = min(pool, key=lambda b: b.outstanding)
            chosen = least
            if key is not None:
                # Cache-aware affinity: backends whose advertised digest
                # says they HAVE this prefix (across HBM/host/PVC tiers)
                # outrank the static ring's guess — after failovers or
                # slack diversions, the replica actually holding a
                # conversation's KV is often not the rendezvous target.
                # Membership is probed with EACH backend's advertised
                # prefix length (keys memoised per length), so a gateway
                # configured with a non-default affinity_prefix_chars
                # still matches what the backends tracked.  Rendezvous
                # WITHIN the digest-hit subset keeps multiple gateway
                # replicas deterministic for the same backend state; no
                # digest info (old backends, first probe pending)
                # degrades to the plain ring.
                keys_by_chars = {chars: key}

                def bkey(b):
                    c = b.kv_digest_chars or chars
                    if c not in keys_by_chars:
                        keys_by_chars[c] = affinity_key(payload, c)
                    return keys_by_chars[c]

                hits = [b for b in pool
                        if digest_has(b.kv_digest, b.kv_digest_bits,
                                      bkey(b))]
                target = self._rendezvous_target(key, hits or pool)
                if (target.outstanding - least.outstanding
                        <= self.config.affinity_load_slack):
                    chosen = target
            chosen.outstanding += 1
            return chosen

    def release(self, backend: Backend, ok: bool) -> None:
        """Return a backend after a request.  ``ok=False`` covers BOTH
        connect failures and 5xx responses (the HTTPError relay path
        passes ``ok=e.code < 500``); enough consecutive failures eject
        the backend until the health loop readmits it."""
        with self._lock:
            backend.outstanding = max(backend.outstanding - 1, 0)
            if ok:
                backend.consecutive_failures = 0
            else:
                backend.consecutive_failures += 1
                if (backend.consecutive_failures
                        >= self.config.eject_after_failures):
                    if backend.healthy:
                        backend.eject_count += 1
                        backend.backoff_until = (
                            time.monotonic()
                            + self._eject_backoff_s(backend.eject_count))
                        logger.warning(
                            "ejecting backend %s after %d consecutive "
                            "failures (readmission probe backs off "
                            "%.1fs, episode %d)",
                            backend.url, backend.consecutive_failures,
                            backend.backoff_until - time.monotonic(),
                            backend.eject_count)
                    backend.healthy = False

    # ---- health checking ------------------------------------------------

    def probe_backends_once(self) -> None:
        """One health-probe round: readmits ejected backends whose
        /healthz passes again (resetting their failure count) and ejects
        ones that stopped answering.  An ejected backend still inside
        its jittered exponential backoff window is NOT probed — repeated
        eject episodes push readmission attempts further apart instead
        of hammering a flapping replica on the health-loop cadence.  The
        background loop below is just this on a timer."""
        for b in self.backends:
            with self._lock:
                if not b.healthy and time.monotonic() < b.backoff_until:
                    continue          # ejected + backing off: don't probe
            digest, digest_bits, digest_chars = None, 0, 0
            models, model_current = None, ""
            probe_t0 = time.monotonic()
            try:
                with urllib.request.urlopen(
                        b.url + "/healthz",
                        timeout=self.config.health_timeout_s) as resp:
                    ok = resp.status == 200
                    if ok:
                        try:
                            info = json.loads(resp.read())
                            digest = info.get("kv_digest")
                            digest_bits = int(info.get("kv_digest_bits")
                                              or 0)
                            digest_chars = int(info.get("kv_digest_chars")
                                               or 0)
                            # model-pool catalog digest: [{"name","tier"}]
                            cat = info.get("models")
                            if isinstance(cat, list):
                                models = {
                                    str(m["name"]): str(m["tier"])
                                    for m in cat
                                    if isinstance(m, dict) and "name" in m}
                                model_current = str(
                                    info.get("model_current") or "")
                        except Exception:
                            pass     # plain-liveness backend: no digest
            except Exception:
                ok = False
            probe_latency = time.monotonic() - probe_t0
            with self._lock:
                b.last_probe_latency_s = round(probe_latency, 6)
                b.probe_failures = 0 if ok else b.probe_failures + 1
                if ok:
                    now = time.monotonic()
                    if not b.healthy:
                        logger.info("readmitting backend %s (health probe "
                                    "passed after backoff episode %d)",
                                    b.url, b.eject_count)
                        b.healthy_since = now
                    elif (b.eject_count and b.healthy_since
                          and now - b.healthy_since
                          >= self.config.readmit_reset_healthy_s):
                        # sustained health since readmission: the flap is
                        # over, the next ejection starts the ladder from
                        # its base again
                        b.eject_count = 0
                    b.healthy = True
                    b.consecutive_failures = 0
                    if isinstance(digest, str):
                        b.kv_digest = digest
                        b.kv_digest_bits = digest_bits
                        b.kv_digest_chars = digest_chars
                    if models is not None:
                        b.models = models
                        b.model_current = model_current
                else:
                    b.healthy = False
                b.last_checked = time.monotonic()

    def _health_loop(self):
        while not self._stop.wait(self.config.health_interval_s):
            if self.config.backends_file or self.config.backends_url:
                # reload BEFORE probing: a just-added backend gets its
                # admission probe this very round
                try:
                    self.reload_backends()
                except Exception:
                    logger.exception("backend source reload failed")
            self.probe_backends_once()

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> int:
        gw = self

        class Handler(_GatewayHandler):
            ctx = gw

        from tpuserve_torch.server.openai_api import _HTTPServer
        self._httpd = _HTTPServer((self.config.host, self.config.port),
                                  Handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="tpuserve-gateway").start()
        self._health_thread = threading.Thread(target=self._health_loop,
                                               daemon=True,
                                               name="tpuserve-gateway-health")
        self._health_thread.start()
        port = self._httpd.server_address[1]
        if self.config.canary_interval_s > 0:
            from tpuserve_torch.obs.canary import CanaryConfig, CanaryProber
            # probe whatever address the listener actually binds — a
            # gateway bound to a specific interface does not answer on
            # loopback, and a prober dialing the wrong address would
            # report a permanent false breach (and scale the fleet out)
            probe_host = ("127.0.0.1"
                          if self.config.host in ("", "0.0.0.0", "::")
                          else self.config.host)
            self.canary = CanaryProber(
                f"http://{probe_host}:{port}",
                CanaryConfig(interval_s=self.config.canary_interval_s))
            self.canary.start()
        logger.info("gateway on :%d -> %s", port,
                    [b.url for b in self.backends])
        return port

    def shutdown(self) -> None:
        self._stop.set()
        if self.canary is not None:
            self.canary.stop()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    def status(self) -> dict:
        with self._lock:
            out = {"backends": [dataclasses.asdict(b) for b in self.backends],
                   "affinity": "rendezvous",
                   "unserved_total": self.unserved_total,
                   "unserved_by_model": dict(self.unserved_by_model)}
        if self.tenants is not None:
            out["tenants"] = self.tenants.snapshot()
        if self.canary is not None:
            # breach state for the autoscaler's status poll (the same
            # fetch that reads unserved_total) — scale out when the
            # black-box view says a class stopped answering
            out["canary"] = self.canary.snapshot()
        return out

    def slo_status(self) -> dict:
        """Fleet SLO view (GET /gateway/slo): every healthy backend's
        in-process burn-rate state + per-class SLI percentiles
        (scraped off /debug/engine on demand), the per-backend probe
        health, and the gateway's own black-box canary — the aggregate
        the multi-gateway tier reads, owned by no single serving
        process."""
        with self._lock:
            backends = list(self.backends)

        def scrape(b):
            entry: dict = {
                "healthy": b.healthy,
                "probe_failures": b.probe_failures,
                "last_probe_latency_s": b.last_probe_latency_s,
            }
            if b.healthy:
                try:
                    with urllib.request.urlopen(
                            b.url + "/debug/engine",
                            timeout=self.config.health_timeout_s) as r:
                        snap = json.loads(r.read())
                    entry["sli"] = snap.get("sli") or {}
                    entry["slo"] = snap.get("slo") or {}
                except Exception as e:
                    entry["error"] = str(e) or type(e).__name__
            return b.url, entry

        # concurrent scrapes: one slow replica must cost ONE timeout,
        # not N serialized ones, on an ops endpoint a dashboard polls
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(8, max(len(backends),
                                                       1))) as pool:
            results = list(pool.map(scrape, backends))
        per_backend: dict = {}
        firing: set = set()
        sli_worst: dict = {}
        for url, entry in results:
            per_backend[url] = entry
            firing.update((entry.get("slo") or {}).get("firing") or ())
            for cls, kinds in (entry.get("sli") or {}).items():
                for kind, pct in kinds.items():
                    cur = sli_worst.setdefault(cls, {}).get(kind)
                    if (cur is None or (pct.get("p95") or 0)
                            > (cur.get("p95") or 0)):
                        sli_worst[cls][kind] = pct
        out = {
            "backends": per_backend,
            # union of in-process firing alerts across the fleet plus
            # the worst per-class/kind SLI percentiles — "is any
            # replica eating its budget" without a Prometheus query
            "firing": sorted(firing),
            "sli_worst": sli_worst,
        }
        if self.canary is not None:
            out["canary"] = self.canary.snapshot()
        return out


class _GatewayHandler(BaseHTTPRequestHandler):
    ctx: Gateway
    protocol_version = "HTTP/1.1"
    # small chunked re-writes per relayed SSE event — same Nagle story as
    # the engine server (tools/load_test.py)
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _send_json_safely(self, code: int, data: bytes,
                          headers: Optional[dict] = None) -> None:
        """Write a JSON response, swallowing client-gone errors (the
        client may have hung up while backends were being tried)."""
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _relay(self, method: str):
        ctx = self.ctx
        if self.path in ("/gateway/status", "/gateway/slo"):
            payload = (ctx.status() if self.path == "/gateway/status"
                       else ctx.slo_status())
            data = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        # Gateway span + W3C context propagation: the gateway emits its
        # own span (parented to the caller's traceparent when present)
        # and injects its context into the upstream request, so
        # gateway -> server -> engine lifecycle is ONE trace tree in the
        # reference-parity OTel pipeline.  Degrades to a no-op exactly
        # like RequestTracer: without the SDK the span is a noop and the
        # caller's traceparent passes through verbatim (_relay_inner).
        from tpuserve_torch.server.tracing import extract_context, get_tracer
        with get_tracer().request_span(
                "gateway " + self.path,
                context=extract_context(self.headers),
                **{"http.method": method}):
            self._relay_inner(method)

    def _relay_inner(self, method: str):
        ctx = self.ctx
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else None
        # Per-tenant rate limiting for the whole pool (server/tenants.py):
        # charge the admission estimate here, settle against the
        # response's real usage below.  tenant = mapped API key or the
        # "model" (LoRA adapter) field.
        tenant, charged, inject_cls = None, 0, None
        # body parsed ONCE for both tenancy and affinity; failover
        # retries reuse the same parse
        payload = (ctx._affinity_payload(body)
                   if method == "POST" and body else None)
        # synthetic canary probes (tpuserve_torch/obs/canary.py) are excluded
        # from gateway tenancy exactly like server-side metering: the
        # prober must not drain a tenant's bucket or bill its usage.
        # Token-gated (TPUSERVE_CANARY_TOKEN) so a tenant can't tag its
        # own traffic to dodge the rate limit.
        from tpuserve_torch.obs.canary import is_canary_header
        canary = is_canary_header(self.headers.get("X-TPUServe-Canary"))
        # tenancy covers the COMPLETION routes only — the same set the
        # engine server meters, so moving the config between the two
        # documented layers never changes which traffic is limited
        # (embeddings don't fit the token-bucket cost model anyway)
        if (not canary and ctx.tenants is not None and payload is not None
                and self.path in ("/v1/completions",
                                  "/v1/chat/completions")):
            from tpuserve_torch.server.tenants import estimate_cost
            tenant = ctx.tenants.resolve(
                self.headers.get("Authorization"), payload.get("model"))
            charged = estimate_cost(payload)
            if (payload.get("slo_class") is None
                    and not self.headers.get("X-SLO-Class")):
                # gateway-only tenancy: the engine server's registry is
                # empty there, so the tenant's configured default class
                # must travel with the request or it silently degrades
                # to 'standard'
                inject_cls = ctx.tenants.slo_class_for(tenant)
            retry = ctx.tenants.charge(tenant, charged)
            if retry is not None:
                self._send_json_safely(429, json.dumps({"error": {
                    "message": f"tenant {tenant!r} token rate limit "
                               f"exceeded; retry in {retry:.1f}s",
                    "type": "rate_limit_exceeded"}}).encode(),
                    headers={"Retry-After": str(int(retry) + 1)})
                return

        def settle(actual: int) -> None:
            nonlocal tenant
            if tenant is not None:
                ctx.tenants.settle(tenant, charged, actual)
                tenant = None
        # Connect-level failover: an unreachable backend costs one retry on
        # the next candidate, not a client-visible 502, as long as another
        # backend remains untried (no response bytes have flowed yet, so
        # the retry is safe for streaming and non-streaming alike).
        tried: set[str] = set()
        backend_ok = True      # only upstream failures count against it
        headers_sent = False
        while True:
            backend = ctx.pick_backend(body if method == "POST" else None,
                                       exclude=tried, payload=payload)
            if backend is None:
                # dynamic pool currently empty (scaled to zero): count
                # the demand — the autoscaler polls it off
                # /gateway/status — and send the client back with a
                # retryable 503 sized to one boot
                with ctx._lock:
                    ctx.unserved_total += 1
                    m = (payload.get("model")
                         if isinstance(payload, dict) else None)
                    if isinstance(m, str) and m:
                        ctx.unserved_by_model[m] = (
                            ctx.unserved_by_model.get(m, 0) + 1)
                settle(0)
                self._send_json_safely(503, json.dumps({"error": {
                    "message": "no backends in the pool (scaled to "
                               "zero); retry shortly",
                    "type": "server_error"}}).encode(),
                    headers={"Retry-After": "5"})
                return
            try:
                fwd = {"Content-Type": self.headers.get(
                    "Content-Type", "application/json")}
                for h in ("Authorization", "X-SLO-Class", "traceparent",
                          "tracestate", "X-TPUServe-Canary"):
                    # tenant identity + SLO class must reach the engine
                    # server (per-tenant default class, exact metering);
                    # trace context passes through so an SDK-less gateway
                    # still links the caller's trace to the server span;
                    # the canary tag rides along so the server excludes
                    # probes from metering + SLI histograms too
                    if self.headers.get(h):
                        fwd[h] = self.headers[h]
                if inject_cls:
                    fwd["X-SLO-Class"] = inject_cls
                # with the SDK active, the gateway SPAN becomes the
                # upstream parent (overwrites the pass-through value)
                from tpuserve_torch.server.tracing import inject_headers
                inject_headers(fwd)
                req = urllib.request.Request(
                    backend.url + self.path, data=body, method=method,
                    headers=fwd)
                resp_ctx = urllib.request.urlopen(
                    req, timeout=ctx.config.upstream_timeout_s)
                break
            except urllib.error.HTTPError as e:
                # an HTTP error *response* from the backend: relay it;
                # 5xx counts against the backend's health.  Release before
                # writing — a client that hung up must not leak the
                # backend's outstanding count.
                ctx.release(backend, ok=e.code < 500)
                settle(0)           # nothing served: full refund
                try:
                    data = e.read()
                except Exception:        # body lost mid-flight
                    data = b'{"error":{"message":"upstream error"}}'
                hdrs = ({"Retry-After": e.headers["Retry-After"]}
                        if e.headers.get("Retry-After") else None)
                self._send_json_safely(e.code, data, headers=hdrs)
                return
            except Exception as e:
                ctx.release(backend, ok=False)
                logger.warning("upstream %s failed: %s", backend.url, e)
                if _is_connect_failure(e):
                    tried.add(backend.url)
                    if len(tried) < len(ctx.backends):
                        continue
                    msg = "all upstream backends unreachable"
                else:
                    # the backend may already be executing the request
                    # (read timeout / mid-request reset): retrying would
                    # duplicate inference work — surface the failure
                    msg = f"upstream {backend.url} failed mid-request"
                settle(0)
                self._send_json_safely(502, json.dumps({"error": {
                    "message": msg, "type": "bad_gateway"}}).encode())
                return
        try:
            with resp_ctx as resp:
                self.send_response(resp.status)
                ctype = resp.headers.get("Content-Type", "application/json")
                self.send_header("Content-Type", ctype)
                if "event-stream" in ctype:
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    headers_sent = True
                    tail = b""
                    while True:
                        try:
                            chunk = resp.read1(65536)
                        except Exception:
                            backend_ok = False      # upstream died mid-stream
                            break
                        if not chunk:
                            break
                        # rolling tail: the final usage chunk (when the
                        # client asked for stream_options.include_usage)
                        # lives in the last few events
                        tail = (tail + chunk)[-8192:]
                        self.wfile.write(hex(len(chunk))[2:].encode()
                                         + b"\r\n" + chunk + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                    # settle against the stream's OWN final usage chunk
                    # when present — charging max_tokens*n for a short
                    # answer would drain the tenant's bucket many times
                    # faster than real consumption.  Streams without
                    # include_usage keep the admission estimate.
                    m = re.findall(rb'"total_tokens":\s*(\d+)', tail)
                    settle(int(m[-1]) if m else charged)
                else:
                    data = resp.read()
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    headers_sent = True
                    self.wfile.write(data)
                    try:
                        # settle against the response's real usage
                        settle(int(json.loads(data)["usage"]
                                   ["total_tokens"]))
                    except Exception:
                        settle(charged)     # no usage: estimate stands
        except (BrokenPipeError, ConnectionResetError):
            pass                      # client went away — backend is fine
        except Exception:
            logger.exception("gateway relay failed")
            if not headers_sent:
                try:
                    data = b'{"error":{"message":"gateway error"}}'
                    self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except Exception:
                    pass
        finally:
            settle(charged)         # no-op when already settled above
            ctx.release(backend, backend_ok)

    def do_GET(self):
        if self.path == "/healthz":
            data = b'{"status":"ok"}'
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        if self.path == "/metrics" and self.ctx.canary is not None:
            # the embedded prober's black-box tpuserve_canary_* SLIs —
            # the gateway's only metrics surface; without a prober the
            # path relays to a backend like any other GET
            data = self.ctx.canary.metrics.render()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        self._relay("GET")

    def do_POST(self):
        self._relay("POST")


def build_parser():
    import argparse
    ap = argparse.ArgumentParser("tpuserve_torch.gateway")
    ap.add_argument("--backend", action="append", default=None,
                    help="backend URL (repeatable)")
    ap.add_argument("--backends-file", default=None, metavar="PATH",
                    help="poll-able backend list (JSON list or one URL "
                         "per line), re-read every health round — the "
                         "autoscaler's reconciler publishes one; "
                         "backends join/leave without a restart")
    ap.add_argument("--backends-url", default=None, metavar="URL",
                    help="HTTP twin of --backends-file")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--tenant-config", default=None, metavar="JSON|PATH",
                    help="per-tenant token metering + rate limits for "
                         "the whole pool (server/tenants.py); default: "
                         "TPUSERVE_TENANTS env")
    ap.add_argument("--canary-interval", type=float, default=0.0,
                    metavar="SECONDS",
                    help="run the embedded synthetic canary: one tagged "
                         "tiny request per SLO class through this "
                         "gateway every SECONDS (tpuserve_torch/obs/"
                         "canary.py); black-box tpuserve_canary_* "
                         "SLIs on /metrics, breach state on "
                         "/gateway/status.  0 = off")
    return ap


def main(argv=None):
    """``python -m tpuserve_torch.server.gateway``: serve until SIGTERM (a
    pod's termination) or Ctrl-C, then stop and exit 0."""
    import signal
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.backend and not (args.backends_file or args.backends_url):
        ap.error("need --backend, --backends-file, or --backends-url")
    logging.basicConfig(level=logging.INFO)
    gw = Gateway(args.backend or [],
                 GatewayConfig(host=args.host, port=args.port,
                               tenant_config=args.tenant_config,
                               backends_file=args.backends_file,
                               backends_url=args.backends_url,
                               canary_interval_s=args.canary_interval))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    port = gw.start()
    print(f"gateway listening on :{port}", flush=True)
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    gw.shutdown()


if __name__ == "__main__":
    main()
