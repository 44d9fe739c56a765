"""Per-tenant token metering and rate limits (multi-tenant serving).

The port's own copy of ``tpuserve/server/tenants.py`` (its imports are the port's).

A tenant is an API key (``Authorization: Bearer <key>`` mapped through
the config) or a LoRA adapter name (one tenant = one adapter — the
multi-LoRA stacked-bank routing is what makes this a real multi-tenant
story); everything else meters under ``default``.  Unknown API keys
deliberately do NOT become tenants of their own: metric label
cardinality stays bounded by the configured set.

Limits are token buckets over *tokens served* (prompt + generated), not
request counts — a tenant streaming 4k-token completions and one
sending 16-token lookups cost the fleet very differently.  A request is
charged an ESTIMATE at admission (prompt estimate + ``max_tokens``) and
settled against actual usage at completion, so the bucket converges on
real consumption without holding admission for a token count that only
exists after generation.

Config (JSON, inline or a file path; ``TPUSERVE_TENANTS`` env or
``--tenant-config``)::

    {"default": {"rate_tps": 0, "burst": 0, "slo_class": null},
     "tenants": {"acme": {"rate_tps": 500, "burst": 5000,
                          "slo_class": "interactive",
                          "api_keys": ["sk-acme-1"]}}}

``rate_tps`` 0 = unlimited (metering only).  ``slo_class`` is the
tenant's default request class (runtime/slo.py), overridable per
request by the ``X-SLO-Class`` header / ``slo_class`` body field.

Enforced at the gateway (one decision for the whole replica pool) or at
a directly-exposed engine server — configure ONE layer, not both, or
every request is charged twice.  Both layers cover the same routes
(``/v1/completions`` + ``/v1/chat/completions``), so moving the config
between them never changes which traffic is limited.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

from tpuserve_torch.runtime.slo import SLO_CLASSES

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantLimit:
    rate_tps: float = 0.0        # token-bucket refill (tokens/s); 0 = no limit
    burst: float = 0.0           # bucket capacity; 0 = 10s of rate
    slo_class: Optional[str] = None   # default SLO class for this tenant

    @property
    def capacity(self) -> float:
        return self.burst or (10.0 * self.rate_tps)


def _parse_limit(name: str, raw: dict) -> TenantLimit:
    if not isinstance(raw, dict):
        raise ValueError(f"tenant {name!r} config must be an object")
    rate = float(raw.get("rate_tps", 0.0))
    burst = float(raw.get("burst", 0.0))
    if rate < 0 or burst < 0:
        raise ValueError(f"tenant {name!r}: rate_tps/burst must be >= 0")
    cls = raw.get("slo_class")
    if cls is not None and cls not in SLO_CLASSES:
        raise ValueError(f"tenant {name!r}: unknown slo_class {cls!r} "
                         f"(one of {'/'.join(SLO_CLASSES)})")
    extra = set(raw) - {"rate_tps", "burst", "slo_class", "api_keys"}
    if extra:
        raise ValueError(f"tenant {name!r}: unknown keys {sorted(extra)}")
    return TenantLimit(rate_tps=rate, burst=burst, slo_class=cls)


class TenantRegistry:
    """Thread-safe tenant resolution + token-bucket accounting (HTTP
    handler threads in the gateway AND the engine server call in)."""

    def __init__(self, limits: Optional[dict] = None,
                 default: Optional[TenantLimit] = None,
                 api_keys: Optional[dict] = None):
        self.limits: dict[str, TenantLimit] = dict(limits or {})
        self.default = default or TenantLimit()
        self._api_keys = dict(api_keys or {})      # bearer key -> tenant
        # tenants that configured api_keys REQUIRE key auth to be
        # attributed: the "model" field is client-controlled, and
        # resolving a keyed tenant from it would let an unauthenticated
        # caller drain that tenant's bucket / pollute its billing
        self._keyed = set(self._api_keys.values())
        self._lock = threading.Lock()
        # token buckets start FULL; (available, last_refill_ts)
        self._buckets: dict[str, list] = {}
        self._usage: dict[str, int] = {}           # tokens served
        self._limited: dict[str, int] = {}         # 429s issued

    # ---- config ---------------------------------------------------------

    @classmethod
    def from_config(cls, cfg: dict) -> "TenantRegistry":
        if not isinstance(cfg, dict):
            raise ValueError("tenant config must be a JSON object")
        extra = set(cfg) - {"default", "tenants"}
        if extra:
            raise ValueError(f"tenant config: unknown keys {sorted(extra)}")
        default = _parse_limit("default", cfg.get("default") or {})
        limits, keys = {}, {}
        for name, raw in (cfg.get("tenants") or {}).items():
            limits[name] = _parse_limit(name, raw)
            for k in (raw or {}).get("api_keys") or ():
                if k in keys:
                    raise ValueError(f"api key mapped to both "
                                     f"{keys[k]!r} and {name!r}")
                keys[k] = name
        return cls(limits, default, keys)

    @classmethod
    def load(cls, source: Optional[str] = None) -> Optional["TenantRegistry"]:
        """Build from ``source`` (inline JSON or a file path), falling
        back to the ``TPUSERVE_TENANTS`` env var; None when nothing is
        configured (tenancy then meters everything under 'default')."""
        source = source or os.environ.get("TPUSERVE_TENANTS")
        if not source:
            return None
        text = source
        if not source.lstrip().startswith("{"):
            with open(source) as f:
                text = f.read()
        return cls.from_config(json.loads(text))

    # ---- resolution -----------------------------------------------------

    def resolve(self, authorization: Optional[str] = None,
                model: Optional[str] = None,
                adapters: tuple = ()) -> str:
        """Tenant for a request: mapped API key first (the stronger
        identity), then the LoRA adapter the request selected, else
        'default'.  Unknown keys fold into 'default' — label
        cardinality must stay bounded by configuration — and a tenant
        that configured api_keys is NEVER attributed from the
        client-controlled "model" field alone: without its key the
        request bills to 'default' instead of draining that tenant's
        bucket credential-free."""
        if authorization:
            key = authorization.split(" ", 1)[-1].strip()
            tenant = self._api_keys.get(key)
            if tenant is not None:
                return tenant
        if isinstance(model, str) and model and (
                model in self.limits or model in adapters) \
                and model not in self._keyed:
            return model
        return DEFAULT_TENANT

    def limit_for(self, tenant: str) -> TenantLimit:
        return self.limits.get(tenant, self.default)

    def slo_class_for(self, tenant: str) -> Optional[str]:
        return self.limit_for(tenant).slo_class

    # ---- token buckets --------------------------------------------------

    def _refill(self, tenant: str, lim: TenantLimit, now: float) -> list:
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = [lim.capacity, now]
        else:
            b[0] = min(lim.capacity, b[0] + (now - b[1]) * lim.rate_tps)
            b[1] = now
        return b

    def charge(self, tenant: str, tokens: float,
               now: Optional[float] = None) -> Optional[float]:
        """Debit ``tokens`` from the tenant's bucket.  Returns None when
        admitted, else the Retry-After seconds until the bucket could
        cover the request.  A FULL bucket always admits (a single
        request larger than the burst must not 429 forever — it just
        drives the bucket negative and throttles what follows)."""
        lim = self.limit_for(tenant)
        if lim.rate_tps <= 0:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            b = self._refill(tenant, lim, now)
            if b[0] >= min(tokens, lim.capacity):
                b[0] -= tokens
                return None
            self._limited[tenant] = self._limited.get(tenant, 0) + 1
            short = min(tokens, lim.capacity) - b[0]
            return max(short / lim.rate_tps, 0.05)

    def settle(self, tenant: str, charged: float, actual: int,
               now: Optional[float] = None) -> None:
        """Reconcile the admission estimate against tokens actually
        served (refunds an over-estimate, debits an under-estimate) and
        meter the usage."""
        lim = self.limit_for(tenant)
        now = time.monotonic() if now is None else now
        with self._lock:
            self._usage[tenant] = self._usage.get(tenant, 0) + int(actual)
            if lim.rate_tps > 0:
                b = self._refill(tenant, lim, now)
                b[0] = min(lim.capacity, b[0] + (charged - actual))

    # ---- observability --------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {"usage_tokens": dict(self._usage),
                    "rate_limited": dict(self._limited),
                    "tenants": sorted(self.limits)}


def estimate_cost(body: dict, default_max_tokens: int = 16) -> int:
    """Admission-time token estimate for the rate limiter: ~prompt
    tokens (4 chars/token heuristic for text, exact for token-id
    prompts) plus the requested generation budget.  Settled against
    actual usage at completion, so the heuristic only has to be cheap,
    not right."""
    prompt = body.get("prompt")
    if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
        p = len(prompt)
    elif isinstance(prompt, str):
        p = max(1, len(prompt) // 4)
    elif isinstance(body.get("messages"), list):
        p = max(1, sum(len(str(m.get("content") or "")) // 4
                       for m in body["messages"] if isinstance(m, dict)))
    else:
        p = 1
    try:
        mt = int(body.get("max_tokens", default_max_tokens))
    except (TypeError, ValueError):
        mt = default_max_tokens
    try:
        # n parallel choices (or best_of candidates) each generate up to
        # max_tokens — without this an n=8 stream bills 1/8 of its cost
        choices = max(int(body.get("n", 1)), int(body.get("best_of", 1)), 1)
    except (TypeError, ValueError):
        choices = 1
    return p + max(0, mt) * min(choices, 64)
