"""Scrape one replica's engine-emitted autoscaling signals over HTTP.

``/debug/engine`` (server/openai_api.py) carries everything the policy
reads, as plain scalars: the flight recorder's per-class
SLI summary, the ``control`` block the engine refreshes every cycle
(brownout level, per-class queue-delay EWMAs, queue depths), and the
replica's cold-start measurement.  ``/metrics`` is the fallback for
pods running an older server: ``tpuserve_brownout_level`` and the queue
gauges are parsed out of the Prometheus exposition instead (no EWMAs or
SLIs there — the scalar block exists precisely so consumers don't have
to reconstruct percentiles from histogram buckets).
"""

from __future__ import annotations

import json
import logging
import re
import urllib.request
from typing import Optional

from tpuserve_torch.autoscale.policy import ReplicaSignals

logger = logging.getLogger("tpuserve_torch.autoscale")

_GAUGE_RE = {
    "brownout_level": re.compile(
        r"^tpuserve_brownout_level\{[^}]*\}\s+([0-9.eE+-]+)", re.M),
    "waiting": re.compile(
        r"^vllm_num_requests_waiting\{[^}]*\}\s+([0-9.eE+-]+)", re.M),
    "running": re.compile(
        r"^vllm_num_requests_running\{[^}]*\}\s+([0-9.eE+-]+)", re.M),
}


def _merge_engines(payload: dict) -> dict:
    """A disagg pod's /debug/engine reports one snapshot per inner
    engine; the pool cares about the pod's worst/summed view."""
    engines = payload.get("engines")
    if not engines:
        return payload
    merged: dict = {"control": {}, "sli": {}}
    worst = {}
    for snap in engines:
        ctl = snap.get("control") or {}
        for k in ("waiting", "running"):
            merged["control"][k] = merged["control"].get(k, 0) \
                + int(ctl.get(k) or 0)
        lvl = int(ctl.get("brownout_level") or 0)
        if lvl >= worst.get("brownout_level", -1):
            worst = ctl
        # SLI families: first engine reporting a class wins (inner
        # engines of one pod serve the same requests end to end)
        for cls, kinds in (snap.get("sli") or {}).items():
            merged["sli"].setdefault(cls, kinds)
    merged["control"]["brownout_level"] = worst.get("brownout_level", 0)
    merged["control"]["queue_delay_ewma"] = \
        worst.get("queue_delay_ewma") or {}
    merged["cold_start_s"] = payload.get("cold_start_s")
    return merged


def signals_from_debug(name: str, payload: dict,
                       ready: bool = True) -> ReplicaSignals:
    """Build :class:`ReplicaSignals` from a ``/debug/engine`` JSON
    payload (single- or multi-engine form)."""
    snap = _merge_engines(payload)
    ctl = snap.get("control") or {}
    ewma = {cls: v for cls, v in (ctl.get("queue_delay_ewma")
                                  or {}).items() if v is not None}
    return ReplicaSignals(
        name=name, ready=ready,
        brownout_level=int(ctl.get("brownout_level") or 0),
        queue_delay_ewma=ewma,
        waiting=int(ctl.get("waiting") or 0),
        running=int(ctl.get("running") or 0),
        sli=snap.get("sli") or {},
        cold_start_s=snap.get("cold_start_s"),
    )


def signals_from_metrics(name: str, text: str,
                         ready: bool = True) -> ReplicaSignals:
    """Degraded fallback: scrape the scalars available in the
    Prometheus exposition (no EWMAs / SLI percentiles)."""
    vals = {}
    for key, rx in _GAUGE_RE.items():
        m = rx.search(text)
        if m:
            vals[key] = int(float(m.group(1)))
    return ReplicaSignals(name=name, ready=ready,
                          brownout_level=vals.get("brownout_level", 0),
                          waiting=vals.get("waiting", 0),
                          running=vals.get("running", 0))


def scrape_replica(name: str, base_url: str,
                   timeout_s: float = 2.0) -> Optional[ReplicaSignals]:
    """Scrape one replica; ``None`` when it answers neither endpoint
    (booting / mid-restart — the pool counts it, the policy can't read
    it)."""
    base = base_url.rstrip("/")
    try:
        with urllib.request.urlopen(base + "/debug/engine",
                                    timeout=timeout_s) as resp:
            return signals_from_debug(name, json.loads(resp.read()))
    except Exception as e:
        logger.debug("scrape %s /debug/engine failed: %s", name, e)
    try:
        with urllib.request.urlopen(base + "/metrics",
                                    timeout=timeout_s) as resp:
            return signals_from_metrics(
                name, resp.read().decode("utf-8", "replace"))
    except Exception as e:
        logger.debug("scrape %s /metrics failed: %s", name, e)
    return None
