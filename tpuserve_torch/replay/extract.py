"""Flight-recorder bundle -> replay workload extraction.

The port's own copy of ``tpuserve/replay/extract.py``: a bundle of either
package extracts to the same workload.

A bundle (post-mortem or ``/debug/engine/dump`` export,
``runtime/flight.py dump_bundle``) holds per-request lifecycle
timelines; this module folds them back into the arrival process, length
mix, class mix and fault schedule that produced them — the workload
file ``tpuserve_torch/replay/harness.py`` replays.

Loud by design:

- schema: a bundle *newer* than this build is rejected; a legacy
  unversioned (v1) bundle is upgraded with a warning (v1 had no
  ring-integrity markers, engine facts, or ``max_tokens`` on QUEUED —
  the upgrade notes exactly what it had to guess).
- truncation: the recorder's rings are bounded, so a long incident's
  oldest events are overwritten.  The dump-time cursor/drop markers
  (``rings``) plus timelines that lack their QUEUED event are *reported*
  (``meta.truncated`` / ``meta.partial_requests`` + a warning) instead
  of silently shrinking the workload.
- fault schedule: FAULT events are re-armed as deterministic
  ``runtime/faults.py`` rules pinned to the same request ids
  (``site:mode:1.0:count=N:match=rid``).  ``hang`` rules are re-armed
  as ``raise`` (a released hang re-enters the fault path as a raise,
  and the synchronous replay loop has no watchdog thread to release
  one); ``delay`` rules are dropped (they shape wall time, which replay
  virtualizes) — both downgrades are noted in ``meta``.
"""

from __future__ import annotations

import json
import logging
import zlib
from typing import Optional

from tpuserve_torch.runtime.flight import FLIGHT_SCHEMA_VERSION
from tpuserve_torch.replay.workload import Workload, WorkloadRequest

logger = logging.getLogger("tpuserve_torch.replay")

# defaults for fields a truncated/legacy timeline no longer carries
DEFAULT_PROMPT_TOKENS = 32
DEFAULT_MAX_TOKENS = 16
# a chaos soak can log thousands of FAULT events; the re-armed spec is
# capped (dropped rules are counted in meta, never silently)
MAX_FAULT_RULES = 64


def load_bundle(path: str) -> dict:
    """Load a bundle file; a disagg pod's ``/debug/engine/dump`` payload
    ({"engines": [...]}) is merged into one bundle (same process, same
    monotonic domain — timelines interleave correctly)."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return merge_engine_bundles(data)


def merge_engine_bundles(data: dict) -> dict:
    if not isinstance(data, dict):
        raise ValueError(f"bundle must be a JSON object, got {type(data)}")
    bundles = data.get("engines")
    if not bundles:
        return data
    merged = dict(bundles[0])
    merged["requests"] = dict(bundles[0].get("requests", {}))
    merged["steps"] = list(bundles[0].get("steps", ()))
    for b in bundles[1:]:
        for rid, tl in b.get("requests", {}).items():
            prev = merged["requests"].get(rid)
            merged["requests"][rid] = sorted(
                (prev or []) + tl, key=lambda e: e["t"])
        merged["steps"] += b.get("steps", ())
    merged["steps"].sort(key=lambda s: s["t"])
    return merged


def _timeline_first(timeline: list, event: str) -> Optional[dict]:
    for e in timeline:
        if e["event"] == event:
            return e
    return None


def _timeline_last(timeline: list, event: str) -> Optional[dict]:
    hit = None
    for e in timeline:
        if e["event"] == event:
            hit = e
    return hit


def workload_from_bundle(bundle: dict, *, seed: int = 0) -> Workload:
    """Convert one flight bundle into a replayable workload (see module
    docstring for the loudness contract)."""
    bundle = merge_engine_bundles(bundle)
    if bundle.get("kind") == "tpuserve-replay-workload":
        raise ValueError("this is already a workload file — pass it to "
                         "replay.replay directly")
    if not isinstance(bundle.get("requests"), dict):
        raise ValueError("not a flight bundle: no 'requests' timeline "
                         "map (post-mortem bundles and /debug/engine/dump "
                         "exports have one)")
    meta: dict = {"source_reason": bundle.get("reason"),
                  "source_schema": bundle.get("schema", 1)}
    sv = bundle.get("schema")
    if sv is None:
        logger.warning(
            "legacy unversioned flight bundle: upgrading as schema v1 — "
            "no ring-integrity markers or engine facts; generation "
            "budgets of unfinished requests fall back to %d tokens",
            DEFAULT_MAX_TOKENS)
        meta["upgraded_from_schema"] = 1
    elif int(sv) > FLIGHT_SCHEMA_VERSION:
        raise ValueError(
            f"flight bundle schema {sv} is newer than this build "
            f"understands ({FLIGHT_SCHEMA_VERSION}) — upgrade the tree "
            "before replaying this dump")

    # ---- truncation / integrity ---------------------------------------
    rings = bundle.get("rings") or {}
    dropped = sum(int(r.get("dropped", 0)) for r in rings.values())
    torn = any(r.get("torn") for r in rings.values())
    if dropped:
        meta["ring_dropped_entries"] = dropped
    if torn:
        meta["ring_torn"] = True

    timelines = bundle.get("requests", {})
    requests: list = []
    partial = 0
    t_anchor = min((tl[0]["t"] for tl in timelines.values() if tl),
                   default=0.0)
    fault_fires: dict = {}          # (rid, site, mode) -> [count, first_t]

    for rid, tl in sorted(timelines.items()):
        if not tl:
            continue
        queued = _timeline_first(tl, "QUEUED")
        shed = _timeline_first(tl, "SHED")
        finished = _timeline_last(tl, "FINISHED")
        head = queued or shed or tl[0]
        detail = dict(head.get("detail") or {})
        if queued is None:
            # intake-shed requests legitimately have no QUEUED event;
            # anything else lost its head to the ring — a partial record
            if shed is None:
                partial += 1
            detail.setdefault("prompt_tokens", DEFAULT_PROMPT_TOKENS)
        arrival = max(0.0, head["t"] - t_anchor)
        fin_detail = dict(finished.get("detail") or {}) if finished else {}
        outcome = (fin_detail.get("cause") if finished
                   else "shed" if shed is not None and queued is None
                   else "unfinished")
        # generation budget: what the incident actually produced when it
        # finished (so replay offers the same decode load), else the
        # recorded request budget, else the default
        if finished and fin_detail.get("output_tokens"):
            max_tokens = int(fin_detail["output_tokens"])
        else:
            max_tokens = int(detail.get("max_tokens", DEFAULT_MAX_TOKENS))
        requests.append(WorkloadRequest(
            request_id=rid,
            arrival_s=round(arrival, 6),
            prompt_tokens=int(detail.get("prompt_tokens",
                                         DEFAULT_PROMPT_TOKENS)),
            max_tokens=max(1, max_tokens),
            slo_class=detail.get("slo_class", "standard"),
            # deterministic per-request sampling seed: crc32, NOT the
            # process-salted builtin hash
            seed=zlib.crc32(rid.encode()) & 0x7FFFFFFF,
            source_outcome=outcome,
        ))
        for e in tl:
            if e["event"] == "FAULT":
                d = e.get("detail") or {}
                key = (rid, d.get("site"), d.get("mode"))
                if key[1] and key[2]:
                    cnt_t = fault_fires.setdefault(key, [0, e["t"]])
                    cnt_t[0] += 1

    if partial:
        meta["partial_requests"] = partial
    if partial or dropped or torn:
        meta["truncated"] = True
        logger.warning(
            "bundle timeline is incomplete (%d overwritten ring entries, "
            "%d request(s) missing their QUEUED event%s) — the extracted "
            "workload REPORTS this instead of silently shrinking; "
            "arrival/length defaults fill the gaps", dropped, partial,
            ", torn dump" if torn else "")

    # ---- fault schedule ------------------------------------------------
    rules = []
    downgraded_hangs = dropped_delays = 0
    for (rid, site, mode), (count, first_t) in sorted(
            fault_fires.items(), key=lambda kv: kv[1][1]):
        if mode == "delay":
            dropped_delays += count
            continue
        if mode == "hang":
            downgraded_hangs += count
            mode = "raise"
        rule = f"{site}:{mode}:1.0:count={count}"
        if rid and rid != "(engine)":
            rule += f":match={rid}"
        rules.append(rule)
    if len(rules) > MAX_FAULT_RULES:
        meta["fault_rules_dropped"] = len(rules) - MAX_FAULT_RULES
        logger.warning("fault schedule capped at %d rules (%d dropped)",
                       MAX_FAULT_RULES, meta["fault_rules_dropped"])
        rules = rules[:MAX_FAULT_RULES]
    if downgraded_hangs:
        meta["fault_hangs_as_raise"] = downgraded_hangs
    if dropped_delays:
        meta["fault_delays_dropped"] = dropped_delays
    faults = ",".join(rules) + (f",seed={seed}" if rules else "") or None

    # ---- source-side context for the replay report --------------------
    steps = [s for s in bundle.get("steps", ()) if s.get("rows", 0) > 0]
    if steps:
        meta["mean_step_ms"] = round(
            sum(s.get("ms", 0.0) for s in steps) / len(steps), 4)
        meta["source_wall_span_s"] = round(
            bundle["steps"][-1]["t"] - bundle["steps"][0]["t"], 3) \
            if len(bundle.get("steps", ())) > 1 else 0.0
    if bundle.get("engine"):
        meta["source_engine"] = dict(bundle["engine"])
    if bundle.get("sli"):
        meta["source_sli"] = bundle["sli"]

    wl = Workload(requests=sorted(requests,
                                  key=lambda r: (r.arrival_s,
                                                 r.request_id)),
                  seed=seed, faults=faults, meta=meta)
    if not wl.requests:
        raise ValueError("bundle contained no replayable request "
                         "timelines — nothing to extract")
    return wl
