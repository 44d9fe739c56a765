"""Engine flight recorder: the port of ``tpuserve/runtime/flight.py``.

On by default, as in the JAX engine, it keeps:

- a fixed-size ring of per-request lifecycle **events** (QUEUED, ADMITTED,
  RESTORING, PREFILL, PREFILL_CHUNK, WINDOW, PREEMPTED, SALVAGED,
  BROWNOUT_CLAMPED, SHED, FAULT, FINISHED with its cause);
- a fixed-size ring of per-cycle **step records** (kind, rows, actual and
  padded tokens, wall ms, and the cycle's host phases from
  ``runtime/hostprof.py``, which the recorder switches on);
- per-SLO-class **SLI reservoirs** (client TTFT, ITL and end-to-end
  seconds, fed by the server's runner) that ``/debug/engine`` and the
  brownout controller's transition logs quote;
- **post-mortem bundles**: on a watchdog trip, a fault storm's fail-all or
  a poison isolation, the last cycles and the affected requests'
  timelines are written as one JSON file under ``TPUSERVE_FLIGHT_DIR``
  (the temporary directory when unset) and counted in
  ``tpuserve_flight_postmortems_total``.

Bundles have the JAX recorder's schema (``FLIGHT_SCHEMA_VERSION``) and
keys, so the JAX package's replay extractor reads them.  With the engine's
device profiler on (``runtime/devprof.py``), a step record carries its
``dev`` deltas (device ms from CUDA events, dispatch ms, captures) and
``/debug/engine`` and every bundle a ``devprof`` section (the ladder, the
HBM watermark, the profiler traces taken); with it off they are absent,
as in the JAX recorder.

Threading contract: every mutating call runs on the engine loop thread.
Serving threads take snapshots only: ring entries are immutable tuples, a
snapshot copies the backing list, and a concurrent append at worst
duplicates or misses the newest slot.  The exception is ``postmortem``,
which the watchdog thread calls while the loop is stuck in a step; it
reads snapshots and touches only the recorder's own counters.

Entries hold host values only (str, int, float, bool, None, tuples and
dicts of those), never a tensor: a field read from the card would add a
wait to every cycle.  Timestamps come from the clock seam
(``runtime/clock.py``); the wall clock is read once, as the anchor that
maps them for span export and bundle headers.  ``TPUSERVE_FLIGHT=0`` (or
``EngineConfig.flight=False``) removes the recorder and the profiler.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Sequence

from tpuserve_torch.runtime.clock import MONOTONIC
from tpuserve_torch.runtime.hostprof import PROF
from tpuserve_torch.utils import env_flag

logger = logging.getLogger("tpuserve_torch.flight")

#: bundle schema, the JAX recorder's
FLIGHT_SCHEMA_VERSION = 2

#: lifecycle event names, in rough lifecycle order (the /debug/requests
#: timeline and the OTLP child spans use them verbatim)
EVENTS = ("QUEUED", "ADMITTED", "RESTORING", "PREFILL", "PREFILL_CHUNK",
          "WINDOW", "PREEMPTED", "SALVAGED", "BROWNOUT_CLAMPED", "SHED",
          "FAULT", "SWAP", "FINISHED")

SLI_KINDS = ("ttft", "itl", "e2e")

# bounds the disk a fault storm can fill with bundles
MAX_POSTMORTEMS = 32


class _Ring:
    """Fixed-size append-only ring of immutable entries.  Single writer;
    ``snapshot()`` is safe from any thread (a list copy of tuples)."""

    __slots__ = ("_buf", "_n", "idx")

    def __init__(self, n: int):
        self._buf = [None] * max(2, n)
        self._n = len(self._buf)
        self.idx = 0

    def append(self, item) -> None:
        self._buf[self.idx % self._n] = item
        self.idx += 1

    def snapshot(self) -> list:
        i, buf = self.idx, list(self._buf)
        if i <= self._n:
            return [x for x in buf[:i] if x is not None]
        cut = i % self._n
        return [x for x in buf[cut:] + buf[:cut] if x is not None]


class FlightRecorder:
    def __init__(self, enabled: Optional[bool] = None,
                 events: int = 0, steps: int = 0,
                 dirpath: Optional[str] = None, clock=None):
        if enabled is None:
            enabled = env_flag("TPUSERVE_FLIGHT")
        self.enabled = bool(enabled)
        ev_n = events or int(os.environ.get("TPUSERVE_FLIGHT_EVENTS", 0) or 8192)
        st_n = steps or int(os.environ.get("TPUSERVE_FLIGHT_STEPS", 0) or 512)
        self._events = _Ring(ev_n)
        self._steps = _Ring(st_n)
        self._dir = dirpath or os.environ.get("TPUSERVE_FLIGHT_DIR") or None
        # the engine's clock (runtime/clock.py): virtual under a test's
        # VirtualClock, so its timelines are in that clock's seconds
        self._clock = clock or MONOTONIC
        # monotonic -> wall anchor for span export and bundle headers only;
        # every recorded timestamp and delta stays monotonic
        self._mono0 = self._clock.monotonic()
        self._wall0 = time.time()        # wall-anchor-ok: export mapping, never a delta
        # engine facts (note_engine_facts), carried in bundles so a replay
        # can size a comparable engine
        self._facts: dict = {}
        # the cycle's control scalars (note_control), replaced whole
        self._control: dict = {}
        # a step record's phase ms are diffs against this snapshot of the
        # profiler's cumulative seconds
        self._prof_last: dict = {}
        # client SLI reservoirs: (class, kind) -> bounded ring
        self._sli: dict = {}
        self.postmortems = 0
        self.last_postmortem: Optional[str] = None
        # the owning engine's device profiler (runtime/devprof.py) when it
        # is on; None keeps every record as a profiler-less engine's
        self.devprof = None

    # ---- writes (engine loop thread) ---------------------------------

    def req_event(self, rid: str, event: str, **detail) -> None:
        if not self.enabled:
            return
        self._events.append((self._clock.monotonic(), rid, event, detail or None))

    def req_event_many(self, rids: tuple, event: str, **detail) -> None:
        """:meth:`req_event` for an event that covers every row of a
        dispatch (WINDOW): one timestamp, one ring entry and one shared
        detail dict for the batch."""
        if not self.enabled or not rids:
            return
        self._events.append((self._clock.monotonic(), tuple(rids), event, detail or None))

    def fault_hook(self, site: str, mode: str, rids: Sequence[str]) -> None:
        """``FaultInjector.on_fire`` target: a firing rule shows up in every
        affected request's timeline."""
        if not self.enabled:
            return
        t = self._clock.monotonic()
        for rid in rids or ("(engine)",):
            self._events.append((t, rid, "FAULT", {"site": site, "mode": mode}))

    def note_step(self, kind: str, rows: int, actual: int, padded: int,
                  dur_s: float) -> None:
        """One engine cycle's step record.  Phase ms are deltas of the
        process's profiler since the previous record: exact for one
        engine, approximate when several engines step in one process."""
        if not self.enabled:
            return
        phases = None
        if PROF.enabled:
            cur = dict(PROF.seconds)
            phases = {}
            for k, v in cur.items():
                d = v - self._prof_last.get(k, 0.0)
                if d > 0:
                    phases[k] = round(d * 1000, 4)
            self._prof_last = cur
        dev = self.devprof.step_delta() if self.devprof is not None else None
        self._steps.append((self._clock.monotonic(), kind, rows, actual, padded,
                            round(dur_s * 1000, 4), phases or None, dev))

    def note_engine_facts(self, **facts) -> None:
        """Engine configuration facts stamped into every bundle (recorded
        even when disabled: facts are not trace data)."""
        self._facts.update({k: v for k, v in facts.items() if v is not None})

    def note_control(self, **scalars) -> None:
        """The cycle's control scalars (the brownout level, per-class
        queue-delay EWMAs, queue depths) as plain numbers; the dict is
        replaced whole, so a reader sees one cycle's values."""
        if not self.enabled:
            return
        self._control = scalars

    def note_sli(self, slo_class: str, kind: str, value: float) -> None:
        """One client latency sample (runner loop thread): TTFT,
        inter-token or end-to-end seconds of one request of ``slo_class``."""
        if not self.enabled:
            return
        ring = self._sli.get((slo_class, kind))
        if ring is None:
            ring = self._sli[(slo_class, kind)] = _Ring(256)
        ring.append(value)

    # ---- snapshots (any thread) --------------------------------------

    def request_timeline(self, rid: str) -> list[dict]:
        """Ordered lifecycle events recorded for ``rid`` (partial once the
        ring wrapped).  Scans newest to oldest and stops at the request's
        QUEUED event."""
        out = []
        for t, r, ev, detail in reversed(self._events.snapshot()):
            if r == rid or (type(r) is tuple and rid in r):
                entry = {"t": t, "event": ev}
                if detail:
                    entry["detail"] = detail
                out.append(entry)
                if ev == "QUEUED":
                    break
        out.reverse()
        return out

    def recent_request_ids(self, limit: int = 64) -> list[str]:
        """Most recently seen request ids, newest last."""
        seen: dict = {}
        for _t, rid, _ev, _d in self._events.snapshot():
            for r in (rid if type(rid) is tuple else (rid,)):
                seen.pop(r, None)
                seen[r] = True
        return list(seen)[-limit:]

    def steps_snapshot(self, limit: int = 128) -> list[dict]:
        out = []
        for t, kind, rows, actual, padded, ms, phases, dev in self._steps.snapshot()[-limit:]:
            rec = {"t": t, "kind": kind, "rows": rows, "actual_tokens": actual,
                   "padded_tokens": padded, "ms": ms}
            if phases:
                rec["phase_ms"] = phases
            if dev:
                rec["dev"] = dev
            out.append(rec)
        return out

    def sli_summary(self) -> dict:
        """p50/p95 over the recent reservoirs, per class and kind."""
        out: dict = {}
        for (cls, kind), ring in list(self._sli.items()):
            vals = sorted(ring.snapshot())
            if not vals:
                continue
            out.setdefault(cls, {})[kind] = {
                "n": len(vals),
                "p50": round(vals[len(vals) // 2], 6),
                "p95": round(vals[min(len(vals) - 1, int(len(vals) * 0.95))], 6),
            }
        return out

    def engine_snapshot(self, steps: int = 128) -> dict:
        out = {
            "enabled": self.enabled,
            "events_recorded": self._events.idx,
            "steps_recorded": self._steps.idx,
            "requests": self.recent_request_ids(),
            "steps": self.steps_snapshot(steps),
            "sli": self.sli_summary(),
            "control": dict(self._control),
            "postmortems": self.postmortems,
            "last_postmortem": self.last_postmortem,
        }
        if self.devprof is not None:
            out["devprof"] = self.devprof.snapshot()
        return out

    def wall_of(self, t_mono: float) -> float:
        """A recorded monotonic timestamp on the wall clock (span export
        and bundle headers only)."""
        return self._wall0 + (t_mono - self._mono0)

    # ---- bundles (post-mortem and on-demand dump) ----------------------

    def dump_bundle(self, reason: str, rids: Sequence[str] = (),
                    extra: Optional[dict] = None) -> dict:
        """A replay-ready bundle: the last cycles, the named (or every
        ring-reachable) request timeline, the SLI reservoirs, the engine
        facts, the schema version and ring-integrity markers.  Snapshot
        reads only, safe from any thread.

        ``rings`` records each ring's write cursor and capacity at the
        start of the dump, the entries already overwritten (``dropped``),
        and whether the cursor moved while the bundle was assembled
        (``torn``), so a replay reports a truncated or raced timeline."""
        ev_cursor, st_cursor = self._events.idx, self._steps.idx
        ids = list(rids) or self.recent_request_ids(limit=10 ** 6)
        bundle = {
            "schema": FLIGHT_SCHEMA_VERSION,
            "reason": reason,
            "written_unix": self.wall_of(self._clock.monotonic()),
            "monotonic_anchor": {"mono": self._mono0, "wall": self._wall0},
            "engine": dict(self._facts),
            "steps": self.steps_snapshot(256),
            "requests": {rid: self.request_timeline(rid) for rid in ids},
            "sli": self.sli_summary(),
            "control": dict(self._control),
        }
        if self.devprof is not None:
            # the ladder, the HBM watermark and the profiler traces taken
            # (written beside the bundles, under the same directory)
            bundle["devprof"] = self.devprof.snapshot()
        bundle["rings"] = {
            "events": {"cursor": ev_cursor, "capacity": self._events._n,
                       "dropped": max(0, ev_cursor - self._events._n),
                       "torn": self._events.idx != ev_cursor},
            "steps": {"cursor": st_cursor, "capacity": self._steps._n,
                      "dropped": max(0, st_cursor - self._steps._n),
                      "torn": self._steps.idx != st_cursor},
        }
        if extra:
            bundle["extra"] = extra
        return bundle

    def postmortem(self, reason: str, rids: Sequence[str] = (),
                   extra: Optional[dict] = None) -> Optional[str]:
        """Write a bundle to ``flight-{reason}-{pid}-{n}-{uuid}.json`` (a
        temporary file, then a rename) and return its path; None when
        disabled, past ``MAX_POSTMORTEMS``, or when the write fails (a
        post-mortem never takes serving down)."""
        if not self.enabled or self.postmortems >= MAX_POSTMORTEMS:
            return None
        try:
            import tempfile
            import uuid
            d = self._dir or tempfile.gettempdir()
            os.makedirs(d, exist_ok=True)
            # the count moves only once the file is in place, so it always
            # equals the files written; the uuid keeps names apart when two
            # recorders of one process, or two threads, dump at once
            n = self.postmortems + 1
            path = os.path.join(d, f"flight-{reason}-{os.getpid()}-{n}"
                                   f"-{uuid.uuid4().hex[:8]}.json")
            bundle = self.dump_bundle(reason, rids, extra)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            self.postmortems = n
            self.last_postmortem = path
            logger.warning("flight post-mortem (%s) written to %s", reason, path)
            return path
        except Exception:
            logger.exception("flight post-mortem write failed")
            return None
