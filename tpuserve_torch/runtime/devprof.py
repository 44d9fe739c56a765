"""Device telemetry: per-dispatch device time, the executable ladder, HBM —
the port of ``tpuserve/runtime/devprof.py``, on CUDA events.

- **device time**: the engine brackets each graph replay or eager dispatch
  with ``dispatch(kind, key)``, which on the card records a start and an
  end CUDA event on the current stream around it, and its existing syncs
  (window flush, pending flush, sample read, verify and draft reads, the
  guided top-k read) with ``sync(kind)``.  When a sync has returned, the
  event pairs that have completed (``Event.query``, which does not wait)
  are read with ``elapsed_time`` and their device seconds are added to
  that sync kind; pairs still running (a pipelined window dispatched after
  the one just flushed) wait for a later sync.  So the profiler adds no
  device sync.  On the CPU there are no events: a sync kind's seconds are
  the host seconds blocked in it, as in the JAX profiler.  ``dispatch``
  also times the host side of the dispatch.
- **executable ladder**: every executable the engine makes
  (``runtime/graphs.py``: on the card, a captured CUDA graph) is one entry,
  registered when it is made with its capture wall (``note_executable``,
  the counterpart of the JAX profiler's first-call XLA compile), then
  counted at each dispatch: capture ms, hits, an activation-bytes
  estimate.
- **HBM watermark**: weights (draft and co-resident models included), the
  KV cache's reservation and the rest the engine holds on the card (the
  graphs' memory pool, shared buffers and split-K scratch from the
  caching allocator, and the bytes outside it that the engine added: the
  graph executables), against the card's memory (``set_hbm``); zeros for
  the rest on the CPU.  Weights and KV are counted apart, not as a
  remainder, so the sum can be held against the card's used bytes.
- **profiler captures**: ``note_capture`` records each ``torch.profiler``
  trace taken through ``/debug/profile`` or the fast-burn SLO auto-capture
  (``server/tracing.py``), so bundles name the traces beside them.

Disabled (``TPUSERVE_DEVPROF=0``, ``EngineConfig.devprof=False``,
``--no-devprof``), every bracket is one shared no-op context and serving is
unchanged.  Every mutating call runs on the engine loop thread; other
threads read ``snapshot()`` copies.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional

from tpuserve_torch.utils import env_flag

#: the ladder rows a snapshot lists at most (the registry itself is whole)
MAX_LADDER_SNAPSHOT = 128

#: an executable key's dispatch kind (the JAX ladder's kind names)
_KINDS = {"prefill": "prefill", "chunk": "prefill_chunk", "mixed": "mixed",
          "decode": "decode", "draft": "draft"}


def dispatch_kind(key: tuple) -> str:
    """The dispatch kind of an executable key (``runtime/graphs.py``)."""
    if key[0] == "verify":
        return "verify_sampled" if key[3] == "sampled" else "verify"
    return _KINDS[key[0]]


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopCtx()


class _Dispatch:
    """One dispatch: its host wall by kind, its ladder hit, and on the card
    a (start, end) event pair around its device work."""

    __slots__ = ("_dp", "_kind", "_key", "_t0", "_ev")

    def __init__(self, dp, kind, key):
        self._dp = dp
        self._kind = kind
        self._key = key

    def __enter__(self):
        dp = self._dp
        self._ev = None
        if dp.cuda:
            self._ev = dp._event()
            self._ev.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        dp = self._dp
        if self._ev is not None:
            end = dp._event()
            end.record()
            dp._inflight.append((self._ev, end))
        dp.dispatch_s[self._kind] += dt
        dp.dispatch_counts[self._kind] += 1
        if self._key is not None:
            # an executable key's entry is under its own kind (a decode
            # executable serves both "decode" and "decode_multi")
            kind = dispatch_kind(self._key) if isinstance(self._key[0], str) else self._kind
            ent = dp.ladder.get((kind, self._key))
            if ent is None:
                # made before the profiler saw it: this first dispatch's
                # wall stands for its making, as the JAX first call does
                dp._register(kind, self._key, dt)
                ent = dp.ladder[(kind, self._key)]
            ent[1] += 1
        return False


class _Sync:
    """One existing wait on the card: the completed dispatches' device
    seconds (on the CPU, the host seconds blocked) go to this kind."""

    __slots__ = ("_dp", "_kind", "_t0")

    def __init__(self, dp, kind):
        self._dp = dp
        self._kind = kind

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dp = self._dp
        if dp.cuda:
            secs = dp._drain_events()
        else:
            secs = time.perf_counter() - self._t0
        dp.sync_s[self._kind] += secs
        dp.sync_counts[self._kind] += 1
        return False


class DeviceProfiler:
    """One engine's device telemetry (see the module docstring).
    ``enabled=None`` reads ``TPUSERVE_DEVPROF`` (default on); ``cuda``:
    time dispatches with CUDA events (the engine passes its device's)."""

    def __init__(self, enabled: Optional[bool] = None, cuda: bool = False):
        if enabled is None:
            enabled = env_flag("TPUSERVE_DEVPROF")
        self.enabled = bool(enabled)
        self.cuda = bool(cuda) and self.enabled
        self.dispatch_s: dict[str, float] = defaultdict(float)
        self.dispatch_counts: dict[str, int] = defaultdict(int)
        # device seconds (host seconds blocked, on the CPU) by sync kind
        self.sync_s: dict[str, float] = defaultdict(float)
        self.sync_counts: dict[str, int] = defaultdict(int)
        # (kind, executable key) -> [capture_ms, hits, est_bytes]
        self.ladder: dict[tuple, list] = {}
        self.compiles = 0
        self.compile_s = 0.0
        self.cycles = 0
        self._act_bytes_per_token = 0
        self._hbm: dict = {}
        self.captures: list[dict] = []
        self.captures_total = 0
        self._last_sync = 0.0
        self._last_dispatch = 0.0
        self._last_compiles = 0
        # (start, end) event pairs not read yet, oldest first, and spare
        # events to reuse (an Event's creation is a CUDA call)
        self._inflight: list = []
        self._spare: list = []

    # ---- hot path (engine loop thread) --------------------------------

    def dispatch(self, kind: str, key: Optional[tuple] = None):
        """Bracket one dispatch; ``key`` (an executable's) counts a ladder
        hit, None (the eager sampler) times it only."""
        if not self.enabled:
            return _NOOP
        return _Dispatch(self, kind, key)

    def sync(self, kind: str):
        if not self.enabled:
            return _NOOP
        return _Sync(self, kind)

    def bump_cycle(self) -> None:
        if self.enabled:
            self.cycles += 1

    def _event(self):
        import torch
        return self._spare.pop() if self._spare else torch.cuda.Event(enable_timing=True)

    def _drain_events(self) -> float:
        """Device seconds of the completed event pairs, in order; stops at
        the first pair still running (later ones are behind it on the
        stream)."""
        secs = 0.0
        n = 0
        for start, end in self._inflight:
            if not end.query():
                break
            secs += start.elapsed_time(end) / 1000.0
            self._spare += (start, end)
            n += 1
        del self._inflight[:n]
        return secs

    # ---- facts (construction, executables, captures) -------------------

    def _register(self, kind: str, key: tuple, seconds: float) -> None:
        self.ladder[(kind, key)] = [round(seconds * 1000, 3), 0, self.estimate_bytes(key)]
        self.compiles += 1
        self.compile_s += seconds

    def note_executable(self, key: tuple, seconds: float) -> None:
        """An executable was made (on the card: captured) in ``seconds``:
        its ladder entry, and one capture counted."""
        if self.enabled and (dispatch_kind(key), key) not in self.ladder:
            self._register(dispatch_kind(key), key, seconds)

    def set_model_hints(self, *, act_bytes_per_token: int) -> None:
        """Activation bytes a padded token, for the ladder's estimate."""
        self._act_bytes_per_token = max(0, int(act_bytes_per_token))

    def estimate_bytes(self, key: tuple) -> int:
        """Estimated activation bytes of a key: the product of its
        dimensions (an executable key's integers after its kind, or a
        leading shape tuple, the JAX keys') times the per-token hint."""
        if not self._act_bytes_per_token or not key:
            return 0
        dims = key[0] if isinstance(key[0], tuple) else key[1:]
        n = 1
        for d in dims:
            if isinstance(d, int) and not isinstance(d, bool):
                n *= max(1, d)
        return n * self._act_bytes_per_token

    def set_hbm(self, *, weights: int, kv_reserved: int, limit: int, num_blocks: int,
                block_bytes: int, in_use: Optional[int] = None,
                other: Optional[int] = None) -> None:
        """The HBM watermark: ``weights`` (parameter bytes, draft and
        co-resident models included), ``kv_reserved`` (the cache's whole
        reservation), ``limit`` (the card's memory, or
        ``TPUSERVE_HBM_BYTES``) and ``other``, the bytes held beyond
        weights and KV when counted apart; else, as the JAX profiler, the
        remainder of ``in_use`` (the used bytes, when known)."""
        if other is None:
            other = 0
            if in_use is not None:
                other = max(0, int(in_use) - int(weights) - int(kv_reserved))
        self._hbm = {
            "limit_bytes": int(limit),
            "weights_bytes": int(weights),
            "kv_reserved_bytes": int(kv_reserved),
            "other_bytes": int(other),
            "num_blocks": int(num_blocks),
            "block_bytes": int(block_bytes),
            "headroom_bytes": int(limit) - int(weights) - int(kv_reserved) - int(other),
        }

    def note_capture(self, trace_dir: str, reason: str, seconds: float) -> None:
        """A ``torch.profiler`` trace was written; bundles list the 16
        newest."""
        self.captures.append({"trace_dir": trace_dir, "reason": reason,
                              "seconds": seconds})
        self.captures_total += 1
        del self.captures[:-16]

    # ---- snapshots (any thread) ---------------------------------------

    def hbm_snapshot(self) -> dict:
        return dict(self._hbm)

    def step_delta(self) -> Optional[dict]:
        """Device ms, dispatch ms and captures since the previous call (the
        flight recorder's step record, loop thread)."""
        sync_t = sum(self.sync_s.values())
        disp_t = sum(self.dispatch_s.values())
        dev = {}
        d = sync_t - self._last_sync
        if d > 0:
            dev["device_ms"] = round(d * 1000, 4)
        d = disp_t - self._last_dispatch
        if d > 0:
            dev["dispatch_ms"] = round(d * 1000, 4)
        d = self.compiles - self._last_compiles
        if d > 0:
            dev["compiles"] = d
        self._last_sync = sync_t
        self._last_dispatch = disp_t
        self._last_compiles = self.compiles
        return dev or None

    def ladder_snapshot(self) -> dict:
        """The ladder as a bounded table, hottest first, with the totals."""
        items = sorted(self.ladder.items(), key=lambda kv: kv[1][1], reverse=True)
        rows = [{"kind": kind, "bucket": repr(key), "compile_ms": ent[0], "hits": ent[1],
                 "est_bytes": ent[2]}
                for (kind, key), ent in items[:MAX_LADDER_SNAPSHOT]]
        return {
            "retained": len(self.ladder),
            "compiles": self.compiles,
            "compile_ms": round(self.compile_s * 1000, 2),
            "truncated": max(0, len(self.ladder) - MAX_LADDER_SNAPSHOT),
            "executables": rows,
        }

    def report(self) -> dict:
        """Per-kind device and dispatch ms and ms a cycle, the ladder, the
        HBM watermark and the captures (/debug/engine, bundles)."""
        cycles = max(self.cycles, 1)
        device = {k: {"total_ms": round(v * 1000, 2), "syncs": self.sync_counts[k]}
                  for k, v in sorted(self.sync_s.items())}
        dispatch = {k: {"total_ms": round(v * 1000, 2), "calls": self.dispatch_counts[k]}
                    for k, v in sorted(self.dispatch_s.items())}
        dev_total = sum(self.sync_s.values())
        disp_total = sum(self.dispatch_s.values())
        return {
            "enabled": self.enabled,
            "cycles": self.cycles,
            "device_ms_per_cycle": round(1000 * dev_total / cycles, 4),
            "dispatch_ms_per_cycle": round(1000 * disp_total / cycles, 4),
            "device": device,
            "dispatch": dispatch,
            "ladder": self.ladder_snapshot(),
            "hbm": self.hbm_snapshot(),
            "captures": list(self.captures),
        }

    snapshot = report
