"""Request tracing: the port of ``tpuserve/server/tracing.py``.

The server emits one span per API request, its parent taken from the
incoming W3C ``traceparent``, and the request's flight-recorder timeline
as ``engine.<event>`` child spans.  The OpenTelemetry SDK is optional and
imported only inside ``try``: when it is not installed, or no
``OTEL_EXPORTER_OTLP_ENDPOINT`` is set, every call is a no-op with the
same API.

Device traces (``/debug/profile`` and the fast-burn SLO auto-capture):
``capture_profile`` runs ``torch.profiler`` (CPU and, with a card, CUDA
activities) for ``seconds`` and writes a Chrome trace; one capture at a
time a process (``capture_profile_locked``, ``CaptureBusy``), under
``TPUSERVE_FLIGHT_DIR`` when set, beside the post-mortem bundles.  The
profiler starts and stops on the engine loop thread (``call``: the server
passes ``AsyncEngineRunner.call``), between two steps, so turning CUPTI on
or off never meets a graph capture the loop may be running; the wait and
the export run on the caller's thread.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import tempfile
import threading
import time

logger = logging.getLogger("tpuserve_torch.tracing")


class _NoopSpan:
    def set_attribute(self, key, value):
        pass


class RequestTracer:
    """One span per served request; OTLP-backed when available, a no-op
    otherwise.  ``request_span`` never raises."""

    def __init__(self):
        self._tracer = None
        endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
        if not endpoint:
            return
        try:
            from opentelemetry import trace
            from opentelemetry.exporter.otlp.proto.http.trace_exporter import (
                OTLPSpanExporter)
            from opentelemetry.sdk.resources import Resource
            from opentelemetry.sdk.trace import TracerProvider
            from opentelemetry.sdk.trace.export import BatchSpanProcessor
            provider = TracerProvider(resource=Resource.create(
                {"service.name": os.environ.get("OTEL_SERVICE_NAME", "tpuserve")}))
            provider.add_span_processor(BatchSpanProcessor(OTLPSpanExporter()))
            trace.set_tracer_provider(provider)
            self._tracer = trace.get_tracer("tpuserve")
            logger.info("OTLP tracing enabled -> %s", endpoint)
        except Exception as e:   # SDK absent or misconfigured: no-op
            logger.info("OTLP tracing unavailable (%s); spans are no-ops", e)

    @property
    def active(self) -> bool:
        return self._tracer is not None

    @contextlib.contextmanager
    def request_span(self, name: str, context=None, **attrs):
        """``context``: an extracted W3C parent context
        (:func:`extract_context`); None starts a new root span."""
        if self._tracer is None:
            yield _NoopSpan()
            return
        try:
            # the kwarg only when present: tracers without it keep working
            kw = {"context": context} if context is not None else {}
            cm = self._tracer.start_as_current_span(name, **kw)
            span = cm.__enter__()
        except Exception:
            yield _NoopSpan()
            return
        try:
            for k, v in attrs.items():
                if v is not None:
                    span.set_attribute(k, v)
            yield span
        except BaseException:
            # the real exc_info, so a failed request's span records its error
            if not cm.__exit__(*sys.exc_info()):
                raise
        else:
            cm.__exit__(None, None, None)


_tracer: RequestTracer | None = None


def get_tracer() -> RequestTracer:
    global _tracer
    if _tracer is None:
        _tracer = RequestTracer()
    return _tracer


def extract_context(headers):
    """The parent context of incoming ``traceparent``/``tracestate``
    headers (W3C), or None: no opentelemetry API, no header, or a
    malformed value all start a new root."""
    try:
        tp = headers.get("traceparent")
        if not tp:
            return None
        from opentelemetry.propagate import extract
        carrier = {"traceparent": tp}
        ts = headers.get("tracestate")
        if ts:
            carrier["tracestate"] = ts
        return extract(carrier)
    except Exception:
        return None


def inject_headers(headers: dict) -> dict:
    """Inject the current span's context as ``traceparent`` into
    ``headers`` (mutated and returned); a no-op without the SDK or outside
    a recording span."""
    try:
        from opentelemetry.propagate import inject
        inject(headers)
    except Exception:
        pass
    return headers


def emit_timeline_spans(tracer: RequestTracer, timeline, wall_of) -> None:
    """A flight-recorder request timeline as child spans of the current
    span (call inside ``request_span``): each event one
    ``engine.<event>`` span from its timestamp to the next event's (the
    last closes on itself); ``wall_of`` maps the recorder's monotonic
    stamps onto the wall clock (``FlightRecorder.wall_of``).  Never
    raises; a no-op when the tracer is inactive."""
    if not tracer.active or not timeline:
        return
    try:
        tr = tracer._tracer
        for i, ev in enumerate(timeline):
            start_ns = int(wall_of(ev["t"]) * 1e9)
            end_t = timeline[i + 1]["t"] if i + 1 < len(timeline) else ev["t"]
            span = tr.start_span("engine." + ev["event"].lower(), start_time=start_ns)
            try:
                for k, v in (ev.get("detail") or {}).items():
                    if isinstance(v, (bool, int, float, str)):
                        span.set_attribute(f"tpuserve.{k}", v)
            finally:
                span.end(end_time=max(start_ns, int(wall_of(end_t) * 1e9)))
    except Exception:
        logger.debug("timeline span export failed", exc_info=True)


def capture_profile(seconds: float, out_dir: str | None = None, call=None) -> dict:
    """A ``torch.profiler`` trace of ``seconds`` of serving: returns
    ``{"trace_dir", "trace", "seconds"}``, the trace a Chrome trace JSON in
    ``trace_dir``.  ``call(fn)`` runs ``fn`` on the engine loop thread
    (None: here)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seconds = min(max(float(seconds), 0.1), 60.0)
    out_dir = out_dir or tempfile.mkdtemp(prefix="tpuserve-profile-")
    call = call or (lambda fn: fn())
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    box = []

    def start():
        # made and started on the loop thread, stopped there too
        box.append(profile(activities=activities))
        box[0].start()
    call(start)
    prof = box[0]
    try:
        time.sleep(seconds)
    finally:
        call(prof.stop)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return {"trace_dir": out_dir, "trace": path, "seconds": seconds}


class CaptureBusy(RuntimeError):
    """A profiler capture is already running in this process (one at a
    time: ``/debug/profile`` answers 409, an auto-capture skips)."""


# one trace at a time a process: manual captures racing each other and the
# SLO auto-capture thread racing either
_capture_lock = threading.Lock()


def profile_out_dir(reason: str) -> str | None:
    """A fresh directory under ``TPUSERVE_FLIGHT_DIR`` (beside the
    post-mortem bundles that name it), or None without one (a temporary
    directory then)."""
    import uuid
    d = os.environ.get("TPUSERVE_FLIGHT_DIR")
    if not d:
        return None
    path = os.path.join(d, f"profile-{reason}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    os.makedirs(path, exist_ok=True)
    return path


def capture_profile_locked(seconds: float, *, reason: str = "manual", profilers=(),
                           call=None) -> dict:
    """:func:`capture_profile` one at a time (``CaptureBusy`` otherwise),
    written under the flight directory when set, and recorded on each
    enabled ``DeviceProfiler`` of ``profilers`` (bundles and
    ``tpuserve_profile_captures`` see it)."""
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a profiler capture is already in progress")
    try:
        out = capture_profile(seconds, out_dir=profile_out_dir(reason), call=call)
    finally:
        _capture_lock.release()
    out["reason"] = reason
    for dp in profilers:
        if dp is not None and getattr(dp, "enabled", False):
            dp.note_capture(out["trace_dir"], reason, out["seconds"])
    return out
