"""Background engine loop with a thread-safe request interface: the port
of ``tpuserve/server/runner.py``.

The engine is single-threaded: every call that touches the card (steps,
graph captures, the pinned staging copies and the events a pipelined
dispatch waits on) runs on the loop thread.  HTTP handler threads talk to
it only through the intake queue and per-request output queues, and make
no CUDA call, so a graph the loop captures on first use (in the global
capture mode) never meets another thread's CUDA work.  Work that is not a
request (embeddings and prompt scoring, ``Engine.embed`` and
``Engine.score_prompts``) goes through :meth:`AsyncEngineRunner.call`: the
loop runs it between two steps and hands back its result or its exception.

Crash-only recovery, as the JAX runner's: a step that raises is salvaged
(``Engine.salvage_requeue`` re-queues every live request through the
token-identical re-prefill path); a cohort that faults again is bisected
until the poison request is isolated and failed alone; a fault storm
(more than ``MAX_FAULTS_PER_WINDOW`` faults in ``FAULT_WINDOW_S``) falls
back to failing everything.  With ``EngineConfig.step_watchdog_s`` a
watchdog thread declares a step stuck past the threshold, releases an
injected hang into the salvage path, and fails the clients of a step still
stuck at twice the threshold.  A real sticky device error re-faults every
probe and ends in that fault-storm fail-all, never in a loop.

With the engine's flight recorder on (``runtime/flight.py``), a poison
isolation, a fault storm's fail-all and a watchdog trip each write a
post-mortem bundle (counted in ``EngineStats.flight_postmortems``), and
every client TTFT, inter-token gap and end-to-end time is also a sample of
the recorder's per-class SLI reservoirs.  ``cold_start_s`` is the first
token any request received, in seconds since this module was imported.

SLO burn rates (``obs/burnrate.py``), as the JAX runner's: with
``slo_eval`` set, every client SLI and every request outcome feeds the
evaluator on this thread (canary probes excluded), evaluated at most once
an engine-clock second; a fast-window alert that fires takes a short
``torch.profiler`` trace (``server/tracing.py``) on a daemon thread, whose
start and stop come back to this thread through :meth:`call`.

The model pool (``modelpool/``): with ``pool`` set, a request naming
another registered model parks until the engine is idle, then the pool
swaps the served model (``Engine.swap_model``) and the parked requests
re-enter intake.  ``on_step_time`` (the NVML exporter's duty cycle) gets
each step's wall seconds.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from typing import Optional, Sequence

from tpuserve_torch.runtime.clock import MONOTONIC
from tpuserve_torch.runtime.request import RequestOutput, RequestState, SamplingParams
from tpuserve_torch.runtime.slo import ShedError

logger = logging.getLogger("tpuserve_torch.server")

# the cold-start anchor: `python -m tpuserve_torch.server` imports this
# module before the weights load and the graphs are captured, so the
# first token's time since it is the process's cold start (real seconds:
# a process boots on the real clock)
_BOOT_MONOTONIC = time.monotonic()


def _advance_counter(ctr, cumulative) -> None:
    """Advance a counter to an engine-side cumulative value (counters only
    go up; the engine keeps its own monotonic totals)."""
    if cumulative > ctr.value:
        ctr.inc(cumulative - ctr.value)


@dataclasses.dataclass
class _Submit:
    prompt: Optional[str]
    prompt_token_ids: Optional[list[int]]
    params: SamplingParams
    out_queue: "queue.Queue[RequestOutput | Exception | None]"
    rid_event: threading.Event
    request_id: Optional[str] = None
    assigned_id: Optional[str] = None
    # admission deadline (the engine clock): still queued past this, the
    # engine aborts the request queue-side and the client gets a
    # TimeoutError through the output queue
    deadline: Optional[float] = None
    adapter: Optional[str] = None     # multi-LoRA adapter name
    # model-pool routing: a registered model other than the one serving
    # parks the submit until the pool swaps to it
    model: Optional[str] = None


@dataclasses.dataclass
class _Abort:
    request_id: str


@dataclasses.dataclass
class _InjectPrefilled:
    """Cross-pod disaggregation: a sequence prefilled on another pod, to be
    adopted into this engine's decode batch (``parallel/disagg_net.py``)."""
    meta: dict
    seq_kv: list
    out_queue: "queue.Queue[RequestOutput | Exception | None]"
    rid_event: threading.Event
    assigned_id: Optional[str] = None
    error: Optional[Exception] = None


@dataclasses.dataclass
class _Call:
    """A function the loop runs between steps (``AsyncEngineRunner.call``)."""
    fn: object
    done: threading.Event
    result: object = None
    error: Optional[BaseException] = None


@dataclasses.dataclass
class _SalvageState:
    """Poison bisection in progress: suspect groups of requests are
    replayed alone (the scheduler's admission filter) until the dispatch
    that faults shrinks to one request, the poison, which is failed with a
    per-request error while everyone else resumes."""
    groups: deque                 # deque[set[str]] groups still to probe
    cleared: set                  # rids that survived a probe (run freely)
    active: Optional[set] = None  # the group being probed
    ok_steps: int = 0             # successful steps since the probe began


class AsyncEngineRunner:
    """Runs ``engine.step()`` on a dedicated thread; routes outputs to
    callers."""

    # crash-only tuning (instance attributes so tests can adjust them)
    MAX_SALVAGES = 12            # consecutive faulted attempts a request;
    #                              above ~2+log2(batch), so an innocent
    #                              sharing bisection rounds with a poison
    #                              request never runs out first
    PROBE_OK_STEPS = 3           # fault-free steps before a group is cleared
    POISON_CONFIRM = 3           # consecutive SINGLETON-probe faults before
    #                              a request is declared poison
    MAX_FAULTS_PER_WINDOW = 20   # whole-engine faults inside FAULT_WINDOW_S
    FAULT_WINDOW_S = 30.0        # before falling back to fail-all
    WATCHDOG_WARMUP_STEPS = 10   # early steps may build kernels or capture
    WATCHDOG_WARMUP_SCALE = 20.0  # graphs: scale the threshold up for them,
    #                               and count a later step's graph capture
    #                               (a bucket's first use) at 1/scale

    def __init__(self, engine, metrics=None):
        self.engine = engine
        self.metrics = metrics
        # request SLI stamps run on the engine's clock (runtime/clock.py);
        # the watchdog and the fault-storm window run on the real clock
        self._clock = getattr(engine, "clock", MONOTONIC)
        self._intake: "queue.Queue[_Submit | _Abort]" = queue.Queue()
        self._out_queues: dict[str, queue.Queue] = {}
        self._req_started: dict[str, float] = {}
        self._last_token_time: dict[str, float] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpuserve-torch-engine-loop")
        self._started = False
        self.steps_failed = 0
        # crash-only recovery state (salvage, bisection, watchdog); the
        # lower-case copies of the tuning mirror the JAX runner's, which
        # its tests (and these) set per instance
        self.max_salvages = self.MAX_SALVAGES
        self.probe_ok_steps = self.PROBE_OK_STEPS
        self.poison_confirm = self.POISON_CONFIRM
        self._singleton_faults: dict[str, int] = {}
        self.step_watchdog_s = float(getattr(
            getattr(engine, "config", None), "step_watchdog_s", 0.0) or 0.0)
        self._fault_times: list[float] = []
        self._salvage: Optional[_SalvageState] = None
        self._steps_done = 0
        self._step_seq = 0
        self._step_started: Optional[tuple[int, float, float]] = None
        self._hard_trip_seq: Optional[int] = None
        self._fail_lock = threading.Lock()
        self._watchdog_thread: Optional[threading.Thread] = None
        # boot -> the first token served, seconds (None until then);
        # /healthz and /debug/engine report it
        self.cold_start_s: Optional[float] = None
        # each step's wall seconds (gpu_metrics.GpuMetricsExporter's duty
        # cycle), when set
        self.on_step_time = None
        # the in-process burn-rate evaluator (obs/burnrate.py), set by the
        # server; fed and evaluated on this thread only
        self.slo_eval = None
        self._slo_eval_last: Optional[float] = None
        # the fast-burn auto-capture's cooldown stamp (real seconds)
        self._auto_capture_last: Optional[float] = None
        # the model pool (modelpool/pool.py), set by the server; submits
        # for another registered model park here until the swap
        self.pool = None
        self._parked: list[_Submit] = []
        # (serving model, its parameter bytes): the weight-tier gauge's
        # card share, walked once a model
        self._pool_hbm_cache: Optional[tuple] = None

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()
            if self.step_watchdog_s > 0:
                self._watchdog_thread = threading.Thread(
                    target=self._watchdog_loop, daemon=True,
                    name="tpuserve-torch-engine-watchdog")
                self._watchdog_thread.start()

    def idle(self) -> bool:
        """No engine work and no undelivered outputs: safe to stop.  Polled
        by the server's graceful drain."""
        return (not self.engine.has_work() and not self._out_queues
                and self._intake.empty() and not self._parked)

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._started:
            self._thread.join(timeout=30)
            if self._watchdog_thread is not None:
                self._watchdog_thread.join(timeout=5)

    # ---- client API (any thread) ---------------------------------------

    def submit(self, prompt: Optional[str] = None,
               prompt_token_ids: Optional[Sequence[int]] = None,
               params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None,
               deadline: Optional[float] = None,
               adapter: Optional[str] = None,
               model: Optional[str] = None,
               ) -> tuple[str, "queue.Queue[RequestOutput | Exception | None]"]:
        """Enqueue a request; returns (request_id, output queue).  The queue
        yields RequestOutput items, then None when finished; an Exception
        item signals a rejected or failed request.  ``adapter``: a loaded
        multi-LoRA adapter's name; ``model``: a model of the pool's
        catalog (another than the one serving parks until the swap)."""
        sub = _Submit(prompt=prompt,
                      prompt_token_ids=list(prompt_token_ids) if prompt_token_ids else None,
                      params=params or SamplingParams(),
                      out_queue=queue.Queue(), rid_event=threading.Event(),
                      request_id=request_id, deadline=deadline, adapter=adapter,
                      model=model)
        self._intake.put(sub)
        self._wake.set()
        sub.rid_event.wait(timeout=60)
        if sub.assigned_id is None:
            raise TimeoutError("engine loop did not accept the request")
        return sub.assigned_id, sub.out_queue

    def abort(self, request_id: str) -> None:
        self._intake.put(_Abort(request_id))
        self._wake.set()

    def submit_prefilled(self, meta: dict, seq_kv: list
                         ) -> tuple[str, "queue.Queue[RequestOutput | Exception | None]"]:
        """Adopt a migrated (already prefilled) sequence on the loop thread
        (``Engine.adopt_prefilled``); raises the loop's error here
        (``MemoryError``: the pool is full, which the server answers 503)."""
        msg = _InjectPrefilled(meta=meta, seq_kv=seq_kv, out_queue=queue.Queue(),
                               rid_event=threading.Event())
        self._intake.put(msg)
        self._wake.set()
        msg.rid_event.wait(timeout=60)
        if msg.error is not None:
            raise msg.error
        if msg.assigned_id is None:
            raise TimeoutError("engine loop did not accept the migration")
        return msg.assigned_id, msg.out_queue

    def call(self, fn, timeout: float = 600.0):
        """Run ``fn()`` on the loop thread between two engine steps and
        return its result, or raise its exception here.  The engine's
        eager work outside the step loop (embeddings, prompt scoring)
        comes this way, so no handler thread makes a CUDA call while the
        loop may be capturing a graph."""
        msg = _Call(fn=fn, done=threading.Event())
        self._intake.put(msg)
        self._wake.set()
        if not msg.done.wait(timeout):
            raise TimeoutError("engine loop did not run the call in time")
        if msg.error is not None:
            raise msg.error
        return msg.result

    def generate_sync(self, prompt=None, prompt_token_ids=None, params=None,
                      timeout: float = 600.0, adapter: Optional[str] = None):
        """Blocking convenience: returns (list[RequestOutput], request_id)."""
        rid, q = self.submit(prompt=prompt, prompt_token_ids=prompt_token_ids,
                             params=params, adapter=adapter)
        outs = []
        deadline = time.monotonic() + timeout
        while True:
            item = q.get(timeout=max(deadline - time.monotonic(), 0.001))
            if item is None:
                self.engine.requests.pop(rid, None)
                return outs, rid
            if isinstance(item, Exception):
                self.engine.requests.pop(rid, None)
                raise item
            outs.append(item)

    # ---- engine loop ----------------------------------------------------

    def _adopt(self, msg: _InjectPrefilled) -> None:
        from tpuserve_torch.parallel.disagg_net import adopt_meta
        try:
            rid = adopt_meta(self.engine, msg.meta, msg.seq_kv)
        except Exception as e:           # refused: the handler answers for it
            msg.error = e
            msg.rid_event.set()
            return
        msg.assigned_id = rid
        self._out_queues[rid] = msg.out_queue
        self._req_started[rid] = self._clock.monotonic()
        self._last_token_time[rid] = self._req_started[rid]
        if self.metrics:
            self.metrics.request_total.inc()
            self.metrics.prompt_tokens.inc(len(msg.meta["prompt_token_ids"]))
        msg.rid_event.set()

    def _drain_intake(self) -> None:
        while True:
            try:
                msg = self._intake.get_nowait()
            except queue.Empty:
                return
            if isinstance(msg, _Call):
                try:
                    msg.result = msg.fn()
                except Exception as e:       # the caller's to handle
                    msg.error = e
                msg.done.set()
                continue
            if isinstance(msg, _InjectPrefilled):
                self._adopt(msg)
                continue
            if isinstance(msg, _Abort):
                if self.engine.abort_request(msg.request_id):
                    q = self._out_queues.pop(msg.request_id, None)
                    self.engine.requests.pop(msg.request_id, None)
                    self._req_started.pop(msg.request_id, None)
                    self._last_token_time.pop(msg.request_id, None)
                    if q is not None:
                        q.put(None)
                continue
            if msg.model and self.pool is not None and msg.model != self.pool.current:
                # a registered model other than the one serving parks until
                # the pool swaps at the next idle boundary; its demand
                # starts a spill -> host prefetch while the engine drains
                if self.pool.is_registered(msg.model):
                    self.pool.note_demand(msg.model)
                    self.pool.request_swap(msg.model)
                    self._parked.append(msg)
                    continue
                msg.assigned_id = msg.request_id or "rejected"
                msg.rid_event.set()
                msg.out_queue.put(ValueError(
                    f"model {msg.model!r} is not in this replica's catalog"))
                msg.out_queue.put(None)
                continue
            try:
                kw = {"adapter": msg.adapter} if msg.adapter else {}
                rid = self.engine.add_request(
                    prompt=msg.prompt, prompt_token_ids=msg.prompt_token_ids,
                    params=msg.params, request_id=msg.request_id,
                    deadline=msg.deadline, **kw)
            except Exception as e:           # invalid or shed: report, don't die
                if (self.slo_eval is not None and isinstance(e, (MemoryError, ShedError))
                        and not msg.params.canary):
                    # a shed or backpressure is unavailability the client
                    # saw; an invalid request is not
                    self.slo_eval.observe_outcome(msg.params.slo_class, False)
                msg.assigned_id = msg.request_id or "rejected"
                msg.rid_event.set()
                msg.out_queue.put(e)
                msg.out_queue.put(None)
                continue
            msg.assigned_id = rid
            self._out_queues[rid] = msg.out_queue
            self._req_started[rid] = self._clock.monotonic()
            self._last_token_time[rid] = self._req_started[rid]
            if self.metrics:
                self.metrics.request_total.inc()
                req = self.engine.requests.get(rid)
                if req is not None:
                    self.metrics.prompt_tokens.inc(req.num_prompt_tokens)
            msg.rid_event.set()

    def _sli_ident(self, rid: str) -> tuple:
        """(SLO class, canary) of a live request: canary probes
        (``obs/canary.py``) stay out of every production SLI and of the
        burn-rate stream."""
        req = self.engine.requests.get(rid)
        if req is None:
            return "standard", False
        return req.params.slo_class, req.params.canary

    def _route_outputs(self, outputs: list[RequestOutput]) -> None:
        now = self._clock.monotonic()
        m = self.metrics
        ev = self.slo_eval
        flights = self._flights()
        for out in outputs:
            if self.cold_start_s is None and out.new_token_ids:
                self.cold_start_s = round(time.monotonic() - _BOOT_MONOTONIC, 6)
                logger.info("cold start: first token %.3fs after boot", self.cold_start_s)
            q = self._out_queues.get(out.request_id)
            cls, canary = self._sli_ident(out.request_id)
            label = dict(model_name=m.model_name, slo_class=cls) if m else None
            if m:
                m.generation_tokens.inc(len(out.new_token_ids))
            last = self._last_token_time.get(out.request_id)
            if last is not None and not canary:
                if out.num_output_tokens == 1:
                    ttft = now - self._req_started.get(out.request_id, now)
                    if m:
                        m.ttft.observe(ttft)
                        m.ttft_class.labels(**label).observe(ttft)
                    for fl in flights:
                        fl.note_sli(cls, "ttft", ttft)
                    if ev is not None:
                        ev.observe(cls, "ttft", ttft)
                elif not out.from_prefill:
                    # a from_prefill emission past the first token is a
                    # re-prefill after a preemption or salvage: its gap is
                    # queue and recompute time, not inter-token latency
                    if m:
                        m.itl.observe(now - last)
                        m.itl_class.labels(**label).observe(now - last)
                    for fl in flights:
                        fl.note_sli(cls, "itl", now - last)
                    if ev is not None:
                        ev.observe(cls, "itl", now - last)
            self._last_token_time[out.request_id] = now
            if q is not None:
                q.put(out)
            if out.finished:
                started = self._req_started.pop(out.request_id, now)
                reason = out.finish_reason.value if out.finish_reason else "stop"
                if canary:
                    # a served probe proves the path: its own family only
                    if m:
                        m.canary_requests.inc()
                        m.request_success.labels(model_name=m.model_name,
                                                 finished_reason=reason).inc()
                else:
                    if m:
                        m.observe_finish(reason, now - started)
                        m.e2e_class.labels(**label).observe(now - started)
                    for fl in flights:
                        fl.note_sli(cls, "e2e", now - started)
                    if ev is not None:
                        ev.observe(cls, "e2e", now - started)
                        ev.observe_outcome(cls, reason in ("stop", "length"))
                self._last_token_time.pop(out.request_id, None)
                # the request record stays in engine.requests: the caller
                # that submitted claims (pops) it for usage
                if q is not None:
                    self._out_queues.pop(out.request_id, None)
                    q.put(None)

    # ---- crash-only recovery: salvage, bisection, watchdog --------------

    def _bump_stat(self, name: str, n: int = 1) -> None:
        """Count a recovery event on the engine's stats (exported by
        ``_update_gauges``)."""
        stats = self.engine.stats
        setattr(stats, name, getattr(stats, name) + n)

    def _fail_all(self, message: str, engine_side: bool = True) -> None:
        """Fail every in-flight stream and abort it in the engine, so
        nothing re-raises in a tight loop.  ``engine_side=False`` is the
        watchdog thread's variant: only the client queues are touched, as
        the loop thread may still be inside the stuck step
        (``_consume_hard_trip`` reconciles the engine on the loop thread)."""
        with self._fail_lock:
            for rid, q in list(self._out_queues.items()):
                if engine_side:
                    try:
                        self.engine.abort_request(rid)
                    except Exception:
                        logger.exception("abort of %s after a failed step", rid)
                    self.engine.requests.pop(rid, None)
                q.put(RuntimeError(message))
                q.put(None)
            self._out_queues.clear()
            self._req_started.clear()
            self._last_token_time.clear()
            self._singleton_faults.clear()

    def _fail_request(self, rid: str, message: str, poisoned: bool = False,
                      exc: Optional[Exception] = None) -> None:
        """Fail ONE stream with a per-request error: a typed ``exc``
        (ShedError -> 429, TimeoutError -> 504) or a RuntimeError carrying
        ``message``.  ``poisoned`` counts it as isolated by salvage."""
        # read before the abort drops the request record
        cls, canary = self._sli_ident(rid)
        if self.slo_eval is not None and not canary:
            # every engine-decided terminal error is a bad event of the
            # availability objective
            self.slo_eval.observe_outcome(cls, False)
        if self.metrics and not canary and not poisoned and not isinstance(exc, ShedError):
            # shed and poison have their own counters; this family counts
            # the rest (deadline 504s, salvage errors), the bad events the
            # availability objective's PromQL twin reads
            self.metrics.requests_failed.inc()
        try:
            self.engine.abort_request(rid)
        except Exception:
            logger.exception("abort of %s", rid)
        self.engine.requests.pop(rid, None)
        self._req_started.pop(rid, None)
        self._last_token_time.pop(rid, None)
        q = self._out_queues.pop(rid, None)
        if q is not None:
            q.put(exc if exc is not None else RuntimeError(message))
            q.put(None)
        if poisoned:
            self._bump_stat("requests_poisoned")
            # the isolated request's whole lifecycle, faults included
            self._dump_postmortem("poison", (rid,))
        logger.warning("request %s failed: %s", rid, message)

    def _drain_engine_errors(self) -> None:
        """Terminal errors the engine decided for QUEUED requests (deadline
        expiry, queue-full class eviction): route each to its client with
        the typed exception so the HTTP layer keeps the right status."""
        for rid, exc in self.engine.drain_request_errors():
            self._fail_request(rid, str(exc), exc=exc)

    def _handle_step_fault(self, exc: Exception) -> None:
        """Salvage instead of failing everyone: re-queue every in-flight
        request through the engine's re-prefill path and replay; a cohort
        that faults AGAIN is bisected until the poison request is isolated
        and failed alone.  Past ``MAX_FAULTS_PER_WINDOW`` faults inside
        ``FAULT_WINDOW_S`` it fails everything (an engine restart)."""
        now = time.monotonic()
        self._fault_times = [t for t in self._fault_times
                             if now - t < self.FAULT_WINDOW_S]
        self._fault_times.append(now)
        eng = self.engine
        if len(self._fault_times) > self.MAX_FAULTS_PER_WINDOW:
            self._bump_stat("engine_restarts")
            # the incident's record, before the fail-all clears the clients
            self._dump_postmortem("fault_storm")
            self._salvage = None
            eng.scheduler.set_admission_filter(None)
            self._fail_all(f"engine failure: {exc}")
            return
        eng.salvage_requeue()
        # charge the fault to the requests in the faulted dispatch; a fault
        # outside any dispatch (a flush at an idle step) charges everyone
        dispatched = set(eng._dispatch_rids or ())
        cohort = []
        for rid in list(self._out_queues):
            req = eng.requests.get(rid)
            if req is None or req.finished:
                continue
            if dispatched and rid not in dispatched:
                continue
            req.num_salvages += 1
            if req.num_salvages > self.max_salvages:
                self._fail_request(
                    rid, f"request failed {req.num_salvages} consecutive "
                         f"faulted engine steps (salvage budget "
                         f"{self.max_salvages} exhausted): {exc}",
                    poisoned=True)
            else:
                cohort.append(rid)
                self._bump_stat("requests_salvaged")
        if not cohort:
            self._salvage = None
            eng.scheduler.set_admission_filter(None)
            return
        if self._salvage is None:
            # first fault: replay the whole cohort as one probe group; a
            # transient fault salvages everyone with no bisection at all
            self._salvage = _SalvageState(groups=deque([set(cohort)]), cleared=set())
        else:
            st = self._salvage
            suspect = set(st.active if st.active else cohort) & set(cohort)
            st.active = None
            st.ok_steps = 0
            if len(suspect) <= 1:
                for rid in suspect:
                    n = self._singleton_faults.get(rid, 0) + 1
                    self._singleton_faults[rid] = n
                    if n >= self.poison_confirm:
                        self._singleton_faults.pop(rid, None)
                        self._fail_request(
                            rid, "poison request isolated by fault bisection "
                                 f"({n} consecutive solo faults): {exc}",
                            poisoned=True)
                    else:
                        # transient chaos may have landed on a solo probe:
                        # probe it again before condemning it
                        st.groups.appendleft({rid})
            else:
                # the probed group faulted again: bisect and probe halves
                ordered = sorted(suspect)
                half = len(ordered) // 2
                st.groups.appendleft(set(ordered[half:]))
                st.groups.appendleft(set(ordered[:half]))
        self._advance_salvage()

    def _advance_salvage(self) -> None:
        """Arm the next probe group (admission filter = cleared + active);
        lift the filter when nothing is left to probe."""
        st = self._salvage
        sched = self.engine.scheduler
        if st is None:
            sched.set_admission_filter(None)
            return
        while st.active is None and st.groups:
            group = {rid for rid in st.groups.popleft() if rid in self._out_queues}
            if group:
                st.active = group
                st.ok_steps = 0
        if st.active is None:
            self._salvage = None
            sched.set_admission_filter(None)
            return
        sched.set_admission_filter(st.cleared | st.active)

    def _note_salvage_progress(self) -> None:
        """After every successful step while a probe is armed: a group that
        ran ``PROBE_OK_STEPS`` fault-free steps (or finished) is cleared,
        and the next suspect group probes."""
        st = self._salvage
        if st is None or st.active is None:
            return
        live = {rid for rid in st.active if rid in self._out_queues}
        if live:
            requests = self.engine.requests
            if not all(getattr(requests.get(rid), "state", None) == RequestState.RUNNING
                       for rid in live):
                return          # the probe group is not (re-)admitted yet
            st.ok_steps += 1
            if st.ok_steps < self.probe_ok_steps:
                return
        for rid in st.active:
            # a clean solo probe exonerates: reset its poison evidence
            self._singleton_faults.pop(rid, None)
        st.cleared |= st.active
        st.active = None
        self._advance_salvage()

    def _capture_s(self) -> float:
        """Seconds the engine's graphs have spent capturing, the capture
        running now included (read from the watchdog thread: the stamp
        before the total, which ``StepGraphs.get`` sets in the other order,
        so a capture ending meanwhile counts twice, never zero times)."""
        graphs = getattr(self.engine, "graphs", None)
        if graphs is None:
            return 0.0
        since = graphs.capturing_since
        return graphs.capture_s + (time.monotonic() - since if since is not None else 0.0)

    def _flights(self) -> list:
        """The engine's flight recorder when it is on (runtime/flight.py)."""
        fl = getattr(self.engine, "flight", None)
        return [fl] if fl is not None and fl.enabled else []

    def _dump_postmortem(self, reason: str, rids=()) -> None:
        """Write a post-mortem bundle (the last cycles and the affected
        timelines) and count it.  Called on the loop thread at a fault
        storm and a poison isolation, and on the watchdog thread at a trip:
        the recorder's snapshot reads make that safe while the loop thread
        is stuck in the step."""
        for fl in self._flights():
            if fl.postmortem(reason, rids) is not None:
                self._bump_stat("flight_postmortems")

    def _watchdog_threshold(self) -> float:
        if self._steps_done < self.WATCHDOG_WARMUP_STEPS:
            # early steps may build a kernel or capture a graph
            return self.step_watchdog_s * self.WATCHDOG_WARMUP_SCALE
        return self.step_watchdog_s

    def _watchdog_loop(self) -> None:
        """Monitor thread: the loop stamps each ``engine.step()`` entry; a
        step past the threshold is stuck.  Stage 1 (trip): count it and
        release injected hangs, which then raise into the salvage path.
        Stage 2 (still stuck past twice the threshold: a real hang): fail
        the waiting clients from here, since the loop thread may never
        come back."""
        poll = max(0.005, min(0.05, self.step_watchdog_s / 5))
        tripped_seq = None
        while not self._stop.wait(poll):
            cur = self._step_started
            if cur is None:
                continue
            seq, t0, c0 = cur
            threshold = self._watchdog_threshold()
            # a bucket's first use captures its graph (and may build a
            # kernel) inside the step: that part counts at 1/scale
            captured = self._capture_s() - c0
            running_s = (time.monotonic() - t0
                         - captured * (1.0 - 1.0 / self.WATCHDOG_WARMUP_SCALE))
            if running_s < threshold:
                continue
            if self._step_started != cur:
                continue        # the step finished meanwhile: slow, not hung
            if tripped_seq != seq:
                tripped_seq = seq
                self._bump_stat("watchdog_trips")
                logger.warning("engine step stuck for %.2fs (watchdog %.2fs): "
                               "releasing injected hangs, failing the dispatch",
                               running_s, threshold)
                # the stuck step's record, written from this thread: the
                # loop thread may never come back to write it
                self._dump_postmortem("watchdog_trip")
                self.engine.faults.release_hangs()
            elif running_s > 2 * threshold and self._hard_trip_seq != seq:
                self._hard_trip_seq = seq
                self._bump_stat("engine_restarts")
                logger.error("engine step still stuck after %.2fs: failing all "
                             "in-flight clients (crash-only restart)", running_s)
                self._fail_all("engine step stuck (watchdog)", engine_side=False)

    def _consume_hard_trip(self, seq: int) -> bool:
        """Loop-side reconciliation after a stage-2 watchdog trip: the
        clients are failed already, so drop the step's outcome and reset
        the engine's request state."""
        if self._hard_trip_seq != seq:
            return False
        self._hard_trip_seq = None
        eng = self.engine
        for rid in list(eng.requests):
            try:
                eng.abort_request(rid)
            except Exception:
                logger.exception("abort of %s after a watchdog trip", rid)
            eng.requests.pop(rid, None)
        self._salvage = None
        eng.scheduler.set_admission_filter(None)
        return True

    # ---- SLO burn rates, auto-capture, the model pool ------------------

    def _evaluate_slo(self) -> None:
        """Advance the burn-rate evaluator (at most once an engine-clock
        second: the window math scans buckets) and export its state: the
        transitions, each objective's burn rate and the firing count."""
        ev = self.slo_eval
        if ev is None:
            return
        from tpuserve_torch.obs.burnrate import EVAL_INTERVAL_S
        now = self._clock.monotonic()
        if self._slo_eval_last is not None and now - self._slo_eval_last < EVAL_INTERVAL_S:
            return
        self._slo_eval_last = now
        transitions = ev.evaluate()
        for tr in transitions:
            logger.warning("SLO burn-rate alert %s: %s/%s (burn %.1fx long / %.1fx short)",
                           tr["state"].upper(), tr["objective"], tr["window"],
                           tr["burn_long"], tr["burn_short"])
        self._maybe_auto_capture(transitions)
        m = self.metrics
        if not m:
            return
        for tr in transitions:
            m.slo_transitions.labels(model_name=m.model_name, objective=tr["objective"],
                                     window=tr["window"], state=tr["state"]).inc()
        state = ev.last_state
        for key, (burn_long, _short) in state.get("burn", {}).items():
            name, _, window = key.rpartition("/")
            m.slo_burn_rate.labels(model_name=m.model_name, objective=name,
                                   window=window).set(burn_long)
        m.slo_alerts_firing.set(len(state.get("firing", ())))

    # fast-burn auto-capture: a short trace (the incident is now) and a long
    # cooldown, so a flapping page cannot fill the flight directory
    AUTO_CAPTURE_SECONDS = 3.0
    AUTO_CAPTURE_COOLDOWN_S = 600.0

    def _maybe_auto_capture(self, transitions: list) -> None:
        """When a fast-window burn-rate alert fires, take a short
        ``torch.profiler`` trace on a daemon thread while the loop keeps
        serving (the trace is of the degraded serving); its start and stop
        run on this thread through :meth:`call`.  Skipped with the device
        profiler off, inside the cooldown, or while another capture runs."""
        fired = [tr for tr in transitions
                 if tr.get("state") == "firing" and tr.get("window") == "fast"]
        dp = getattr(self.engine, "devprof", None)
        if not fired or dp is None or not dp.enabled:
            return
        now = time.monotonic()
        if (self._auto_capture_last is not None
                and now - self._auto_capture_last < self.AUTO_CAPTURE_COOLDOWN_S):
            return
        self._auto_capture_last = now
        reason = f"slo-{fired[0]['objective']}"

        def run():
            from tpuserve_torch.server.tracing import CaptureBusy, capture_profile_locked
            try:
                out = capture_profile_locked(self.AUTO_CAPTURE_SECONDS, reason=reason,
                                             profilers=[dp], call=self.call)
                logger.warning("fast-burn auto-capture -> %s", out["trace_dir"])
            except CaptureBusy:
                logger.info("fast-burn auto-capture skipped: a capture is in progress")
            except Exception:
                logger.exception("fast-burn auto-capture failed")

        threading.Thread(target=run, daemon=True, name="tpuserve-torch-auto-capture").start()

    def _maybe_swap_pool(self) -> None:
        """The model pool's hot-swap at the idle boundary (loop thread):
        parked submits past their deadline get the typed 504; with the
        engine idle the pool swaps, and the submits for the new model
        re-enter intake."""
        pool = self.pool
        if pool is None:
            return
        if self._parked:
            still = []
            now = self._clock.monotonic()
            for msg in self._parked:
                if msg.deadline is not None and now > msg.deadline:
                    msg.assigned_id = msg.request_id or "rejected"
                    msg.rid_event.set()
                    msg.out_queue.put(TimeoutError(
                        "admission deadline expired while parked for a model swap "
                        f"to {msg.model!r}"))
                    msg.out_queue.put(None)
                else:
                    still.append(msg)
            self._parked = still
        if pool.pending is None:
            if not self._parked:
                return
            # several models may park at once: aim at the oldest still parked
            pool.request_swap(self._parked[0].model)
        if self.engine.has_work():
            return
        outcome = pool.maybe_swap(self.engine)
        if outcome is None:
            return
        logger.info("model swap -> %s (source tier: %s)", pool.current, outcome)
        still = []
        for msg in self._parked:
            if msg.model == pool.current:
                self._intake.put(msg)
            else:
                still.append(msg)
        self._parked = still
        self._wake.set()

    # ---- gauges ---------------------------------------------------------

    def _update_gauges(self) -> None:
        """The vllm_* and tpuserve_* gauges and counters from host state
        only (queue lengths, free blocks, engine stats): no CUDA call."""
        self._evaluate_slo()
        m = self.metrics
        if not m:
            return
        sched = self.engine.scheduler
        running, waiting = sched.num_running, sched.num_waiting
        m.running.set(running)
        m.waiting.set(waiting)
        m.active_requests.set(running + waiting)
        bm = self.engine.block_manager
        m.kv_usage.set((bm.num_blocks - bm.num_free_blocks) / max(bm.num_blocks, 1))
        _advance_counter(m.prefix_hits, bm.prefix_hits)
        _advance_counter(m.prefix_queries, bm.prefix_queries)
        stats = self.engine.stats
        for metric, value in ((m.preemptions, stats.preemptions),
                              (m.window_overrun, stats.window_overrun_tokens),
                              (m.latency_windows, stats.latency_windows),
                              (m.padded_tokens_total, stats.padded_tokens_total),
                              (m.actual_tokens_total, stats.actual_tokens_total),
                              (m.mixed_steps, stats.num_mixed_steps),
                              (m.guided_fallbacks, stats.guided_fallbacks),
                              (m.guided_fsm_requests, stats.guided_fsm_requests),
                              (m.guided_fsm_windows, stats.guided_fsm_windows),
                              (m.kv_demoted, stats.kv_demoted_blocks),
                              (m.kv_spilled, stats.kv_spilled_blocks),
                              (m.kv_tier_dropped, stats.kv_tier_dropped_blocks),
                              (m.kv_restored, stats.kv_restored_blocks),
                              (m.requests_shed, stats.requests_shed),
                              (m.requests_preempted, stats.slo_preemptions),
                              (m.requests_salvaged, stats.requests_salvaged),
                              (m.requests_poisoned, stats.requests_poisoned),
                              (m.watchdog_trips, stats.watchdog_trips),
                              (m.engine_restarts, stats.engine_restarts),
                              (m.flight_postmortems, stats.flight_postmortems),
                              (m.spec_proposed, stats.spec_proposed),
                              (m.spec_accepted, stats.spec_accepted),
                              (m.spec_pauses, stats.spec_pauses),
                              (m.released_blocks, stats.released_blocks)):
            _advance_counter(metric, value)
        m.step_padded_tokens.set(stats.step_padded_tokens)
        m.step_actual_tokens.set(stats.step_actual_tokens)
        m.brownout_level.set(stats.brownout_level)
        ctl = getattr(self.engine, "_slo", None)
        if ctl is not None:
            for cls, delay in ctl.drain_delay_obs():
                m.queue_delay.labels(model_name=m.model_name, slo_class=cls).observe(delay)
        # the tier restores' begin -> commit times, drained on the loop
        # thread that appended them
        for v in stats.restore_latencies:
            m.kv_restore_latency.observe(v)
        stats.restore_latencies.clear()
        for tier, n in self.engine.kv_tier_blocks().items():
            m.kv_tier_blocks.labels(model_name=m.model_name, tier=tier).set(n)
        label = {"model_name": m.model_name}
        dp = getattr(self.engine, "devprof", None)
        if dp is not None and dp.enabled:
            # device telemetry: the engine keeps cumulative totals
            hbm = dp.hbm_snapshot()
            for kind, field in (("weights", "weights_bytes"), ("kv", "kv_reserved_bytes"),
                                ("other", "other_bytes")):
                m.hbm_bytes.labels(kind=kind, **label).set(hbm.get(field, 0))
            m.hbm_headroom.set(hbm.get("headroom_bytes", 0))
            for kind, secs in list(dp.sync_s.items()):
                _advance_counter(m.device_seconds.labels(kind=kind, **label), secs)
            _advance_counter(m.exec_compiles, dp.compiles)
            _advance_counter(m.exec_compile_seconds, dp.compile_s)
            m.execs_retained.set(len(dp.ladder))
            _advance_counter(m.profile_captures, dp.captures_total)
        pool = self.pool
        if pool is not None:
            # swap totals and latencies ride the engine's stats (carried
            # across swaps); residency comes from the pool's store
            for outcome, n in list(stats.model_swaps_by_outcome.items()):
                _advance_counter(m.model_swaps.labels(outcome=outcome, **label), n)
            for _tier, dt in stats.swap_latencies:
                m.model_swap_seconds.observe(dt)
            stats.swap_latencies.clear()
            cached = self._pool_hbm_cache
            if cached is None or cached[0] != pool.current:
                from tpuserve_torch.models.weights import param_nbytes
                cached = self._pool_hbm_cache = (pool.current,
                                                 param_nbytes(self.engine.params))
            tiers = pool.tiers.bytes_by_tier()
            m.weight_tier_bytes.labels(tier="hbm", **label).set(
                cached[1] + pool.resident_nbytes())
            m.weight_tier_bytes.labels(tier="host", **label).set(tiers.get("host", 0))
            m.weight_tier_bytes.labels(tier="spill", **label).set(tiers.get("spill", 0))
            m.models_resident.set(sum(1 for e in pool.catalog_status()
                                      if e["tier"] in ("serving", "resident")))

    def _loop(self) -> None:
        logger.info("engine loop started")
        while not self._stop.is_set():
            self._drain_intake()
            if not self.engine.has_work():
                self._maybe_swap_pool()
                self._update_gauges()
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            self._step_seq += 1
            seq = self._step_seq
            step_start = time.monotonic()
            self._step_started = (seq, step_start, self._capture_s())
            try:
                outputs = self.engine.step()
                if self.on_step_time is not None:
                    self.on_step_time(time.monotonic() - step_start)
            except Exception as e:
                self._step_started = None
                logger.exception("engine step failed")
                self.steps_failed += 1
                if self._consume_hard_trip(seq):
                    continue
                self._handle_step_fault(e)
                time.sleep(0.05)
                continue
            self._step_started = None
            self._steps_done += 1
            if self._consume_hard_trip(seq):
                continue
            self._note_salvage_progress()
            self._drain_engine_errors()
            self._route_outputs(outputs)
            self._update_gauges()
        logger.info("engine loop stopped")
