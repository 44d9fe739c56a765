"""Background engine loop with a thread-safe request interface: the port
of ``tpuserve/server/runner.py``.

The engine is single-threaded: every call that touches the card (steps,
graph captures, the pinned staging copies and the events a pipelined
dispatch waits on) runs on the loop thread.  HTTP handler threads talk to
it only through the intake queue and per-request output queues, and make
no CUDA call, so a graph the loop captures on first use (in the global
capture mode) never meets another thread's CUDA work.

Not ported: crash-only salvage, the hang watchdog, SLO evaluation, fault
injection and the model pool (ROADMAP.md A5b and A9).  A step that raises
fails every in-flight request with the error (``_fail_all``), as the JAX
runner does once salvage gives up.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Optional, Sequence

from tpuserve_torch.runtime.clock import MONOTONIC
from tpuserve_torch.runtime.request import RequestOutput, SamplingParams

logger = logging.getLogger("tpuserve_torch.server")


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


@dataclasses.dataclass
class _Abort:
    request_id: str


class AsyncEngineRunner:
    """Runs ``engine.step()`` on a dedicated thread; routes outputs to
    callers."""

    def __init__(self, engine, metrics=None):
        self.engine = engine
        self.metrics = metrics
        # request SLI stamps run on the engine's clock (runtime/clock.py)
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

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def idle(self) -> bool:
        """No engine work and no undelivered outputs: safe to stop.  Polled
        by the server's graceful drain."""
        return (not self.engine.has_work() and not self._out_queues
                and self._intake.empty())

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._started:
            self._thread.join(timeout=30)

    # ---- client API (any thread) ---------------------------------------

    def submit(self, prompt: Optional[str] = None,
               prompt_token_ids: Optional[Sequence[int]] = None,
               params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None,
               deadline: Optional[float] = None,
               ) -> tuple[str, "queue.Queue[RequestOutput | Exception | None]"]:
        """Enqueue a request; returns (request_id, output queue).  The queue
        yields RequestOutput items, then None when finished; an Exception
        item signals a rejected or failed request."""
        sub = _Submit(prompt=prompt,
                      prompt_token_ids=list(prompt_token_ids) if prompt_token_ids else None,
                      params=params or SamplingParams(),
                      out_queue=queue.Queue(), rid_event=threading.Event(),
                      request_id=request_id, deadline=deadline)
        self._intake.put(sub)
        self._wake.set()
        sub.rid_event.wait(timeout=60)
        if sub.assigned_id is None:
            raise TimeoutError("engine loop did not accept the request")
        return sub.assigned_id, sub.out_queue

    def abort(self, request_id: str) -> None:
        self._intake.put(_Abort(request_id))
        self._wake.set()

    def generate_sync(self, prompt=None, prompt_token_ids=None, params=None,
                      timeout: float = 600.0):
        """Blocking convenience: returns (list[RequestOutput], request_id)."""
        rid, q = self.submit(prompt=prompt, prompt_token_ids=prompt_token_ids,
                             params=params)
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

    def _drain_intake(self) -> None:
        while True:
            try:
                msg = self._intake.get_nowait()
            except queue.Empty:
                return
            if isinstance(msg, _Abort):
                if self.engine.abort_request(msg.request_id):
                    q = self._out_queues.pop(msg.request_id, None)
                    self.engine.requests.pop(msg.request_id, None)
                    self._req_started.pop(msg.request_id, None)
                    self._last_token_time.pop(msg.request_id, None)
                    if q is not None:
                        q.put(None)
                continue
            try:
                rid = self.engine.add_request(
                    prompt=msg.prompt, prompt_token_ids=msg.prompt_token_ids,
                    params=msg.params, request_id=msg.request_id,
                    deadline=msg.deadline)
            except Exception as e:           # invalid request: report, don't die
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

    def _route_outputs(self, outputs: list[RequestOutput]) -> None:
        now = self._clock.monotonic()
        m = self.metrics
        for out in outputs:
            q = self._out_queues.get(out.request_id)
            if m:
                m.generation_tokens.inc(len(out.new_token_ids))
                last = self._last_token_time.get(out.request_id)
                if last is not None:
                    if out.num_output_tokens == 1:
                        m.ttft.observe(now - self._req_started.get(out.request_id, now))
                    elif not out.from_prefill:
                        # a from_prefill emission past the first token is a
                        # re-prefill after preemption: its gap is queue and
                        # recompute time, not inter-token latency
                        m.itl.observe(now - last)
                self._last_token_time[out.request_id] = now
            if q is not None:
                q.put(out)
            if out.finished:
                started = self._req_started.pop(out.request_id, now)
                if m:
                    reason = out.finish_reason.value if out.finish_reason else "stop"
                    m.observe_finish(reason, now - started)
                self._last_token_time.pop(out.request_id, None)
                # the request record stays in engine.requests: the caller
                # that submitted claims (pops) it for usage
                if q is not None:
                    self._out_queues.pop(out.request_id, None)
                    q.put(None)

    def _fail_all(self, message: str) -> None:
        """Fail every in-flight stream and abort it in the engine, so
        nothing re-raises in a tight loop (loop thread only)."""
        for rid, q in list(self._out_queues.items()):
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

    def _fail_request(self, rid: str, message: str,
                      exc: Optional[Exception] = None) -> None:
        """Fail one stream with a typed error (TimeoutError -> 504) or a
        RuntimeError carrying ``message``."""
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
        logger.warning("request %s failed: %s", rid, message)

    def _drain_engine_errors(self) -> None:
        """Terminal errors the engine decided for QUEUED requests (deadline
        expiry): route each to its client with the typed exception so the
        HTTP layer keeps the right status code."""
        for rid, exc in self.engine.drain_request_errors():
            self._fail_request(rid, str(exc), exc=exc)

    def _update_gauges(self) -> None:
        """The vllm_* gauges and counters from host state only (queue
        lengths, free blocks, engine stats): no CUDA call."""
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
        stats = self.engine.stats
        for metric, value in ((m.preemptions, stats.preemptions),
                              (m.guided_fallbacks, stats.guided_fallbacks),
                              (m.guided_fsm_requests, stats.guided_fsm_requests),
                              (m.guided_fsm_windows, stats.guided_fsm_windows),
                              (m.kv_demoted, stats.kv_demoted_blocks),
                              (m.kv_spilled, stats.kv_spilled_blocks),
                              (m.kv_tier_dropped, stats.kv_tier_dropped_blocks),
                              (m.kv_restored, stats.kv_restored_blocks)):
            _advance_counter(metric, value)
        # the tier restores' begin -> commit times, drained on the loop
        # thread that appended them
        for v in stats.restore_latencies:
            m.kv_restore_latency.observe(v)
        stats.restore_latencies.clear()
        for tier, n in self.engine.kv_tier_blocks().items():
            m.kv_tier_blocks.labels(model_name=m.model_name, tier=tier).set(n)

    def _loop(self) -> None:
        logger.info("engine loop started")
        while not self._stop.is_set():
            self._drain_intake()
            if not self.engine.has_work():
                self._update_gauges()
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                outputs = self.engine.step()
            except Exception as e:
                logger.exception("engine step failed")
                self.steps_failed += 1
                self._fail_all(f"engine failure: {e}")
                time.sleep(0.05)
                continue
            self._drain_engine_errors()
            self._route_outputs(outputs)
            self._update_gauges()
        logger.info("engine loop stopped")
