"""Prometheus serving metrics with the vLLM-compatible families of
``tpuserve/server/metrics.py``: the same names, label (``model_name``),
types and histogram bucket edges, so the reference's scrape config and
queries read the port unchanged.

The card's machine has no ``prometheus_client``, so the port renders the
text exposition format itself (``_Family``).  Of the ``tpuserve_*``
families, guided decoding's, speculative decoding's (drafts proposed and
accepted, governor pauses), the tiered KV cache's, the SLO controller's
(sheds, class preemptions, the brownout level, the per-class queue-delay
histogram and the client TTFT / ITL / end-to-end twins), crash-only
recovery's (salvaged, poisoned, watchdog trips, engine restarts) and the
flight recorder's (post-mortem bundles, on-demand dumps) are served;
those of tenants, the device profiler and the model pool wait for those
modules (ROADMAP.md A9).
"""

from __future__ import annotations

import math
import threading

_TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.25, 0.5, 1.0, 2.5,
                 5.0, 10.0)
_ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
_DURATION_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
# the per-SLO-class queue-delay edges, as the JAX server's
_SLI_E2E_BUCKETS = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                    120.0)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return repr(float(v))


class _Child:
    """One labelled series of a family: a value, or a histogram's bucket
    counts and sum.  Updates hold the family's lock, so the runner thread
    and the handler threads may both feed it."""

    def __init__(self, family: "_Family"):
        self._f = family
        self.value = 0.0
        if family.kind == "histogram":
            self.buckets = [0] * len(family.edges)
            self.count = 0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("a counter only goes up")
        with self._f.lock:
            self.value += n

    def set(self, v: float) -> None:
        with self._f.lock:
            self.value = float(v)

    def observe(self, v: float) -> None:
        with self._f.lock:
            self.value += v
            self.count += 1
            for i, edge in enumerate(self._f.edges):
                if v <= edge:
                    self.buckets[i] += 1


class _Family:
    """A metric family: ``kind`` is counter, gauge or histogram."""

    def __init__(self, name: str, doc: str, kind: str, labelnames: tuple,
                 edges: tuple = ()):
        self.name, self.doc, self.kind = name, doc, kind
        self.labelnames = labelnames
        self.edges = tuple(edges) + (math.inf,) if kind == "histogram" else ()
        self.lock = threading.Lock()
        self.children: dict[tuple, _Child] = {}

    def labels(self, **kw) -> _Child:
        key = tuple(str(kw[n]) for n in self.labelnames)
        with self.lock:
            child = self.children.get(key)
            if child is None:
                child = self.children[key] = _Child(self)
        return child

    def render(self) -> list[str]:
        # a counter's samples end in _total, and so do its HELP and TYPE
        # lines, as the reference's prometheus_client writes them
        name = (self.name if self.kind != "counter" or self.name.endswith("_total")
                else self.name + "_total")
        out = [f"# HELP {name} {self.doc}", f"# TYPE {name} {self.kind}"]
        with self.lock:
            series = sorted(self.children.items())
            for key, c in series:
                labels = dict(zip(self.labelnames, key))
                if self.kind != "histogram":
                    out.append(f"{name}{_labels(labels)} {_fmt(c.value)}")
                    continue
                for edge, n in zip(self.edges, c.buckets):
                    out.append(f"{name}_bucket{_labels(dict(labels, le=_fmt(edge)))} "
                               f"{_fmt(n)}")
                out.append(f"{name}_count{_labels(labels)} {_fmt(c.count)}")
                out.append(f"{name}_sum{_labels(labels)} {_fmt(c.value)}")
        return out


def _labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


class ServerMetrics:
    """One server's metric families (one object a server, so tests can run
    many servers in a process)."""

    def __init__(self, model_name: str):
        self.model_name = model_name
        self._families: list[_Family] = []
        label = {"model_name": model_name}

        def family(name, doc, kind, labelnames=("model_name",), edges=()):
            f = _Family(name, doc, kind, labelnames, edges)
            self._families.append(f)
            return f

        def counter(name, doc):
            return family(name, doc, "counter").labels(**label)

        def gauge(name, doc):
            return family(name, doc, "gauge").labels(**label)

        def histogram(name, doc, buckets):
            return family(name, doc, "histogram", edges=buckets).labels(**label)

        def class_histogram(name, doc, buckets):
            # one series a (model_name, slo_class): callers pick .labels()
            return family(name, doc, "histogram", ("model_name", "slo_class"), buckets)

        # the families the reference's verification queries look for
        self.request_total = counter("vllm_request_total", "Total requests received")
        self.active_requests = gauge("vllm_active_requests",
                                     "Requests currently running or queued")
        self.request_duration = histogram("vllm_request_duration_seconds",
                                          "End-to-end request latency", _DURATION_BUCKETS)
        # standard vLLM serving families
        self.request_success = family("vllm_request_success", "Finished requests by reason",
                                      "counter", ("model_name", "finished_reason"))
        self.prompt_tokens = counter("vllm_prompt_tokens", "Prefill tokens processed")
        self.generation_tokens = counter("vllm_generation_tokens", "Tokens generated")
        self.ttft = histogram("vllm_time_to_first_token_seconds", "Time to first token",
                              _TTFT_BUCKETS)
        self.itl = histogram("vllm_time_per_output_token_seconds", "Inter-token latency",
                             _ITL_BUCKETS)
        self.kv_usage = gauge("vllm_kv_cache_usage_perc", "Fraction of KV blocks in use")
        self.preemptions = counter("vllm_num_preemptions",
                                   "Sequences preempted and re-prefilled")
        self.running = gauge("vllm_num_requests_running", "Requests in the decode batch")
        self.waiting = gauge("vllm_num_requests_waiting", "Requests queued for prefill")
        # guided decoding's counters, as the JAX server's
        self.guided_fallbacks = counter(
            "tpuserve_guided_fallbacks",
            "Guided-decoding steps where the whole top-K was grammatically invalid "
            "and a structural fallback token was substituted (runtime/engine.py "
            "_guided_pick)")
        self.guided_fsm_requests = counter(
            "tpuserve_guided_fsm_requests",
            "Guided requests served by compiled grammar-FSM logit masks "
            "(runtime/grammar/); guided traffic not counted here ran the per-step "
            "substitution path")
        self.guided_fsm_windows = counter(
            "tpuserve_guided_fsm_windows",
            "Fused multi-step windows that carried grammar-FSM masks; zero under "
            "guided load means constraints are pinning decode to per-step dispatches")
        # speculative decoding's counters, as the JAX server's
        self.spec_proposed = counter(
            "tpuserve_spec_draft_tokens_proposed",
            "Draft tokens offered to the speculative verifier (vLLM "
            "spec_decode_num_draft_tokens analog)")
        self.spec_accepted = counter(
            "tpuserve_spec_draft_tokens_accepted",
            "Draft tokens accepted by the verifier; divide by proposed "
            "for the live acceptance rate")
        self.spec_pauses = counter(
            "tpuserve_spec_adaptive_pauses",
            "Times the adaptive governor paused speculation for "
            "below-break-even acceptance (runtime/spec.py)")
        self.released_blocks = counter(
            "tpuserve_window_released_blocks",
            "KV blocks recycled by the sliding-window rolling buffer "
            "(runtime/block_manager.py release_out_of_window)")
        # the tiered KV cache (runtime/kv_tiers.py), as the JAX server's:
        # residency by tier ("hbm": freed-but-hashed blocks in the card's
        # cached pool; "host": pages in host DRAM under the byte budget;
        # "spill": files in the spill directory) and the demote / spill /
        # drop / restore flow
        self.kv_tier_blocks = family(
            "tpuserve_kv_tier_blocks",
            "Prefix-cache KV blocks resident per tier (exactly-one-tier invariant: a "
            "chain hash resolves in hbm, host, OR spill)", "gauge",
            ("model_name", "tier"))
        self.kv_demoted = counter(
            "tpuserve_kv_blocks_demoted",
            "Prefix blocks demoted out of HBM into the host-DRAM tier instead of "
            "destroyed on eviction (tiered KV cache; TPUSERVE_KV_TIERS=0 restores "
            "destroy-on-evict)")
        self.kv_spilled = counter(
            "tpuserve_kv_blocks_spilled",
            "Host-tier blocks cascaded to the PVC spill tier under host-byte-budget "
            "pressure")
        self.kv_tier_dropped = counter(
            "tpuserve_kv_blocks_tier_dropped",
            "Blocks that fell off the LAST tier (KV lost; the next reuse pays full "
            "prefill) — rising fast means the spill tier is undersized for the reuse "
            "window")
        self.kv_restored = counter(
            "tpuserve_kv_blocks_restored",
            "Prefix blocks copied back host->HBM ahead of admission (each one is a "
            "block of prefill compute a request skipped)")
        self.kv_restore_latency = histogram(
            "tpuserve_kv_restore_latency_seconds",
            "Tier-restore begin->commit wall time (the async copy overlaps the current "
            "dispatch; this is the admission hold, one engine cycle + copy tail)",
            _ITL_BUCKETS)
        # overload robustness (runtime/slo.py), as the JAX server's
        self.requests_shed = counter(
            "tpuserve_requests_shed",
            "Requests rejected at intake by the brownout ladder or evicted from a "
            "full queue for a stricter-class arrival (HTTP 429 + Retry-After; no "
            "prefill was spent)")
        self.requests_preempted = counter(
            "tpuserve_requests_preempted",
            "Running batch-class rows preempted to seat a stricter-class arrival "
            "(token-identical re-prefill replay; bounded per request by the "
            "preemption budget).  A subset of vllm_num_preemptions")
        self.brownout_level = gauge(
            "tpuserve_brownout_level",
            "Current graceful-degradation rung (0 normal, 1 spec off for batch, 2 "
            "batch max_tokens capped, 3 batch shed, 4 standard shed too) - entered "
            "on pressure immediately, exited hysteretically (runtime/slo.py)")
        self.queue_delay = class_histogram(
            "tpuserve_queue_delay_seconds",
            "Admission queue delay per SLO class: arrival to first prefill "
            "scheduling, fresh admissions only - the per-class SLI the overload "
            "estimator steers the brownout ladder by", _SLI_E2E_BUCKETS)
        self.ttft_class = class_histogram(
            "tpuserve_ttft_seconds",
            "Client-observable time to first token per SLO class", _TTFT_BUCKETS)
        self.itl_class = class_histogram(
            "tpuserve_itl_seconds",
            "Client-observable inter-token latency per SLO class (re-prefill replay "
            "gaps excluded like vllm_time_per_output_token_seconds)", _ITL_BUCKETS)
        self.e2e_class = class_histogram(
            "tpuserve_e2e_seconds",
            "Client-observable end-to-end request latency per SLO class (slo_class= "
            "label; submit to finish).  Buckets include sub-100ms edges (SLI_BUCKETS) "
            "so burn-rate math resolves fast classes", _SLI_E2E_BUCKETS)
        # crash-only recovery (server/runner.py), as the JAX server's
        self.requests_salvaged = counter(
            "tpuserve_requests_salvaged_total",
            "Requests re-queued through the preemption re-prefill path after a "
            "faulted/stuck engine step and replayed token-identically (crash-only "
            "salvage, server/runner.py)")
        self.requests_poisoned = counter(
            "tpuserve_requests_poisoned_total",
            "Requests isolated as poison by fault bisection (or out of salvage "
            "budget) and failed with a per-request error while the rest of their "
            "batch resumed")
        self.watchdog_trips = counter(
            "tpuserve_engine_watchdog_trips",
            "Engine dispatches declared stuck by the hang watchdog (past "
            "step_watchdog_s), where the device call blocks instead of raising")
        self.engine_restarts = counter(
            "tpuserve_engine_restarts",
            "Whole-engine fail-all fallbacks: fault storms past the salvage window "
            "or unrecoverable hangs - each count failed every in-flight stream")
        # the flight recorder (runtime/flight.py), as the JAX server's
        self.flight_postmortems = counter(
            "tpuserve_flight_postmortems",
            "Post-mortem bundles written by the engine flight recorder (watchdog "
            "trip, fault-storm fail-all, poison isolation) — each count is a JSON "
            "file of the last N engine cycles + affected request timelines under "
            "TPUSERVE_FLIGHT_DIR (/debug/engine reports the newest path)")
        self.replay_dumps = counter(
            "tpuserve_replay_dumps",
            "Replay-ready flight bundles exported on demand via GET "
            "/debug/engine/dump (tools/replay.py dump) — unlike post-mortems these "
            "capture a HEALTHY engine's recent timelines for trace-driven replay "
            "(tpuserve/replay/)")

    def observe_finish(self, reason: str, duration_s: float) -> None:
        self.request_success.labels(model_name=self.model_name,
                                    finished_reason=reason).inc()
        self.request_duration.observe(duration_s)

    def render(self) -> bytes:
        lines = []
        for f in self._families:
            lines += f.render()
        return ("\n".join(lines) + "\n").encode()
