"""Prometheus serving metrics with the vLLM-compatible families of
``tpuserve/server/metrics.py``: the same names, label (``model_name``),
types and histogram bucket edges, so the reference's scrape config and
queries read the port unchanged.

The card's machine has no ``prometheus_client``, so the port renders the
text exposition format itself (``_Family``).  ``ServerMetrics`` serves
every family of the JAX server's: the vLLM ones, the step-padding gauges
and totals, prefix-cache hits and queries, window overruns and latency
windows, mixed steps, guided and speculative decoding's, the tiered KV
cache's, the SLO controller's, crash-only recovery's (failed, salvaged,
poisoned, watchdog trips, engine restarts), the flight recorder's,
tenants', the burn-rate evaluator's, the device profiler's (device
seconds from CUDA events, graph captures, the HBM watermark, profile
captures) and the model pool's.  ``CanaryMetrics`` is the synthetic
prober's own registry (``obs/canary.py``).
"""

from __future__ import annotations

import math
import threading

_TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.25, 0.5, 1.0, 2.5,
                 5.0, 10.0)
_ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
_DURATION_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
# the per-SLO-class SLI edges, as the JAX server's: a latency objective
# is only evaluable at a bucket edge (obs/objectives.py rejects others)
_SLI_E2E_BUCKETS = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                    120.0)
SLI_BUCKETS = {"ttft": _TTFT_BUCKETS, "itl": _ITL_BUCKETS, "e2e": _SLI_E2E_BUCKETS}
_COLD_START_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 40.0, 80.0, 160.0, 320.0)


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


class _Registry:
    """An ordered set of families rendered as one exposition."""

    def __init__(self):
        self._families: list[_Family] = []

    def family(self, name, doc, kind, labelnames=("model_name",), edges=()) -> _Family:
        f = _Family(name, doc, kind, tuple(labelnames), edges)
        self._families.append(f)
        return f

    def render(self) -> bytes:
        lines = []
        for f in self._families:
            lines += f.render()
        return ("\n".join(lines) + "\n").encode()


class ServerMetrics(_Registry):
    """One server's metric families (one object a server, so tests can run
    many servers in a process)."""

    def __init__(self, model_name: str):
        super().__init__()
        self.model_name = model_name
        label = {"model_name": model_name}
        family = self.family

        def counter(name, doc):
            return family(name, doc, "counter").labels(**label)

        def gauge(name, doc):
            return family(name, doc, "gauge").labels(**label)

        def histogram(name, doc, buckets):
            return family(name, doc, "histogram", edges=buckets).labels(**label)

        def labelled(name, doc, kind, extra, buckets=()):
            # callers pick .labels(model_name=..., <extra>=...)
            return family(name, doc, kind, ("model_name",) + tuple(extra), buckets)

        # the families the reference's verification queries look for
        self.request_total = counter("vllm_request_total", "Total requests received")
        self.active_requests = gauge("vllm_active_requests",
                                     "Requests currently running or queued")
        self.request_duration = histogram("vllm_request_duration_seconds",
                                          "End-to-end request latency", _DURATION_BUCKETS)
        # standard vLLM serving families
        self.request_success = labelled("vllm_request_success", "Finished requests by reason",
                                        "counter", ("finished_reason",))
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
        # the engine's own step and cache counters, as the JAX server's
        self.window_overrun = counter(
            "tpuserve_window_overrun_tokens",
            "Tokens computed past a request's stop point by fused "
            "multi-step windows and dropped at emit (the cost knob for "
            "--multi-step; no vLLM analog)")
        self.prefix_hits = counter(
            "tpuserve_prefix_cache_hits",
            "Prefix-cache lookups that found at least one cached block "
            "(vLLM gpu_prefix_cache_hit_rate analog: divide by queries)."
            "  Counted once PER LOOKUP, exactly like queries — the two "
            "must share a unit or the hit-rate gauge lies when the "
            "first block already misses")
        self.prefix_queries = counter(
            "tpuserve_prefix_cache_queries",
            "Prefix-cache lookups performed (one per real admission "
            "lookup; scheduler routing peeks don't count)")
        self.latency_windows = counter(
            "tpuserve_latency_windows",
            "Fused decode windows shrunk to min_multi_step because "
            "arrivals were landing into a busy engine (adaptive window "
            "sizing, runtime/engine.py _window_steps)")
        self.step_padded_tokens = gauge(
            "tpuserve_step_padded_tokens",
            "Tokens dispatched by the engine's last step INCLUDING "
            "bucket/alignment padding — compare against "
            "tpuserve_step_actual_tokens to see what the static-shape "
            "buckets cost.  Mixed ragged batching collapses the "
            "(batch x length) grid to one flat-token bucket, which is "
            "exactly the gap these two gauges make observable")
        self.step_actual_tokens = gauge(
            "tpuserve_step_actual_tokens",
            "Real (non-padding) tokens computed by the engine's last "
            "step")
        self.padded_tokens_total = counter(
            "tpuserve_padded_tokens_total",
            "Cumulative dispatched tokens including padding; with "
            "tpuserve_actual_tokens_total this gives the live padding "
            "efficiency ratio for before/after bucketing comparisons")
        self.actual_tokens_total = counter(
            "tpuserve_actual_tokens_total",
            "Cumulative real tokens computed across all engine steps")
        self.mixed_steps = counter(
            "tpuserve_mixed_steps",
            "Ragged mixed prefill+decode dispatches (scheduler mixed "
            "mode) — zero under admission load means the engine is "
            "phase-splitting")
        def labelled_class(name, doc, buckets):
            return labelled(name, doc, "histogram", ("slo_class",), buckets)

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
        self.requests_failed = counter(
            "tpuserve_requests_failed",
            "Terminal engine-decided failures routed to clients other "
            "than shed/poison (admission-deadline 504s, salvage-path "
            "errors) — with shed + poisoned, the bad-event families "
            "the availability SLO's PromQL twin reads, matching what "
            "the in-process burn-rate evaluator counts "
            "(tpuserve/obs/objectives.py)")
        self.brownout_level = gauge(
            "tpuserve_brownout_level",
            "Current graceful-degradation rung (0 normal, 1 spec off for batch, 2 "
            "batch max_tokens capped, 3 batch shed, 4 standard shed too) - entered "
            "on pressure immediately, exited hysteretically (runtime/slo.py)")
        self.queue_delay = labelled_class(
            "tpuserve_queue_delay_seconds",
            "Admission queue delay per SLO class: arrival to first prefill "
            "scheduling, fresh admissions only - the per-class SLI the overload "
            "estimator steers the brownout ladder by", _SLI_E2E_BUCKETS)
        self.ttft_class = labelled_class(
            "tpuserve_ttft_seconds",
            "Client-observable time to first token per SLO class", _TTFT_BUCKETS)
        self.itl_class = labelled_class(
            "tpuserve_itl_seconds",
            "Client-observable inter-token latency per SLO class (re-prefill replay "
            "gaps excluded like vllm_time_per_output_token_seconds)", _ITL_BUCKETS)
        self.e2e_class = labelled_class(
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

        # multi-tenant metering (server/tenants.py): tenant = API key or
        # LoRA adapter; the label's values are the configured set plus
        # "default"
        self.tenant_tokens = labelled(
            "tpuserve_tenant_tokens",
            "Tokens served per tenant (prompt + generated; settled "
            "against the estimate the rate limiter charged at "
            "admission) — the metering source for per-tenant billing "
            "and the token-bucket rate limits", "counter", ("tenant",))
        self.tenant_rate_limited = labelled(
            "tpuserve_tenant_rate_limited",
            "Requests rejected 429 by a tenant's token-bucket rate "
            "limit (Retry-After = time until the bucket refills "
            "enough)", "counter", ("tenant",))
        # in-process SLO evaluation (obs/burnrate.py), fed by the same SLI
        # stream as the histograms above
        self.slo_burn_rate = labelled(
            "tpuserve_slo_burn_rate",
            "Long-window error-budget burn rate per declared SLO "
            "objective and alert window (objective= from "
            "tpuserve/obs/objectives.py, window= fast|slow).  1.0 = "
            "burning exactly the budget; the window's factor (e.g. "
            "14.4 fast) is the firing threshold", "gauge", ("objective", "window"))
        self.slo_alerts_firing = gauge(
            "tpuserve_slo_alerts_firing",
            "SLO burn-rate alerts currently firing in-process (count "
            "over objective x window pairs) — nonzero means this pod "
            "is eating error budget fast enough to page, even if the "
            "Prometheus stack is down")
        self.slo_transitions = labelled(
            "tpuserve_slo_alert_transitions",
            "In-process burn-rate alert state transitions (state= "
            "firing|resolved, objective=, window=) — the replay "
            "backtester (tools/replay.py backtest) reproduces exactly "
            "this sequence from a recorded incident", "counter",
            ("objective", "window", "state"))
        self.canary_requests = counter(
            "tpuserve_canary_requests",
            "Synthetic canary probes served by this pod (tagged "
            "X-TPUServe-Canary; excluded from tenant metering and "
            "every production SLI histogram — this counter is the "
            "proof they still flow through the real path)")
        # device telemetry (runtime/devprof.py): device time from CUDA
        # events, the captured-graph ladder and the HBM watermark;
        # TPUSERVE_DEVPROF=0 leaves these families at zero
        self.hbm_bytes = labelled(
            "tpuserve_hbm_bytes",
            "Per-device HBM watermark by kind= weights (loaded param "
            "bytes, draft and co-resident models included), kv (the paged "
            "cache's full static reservation), other (workspace, graph "
            "pools and fragmentation the allocator reports beyond "
            "weights+kv) — reconciled against torch.cuda.mem_get_info",
            "gauge", ("kind",))
        self.hbm_headroom = gauge(
            "tpuserve_hbm_headroom_bytes",
            "Detected HBM budget minus weights+kv+other — what is left "
            "before the next ladder bucket, draft model, or KV resize "
            "OOMs; the generated hbm-headroom-low warning fires on the "
            "ratio of this to the budget")
        self.device_seconds = labelled(
            "tpuserve_device_seconds",
            "Device seconds of the engine's dispatches, from CUDA events "
            "around each graph replay or eager dispatch, read at the "
            "engine's existing syncs, by sync kind= window|decode|sample|"
            "verify|draft|guided", "counter", ("kind",))
        self.exec_compiles = counter(
            "tpuserve_executable_compiles",
            "First-dispatch graph captures observed by the executable "
            "ladder (one per (dispatch kind, bucket) pair) — a rising "
            "rate in steady state is a capture storm: bucket ladders "
            "too fine, or an unbounded shape leaking into a dispatch")
        self.exec_compile_seconds = counter(
            "tpuserve_executable_compile_seconds",
            "Wall seconds spent inside first-dispatch capture brackets "
            "— the serving stall each new executable cost (warmup "
            "prepays the planned ladder; this counts the rest)")
        self.execs_retained = gauge(
            "tpuserve_executables_retained",
            "Distinct (dispatch kind, bucket) executables the ladder "
            "has ever dispatched and the engine retains — ladder bloat is "
            "graph-pool memory, bounded by design by the power-of-2 "
            "bucketing")
        self.profile_captures = counter(
            "tpuserve_profile_captures",
            "torch.profiler traces captured on demand (POST "
            "/debug/profile) or by the fast-burn SLO auto-capture hook "
            "— trace dirs land under TPUSERVE_FLIGHT_DIR beside the "
            "post-mortem bundles that reference them")
        # model pool (modelpool/): weight tiering and hot-swap so one
        # replica serves a catalog; no catalog leaves these at zero
        self.model_swaps = labelled(
            "tpuserve_model_swaps",
            "Model hot-swaps executed at engine idle boundaries, by "
            "outcome= the source tier the incoming weights restored "
            "from: resident (HBM co-resident — no copy), host "
            "(pinned host restore), spill (spill-file restore), cold "
            "(full checkpoint load / init)", "counter", ("outcome",))
        self.model_swap_seconds = histogram(
            "tpuserve_model_swap_seconds",
            "Drain-boundary-to-serving wall time of each model hot-swap "
            "(weight restore + engine rebuild + graph capture)",
            _COLD_START_BUCKETS)
        self.weight_tier_bytes = labelled(
            "tpuserve_weight_tier_bytes",
            "Model/LoRA weight bytes resident per tier= hbm (the "
            "serving params plus co-resident sets), host (pinned host "
            "tier under TPUSERVE_WEIGHT_HOST_BYTES), spill (spill "
            "tier) — the weight twin of tpuserve_kv_tier_blocks",
            "gauge", ("tier",))
        self.models_resident = gauge(
            "tpuserve_models_resident",
            "Catalog models with weights live in HBM right now (the "
            "serving model + co-resident sets, <= max_resident) — the "
            "co-serving occupancy the gateway's catalog routing and "
            "the per-model scale-from-zero signal key on")

    def observe_finish(self, reason: str, duration_s: float) -> None:
        self.request_success.labels(model_name=self.model_name,
                                    finished_reason=reason).inc()
        self.request_duration.observe(duration_s)


class CanaryMetrics(_Registry):
    """The synthetic prober's own registry (``obs/canary.py``): black-box
    SLIs measured from outside the serving process, per SLO class."""

    def __init__(self):
        super().__init__()
        self.probes = self.family(
            "tpuserve_canary_probes",
            "Synthetic probe requests attempted per SLO class "
            "(slo_class= label) — black-box coverage; "
            "absent(tpuserve_canary_probes_total) in the generated "
            "rules catches a dead prober", "counter", ("slo_class",))
        self.failures = self.family(
            "tpuserve_canary_failures",
            "Probe requests that failed (non-200, malformed body, or "
            "timed out) per SLO class — the numerator of the "
            "black-box availability SLI", "counter", ("slo_class",))
        self.probe_latency = self.family(
            "tpuserve_canary_probe_latency_seconds",
            "End-to-end wall latency of successful probes per SLO "
            "class — the black-box twin of tpuserve_e2e_seconds, "
            "measured through the full gateway->server->engine path",
            "histogram", ("slo_class",), _SLI_E2E_BUCKETS)
        self.breached = self.family(
            "tpuserve_canary_breached",
            "1 while any SLO class has >= the configured consecutive "
            "probe failures (0 otherwise) — the scale-out/eject "
            "signal the autoscaler polls off /gateway/status", "gauge", ()).labels()
