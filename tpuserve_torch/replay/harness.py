"""Deterministic virtual-time replay of a workload against the real engine.

The port's own copy of ``tpuserve/replay/harness.py``.  Its engine is the
port's, built on ``ReplayOptions.device`` ("cuda" unless the caller asks
for "cpu", as the tests do); on the card pass the port's page size
(``block_size=32``) where the workload carries no engine facts.

This is a *replay*, not a simulation: the actual ``runtime/engine.py``
schedules, prefills, decodes, sheds, preempts and salvages — the only
substitutions are (a) a :class:`~tpuserve_torch.runtime.clock.VirtualClock`
behind the engine's clock seam, advanced by a modelled per-step cost
instead of the wall, and (b) deterministically synthesized prompt ids
(``Workload.prompt_ids``).  Because every time-derived policy input
(queue-delay EWMAs, brownout hold timers, admission deadlines,
adaptive-window holds, flight timelines) reads the virtual clock, a
ten-minute storm replays in seconds of wall time with *undistorted*
policy dynamics — and twice with the same seed it replays identically,
token for token (the tier-1 determinism pin, tests/test_replay.py).

Faulted steps are salvaged synchronously: the harness mirrors the
runner's crash-only policy (``Engine.salvage_requeue`` + a bounded
retry budget) without its threads, so fault-storm post-mortems replay
deterministically too.

Virtual-time caveats (also in README "Trace replay"):

- every engine cycle costs one fixed ``step_time_s`` (default: the
  source incident's mean step wall ms), so relative per-class latency
  shapes replay faithfully while absolute SLIs scale with how well
  that one number models the real per-cycle cost;
- everything stamped inside a cycle lands at the cycle's end time;
- idle gaps jump straight to the next arrival (that, plus CPU-runnable
  dispatches, is the >=10x wall speedup on sparse incidents).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import time
from typing import Optional

from tpuserve_torch.replay.workload import Workload
from tpuserve_torch.runtime.clock import VirtualClock
from tpuserve_torch.runtime.slo import ShedError

logger = logging.getLogger("tpuserve_torch.replay")

REPORT_SCHEMA_VERSION = 1

# loop backstops: a replay is a test input, and a bug (engine or
# workload) must terminate with a loud partial report, not hang CI
MAX_SALVAGE_ROUNDS = 200
MAX_STEPS_PER_REQUEST = 4096


@dataclasses.dataclass
class ReplayOptions:
    model: str = "tiny-qwen3"
    # virtual seconds one engine cycle costs; None = the source
    # incident's mean step ms (workload.meta) clamped to [1, 250] ms,
    # or 20 ms without one
    step_time_s: Optional[float] = None
    # engine sizing; None = source engine facts (workload.meta
    # ["source_engine"]) with caps, else CPU-friendly defaults
    max_num_seqs: Optional[int] = None
    num_blocks: Optional[int] = None
    block_size: Optional[int] = None
    # None = the source engine's fused-window size (bundle facts), so
    # window-batched ITL dynamics replay; 1 without facts
    multi_step: Optional[int] = None
    seed: Optional[int] = None          # overrides workload.seed
    slo_classes: bool = True
    include_token_streams: bool = True  # full streams in the report
    #                                     (auto-dropped past 256 requests)
    # write the replay engine's own flight bundle here after the run —
    # a replay is itself a recorded incident, so the loop closes:
    # bundle -> workload -> replay -> bundle (tests round-trip on this)
    dump_bundle_path: Optional[str] = None
    # optional SLO-evaluation observer (tpuserve_torch/obs/backtest.py): the
    # harness calls bind_clock(clock) once after the engine build, then
    # on_sli(cls, kind, value) per sample, on_outcome(cls, outcome) per
    # terminal state, and on_tick() after every engine cycle — enough
    # to run the burn-rate engine over the replay in virtual time
    observer: Optional[object] = None
    # the engine's device; it never falls back to the CPU on its own
    device: str = "cuda"
    # a weight tree already made for ``model`` on ``device`` (shared by
    # every engine built from these options); None = each engine draws
    # its own from the seed
    params: Optional[dict] = None


def _resolve_step_time(workload: Workload,
                       opts: ReplayOptions) -> float:
    if opts.step_time_s is not None:
        return max(1e-4, float(opts.step_time_s))
    mean_ms = workload.meta.get("mean_step_ms")
    if mean_ms:
        return min(max(float(mean_ms) / 1000.0, 0.001), 0.25)
    return 0.02


def build_replay_engine(workload: Workload, opts: ReplayOptions):
    """Build an engine on ``opts.device`` sized like the source incident's
    (seats/blocks from the bundle's engine facts when present), with the
    virtual clock installed through the clock seam.  Returns
    ``(engine, clock)``."""
    from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,
                                        SchedulerConfig)
    facts = workload.meta.get("source_engine") or {}
    seed = workload.seed if opts.seed is None else opts.seed
    block_size = opts.block_size or int(facts.get("block_size") or 4)
    max_num_seqs = opts.max_num_seqs or min(
        int(facts.get("max_num_seqs") or 8), 64)
    # longest sequence the workload can grow (prompt + generation),
    # bounded by the tiny model's position range at submit time
    longest = max((r.prompt_tokens + r.max_tokens
                   for r in workload.requests), default=64)
    blocks_per_seq = -(-longest // block_size) + 2
    num_blocks = opts.num_blocks or int(facts.get("num_blocks") or 0)
    if not num_blocks:
        # enough for the full decode batch plus prefix-cache headroom;
        # overload scarcity then comes from seats + arrival rate, which
        # is what the source engine facts preserve
        num_blocks = blocks_per_seq * max_num_seqs * 2
    engine = Engine(EngineConfig(
        model=opts.model,
        cache=CacheConfig(block_size=block_size, num_blocks=num_blocks,
                          max_blocks_per_seq=blocks_per_seq),
        scheduler=SchedulerConfig(
            max_num_seqs=max_num_seqs,
            min_prefill_bucket=8, min_decode_bucket=2,
            mixed_batching=bool(facts.get("mixed_batching", False))),
        multi_step=(opts.multi_step
                    or int(facts.get("multi_step") or 1)),
        slo_classes=opts.slo_classes,
        flight=True,
        faults=workload.faults or "",
        seed=seed,
        clock=(clock := VirtualClock())),
        params=opts.params, device=opts.device)
    return engine, clock


def replay(workload: Workload,
           opts: Optional[ReplayOptions] = None) -> dict:
    """Replay ``workload`` deterministically and return the structured
    replay report (SLI families, terminal-state accounting, determinism
    digests, speedup)."""
    opts = opts or ReplayOptions()
    step_time_s = _resolve_step_time(workload, opts)
    wall0 = time.perf_counter()
    engine, clock = build_replay_engine(workload, opts)
    observer = opts.observer
    if observer is not None:
        observer.bind_clock(clock)
    vocab = engine.model_cfg.vocab_size
    max_len = engine.max_seq_len
    from tpuserve_torch.runtime.request import SamplingParams

    pending = sorted(workload.requests,
                     key=lambda r: (r.arrival_s, r.request_id))
    outcomes: dict = {}
    tokens: dict = {}
    arrival: dict = {}
    first_emit: dict = {}
    last_emit: dict = {}
    sli: dict = {}                  # (slo_class, kind) -> [samples]
    cls_of: dict = {}
    clamped = 0
    salvage_rounds = 0
    max_brownout = 0

    def observe(cls: str, kind: str, value: float) -> None:
        sli.setdefault((cls, kind), []).append(value)
        engine.flight.note_sli(cls, kind, value)
        if observer is not None:
            observer.on_sli(cls, kind, value)

    def note_outcome(rid: str, outcome: str) -> None:
        outcomes[rid] = outcome
        if observer is not None:
            observer.on_outcome(cls_of.get(rid, "standard"), outcome)

    def submit(r) -> None:
        ids = workload.prompt_ids(r, vocab)
        max_tokens = max(1, min(r.max_tokens, max_len - 2))
        if len(ids) + max_tokens >= max_len:
            nonlocal clamped
            clamped += 1
            ids = ids[-(max_len - max_tokens - 1):]
        params = SamplingParams(
            max_tokens=max_tokens,
            temperature=r.temperature,
            top_p=r.top_p,
            ignore_eos=r.ignore_eos,
            seed=r.seed if r.seed is not None else 0,
            slo_class=r.slo_class)
        cls_of[r.request_id] = r.slo_class
        arrival[r.request_id] = r.arrival_s
        try:
            engine.add_request(prompt_token_ids=ids, params=params,
                               request_id=r.request_id)
        except ShedError:
            note_outcome(r.request_id, "shed")
        except MemoryError:
            note_outcome(r.request_id, "rejected")
        except Exception as e:          # noqa: BLE001 — report, don't die
            logger.warning("replay submit of %s failed: %s",
                           r.request_id, e)
            note_outcome(r.request_id, "error")

    def drain_engine_errors() -> None:
        for rid, exc in engine.drain_request_errors():
            note_outcome(rid, "shed" if isinstance(exc, ShedError)
                         else "deadline_aborted"
                         if isinstance(exc, TimeoutError) else "error")

    def route(outs) -> None:
        now = clock.monotonic()
        for o in outs:
            rid = o.request_id
            if o.new_token_ids:
                tokens.setdefault(rid, []).extend(o.new_token_ids)
            cls = cls_of.get(rid, "standard")
            if o.new_token_ids:
                if rid not in first_emit:
                    first_emit[rid] = now
                    observe(cls, "ttft", now - arrival.get(rid, 0.0))
                elif o.from_prefill and o.num_output_tokens > 1:
                    pass            # re-prefill replay: queue+recompute,
                    #                 not inter-token latency (runner rule)
                elif rid in last_emit:
                    observe(cls, "itl", now - last_emit[rid])
                last_emit[rid] = now
            if o.finished:
                cause = (o.finish_reason.value if o.finish_reason
                         else "stop")
                note_outcome(rid, cause)
                observe(cls, "e2e", now - arrival.get(rid, 0.0))
                engine.requests.pop(rid, None)
                last_emit.pop(rid, None)

    max_steps = MAX_STEPS_PER_REQUEST * max(1, len(pending))
    steps = aborted = 0
    while pending or engine.has_work():
        if not engine.has_work() and pending:
            clock.advance_to(pending[0].arrival_s)
        while pending and pending[0].arrival_s <= clock.monotonic():
            submit(pending.pop(0))
        if not engine.has_work():
            continue
        # the cycle about to run completes step_time_s of virtual time
        # from now; everything it stamps lands at its end time
        clock.advance(step_time_s)
        steps += 1
        try:
            route(engine.step())
        except Exception as e:          # noqa: BLE001 — chaos schedule
            salvage_rounds += 1
            salvage = getattr(engine, "salvage_requeue", None)
            if salvage is None or salvage_rounds > MAX_SALVAGE_ROUNDS:
                logger.warning("replay abandoning after %d salvage "
                               "rounds: %s", salvage_rounds, e)
                aborted = 1
                break
            salvage()
        drain_engine_errors()
        if observer is not None:
            # alert evaluation lands at cycle ends, like everything else
            # stamped under virtual time
            observer.on_tick()
        if engine.stats.brownout_level > max_brownout:
            max_brownout = engine.stats.brownout_level
        if steps > max_steps:
            logger.warning("replay exceeded %d steps — aborting with a "
                           "partial report", max_steps)
            aborted = 1
            break
    # a queue-full class eviction during the very last submission can
    # land in the outbox after the final step already drained it
    drain_engine_errors()
    if aborted:
        for rid in [r.request_id for r in pending] + list(
                getattr(engine, "requests", {})):
            outcomes.setdefault(rid, "replay_aborted")

    wall_s = time.perf_counter() - wall0
    virtual_s = clock.monotonic()
    from tpuserve_torch.replay.report import sli_summary
    sli_sum = sli_summary(sli)
    counters = {
        "completed": sum(1 for v in outcomes.values()
                         if v in ("stop", "length")),
        "shed": sum(1 for v in outcomes.values() if v == "shed"),
        "rejected": sum(1 for v in outcomes.values() if v == "rejected"),
        "deadline_aborted": sum(1 for v in outcomes.values()
                                if v == "deadline_aborted"),
        "aborted": sum(1 for v in outcomes.values() if v == "abort"),
        "errors": sum(1 for v in outcomes.values()
                      if v in ("error", "replay_aborted")),
        "salvage_rounds": salvage_rounds,
        "requests_salvaged": engine.stats.requests_salvaged,
        "preemptions": engine.stats.preemptions,
        "slo_preemptions": engine.stats.slo_preemptions,
        "requests_shed_engine": engine.stats.requests_shed,
        "max_brownout_level": max_brownout,
        "engine_steps": steps,
        "prompts_clamped": clamped,
    }
    stream_digest = hashlib.sha256(json.dumps(
        [(rid, tokens.get(rid, []), outcomes.get(rid))
         for rid in sorted(set(outcomes) | set(tokens))],
        sort_keys=True).encode()).hexdigest()
    sli_digest = hashlib.sha256(json.dumps(
        sli_sum, sort_keys=True).encode()).hexdigest()
    report = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "workload": workload.summary(),
        "engine": dict(engine.flight._facts),
        "step_time_s": step_time_s,
        "virtual_s": round(virtual_s, 6),
        "wall_s": round(wall_s, 3),
        # incident-seconds replayed per wall-second: the ">=10x faster
        # than wall" acceptance number for sparse/long incidents
        "speedup": round(virtual_s / wall_s, 2) if wall_s else 0.0,
        "aborted": bool(aborted),
        "sli": sli_sum,
        "counters": counters,
        "outcomes": outcomes,
        "token_digest": stream_digest,
        "sli_digest": sli_digest,
    }
    if opts.include_token_streams and len(outcomes) <= 256:
        report["token_streams"] = {rid: tokens.get(rid, [])
                                   for rid in sorted(outcomes)}
    if opts.dump_bundle_path:
        with open(opts.dump_bundle_path, "w", encoding="utf-8") as f:
            json.dump(engine.flight.dump_bundle("replay_capture"), f,
                      indent=1, sort_keys=True)
    return report
