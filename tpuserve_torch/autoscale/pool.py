"""Simulated replica pool: the autoscaler's proving ground.

The port's own copy of ``tpuserve/autoscale/pool.py``.  Its replicas are
the port's engines on ``PoolReplayOptions.device`` ("cuda" unless the caller
asks for "cpu", as the tests do).

``pool_replay`` is the pool-level twin of ``tpuserve_torch/replay/harness``:
N *real* engines (one per simulated replica) run a recorded workload
under ONE shared :class:`~tpuserve_torch.runtime.clock.VirtualClock`, with a
least-loaded router in front (the gateway's job) and, optionally, an
:class:`~tpuserve_torch.autoscale.policy.AutoscalePolicy` ticked at a fixed
control cadence driving the replica count — scale-out boots a fresh
engine after a modelled ``cold_start_s`` (the compile-cache + orbax +
KV-spill-warm boot the manifests make cheap), scale-in drains a replica
to empty before retiring it, and scale-from-zero is just an empty
initial pool plus pending demand.

Because every engine, the policy, and the router read the same virtual
clock, a recorded brownout storm replays in seconds with undistorted
policy dynamics, and the SAME storm + the SAME policy config produce
the SAME decision sequence (``decision_digest`` — the tier-1 pin).
That turns policy tuning into a replay-diff loop: replay the storm,
change one knob, diff the per-class SLIs and the decision timeline.  No Kubernetes anywhere; tier-1 drives the
whole control plane on CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import time
from typing import Optional

from tpuserve_torch.autoscale.policy import (AutoscalePolicy, Decision,
                                             PolicyConfig, PoolSignals,
                                             ReplicaSignals, decisions_digest)
from tpuserve_torch.replay.workload import Workload, WorkloadRequest
from tpuserve_torch.runtime.clock import VirtualClock
from tpuserve_torch.runtime.slo import ShedError

logger = logging.getLogger("tpuserve_torch.autoscale")

# loop backstops, same contract as the single-engine harness: a bug
# must end with a loud partial report, not hang CI
MAX_SALVAGE_ROUNDS = 200
MAX_STEPS_PER_REQUEST = 4096
MAX_EVENTS = 1024


@dataclasses.dataclass
class PoolReplayOptions:
    model: str = "tiny-qwen3"
    # virtual seconds one engine cycle costs (every busy replica steps
    # once per pool cycle — replicas are genuinely parallel hardware)
    step_time_s: float = 0.02
    # autoscaler control-loop cadence (virtual seconds)
    control_interval_s: float = 0.25
    # modelled boot -> ready time for a replica started mid-replay (the
    # compile-cache / orbax / spill-rescan boot; measured for real by
    # tpuserve_cold_start_seconds in production)
    cold_start_s: float = 1.0
    initial_replicas: int = 1
    # per-replica engine sizing (small seats => realistic scarcity)
    max_num_seqs: int = 4
    block_size: int = 4
    num_blocks: int = 0                # 0 = auto from the workload
    multi_step: int = 1
    max_waiting: int = 8               # per-replica admission cap
    seed: Optional[int] = None         # overrides workload.seed
    slo_classes: bool = True
    # tiered KV options forwarded to every replica engine; a shared
    # kv_spill_dir is how a from-zero replica boots with a WARM prefix
    # cache (the spill tier rescans the dir at engine construction)
    kv_spill_dir: Optional[str] = None
    kv_host_bytes: int = 0
    # keep ticking the (idle) control loop this long after the last
    # request finishes, so scale-in-when-drained is observable
    trailing_idle_s: float = 0.0
    include_token_streams: bool = False
    # every replica's device; it never falls back to the CPU on its own
    device: str = "cuda"
    # a weight tree already made for ``model`` on ``device``, shared by
    # every replica; None = each replica draws its own from the seed
    params: Optional[dict] = None


class _Replica:
    """One simulated replica: a real engine plus boot/drain state."""

    def __init__(self, name: str, engine, created_t: float,
                 ready_t: float):
        self.name = name
        self.engine = engine
        self.created_t = created_t
        self.ready_t = ready_t
        self.draining = False
        self.first_token_t: Optional[float] = None
        self.salvage_rounds = 0
        self.prev_level = 0

    def ready(self, now: float) -> bool:
        return now >= self.ready_t and not self.draining

    @property
    def load(self) -> int:
        s = self.engine.scheduler
        return s.num_waiting + len(s.running)

    def signals(self, now: float) -> ReplicaSignals:
        slo = self.engine._slo
        snap = slo.snapshot() if slo is not None else {}
        s = self.engine.scheduler
        return ReplicaSignals(
            name=self.name,
            ready=now >= self.ready_t,
            draining=self.draining,
            brownout_level=int(snap.get("brownout_level", 0)),
            queue_delay_ewma={
                cls: v for cls, v in
                (snap.get("queue_delay_ewma") or {}).items()
                if v is not None},
            waiting=s.num_waiting,
            running=len(s.running),
            sli=self.engine.flight.sli_summary(),
            cold_start_s=(self.first_token_t - self.created_t
                          if self.first_token_t is not None else None),
        )


def _build_pool_engine(workload: Workload, opts: PoolReplayOptions,
                       clock: VirtualClock):
    from tpuserve_torch.runtime import (CacheConfig, Engine, EngineConfig,
                                        SchedulerConfig)
    seed = workload.seed if opts.seed is None else opts.seed
    longest = max((r.prompt_tokens + r.max_tokens
                   for r in workload.requests), default=64)
    blocks_per_seq = -(-longest // opts.block_size) + 2
    num_blocks = opts.num_blocks \
        or blocks_per_seq * opts.max_num_seqs * 2
    tiers = True if (opts.kv_spill_dir or opts.kv_host_bytes) else None
    return Engine(EngineConfig(
        model=opts.model,
        cache=CacheConfig(block_size=opts.block_size,
                          num_blocks=num_blocks,
                          max_blocks_per_seq=blocks_per_seq),
        scheduler=SchedulerConfig(
            max_num_seqs=opts.max_num_seqs,
            min_prefill_bucket=8, min_decode_bucket=2,
            max_waiting=opts.max_waiting),
        multi_step=opts.multi_step,
        slo_classes=opts.slo_classes,
        enable_prefix_caching=True,
        kv_tiers=tiers,
        kv_host_bytes=opts.kv_host_bytes,
        kv_spill_dir=opts.kv_spill_dir,
        flight=True,
        seed=seed,
        clock=clock), params=opts.params, device=opts.device)


def make_storm_workload(n: int = 60, ramp_s: float = 8.0,
                        span_s: float = 30.0, prompt_tokens: int = 12,
                        max_tokens: int = 6, seed: int = 12,
                        prefix_group: Optional[str] = None,
                        prefix_tokens: int = 8) -> Workload:
    """A synthetic brownout storm: a trickle that ramps into a sustained
    burst well past one small replica's seats, interactive/standard/
    batch mixed 2:1:1 — the overload shape the brownout ladder (and so
    the scale-out trigger) reacts to.  Deterministic from the args."""
    reqs = []
    classes = ("interactive", "standard", "interactive", "batch")
    for i in range(n):
        # first quarter spread over the ramp, the rest packed into the
        # remaining span (sustained overload, not one spike)
        if i < n // 4:
            at = ramp_s * i / max(1, n // 4)
        else:
            at = ramp_s + (span_s - ramp_s) * (i - n // 4) \
                / max(1, n - n // 4)
        reqs.append(WorkloadRequest(
            request_id=f"storm-{i:03d}", arrival_s=round(at, 3),
            prompt_tokens=prompt_tokens, max_tokens=max_tokens,
            slo_class=classes[i % len(classes)], seed=i,
            prefix_group=prefix_group if prefix_group and i % 2 else None,
            prefix_tokens=prefix_tokens if prefix_group and i % 2 else 0))
    return Workload(requests=reqs, seed=seed,
                    meta={"source": "autoscale-storm"})


def pool_replay(workload: Workload,
                opts: Optional[PoolReplayOptions] = None,
                policy_cfg: Optional[PolicyConfig] = None,
                metrics=None) -> dict:
    """Replay ``workload`` against a simulated replica pool and return
    the pool report.  ``policy_cfg=None`` pins the topology static at
    ``opts.initial_replicas`` (the A/B baseline); otherwise a fresh
    :class:`AutoscalePolicy` on the pool's virtual clock drives the
    replica count.  ``metrics``: an optional
    ``server.metrics.AutoscalerMetrics`` to feed (decisions counter,
    replica gauge, cold-start histogram) exactly as the production
    reconciler would."""
    opts = opts or PoolReplayOptions()
    wall0 = time.perf_counter()
    clock = VirtualClock()
    policy = (AutoscalePolicy(policy_cfg, clock=clock)
              if policy_cfg is not None else None)

    replicas: list[_Replica] = []
    retired: list[_Replica] = []
    serial = 0
    events: list = []
    vocab = [0]          # resolved at first engine build
    max_len = [1 << 30]

    def note(kind: str, **detail) -> None:
        if len(events) < MAX_EVENTS:
            events.append({"t": round(clock.monotonic(), 6),
                           "event": kind, **detail})

    def spawn(k: int, cold: bool) -> None:
        nonlocal serial
        for _ in range(max(0, k)):
            now = clock.monotonic()
            eng = _build_pool_engine(workload, opts, clock)
            vocab[0] = eng.model_cfg.vocab_size
            max_len[0] = eng.max_seq_len
            r = _Replica(f"replica-{serial}", eng, now,
                         now + (opts.cold_start_s if cold else 0.0))
            serial += 1
            replicas.append(r)
            note("replica_start", replica=r.name, cold=cold,
                 ready_t=round(r.ready_t, 6))

    spawn(opts.initial_replicas, cold=False)

    pending = sorted(workload.requests,
                     key=lambda r: (r.arrival_s, r.request_id))
    pool_queue: list[WorkloadRequest] = []
    outcomes: dict = {}
    tokens: dict = {}
    arrival: dict = {}
    first_emit: dict = {}
    last_emit: dict = {}
    served_by: dict = {}
    cls_of: dict = {}
    sli: dict = {}
    first_shed_t: Optional[float] = None
    first_l3_t: Optional[float] = None
    next_control = 0.0

    def observe(replica: _Replica, cls: str, kind: str,
                value: float) -> None:
        sli.setdefault((cls, kind), []).append(value)
        replica.engine.flight.note_sli(cls, kind, value)

    from tpuserve_torch.runtime.request import SamplingParams

    def submit(replica: _Replica, r: WorkloadRequest) -> bool:
        """True when admitted (or terminally shed/rejected); False =
        leave it pool-queued."""
        nonlocal first_shed_t
        ids = workload.prompt_ids(r, vocab[0])
        max_tokens = max(1, min(r.max_tokens, max_len[0] - 2))
        if len(ids) + max_tokens >= max_len[0]:
            ids = ids[-(max_len[0] - max_tokens - 1):]
        params = SamplingParams(
            max_tokens=max_tokens, temperature=r.temperature,
            top_p=r.top_p, ignore_eos=r.ignore_eos,
            seed=r.seed if r.seed is not None else 0,
            slo_class=r.slo_class)
        try:
            replica.engine.add_request(prompt_token_ids=ids,
                                       params=params,
                                       request_id=r.request_id)
        except ShedError:
            outcomes[r.request_id] = "shed"
            if first_shed_t is None:
                first_shed_t = clock.monotonic()
            note("shed", request=r.request_id, replica=replica.name,
                 slo_class=r.slo_class)
            return True
        except MemoryError:
            return False               # replica full: stays pool-queued
        except Exception as e:         # noqa: BLE001 — report, don't die
            logger.warning("pool submit of %s failed: %s",
                           r.request_id, e)
            outcomes[r.request_id] = "error"
            return True
        cls_of[r.request_id] = r.slo_class
        arrival[r.request_id] = r.arrival_s
        served_by[r.request_id] = replica.name
        return True

    def route_queue() -> None:
        now = clock.monotonic()
        still: list[WorkloadRequest] = []
        for r in pool_queue:
            cands = [rep for rep in replicas if rep.ready(now)
                     and rep.engine.scheduler.num_waiting
                     < opts.max_waiting]
            if not cands:
                still.append(r)
                continue
            target = min(cands, key=lambda rep: (rep.load, rep.name))
            if not submit(target, r):
                still.append(r)
        pool_queue[:] = still

    def route_outputs(replica: _Replica, outs) -> None:
        now = clock.monotonic()
        for o in outs:
            rid = o.request_id
            if o.new_token_ids:
                tokens.setdefault(rid, []).extend(o.new_token_ids)
                if replica.first_token_t is None:
                    replica.first_token_t = now
                    note("first_token", replica=replica.name,
                         cold_start_s=round(now - replica.created_t, 6))
                cls = cls_of.get(rid, "standard")
                if rid not in first_emit:
                    first_emit[rid] = now
                    observe(replica, cls, "ttft",
                            now - arrival.get(rid, 0.0))
                elif o.from_prefill and o.num_output_tokens > 1:
                    pass        # re-prefill replay gap, not ITL
                elif rid in last_emit:
                    observe(replica, cls, "itl", now - last_emit[rid])
                last_emit[rid] = now
            if o.finished:
                cause = (o.finish_reason.value if o.finish_reason
                         else "stop")
                outcomes[rid] = cause
                observe(replica, cls_of.get(rid, "standard"), "e2e",
                        now - arrival.get(rid, 0.0))
                replica.engine.requests.pop(rid, None)
                last_emit.pop(rid, None)

    def drain_errors(replica: _Replica) -> None:
        nonlocal first_shed_t
        for rid, exc in replica.engine.drain_request_errors():
            if isinstance(exc, ShedError):
                outcomes[rid] = "shed"
                if first_shed_t is None:
                    first_shed_t = clock.monotonic()
            elif isinstance(exc, TimeoutError):
                outcomes[rid] = "deadline_aborted"
            else:
                outcomes[rid] = "error"

    def pool_signals(now: float) -> PoolSignals:
        # booting replicas are counted, not listed — matching KubePool,
        # where a not-yet-ready pod can't be scraped (PoolSignals.live
        # sums the two, so listing them too would double-count)
        return PoolSignals(
            t=now,
            replicas=[r.signals(now) for r in replicas
                      if now >= r.ready_t],
            booting=sum(1 for r in replicas
                        if now < r.ready_t and not r.draining),
            pending_demand=len(pool_queue))

    def control_tick(now: float) -> None:
        nonlocal first_l3_t
        d: Decision = policy.decide(pool_signals(now))
        if metrics is not None and d.action != "hold":
            metrics.decisions.labels(action=d.action).inc()
        if d.action == "scale_out":
            spawn(d.target - d.current, cold=True)
            note("scale_out", target=d.target, reason=d.reason)
        elif d.action == "scale_in":
            # retire the least-loaded ready replica through the drain
            # path: no new routes, finishes in-flight, removed at empty
            cands = [r for r in replicas if r.ready(now)]
            if cands:
                victim = min(cands, key=lambda r: (r.load, r.name))
                victim.draining = True
                note("scale_in", replica=victim.name, reason=d.reason)
        if metrics is not None:
            metrics.replicas.labels(pool="simpool").set(
                len([r for r in replicas if not r.draining]))

    def reap_drained() -> None:
        for r in replicas[:]:
            if r.draining and not r.engine.has_work():
                replicas.remove(r)
                retired.append(r)
                note("replica_drained", replica=r.name)

    max_steps = MAX_STEPS_PER_REQUEST * max(1, len(pending))
    steps = aborted = 0
    while pending or pool_queue \
            or any(r.engine.has_work() for r in replicas):
        now = clock.monotonic()
        while pending and pending[0].arrival_s <= now:
            pool_queue.append(pending.pop(0))
        if policy is not None and now >= next_control - 1e-9:
            control_tick(now)
            next_control = now + opts.control_interval_s
        reap_drained()
        route_queue()
        busy = [r for r in replicas
                if now >= r.ready_t and r.engine.has_work()]
        if not busy:
            nxt = [t for t in (
                pending[0].arrival_s if pending else None,
                min((r.ready_t for r in replicas if now < r.ready_t),
                    default=None),
                next_control if policy is not None
                and (pending or pool_queue
                     or any(now < r.ready_t for r in replicas))
                else None) if t is not None]
            if not nxt:
                break                  # demand but no capacity possible
            clock.advance_to(min(nxt))
            continue
        # the cycle about to run completes step_time_s of virtual time;
        # every busy replica runs it in parallel
        clock.advance(opts.step_time_s)
        steps += 1
        for r in busy:
            try:
                route_outputs(r, r.engine.step())
            except Exception as e:     # noqa: BLE001 — chaos schedule
                r.salvage_rounds += 1
                salvage = getattr(r.engine, "salvage_requeue", None)
                if salvage is None \
                        or r.salvage_rounds > MAX_SALVAGE_ROUNDS:
                    logger.warning("pool replica %s abandoned after %d "
                                   "salvage rounds: %s", r.name,
                                   r.salvage_rounds, e)
                    aborted = 1
                    break
                salvage()
            drain_errors(r)
            lvl = r.engine.stats.brownout_level
            if lvl >= 3 and r.prev_level < 3 and first_l3_t is None:
                first_l3_t = clock.monotonic()
                note("brownout_l3", replica=r.name, level=lvl)
            r.prev_level = lvl
        if aborted or steps > max_steps:
            if steps > max_steps:
                logger.warning("pool replay exceeded %d steps — "
                               "aborting with a partial report",
                               max_steps)
            aborted = 1
            break
    for r in replicas:
        drain_errors(r)
    if aborted:
        for rid in ([r.request_id for r in pending]
                    + [r.request_id for r in pool_queue]):
            outcomes.setdefault(rid, "replay_aborted")
        for rep in replicas:
            for rid in list(getattr(rep.engine, "requests", {})):
                outcomes.setdefault(rid, "replay_aborted")
    else:
        for r in pool_queue:
            outcomes.setdefault(r.request_id, "unserved")

    # trailing idle window: let the (virtual) control loop observe the
    # drained pool so scale-in decisions land in the report
    if policy is not None and opts.trailing_idle_s > 0:
        end = clock.monotonic() + opts.trailing_idle_s
        while clock.monotonic() < end - 1e-9:
            clock.advance_to(min(max(next_control,
                                     clock.monotonic()), end))
            now = clock.monotonic()
            if now >= next_control - 1e-9:
                control_tick(now)
                next_control = now + opts.control_interval_s
            reap_drained()
            if next_control > end:
                clock.advance_to(end)

    cold_starts = sorted(
        round(r.first_token_t - r.created_t, 6)
        for r in replicas + retired
        if r.first_token_t is not None and r.ready_t > r.created_t)
    if metrics is not None:
        for v in cold_starts:
            metrics.cold_start.observe(v)
    decisions = [dataclasses.asdict(d) for d in policy.decisions] \
        if policy is not None else []
    first_out = next((d for d in (policy.decisions if policy else [])
                      if d.action == "scale_out"), None)
    from tpuserve_torch.replay.report import sli_summary
    sli_sum = sli_summary(sli)
    wall_s = time.perf_counter() - wall0
    virtual_s = clock.monotonic()
    token_digest = hashlib.sha256(json.dumps(
        [(rid, tokens.get(rid, []), outcomes.get(rid))
         for rid in sorted(set(outcomes) | set(tokens))],
        sort_keys=True).encode()).hexdigest()
    report = {
        "mode": "autoscaled" if policy is not None else "static",
        "workload": workload.summary(),
        "replicas_initial": opts.initial_replicas,
        "replicas_peak": serial,
        "replicas_final": len(replicas),
        "replicas_retired": len(retired),
        "cold_start_s": opts.cold_start_s,
        "cold_starts_observed_s": cold_starts,
        "decisions": decisions,
        "decision_digest": decisions_digest(
            policy.decisions) if policy is not None else None,
        "first_scale_out_t": (round(first_out.t, 6)
                              if first_out is not None else None),
        "first_shed_t": (round(first_shed_t, 6)
                         if first_shed_t is not None else None),
        "first_l3_t": (round(first_l3_t, 6)
                       if first_l3_t is not None else None),
        "events": events,
        "sli": sli_sum,
        "counters": {
            "completed": sum(1 for v in outcomes.values()
                             if v in ("stop", "length")),
            "shed": sum(1 for v in outcomes.values() if v == "shed"),
            "unserved": sum(1 for v in outcomes.values()
                            if v == "unserved"),
            "errors": sum(1 for v in outcomes.values()
                          if v in ("error", "replay_aborted")),
            "kv_restored_blocks": sum(
                r.engine.stats.kv_restored_blocks
                for r in replicas + retired),
            "pool_steps": steps,
        },
        "outcomes": outcomes,
        "token_digest": token_digest,
        "aborted": bool(aborted),
        "virtual_s": round(virtual_s, 6),
        "wall_s": round(wall_s, 3),
        "speedup": round(virtual_s / wall_s, 2) if wall_s else 0.0,
    }
    if opts.include_token_streams and len(outcomes) <= 256:
        report["token_streams"] = {rid: tokens.get(rid, [])
                                   for rid in sorted(outcomes)}
    return report
