"""Continuous-batching scheduler.

Each engine step is either a PREFILL batch (admit waiting requests, bounded
by a token budget) or a DECODE step over everything running — the classic
continuous-batching loop that, in the reference, lives inside the deployed
vLLM container (reference: SURVEY.md §2.2; the repo itself has no scheduler).
Prefill lengths and decode batch sizes are bucketed to powers of two so XLA
compiles a small, reusable set of executables (static shapes — see
SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from tpuserve_torch.runtime.block_manager import BlockManager
from tpuserve_torch.runtime.clock import MONOTONIC
from tpuserve_torch.runtime.request import Request, RequestState
from tpuserve_torch.runtime.slo import BATCH, class_rank
from tpuserve_torch.utils import env_flag, next_power_of_2


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_num_seqs: int = 64              # decode batch capacity
    max_prefill_tokens: int = 8192      # per-step prefill token budget
    max_prefill_seqs: int = 8
    min_prefill_bucket: int = 32        # smallest padded prompt length
    min_decode_bucket: int = 4          # smallest padded decode batch
    # Prompts longer than this run as a sequence of fixed-size chunks
    # against the cache (ONE compiled shape instead of a giant per-length
    # bucket; bounds prefill activation memory for long contexts).
    prefill_chunk_size: int = 2048
    # The pipeline engine (parallel/pipeline.py) has no chunked-prefill
    # trunk; with this off, EVERY prefill takes the batched route — long
    # prompts get their own single-sequence batch at a big bucket instead
    # of chunking, and prefix-cache hits never chunk by choice.  All three
    # chunk routes check this flag, so "off" is a guarantee, not a default.
    allow_chunked_prefill: bool = True
    # Admission backpressure: new requests beyond this many waiting are
    # rejected (MemoryError -> HTTP 503) instead of growing host-side
    # queue state without bound under a flood.  0 = auto (4x
    # max_num_seqs); negative disables the cap.  Preemption re-entries
    # bypass it — running work must never be dropped for queue pressure.
    max_waiting: int = 0

    def resolve_max_waiting(self) -> int:
        if self.max_waiting < 0:
            return 1 << 30
        return self.max_waiting or 4 * self.max_num_seqs
    # SUPERSEDED by mixed_batching (kept as a compat shim for configs
    # that set it): run one decode step after every BATCHED prefill, so
    # running streams get at most one admission batch between tokens.
    # Mixed batching subsumes this — decode rows ride EVERY step — and
    # bounds ITL tighter; prefer it for latency-sensitive serving.
    interleave_batched_prefill: bool = False
    # Mixed ragged batching ("Ragged Paged Attention", PAPERS.md; Sarathi
    # token-budget fill): each step with admissible prefill work is ONE
    # flat-token batch — every running decode row first, then
    # prefill-chunk tokens up to mixed_token_budget — served by the
    # ragged trunk (models/transformer.forward_ragged) in one dispatch.
    # No phase split: in-flight streams get a token every scheduling
    # cycle even mid-admission-burst, and bucketing collapses to the one
    # flat-token dimension.  Cycles with no admissible prefill stay on
    # the decode path (fused multi-step windows, speculation).
    mixed_batching: bool = False
    # flat-token budget per mixed step; decode rows charge 1 token each,
    # prefill chunks fill the remainder (Sarathi-style chunk sizing)
    mixed_token_budget: int = 512


@dataclasses.dataclass
class ScheduledBatch:
    kind: str            # "prefill" | "prefill_chunk" | "decode" | "mixed"
    requests: list[Request]
    # prefill only: padded token length all prompts in the batch share
    # (for prefill_chunk: the fixed chunk size)
    padded_len: int = 0
    # decode only: padded batch size
    padded_batch: int = 0
    # mixed only: (request, token budget this step) prefill rows — the
    # flat batch is ``requests`` (decode rows, one token each) plus these
    # chunks; the engine owns the flat-bucket/alignment padding and
    # recounts actual tokens itself (chunks can shrink at run time via
    # the prefix-cache skip)
    prefill_chunks: list = dataclasses.field(default_factory=list)


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, block_manager: BlockManager,
                 max_model_len: int, ragged_align: int = 1):
        self.cfg = cfg
        self.block_manager = block_manager
        self.max_model_len = max_model_len
        # Batched admission (one block_manager.admit_prefill call per
        # cycle — native when the C++ manager is loaded) vs the
        # historical inline per-candidate loop: TPUSERVE_HOST_BATCHED=0
        # keeps the pre-batching path so the host-overhead A/B
        # (bench.py --clients-sweep, BENCHMARKS.md) measures what it
        # claims on every phase, admission included.
        self._batched_admission = env_flag("TPUSERVE_HOST_BATCHED")
        # Mixed mode: the engine pads the decode region and every prefill
        # chunk to this flat-row block (the ragged kernel's grid
        # granularity) — the token budget must charge those PADDED rows,
        # or a burst of tiny prompts would blow the flat bucket far past
        # the warmed ladder (one XLA compile stall per novel bucket).
        self.ragged_align = max(1, ragged_align)
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        # Fault-salvage bisection (server/runner.py): when set, only these
        # request ids may be ADMITTED from the waiting queue — suspect
        # groups are probed in isolation to find a poison request.  Running
        # requests are unaffected; None lifts the restriction.
        self.admission_filter: Optional[set[str]] = None
        # SLO controller (runtime/slo.py), set by the engine when class
        # scheduling is enabled.  None = classless FIFO: every policy
        # below degrades byte-identically to the pre-SLO behaviour
        # (TPUSERVE_SLO_CLASSES=0, the same-commit A/B lever).
        self.slo = None
        # Flight recorder (runtime/flight.py), set by the engine when
        # enabled: admissions and preemptions are recorded HERE — the
        # one place each decision is made — so every admission path
        # (batched / chunked / mixed) and both preemption kinds emit
        # identically.  None = no recording.
        self.flight = None
        # Injectable time source (runtime/clock.py): the engine overwrites
        # this with ITS clock so queue-delay measurement replays in
        # virtual time; a standalone scheduler (unit tests) gets the real
        # clock.
        self.clock = MONOTONIC
        # Set after scheduling a chunked-prefill step: the next cycle runs a
        # decode step first (if anything is running) so in-flight streams get
        # a token between chunks — without this, a 32k prompt at the 2048
        # chunk size stalls every running decode for ~16 consecutive steps
        # (vLLM bounds ITL the same way by mixing decode into chunk batches).
        self._interleave_decode = False

    # ---- intake ---------------------------------------------------------

    def _rank(self, req: Request) -> int:
        """SLO class rank for queue ordering; 0 for everyone when class
        scheduling is off, so the legacy priority-only order is exact."""
        return class_rank(req.params.slo_class) if self.slo is not None else 0

    def _key(self, req: Request) -> tuple:
        return (self._rank(req), req.params.priority)

    def add(self, req: Request) -> None:
        """Queue for admission.  Ordered by (SLO class rank, priority) —
        both LOWER = admitted sooner — FIFO within a level (vLLM priority
        semantics; class rank is 0 for everyone when SLO scheduling is
        off).  Preempted requests re-enter at the queue head regardless
        (appendleft / reinsert_preempted at the call sites, which also
        bypass the backpressure cap) — resuming holds its own priority:
        their KV was already paid for once."""
        if len(self.waiting) >= self.cfg.resolve_max_waiting():
            raise MemoryError(
                f"waiting queue full ({len(self.waiting)} requests); "
                "retry later or add replicas (backpressure — the engine "
                "bounds host-side queue state)")
        key = self._key(req)
        if not self.waiting or self._key(self.waiting[-1]) <= key:
            self.waiting.append(req)         # common case: same level
            return
        idx = len(self.waiting)
        while idx > 0 and self._key(self.waiting[idx - 1]) > key:
            prev = self.waiting[idx - 1]
            if prev.output_token_ids and self._rank(prev) <= key[0]:
                # a preempted mid-stream request is a barrier: new
                # arrivals of its own or a looser class never insert
                # ahead of it — otherwise a sustained same-priority
                # stream starves its half-delivered response forever.
                # A strictly STRICTER class may jump it: that is the
                # SLO contract, and the victim's preemption budget (not
                # queue position) bounds its total regression.
                break
            idx -= 1
        self.waiting.insert(idx, req)

    def reinsert_preempted(self, req: Request) -> None:
        """Re-queue a CLASS-preemption victim: ahead of every waiting
        request of its own class (its KV was paid for once and it may
        hold half-delivered output) but behind all stricter classes —
        unlike the decode-OOM ``appendleft``, which must go absolutely
        first so its freed blocks can drain."""
        rank = self._rank(req)
        idx = 0
        while idx < len(self.waiting) and self._rank(self.waiting[idx]) < rank:
            idx += 1
        self.waiting.insert(idx, req)

    def abort(self, request_id: str) -> Optional[Request]:
        for q in (self.waiting, self.running):
            for r in q:
                if r.request_id == request_id:
                    q.remove(r)
                    return r
        return None

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ---- policy ---------------------------------------------------------

    def prefill_bucket(self, n: int) -> int:
        return max(next_power_of_2(n), self.cfg.min_prefill_bucket)

    def _chunk_bucket(self, remaining: int) -> int:
        """Padded length for a chunked prefill step: a short tail compiles a
        small power-of-two bucket instead of the full chunk shape."""
        return min(self.cfg.prefill_chunk_size, self.prefill_bucket(remaining))

    def _note_admit(self, req: Request) -> None:
        """Note a FRESH admission's queue delay — to the SLO load
        estimator and the flight recorder (preempted re-entries and
        chunk continuations excluded: their wait measures preemption
        policy, not admission load; their re-prefill shows up as a
        replay PREFILL event instead)."""
        if (req.state != RequestState.WAITING or req.num_prefilled > 0
                or req.output_token_ids):
            return
        delay = self.clock.monotonic() - req.arrival_time
        if self.slo is not None:
            self.slo.note_admission(self._rank(req), delay)
        if self.flight is not None:
            self.flight.req_event(req.request_id, "ADMITTED",
                                  queue_delay_ms=round(delay * 1000, 3))

    def _pop_head_for_chunking(self, head: Request,
                               cached: int = 0) -> Optional[ScheduledBatch]:
        need = self.block_manager.blocks_needed(head.num_tokens) + 1
        if need > self.block_manager.num_free_blocks:
            return None          # wait for blocks to free up
        self._note_admit(head)
        self.waiting.popleft()
        return ScheduledBatch(kind="prefill_chunk", requests=[head],
                              padded_len=self._chunk_bucket(
                                  head.num_tokens - cached))

    def decode_bucket(self, n: int) -> int:
        return min(max(next_power_of_2(n), self.cfg.min_decode_bucket),
                   next_power_of_2(self.cfg.max_num_seqs))

    def set_admission_filter(self, allowed) -> None:
        """Restrict admission from the waiting queue to ``allowed`` request
        ids (None lifts).  The crash-only salvage path uses this to replay
        bisected suspect groups one at a time; everything held back keeps
        its queue position and admits normally once the filter lifts."""
        self.admission_filter = set(allowed) if allowed is not None else None

    def schedule(self) -> Optional[ScheduledBatch]:
        """Admission-filter wrapper over :meth:`_schedule`: held-back
        requests are lifted out of the waiting queue for the duration of
        one scheduling decision and restored in order, so the policy code
        below never has to reason about the filter."""
        if self.admission_filter is None:
            return self._schedule()
        held = [r for r in self.waiting
                if r.request_id not in self.admission_filter]
        for r in held:
            self.waiting.remove(r)
        try:
            return self._schedule()
        finally:
            for r in reversed(held):
                self.waiting.appendleft(r)

    def _schedule(self) -> Optional[ScheduledBatch]:
        """Pick the next batch.  Prefill-priority: admit waiting work first
        (keeps TTFT low and the decode batch full), then decode.  Exception:
        directly after a chunked-prefill step, one decode step runs first so
        a long prompt's multi-step admission cannot starve in-flight streams
        (bounded inter-token latency).

        Mixed mode (cfg.mixed_batching) replaces the phase split: any
        cycle with admissible prefill work returns ONE kind="mixed" flat
        batch carrying every running decode row plus prefill-chunk
        tokens; prefill-free cycles fall through to the plain decode path
        so fused windows/speculation keep pure-decode throughput."""
        if self.cfg.mixed_batching:
            batch = self._schedule_mixed()
            if batch is not None:
                return batch
            if self.running:
                return ScheduledBatch(
                    kind="decode", requests=list(self.running),
                    padded_batch=self.decode_bucket(len(self.running)))
            return None
        if self._interleave_decode and self.running:
            self._interleave_decode = False
            return ScheduledBatch(
                kind="decode", requests=list(self.running),
                padded_batch=self.decode_bucket(len(self.running)))
        batch = self._schedule_prefill()
        if batch is not None:
            self._interleave_decode = (
                batch.kind == "prefill_chunk"
                or self.cfg.interleave_batched_prefill)
            return batch
        if self.running:
            return ScheduledBatch(
                kind="decode", requests=list(self.running),
                padded_batch=self.decode_bucket(len(self.running)))
        return None

    def _schedule_prefill(self) -> Optional[ScheduledBatch]:
        if not self.waiting or len(self.running) >= self.cfg.max_num_seqs:
            return None
        # A long prompt runs chunk-by-chunk, alone.  A partially-prefilled
        # request ANYWHERE in the queue continues first: it already holds KV
        # blocks, and it can end up behind other waiting requests when a
        # decode-OOM preemption appendlefts its victim — if it could not be
        # scheduled from there, its blocks would never drain and the engine
        # would livelock.
        for req in self.waiting:
            if req.num_prefilled > 0:
                self.waiting.remove(req)
                return ScheduledBatch(kind="prefill_chunk", requests=[req],
                                      padded_len=self._chunk_bucket(
                                          req.num_tokens - req.num_prefilled))
        head = self.waiting[0]
        # Tiered KV cache: a head request whose lower-tier prefix is mid-
        # restore holds admission for the cycle the async host->HBM copy
        # overlaps (engine._begin_tier_restores) — it admits next cycle
        # with the restored span as a prefix-cache hit and prefills only
        # the uncached suffix.  Same shape as waiting for blocks: the
        # caller falls through to a decode step.
        if head.state == RequestState.RESTORING:
            return None
        # Long prompts chunk by necessity (checked first — no cache probe,
        # which would re-hash an unbounded prompt every scheduling cycle
        # while it waits for blocks).
        if (self.cfg.allow_chunked_prefill
                and head.num_tokens > self.cfg.prefill_chunk_size):
            return self._pop_head_for_chunking(head)
        # Prompts with a SUBSTANTIAL prefix-cache hit chunk by choice — the
        # chunked path starts at the cached offset and skips the recompute.
        # A small hit stays on the batched path: recomputing a few cached
        # tokens is far cheaper than giving up prefill batching.
        cached = 0
        if (self.block_manager.enable_prefix_caching
                and self.cfg.allow_chunked_prefill):
            _, cached = self.block_manager.lookup_prefix(
                head.prompt_token_ids + head.output_token_ids,
                count_stats=False)
        if cached >= max(2 * self.block_manager.block_size,
                         head.num_tokens // 4):
            return self._pop_head_for_chunking(head, cached)
        # Admission arithmetic runs in the BLOCK MANAGER (one native call
        # per cycle when the C++ manager is loaded): the manager holds the
        # free-pool state the decision charges against, and the shared
        # power-of-2 bucket / token-budget / +1-headroom rules live in one
        # place for both impls (block_manager.admit_prefill).  This loop
        # only collects the candidate head segment — truncated at the
        # first chunk-route prompt, whose batching here would one-shot
        # prefill a giant uncompiled bucket.  num_tokens (not
        # num_prompt_tokens): a preempted request re-prefills its prompt
        # plus everything generated so far.
        seats = min(self.cfg.max_prefill_seqs,
                    self.cfg.max_num_seqs - len(self.running))
        budget = self.cfg.max_prefill_tokens
        head_rank = self._rank(head)
        if self.slo is not None and head_rank >= BATCH:
            # batch prefill admits only into the leftover budget: the
            # reserved headroom stays free for a stricter-class arrival,
            # which would otherwise wait out a fully-booked batch bucket
            budget -= int(budget * self.slo.cfg.reserve_frac)
        counts: list[int] = []
        for req in self.waiting:
            if len(counts) >= seats:
                break
            if (self.cfg.allow_chunked_prefill
                    and req.num_tokens > self.cfg.prefill_chunk_size):
                break
            if req.state == RequestState.RESTORING:
                # mid-restore: its prefix lands in HBM next cycle — the
                # head segment stops here (FIFO order preserved)
                break
            if self.slo is not None and self._rank(req) != head_rank:
                # classes never share a prefill batch: a batch row
                # co-admitted with interactive ones would widen their
                # shared bucket and charge the reserved budget
                break
            counts.append(req.num_tokens)
        if not counts:
            return None
        if self._batched_admission:
            n_pick, bucket = self.block_manager.admit_prefill(
                counts, seats, budget,
                self.cfg.min_prefill_bucket)
        else:
            # legacy inline loop (the pre-batching admission path, kept
            # for the A/B) — MUST stay arithmetic-identical to
            # block_manager.admit_prefill, which tests/test_scheduler
            # and the native op-trace differential pin
            n_pick = bucket = reserved = 0
            free = self.block_manager.num_free_blocks
            for c in counts:
                cand = max(bucket, self.prefill_bucket(c))
                if (cand * (n_pick + 1) > budget
                        and n_pick):
                    break
                need = self.block_manager.blocks_needed(c) + 1
                if reserved + need > free:
                    break
                n_pick += 1
                reserved += need
                bucket = cand
        if not n_pick:
            return None
        for i in range(n_pick):
            self._note_admit(self.waiting[i])
        picked = [self.waiting.popleft() for _ in range(n_pick)]
        return ScheduledBatch(kind="prefill", requests=picked, padded_len=bucket)

    def _schedule_mixed(self) -> Optional[ScheduledBatch]:
        """Token-budget mixed batch: all running decode rows ride first
        (1 token each — no running stream EVER waits out an admission
        burst, the fairness property tests/test_scheduler.py pins), then
        prefill-chunk tokens fill the remaining budget.  Partially
        prefilled requests anywhere in the queue continue first (the same
        block-drain livelock rule as _schedule_prefill); fresh admissions
        are FIFO from the head and stop at the first one whose blocks
        don't fit.  Returns None when nothing prefill-side is admissible
        — the caller then runs a plain decode step."""
        if not self.waiting:
            return None
        align = self.ragged_align

        def rows(n: int) -> int:
            # flat rows a chunk of n tokens actually occupies in the
            # engine's block-aligned layout (engine._run_mixed)
            return -(-n // align) * align

        # budget is in FLAT ROWS (padding included): decode rows occupy
        # one align-padded region, each chunk its own aligned span — so
        # the dispatched bucket T never exceeds
        # next_power_of_2(mixed_token_budget), which is exactly what
        # warmup pre-compiles
        budget = self.cfg.mixed_token_budget - rows(len(self.running))
        seats = self.cfg.max_num_seqs - len(self.running)
        if budget < align or seats <= 0:
            return None
        # SLO headroom: fresh BATCH-class admissions only fill the budget
        # left above this reserve, so an interactive arrival next cycle
        # finds flat rows free instead of a fully-booked batch step.
        # Continuations are exempt (the block-drain livelock rule).
        reserve = 0
        if self.slo is not None:
            reserve = rows(int(self.cfg.mixed_token_budget
                               * self.slo.cfg.reserve_frac))

        def take(remaining: int, avail: int) -> int:
            # largest admissible chunk: whole remainder if its aligned
            # span fits the row budget, else the biggest aligned span
            if rows(remaining) <= avail:
                return remaining
            return (avail // align) * align

        # each decode row may append into a fresh block this step — leave
        # them headroom before reserving for admissions
        free = self.block_manager.num_free_blocks - len(self.running)
        chunks: list = []
        for req in list(self.waiting):
            if budget < align or seats <= 0:
                break
            if req.num_prefilled > 0:
                n = take(req.num_tokens - req.num_prefilled, budget)
                if n <= 0:
                    break
                self.waiting.remove(req)
                chunks.append((req, n))
                budget -= rows(n)
                seats -= 1
        while self.waiting and budget >= align and seats > 0:
            head = self.waiting[0]
            if head.state == RequestState.RESTORING:
                break                    # prefix mid-restore: admit next cycle
            avail = budget
            if reserve and self._rank(head) >= BATCH:
                # fresh batch work fills leftover budget only; the queue
                # is class-ordered, so everything behind this head is
                # batch too — stop rather than skip
                avail = budget - reserve
                if avail < align:
                    break
            need = self.block_manager.blocks_needed(head.num_tokens) + 1
            if need > free:
                break                        # wait for blocks to free up
            cached = 0
            if self.block_manager.enable_prefix_caching:
                # compute-skip: the engine starts this chunk at the
                # cached offset (prefill_chunk semantics), so only the
                # uncached tail charges the token budget
                _, cached = self.block_manager.lookup_prefix(
                    head.prompt_token_ids + head.output_token_ids,
                    count_stats=False)
            n = take(head.num_tokens - cached, avail)
            if n <= 0:
                break
            self._note_admit(head)
            self.waiting.popleft()
            chunks.append((head, n))
            free -= need
            budget -= rows(n)
            seats -= 1
        if not chunks:
            return None
        return ScheduledBatch(kind="mixed", requests=list(self.running),
                              prefill_chunks=chunks)

    # ---- state transitions (driven by the engine) -----------------------

    def mark_running(self, reqs: list[Request]) -> None:
        for r in reqs:
            r.state = RequestState.RUNNING
            self.running.append(r)

    def finish(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        if req in self.running:
            self.running.remove(req)
        self.block_manager.free(req.request_id)

    def preempt_last(self) -> Optional[Request]:
        """Evict a running request back to waiting (frees its blocks; it
        will re-prefill later).  Called on decode OOM.  Classless: the
        most recent admission; with SLO scheduling: the most recent row
        of the LOOSEST class present, so memory pressure costs batch
        work before interactive streams."""
        if not self.running:
            return None
        idx = len(self.running) - 1
        if self.slo is not None:
            worst = max(self._rank(r) for r in self.running)
            while idx > 0 and self._rank(self.running[idx]) != worst:
                idx -= 1
        req = self.running.pop(idx)
        self.block_manager.free(req.request_id)
        # Re-prefill will recompute the full context (prompt + generated).
        req.state = RequestState.PREEMPTED
        req.num_prefilled = 0
        self.waiting.appendleft(req)
        if self.flight is not None:
            self.flight.req_event(req.request_id, "PREEMPTED",
                                  cause="decode_oom")
        return req

    def preempt_for_class(self, victim: Request) -> None:
        """SLO priority preemption (engine picks the victim): free the
        victim's KV and re-queue it BY CLASS — behind stricter waiting
        work, ahead of its own class — charging its per-request
        preemption budget.  Replay through the re-prefill path is
        token-identical (the property tests/test_salvage.py pins), so
        preempting background work for interactive traffic is safe."""
        self.running.remove(victim)
        self.block_manager.free(victim.request_id)
        victim.state = RequestState.PREEMPTED
        victim.num_prefilled = 0
        victim.num_preemptions += 1
        self.reinsert_preempted(victim)
        if self.flight is not None:
            self.flight.req_event(victim.request_id, "PREEMPTED",
                                  cause="slo_class")
