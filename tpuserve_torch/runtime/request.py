"""Request lifecycle types for the serving engine.

The reference's request surface is the OpenAI-compatible API it smoke-tests
through the llm-d gateway (reference: llm-d-test.yaml:61-78 POSTs
``{"model": ..., "prompt": ..., "max_tokens": ...}``); these types carry that
request through tokenize -> schedule -> prefill -> decode -> detokenize.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional, Sequence


class RequestState(enum.Enum):
    WAITING = "waiting"
    # Tiered KV cache: a lower-tier prefix hit is being copied back into
    # HBM ahead of this request's admission (engine._begin_tier_restores).
    # The request stays in the waiting queue but the scheduler holds its
    # admission for the one cycle the async host->HBM copy overlaps with;
    # it then prefills only the uncached suffix.
    RESTORING = "restoring"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


class FinishReason(enum.Enum):
    STOP = "stop"            # hit EOS or a stop string
    LENGTH = "length"        # hit max_tokens / max_model_len
    ABORT = "abort"


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 16
    temperature: float = 1.0
    top_k: int = 0                      # <=0 disables
    top_p: float = 1.0                  # >=1 disables
    min_p: float = 0.0                  # <=0 disables (vLLM extension)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    stop: tuple[str, ...] = ()
    ignore_eos: bool = False
    seed: Optional[int] = None
    logprobs: Optional[int] = None      # top-N logprobs per generated token
    # OpenAI logit_bias: token id -> additive bias (clamped to ±100 at the
    # API layer); applied to the logits before every sampling step
    logit_bias: Optional[dict[int, float]] = None
    # vLLM min_tokens: EOS is masked out of the logits and stop-string
    # termination is suppressed until this many tokens have been generated
    min_tokens: int = 0
    # vLLM stop_token_ids: extra ids that finish the request like EOS does
    # (the matched token is emitted; min_tokens suppresses these too)
    stop_token_ids: tuple[int, ...] = ()
    # vLLM include_stop_str_in_output: keep the matched stop string in
    # the emitted/stored text instead of truncating it (OpenAI default)
    include_stop_str_in_output: bool = False
    # vLLM priority scheduling: LOWER value = admitted sooner; FIFO
    # within a level (runtime/scheduler.py Scheduler.add)
    priority: int = 0
    # SLO class (runtime/slo.py): "interactive" / "standard" / "batch".
    # With SLO scheduling enabled the waiting queue orders by
    # (class rank, priority), the mixed/prefill token budgets reserve
    # headroom for non-batch classes, and under pressure batch rows are
    # preempted (token-identical re-prefill replay) or shed first.
    slo_class: str = "standard"
    # Synthetic canary probe (tpuserve/obs/canary.py, tagged via the
    # X-TPUServe-Canary header): served through the normal path but
    # EXCLUDED from tenant metering and the production SLI histograms /
    # burn-rate stream (server/runner.py) — the prober observes the
    # system, it must not feed the signals it cross-checks
    canary: bool = False
    # vLLM truncate_prompt_tokens: keep only the LAST N prompt tokens
    # at intake (clients cap their own context budget server-side)
    truncate_prompt_tokens: Optional[int] = None
    # Structured output (OpenAI response_format): "json" constrains
    # generation to one valid JSON object, "json_schema" additionally to
    # ``guided_schema``.  Grammar-FSM-compilable specs run as true logit
    # masks inside fused multi-step windows (runtime/grammar/); specs the
    # compiler can't bound fall back to per-step candidate validation
    # (runtime/guided.py) on the single-step decode path
    guided: Optional[str] = None
    # canonical JSON text of the compiled schema ("json_schema" mode);
    # kept as text so SamplingParams stays hash/replace-friendly
    guided_schema: Optional[str] = None

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def needs_truncation(self) -> bool:
        return self.top_k > 0 or self.top_p < 1.0 or self.min_p > 0.0

    @property
    def needs_penalties(self) -> bool:
        return (self.presence_penalty != 0.0 or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)

    @property
    def needs_logit_bias(self) -> bool:
        return bool(self.logit_bias)

    @property
    def needs_min_tokens(self) -> bool:
        """Whether the stop-id logits mask may be required (ignore_eos
        streams never stop on EOS, so no EOS mask — but stop_token_ids
        still need masking; stop-string suppression is host-side and needs
        no mask)."""
        return self.min_tokens > 0 and (not self.ignore_eos
                                        or bool(self.stop_token_ids))

    def multihost_unsupported(self) -> list[str]:
        """Parameter families the multi-host lockstep protocol cannot
        serve (it mirrors prefill/decode/sample only; penalty/bias/
        min-tokens/logprob jits are out of protocol — parallel/multihost.py
        "Limitations").  ONE source of truth for both rejection sites: the
        engine's intake guard and the API edge's 400
        (tpuserve/server/openai_api.py) — keep them from drifting."""
        return [name for name, used in (
            ("presence_penalty/frequency_penalty/repetition_penalty",
             self.needs_penalties),
            ("logit_bias", self.needs_logit_bias),
            ("min_tokens", self.needs_min_tokens),
            # min_p would extend the 4-array lockstep sample broadcast
            ("min_p", self.min_p > 0.0),
            ("logprobs", self.logprobs is not None),
            # per-step host-side candidate validation cannot be mirrored
            # by the fixed-shape lockstep step kinds
            ("response_format", self.guided is not None),
        ) if used]

    def min_tokens_active(self, n_generated: int, slack: int = 0) -> bool:
        """True while the min_tokens floor is still in force after
        ``n_generated`` tokens.  ``slack`` widens the window for callers
        whose host-side length is stale (the pipelined decode path runs one
        step behind) — the single place the boundary arithmetic lives."""
        return self.min_tokens > 0 and n_generated < self.min_tokens + slack

    def logit_bias_items(self) -> tuple:
        """Sorted (token_id, bias) pairs, computed once — the bias is
        static per request but applied on every sampling step."""
        cached = getattr(self, "_bias_items", None)
        if cached is None:
            cached = tuple(sorted((self.logit_bias or {}).items()))
            object.__setattr__(self, "_bias_items", cached)
        return cached


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_token_ids: list[int]
    params: SamplingParams
    prompt: Optional[str] = None
    # tpulint: sync-ok(standalone-Request default only; the engine passes arrival_time from its clock seam)
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)

    state: RequestState = RequestState.WAITING
    output_token_ids: list[int] = dataclasses.field(default_factory=list)
    output_text: str = ""
    finish_reason: Optional[FinishReason] = None
    first_token_time: Optional[float] = None     # TTFT measurement
    finish_time: Optional[float] = None
    # logprob of each generated token + top alternatives (when requested)
    logprobs: list[dict] = dataclasses.field(default_factory=list)
    # chunked prefill progress: prompt tokens already written to the cache
    # (reset on preemption along with the cache itself)
    num_prefilled: int = 0
    # stop-string hold-back: text withheld from emission because it is a
    # prefix of a stop string that may complete in a later delta (flushed
    # on finish; engine._match_stop owns it)
    stop_held: str = ""
    # multi-LoRA: index into the engine's loaded adapter stack
    # (weights.load_lora_stack); None = base model
    adapter_idx: Optional[int] = None
    # Admission deadline (time.monotonic seconds): a request still
    # QUEUED past this is aborted engine-side with a TimeoutError
    # before any prefill is spent (Engine._expire_queued_deadlines) —
    # its client's request_timeout_s would kill it anyway; honoring the
    # deadline queue-side just stops the engine paying for a response
    # nobody is waiting for.  None = no queue-side deadline.
    deadline: Optional[float] = None
    # SLO class preemptions absorbed so far (runtime/slo.py): bounded by
    # SloConfig.preempt_budget so interactive pressure cannot starve a
    # batch request's forward progress forever.
    num_preemptions: int = 0
    # crash-only salvage: CONSECUTIVE faulted engine steps this request was
    # dispatched in without emitting a token since (reset on every emission
    # — engine._emit_one).  The runner's per-request fault budget
    # (AsyncEngineRunner.max_salvages) fails the request once this exceeds
    # it, bounding retry loops without punishing long streams that merely
    # coexist with sporadic chaos.
    num_salvages: int = 0

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    @property
    def finished(self) -> bool:
        return self.state == RequestState.FINISHED


@dataclasses.dataclass
class RequestOutput:
    """Incremental output emitted by Engine.step() for one request."""
    request_id: str
    new_token_ids: list[int]
    new_text: str
    finished: bool
    finish_reason: Optional[FinishReason] = None
    num_prompt_tokens: int = 0
    num_output_tokens: int = 0
    # True when this emission came from a prefill step.  With
    # num_output_tokens > 1 it marks a re-prefill after preemption, whose
    # wall-clock gap is queue+recompute time, not inter-token latency.
    from_prefill: bool = False


def check_stop(req: Request, eos_token_ids: Sequence[int], max_model_len: int) -> Optional[FinishReason]:
    """Decide whether a request just finished after its latest token.

    Stop-*string* matching is handled by the engine during detokenization
    (it must truncate the emitted text); this checks eos/length only.
    """
    if not req.output_token_ids:
        return None
    last = req.output_token_ids[-1]
    if (not req.params.min_tokens_active(len(req.output_token_ids))
            and ((not req.params.ignore_eos and last in eos_token_ids)
                 or last in req.params.stop_token_ids)):
        # min_tokens: the logits mask should prevent EOS from being
        # sampled at all; this guard covers any path where it leaks.
        # stop_token_ids finish unconditionally of ignore_eos (vLLM).
        return FinishReason.STOP
    if len(req.output_token_ids) >= req.params.max_tokens:
        return FinishReason.LENGTH
    if req.num_tokens >= max_model_len:
        return FinishReason.LENGTH
    return None
