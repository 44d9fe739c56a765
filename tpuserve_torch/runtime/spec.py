"""Speculative decoding: n-gram drafts or a draft model, verified in one
pass — the port's own copy of ``tpuserve/runtime/spec.py``.

Draft proposal is model-free "prompt lookup": the trailing n-gram of
(prompt + generated) is matched against the sequence's own history and the
continuation of its most recent earlier occurrence is proposed; or a
smaller draft model extends the last ``draft_window`` tokens by k greedy
tokens (``transformer.draft_propose``).  The target model then scores the
whole draft window in ONE verify pass (``transformer.decode_verify``, or
``decode_verify_sampled`` for sampled rows) and accepts the longest
matching prefix plus one bonus token, so a step emits 1..k+1 tokens for
one weight pass.

The proposer is the C++ scanner of ``tpuserve_torch.native`` when g++
built it (it runs on the host between dispatches, once a sequence a spec
step), else the pure-Python one, as in the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    num_draft_tokens: int = 4        # k: draft window is k+1 rows
    # ---- draft-model speculation (vLLM's draft-model mode) --------------
    # A smaller registered model proposes the k tokens instead of prompt
    # lookup.  The draft runs STATELESSLY over the last ``draft_window``
    # tokens each spec step (models/transformer.draft_propose): no draft
    # KV cache to mirror through the target's allocate/advance/preempt
    # lifecycle.  None = n-gram prompt lookup (model-free).
    draft_model: str | None = None
    draft_checkpoint_dir: str | None = None
    draft_window: int = 64           # context the draft sees per proposal
    max_ngram: int = 3               # longest trailing n-gram to match
    min_ngram: int = 1
    # only the most recent window is scanned for matches: the proposer runs
    # on the synchronous host path every step, so its cost must not grow
    # with context length
    max_lookback: int = 1024
    # run the (k+1)-row verify pass only when at least this fraction of the
    # batch has a proposal: draft-less rows pay the full window cost to
    # emit one token
    min_batch_coverage: float = 0.5
    # ---- adaptive governor: the measured acceptance rate, not a config
    # default, decides whether speculation runs; paused when it is a loss,
    # re-probed later
    adaptive: bool = True
    # pause when rolling acceptance drops below this (break-even is roughly
    # (verify_cost/decode_cost - 1) / k; the margin covers the proposer)
    min_acceptance: float = 0.15
    # draft-model break-even is higher: each spec step also pays k
    # cache-less draft passes before the verify pass
    min_acceptance_draft: float = 0.35

    @property
    def effective_min_acceptance(self) -> float:
        return (self.min_acceptance_draft if self.draft_model
                else self.min_acceptance)
    # judge only after this many proposed tokens
    adaptive_window_proposed: int = 256
    # how long a pause lasts, in decode steps, before re-probing
    adaptive_pause_steps: int = 4096


def _ngram_propose_py(ids: list[int], k: int, max_ngram: int = 3,
                      min_ngram: int = 1, max_lookback: int = 1024) -> list[int]:
    """The pure-Python scanner (the JAX ``_ngram_propose_py``, which the
    C++ one matches)."""
    if len(ids) > max_lookback:
        ids = ids[-max_lookback:]
    L = len(ids)
    for n in range(max_ngram, min_ngram - 1, -1):
        if L < n + 1:
            continue
        tail = ids[L - n:]
        # most recent occurrence strictly before the trailing one, with at
        # least one continuation token available
        for j in range(L - n - 1, -1, -1):
            if ids[j:j + n] == tail:
                cont = ids[j + n:j + n + k]
                if cont:
                    return cont
    return []


def _resolve_propose():
    """The C++ scanner when the extension builds, else the Python one."""
    from tpuserve_torch import native
    if native.native_available():
        return native.ngram_propose
    return _ngram_propose_py


_propose_impl = None


def ngram_propose(ids: list[int], k: int, max_ngram: int = 3,
                  min_ngram: int = 1, max_lookback: int = 1024) -> list[int]:
    """Propose up to ``k`` draft tokens from the sequence's own history:
    the tokens that followed the most recent earlier occurrence of the
    trailing n-gram within the last ``max_lookback`` tokens, longest n
    first."""
    global _propose_impl
    if _propose_impl is None:
        _propose_impl = _resolve_propose()
    return _propose_impl(ids, k, max_ngram, min_ngram, max_lookback)


def accept_greedy(draft: list[int], pred) -> list[int]:
    """Longest draft prefix matching the model's greedy predictions, plus
    the bonus token.  ``pred[j]`` is the model's next token after row j
    (row 0 = the last accepted token, rows 1.. = draft tokens)."""
    a = 0
    while a < len(draft) and int(pred[a]) == draft[a]:
        a += 1
    return draft[:a] + [int(pred[a])]


def accept_sampled(draft: list[int], accept_row, pred) -> list[int]:
    """Host side of rejection-sampling acceptance
    (``ops/sampling.spec_accept_sampled``): ``accept_row[j]`` says whether
    draft token j was accepted against row j's sampled distribution;
    ``pred[j]`` is the sampled replacement (on rejection) or bonus (after a
    fully accepted draft).  The accepted prefix plus exactly one sampled
    token, as :func:`accept_greedy`."""
    a = 0
    while a < len(draft) and bool(accept_row[a]):
        a += 1
    return draft[:a] + [int(pred[a])]
