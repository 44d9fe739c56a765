"""Token sampling — the port of ``tpuserve/ops/sampling.py``: greedy,
temperature and "full" (top-k / top-p / min-p truncation) sampling, the
presence / frequency / repetition penalties, ``logit_bias`` and logprobs,
each a plain function on tensors.

The JAX sampler draws each row's Gumbel noise from a ``(salt, step)``
``jax.random`` key, so a seeded stream does not depend on the batch it
lands in, its place there, or the window size.  ``jax.random``'s bits
cannot be reproduced in torch; :func:`keyed_gumbel` keeps the contract
with a counter-based integer hash of (salt, step, vocabulary index) in
plain torch integer ops: no generator object, so a captured CUDA graph
serves any request.  ``sample_tokens`` also takes the noise whole
(``gumbel``), so a test can feed both sides the same numbers.  In the full
mode noise column j goes to the j-th most likely token (the argmax runs in
sorted order), as in the JAX sampler.  Speculative acceptance
(:func:`spec_accept_sampled`) keys its uniform and its resample noise the
same way, on two streams of their own.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
# xorshift-multiply rounds with odd multipliers below 2**31, so the
# products of 32-bit values stay inside int64
_MUL = (0x7FEB352D, 0x5BD1E995)
_IDX_SALT = 0x9E3779B9
_STREAM_SALT = 0x85EBCA6B
# keyed_uniform streams of speculative acceptance: its uniform and its
# resample noise (stream 0 is the decode sampler's)
SPEC_U_STREAM, SPEC_G_STREAM = 1, 2
NEG_INF = -1e30


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash of int64 ``x`` holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _U32
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _U32
    return x ^ (x >> 16)


def keyed_uniform(salt: torch.Tensor, step: torch.Tensor, n: int,
                  stream: int = 0) -> torch.Tensor:
    """(B, n) float32 uniforms in [0, 1) on the keys' device: row ``i`` is a
    function of ``(salt[i], step[i], stream)`` alone (int32 or int64
    tensors of (B,) holding uint32 bit patterns).  Stream 0 is the
    decode sampler's; other streams are independent draws of the same
    key (speculative acceptance takes its uniform and its Gumbel noise
    from two of them)."""
    row = _mix32(_mix32(salt.long() & _U32) ^ (step.long() & _U32))
    if stream:
        row = _mix32(row ^ ((stream * _STREAM_SALT) & _U32))
    idx = torch.arange(n, dtype=torch.int64, device=salt.device)
    col = _mix32((idx + _IDX_SALT) & _U32)
    h = _mix32(row[:, None] ^ col[None, :])
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def keyed_gumbel(salt: torch.Tensor, step: torch.Tensor,
                 vocab_size: int, stream: int = 0) -> torch.Tensor:
    """(B, V) float32 Gumbel noise of :func:`keyed_uniform`'s draws, the
    uniforms mapped into [1e-7, 1) as in the JAX sampler."""
    u = keyed_uniform(salt, step, vocab_size, stream)
    return -torch.log(-torch.log(u * (1.0 - 1e-7) + 1e-7))



def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor | None = None,
                  *, mode: str = "greedy", gumbel=None,
                  top_k: torch.Tensor | None = None, top_p: torch.Tensor | None = None,
                  min_p: torch.Tensor | None = None) -> torch.Tensor:
    """Sample next tokens.

    logits: (B, V); temperature: (B,) per-row, ``<= 0`` means greedy for
    that row; gumbel: the (B, V) noise of the sampled modes, or a function
    of no argument that makes it (called after the full mode's sort, so
    the noise's and the sort's temporaries never coexist);
    top_k/top_p/min_p: (B,) per-row truncation of the full mode (``top_k
    <= 0``, ``top_p >= 1`` and ``min_p <= 0`` disable theirs).
      - "greedy": argmax (everything else ignored).
      - "temperature": argmax(logits / temperature + gumbel).
      - "full": the truncated scaled logits in descending order, argmax
        of them plus the noise, mapped back through the sort.
    Returns (B,) int32 on the logits' device.
    """
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if mode == "greedy":
        return greedy_tok
    if mode not in ("temperature", "full"):
        raise ValueError(f"unknown sampling mode {mode!r}")
    temperature = temperature.to(logits.device)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if mode == "temperature":
        noise = gumbel() if callable(gumbel) else gumbel
        sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
    else:
        masked_sorted, sort_idx = truncated_sorted_logits(scaled, top_k, top_p, min_p)
        del scaled
        noise = gumbel() if callable(gumbel) else gumbel
        choice = torch.argmax(masked_sorted + noise, dim=-1)          # sorted index
        sampled = torch.gather(sort_idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)


def truncated_sorted_logits(scaled: torch.Tensor, top_k: torch.Tensor,
                            top_p: torch.Tensor, min_p: torch.Tensor | None = None):
    """Top-k / top-p (/ min-p) truncation of temperature-scaled logits
    (B, V).  Returns (the logits in descending order with dropped tokens at
    ``NEG_INF``, the (B, V) int64 vocabulary id of each sorted position).
    Ties sort in index order (a stable sort of the negated logits, as the
    JAX ``argsort(-x)``).  A token is kept while the probability before it
    is below ``top_p``, so the most likely one always is; min-p keeps
    tokens of at least ``min_p`` times the largest probability, with
    ``min_p`` NaN-zeroed and clamped to [0, 1] so that one always
    survives."""
    V = scaled.shape[-1]
    sort_idx = torch.sort(-scaled, dim=-1, stable=True)[1]
    sorted_logits = torch.gather(scaled, 1, sort_idx)
    rank = torch.arange(V, device=scaled.device)
    k = torch.where(top_k <= 0, V, top_k.long())[:, None]
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = (rank < k) & ((torch.cumsum(probs, dim=-1) - probs) < top_p[:, None])
    if min_p is not None:
        mp = torch.clamp(torch.nan_to_num(min_p, nan=0.0), 0.0, 1.0)
        keep &= probs >= mp[:, None] * probs[:, :1]
    return torch.where(keep, sorted_logits, NEG_INF), sort_idx


def truncated_scaled_logits(scaled: torch.Tensor, top_k: torch.Tensor,
                            top_p: torch.Tensor,
                            min_p: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`truncated_sorted_logits` in vocabulary order, for consumers
    that index by token id (speculative acceptance)."""
    masked_sorted, sort_idx = truncated_sorted_logits(scaled, top_k, top_p, min_p)
    return torch.empty_like(masked_sorted).scatter_(1, sort_idx, masked_sorted)


def apply_token_mask(logits: torch.Tensor, packed: torch.Tensor,
                     enabled: torch.Tensor) -> torch.Tensor:
    """Grammar-FSM logit masking, as the JAX ``apply_token_mask``: every
    token a row's mask forbids drops to ``NEG_INF`` before any truncation,
    so sampling renormalises over exactly the legal set.

    logits: (B, V); packed: (B, ceil(V/32)) int32 or uint32 allow bits
    (bit t%32 of word t//32 = token t, ``runtime/grammar/fsm.py``'s
    layout); enabled: (B,) bool, False rows pass through.  The bit test
    is an AND with the token's one-bit word on int32, where bit 31 is the
    sign bit: no unsigned shift is needed.  Returns (B, V) float32."""
    V = logits.shape[-1]
    ids = torch.arange(V, dtype=torch.int64, device=logits.device)
    words = packed.to(torch.int32).index_select(1, ids // 32)            # (B, V)
    bit = torch.bitwise_left_shift(torch.ones_like(ids, dtype=torch.int32),
                                   (ids % 32).to(torch.int32))
    allow = (words & bit) != 0
    allow |= ~enabled.to(torch.bool)[:, None]
    return torch.where(allow, logits.float(), NEG_INF)


def scatter_add_rows(out: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Add ``vals`` (B, K) into ``out`` (B, V) float32 at ``ids`` (B, K),
    in place; ids outside [0, V) are dropped, as the JAX scatter's
    ``mode="drop"`` (they add 0.0 to column 0 instead)."""
    V = out.shape[1]
    ids = ids.long()
    keep = (ids >= 0) & (ids < V)
    return out.scatter_add_(1, torch.where(keep, ids, 0),
                            torch.where(keep, vals.float(), 0.0))


def token_counts(output_tokens: torch.Tensor, output_mask: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """(B, T) token history and its validity mask -> (B, V) float32
    counts; ids past the vocabulary are dropped."""
    ids = torch.where(output_mask, output_tokens.long(), vocab_size)
    out = torch.zeros((ids.shape[0], vocab_size), dtype=torch.float32, device=ids.device)
    return scatter_add_rows(out, ids, torch.ones(ids.shape, dtype=torch.float32,
                                                 device=ids.device))


def penalize_from_counts(logits: torch.Tensor, counts: torch.Tensor,
                         presence_penalty: torch.Tensor,
                         frequency_penalty: torch.Tensor,
                         repetition_penalty: torch.Tensor) -> torch.Tensor:
    """OpenAI presence/frequency and HF repetition penalties from (B, V)
    counts, in the JAX order: presence, frequency, then repetition (divide
    a positive logit, multiply the others) on the tokens seen."""
    logits = logits.float()
    seen = counts > 0
    logits = logits - presence_penalty[:, None] * seen
    logits = logits - frequency_penalty[:, None] * counts
    rep = repetition_penalty[:, None]
    rep_logits = torch.where(logits > 0, logits / rep, logits * rep)
    return torch.where(seen, rep_logits, logits)


def apply_logit_penalties(logits: torch.Tensor, output_tokens: torch.Tensor,
                          output_mask: torch.Tensor, presence_penalty: torch.Tensor,
                          frequency_penalty: torch.Tensor,
                          repetition_penalty: torch.Tensor) -> torch.Tensor:
    """The penalties straight from the (B, T) token history."""
    counts = token_counts(output_tokens, output_mask, logits.shape[1])
    return penalize_from_counts(logits, counts, presence_penalty, frequency_penalty,
                                repetition_penalty)


def apply_logit_bias(logits: torch.Tensor, bias_ids: torch.Tensor,
                     bias_vals: torch.Tensor) -> torch.Tensor:
    """OpenAI ``logit_bias``: (B, K) ids (ids >= V are padding, dropped)
    and float values added to the (B, V) logits."""
    dense = torch.zeros(logits.shape, dtype=torch.float32, device=logits.device)
    return logits.float() + scatter_add_rows(dense, bias_ids, bias_vals)


def compute_logprobs(logits: torch.Tensor, chosen: torch.Tensor, top_n: int):
    """Log-probabilities of the chosen tokens and the top ``top_n``: from
    (B, V) logits and (B,) chosen ids, (chosen_lp (B,) float32, top_ids
    (B, top_n) int32, top_lps (B, top_n) float32), top ids by descending
    log-probability."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = torch.gather(lp, 1, chosen.long()[:, None])[:, 0]
    top_lps, top_ids = torch.topk(lp, top_n, dim=-1)
    return chosen_lp, top_ids.to(torch.int32), top_lps


def spec_accept_sampled(logits: torch.Tensor, draft_next: torch.Tensor,
                        chunk_lens: torch.Tensor, salt: torch.Tensor,
                        step: torch.Tensor, temperature: torch.Tensor,
                        top_k: torch.Tensor, top_p: torch.Tensor,
                        min_p: torch.Tensor | None = None, noise=None):
    """Rejection-sampling acceptance for speculative decoding under
    temperature / top-k / top-p (/ min-p) sampling, as the JAX
    ``spec_accept_sampled``: drafts are deterministic (n-gram lookup, a
    greedy draft model), so draft token d is accepted with probability
    p̃(d) and a rejection resamples from p̃ with d's mass removed; the
    emitted marginal is exactly p̃, the truncated distribution the decode
    sampler draws from.

    logits: (B, K, V) verify logits (row j = after consuming row j);
    draft_next: (B, K-1) int32, the draft token row j's distribution
    decides (verify input token j + 1); positions at or past
    ``chunk_lens - 1`` are padding, whose token must NOT lose mass in the
    bonus resample; salt/step: (B,) each row's sampling key, position j
    keyed (salt, step + j); temperature/top_k/top_p(/min_p): (B,), the
    decode sampler's truncation.  ``noise``: (u (B, K), gumbel (B, K, V))
    to use instead of the keyed draws (tests feed JAX's).  The uniform and
    the resample noise come from two keyed streams, so the accept decision
    and the replacement draw are independent.  ``temperature <= 0`` rows
    reduce to exact greedy acceptance (accept = draft == argmax, pred =
    argmax).

    The positions run one at a time, so the truncation's sort and the
    noise hold (B, V) temporaries, as the decode sampler's.  Returns
    (accept (B, K-1) bool, pred (B, K) int32): pred[:, j] is the
    replacement when draft j is rejected, and the bonus token at a row's
    own chunk end."""
    B, K, V = logits.shape
    dev = logits.device
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    d = draft_next.long()
    is_draft = (torch.arange(K - 1, device=dev)[None, :]
                < (chunk_lens.long() - 1)[:, None])                  # (B, K-1)
    greedy_row = (temperature <= 0.0)[:, None]
    rows = torch.arange(B, device=dev)
    accept_cols, pred_cols = [], []
    for j in range(K):
        lj = logits[:, j].float()
        sj = step.long() + j
        greedy = torch.argmax(lj, dim=-1)
        masked = truncated_scaled_logits(lj / temp, top_k, top_p, min_p)
        if noise is None:
            gumbel = keyed_gumbel(salt, sj, V, SPEC_G_STREAM)
        else:
            gumbel = noise[1][:, j].float()
        if j < K - 1:
            p = torch.softmax(masked, dim=-1)
            p_draft = p[rows, d[:, j]]
            u = (keyed_uniform(salt, sj, 1, SPEC_U_STREAM)[:, 0] if noise is None
                 else noise[0][:, j].float())
            accept_cols.append(torch.where(greedy_row[:, 0], d[:, j] == greedy,
                                           u < p_draft))
            # the draft token's mass goes only at real draft positions
            drop = torch.zeros((B, V), dtype=torch.bool, device=dev)
            drop[rows, d[:, j]] = is_draft[:, j]
            masked = torch.where(drop, NEG_INF, masked)
        sampled = torch.argmax(masked + gumbel, dim=-1)
        pred_cols.append(torch.where(greedy_row[:, 0], greedy, sampled))
    accept = (torch.stack(accept_cols, dim=1) if accept_cols
              else torch.zeros((B, 0), dtype=torch.bool, device=dev))
    return accept, torch.stack(pred_cols, dim=1).to(torch.int32)
