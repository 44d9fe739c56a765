"""Plain PyTorch attention and KV-cache ops — the port of the reference
ops in ``tpuserve/ops/attention.py``.

These are the semantics the CUDA kernels (``ops/flash_prefill.py``,
``ops/paged_decode.py``, ``ops/paged_window.py``, ``ops/ragged_paged.py``)
are held to on the card, and the path every op takes for tensors on the
CPU.  Two deliberate differences from the JAX reference, both matching the
kernels:

- V rows outside every row's valid key range are zeroed before P·V.  Cache
  pages made with ``torch.empty`` may hold NaN, and 0 * NaN would poison
  the output even though those probabilities are exactly 0.
- Paged-decode rows with ``seq_len == 0`` (batch padding) return zeros.

Cache writes update the cache tensors in place (the JAX ops return new
arrays); slots equal to ``PAD_SLOT`` are dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30

# Sentinel slot id for padding tokens in write_kv_cache: far out of range
# for any realistic cache, so the write drops it.
PAD_SLOT = 2**30

KV_QUANT_MAX = 127.0


def _softcap(scores: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma2 attention-score softcap: cap * tanh(s / cap); None = off."""
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(..., Hkv, D) -> (..., Hkv*n_rep, D) grouped-query expansion."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      prompt_lens: torch.Tensor, scale: float,
                      sliding_window: int | None = None,
                      logit_softcap: float | None = None) -> torch.Tensor:
    """Causal self-attention over right-padded prompts.

    q: (B, T, Hq, D); k: (B, T, Hkv, D); v: (B, T, Hkv, Dv), its width
    contracted on its own (MLA's values are narrower than its keys);
    prompt_lens: (B,) valid lengths.  ``sliding_window``: row p attends
    keys in (p - W, p].  Returns (B, T, Hq, Dv) in q.dtype; scores and
    softmax in float32.  Rows at or past ``prompt_lens`` are unspecified.
    """
    B, T, Hq, D = q.shape
    n_rep = Hq // k.shape[2]
    pos = torch.arange(T, device=q.device)
    key_ok = pos[None, :] < prompt_lens.to(q.device)[:, None]         # (B, Tk)
    v = torch.where(key_ok[:, :, None, None], v, torch.zeros_like(v))
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = _softcap(scores, logit_softcap)
    causal = pos[None, :] <= pos[:, None]                              # (Tq, Tk)
    if sliding_window is not None:
        causal = causal & (pos[None, :] > pos[:, None] - sliding_window)
    mask = causal[None, None, :, :] & key_ok[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., Hkv, D) -> (int8 values, float32 scales (..., Hkv)).
    Symmetric absmax over head_dim: one scale per vector per kv head."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / KV_QUANT_MAX, min=1e-10)
    q = torch.clamp(torch.round(xf / s[..., None]),
                    -KV_QUANT_MAX, KV_QUANT_MAX).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`; ``scales`` broadcasts over head_dim."""
    return (q.float() * scales[..., None].float()).to(dtype)


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, scale: float,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           sliding_window: int | None = None,
                           logit_softcap: float | None = None,
                           scale_slices: tuple[int, ...] | None = None) -> torch.Tensor:
    """Single-token decode attention against a paged KV cache.

    q: (B, Hq, D); k_cache/v_cache: (num_blocks, block_size, Hkv, D);
    block_tables: (B, max_blocks) physical block ids; seq_lens: (B,) tokens
    in cache per sequence, including the one being decoded.
    ``k_scale``/``v_scale``: (num_blocks, block_size, Hkv) float32 scales
    when the cache stores int8 (dequantized into q.dtype), or with
    ``scale_slices`` (int8 MLA) (num_blocks, block_size, len(scale_slices))
    scales of channel slices of those widths.
    ``sliding_window``: attend only the last W cached positions.
    Returns (B, Hq, D) in q.dtype.
    """
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    k, v = _gather_pages(k_cache, v_cache, block_tables, k_scale, v_scale, q.dtype,
                         scale_slices)
    S = k.shape[1]
    pos = torch.arange(S, device=q.device)[None, :]
    lens = seq_lens.to(q.device)[:, None]
    valid = pos < lens                                              # (B, S)
    if sliding_window is not None:
        valid = valid & (pos >= lens - sliding_window)
    v = torch.where(valid[:, :, None, None], v, torch.zeros_like(v))
    # grouped-query layout: each kv head's pages serve its G query heads
    # without a repeated copy (MLA's one latent head serves all of them)
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()).reshape(B, Hq, S) * scale
    scores = _softcap(scores, logit_softcap)
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype).reshape(B, Hkv, G, S)
    # a seq_len == 0 row has every V row zeroed, so it returns zeros
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v).reshape(B, Hq, D)
    return out.to(q.dtype)


def _gather_pages(k_cache, v_cache, block_tables, k_scale, v_scale, dtype,
                  scale_slices=None):
    """Gather each row of ``block_tables``' pages: (N, S, Hkv, D) K and V,
    int8 pages dequantized into ``dtype``: by one scale a (token, kv head),
    or with ``scale_slices`` by one scale a channel slice of those widths
    (int8 MLA's latent and rope slices, :func:`expand_slice_scales`).  One
    helper for every plain paged op, as the JAX ``_dequant_gathered``."""
    N = block_tables.shape[0]
    _, bs, Hkv, D = k_cache.shape
    S = block_tables.shape[1] * bs
    bt = block_tables.long()
    k = k_cache[bt].reshape(N, S, Hkv, D)
    v = v_cache[bt].reshape(N, S, Hkv, D)
    if k_scale is None:
        return k, v
    if scale_slices is not None:
        n = len(scale_slices)
        ksc = expand_slice_scales(k_scale[bt].reshape(N, S, n), scale_slices)
        vsc = expand_slice_scales(v_scale[bt].reshape(N, S, n), scale_slices)
        return (k.float() * ksc).to(dtype), (v.float() * vsc).to(dtype)
    return (dequantize_kv(k, k_scale[bt].reshape(N, S, Hkv), dtype),
            dequantize_kv(v, v_scale[bt].reshape(N, S, Hkv), dtype))


def chunked_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, block_tables: torch.Tensor,
                              ctx_lens: torch.Tensor, chunk_lens: torch.Tensor,
                              scale: float, *, seg_size: int = 512,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None,
                              sliding_window: int | None = None,
                              logit_softcap: float | None = None,
                              scale_slices=None) -> torch.Tensor:
    """Attention for one prefill chunk (or any query window) against the
    paged cache.

    The chunk's K/V must already be written (keys at positions
    ``ctx_lens .. ctx_lens + chunk_lens``).  Query row ``i`` sits at
    position ``ctx_lens + i`` and attends every cached key at or before
    it.  Keys stream in ``seg_size`` segments with an online softmax, so
    the transient is (B, Hq, C, seg).  q: (B, C, Hq, D); block_tables:
    (B, max_blocks); ctx_lens/chunk_lens: (B,).  Returns (B, C, Hq, D);
    rows past ``chunk_lens`` return zeros.
    """
    B, C, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    k, v = _gather_pages(k_cache, v_cache, block_tables, k_scale, v_scale, q.dtype,
                         scale_slices)
    S = k.shape[1]
    ctx = ctx_lens.to(q.device).long()[:, None, None]            # (B, 1, 1)
    n = chunk_lens.to(q.device).long()[:, None, None]
    j = torch.arange(S, device=q.device)
    v_ok = j[None, :] < (ctx + n)[:, 0]                           # (B, S)
    if sliding_window is not None:
        v_ok = v_ok & (j[None, :] > ctx[:, 0] - sliding_window)
    v = torch.where(v_ok[:, :, None, None], v, torch.zeros_like(v))
    q_r = (q.float() * scale).reshape(B, C, Hkv, G, D)
    qi = torch.arange(C, device=q.device)[None, :, None]          # (1, C, 1)
    q_valid = qi < n
    o = torch.zeros(B, Hq, C, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, Hq, C), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, Hq, C, dtype=torch.float32, device=q.device)
    seg = min(seg_size, S)
    for s0 in range(0, S, seg):
        ks, vs = k[:, s0:s0 + seg].float(), v[:, s0:s0 + seg].float()
        w = ks.shape[1]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q_r, ks).reshape(B, Hq, C, w)
        scores = _softcap(scores, logit_softcap)
        jj = s0 + torch.arange(w, device=q.device)[None, None, :]
        mask = (jj <= ctx + qi) & q_valid
        if sliding_window is not None:
            mask = mask & (jj > ctx + qi - sliding_window)
        mask = mask[:, None]                                      # (B, 1, C, w)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.where(mask, torch.exp(scores - m_new[..., None]),
                        torch.zeros_like(scores))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.reshape(B, Hkv, G, C, w), vs)
        o = o * alpha[..., None] + pv.reshape(B, Hq, C, D)
        m = m_new
    out = o / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ragged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, row_block_tables: torch.Tensor,
                     row_lens: torch.Tensor, scale: float, *,
                     seg_size: int = 512,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     sliding_window: int | None = None,
                     logit_softcap: float | None = None,
                     scale_slices=None) -> torch.Tensor:
    """Flat-token ragged attention: row ``t`` of q (T, Hq, D) attends the
    keys at positions ``< row_lens[t]`` of its own sequence, whose block
    table is ``row_block_tables[t]`` (T, max_blocks).  Keys stream in
    ``seg_size`` segments with an online softmax.  For a decode row this
    is :func:`paged_decode_attention`'s math, for a chunk row
    :func:`chunked_prefill_attention`'s.  Returns (T, Hq, D)."""
    T, Hq, D = q.shape
    _, bs, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    mb = row_block_tables.shape[1]
    pg = max(1, seg_size // bs)                   # pages per segment
    lens = row_lens.to(q.device).long()[:, None]
    q_r = (q.float() * scale).reshape(T, Hkv, G, D)
    o = torch.zeros(T, Hq, D, dtype=torch.float32, device=q.device)
    m = torch.full((T, Hq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(T, Hq, dtype=torch.float32, device=q.device)
    for c0 in range(0, mb, pg):
        k, v = _gather_pages(k_cache, v_cache, row_block_tables[:, c0:c0 + pg],
                             k_scale, v_scale, q.dtype, scale_slices)
        R = k.shape[1]
        j = c0 * bs + torch.arange(R, device=q.device)[None, :]   # (1, R)
        mask = j < lens
        if sliding_window is not None:
            mask = mask & (j >= lens - sliding_window)
        v = torch.where(mask[:, :, None, None], v, torch.zeros_like(v))
        scores = torch.einsum("thgd,tkhd->thgk", q_r, k.float()).reshape(T, Hq, R)
        scores = _softcap(scores, logit_softcap)
        scores = torch.where(mask[:, None, :], scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.where(mask[:, None, :], torch.exp(scores - m_new[..., None]),
                        torch.zeros_like(scores))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("thgk,tkhd->thgd", p.reshape(T, Hkv, G, R), v.float())
        o = o * alpha[..., None] + pv.reshape(T, Hq, D)
        m = m_new
    out = o / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.to(q.dtype)


def ragged_blocked_attention(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, blk_bt: torch.Tensor,
                             row_lens: torch.Tensor, blk: int, scale: float, *,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None,
                             sliding_window: int | None = None,
                             logit_softcap: float | None = None,
                             scale_slices=None) -> torch.Tensor:
    """Block-gather ragged attention, valid only for rows whose ``blk``-row
    block belongs to one sequence (the mixed layout's prefill blocks): the
    pages are gathered once per block (``blk_bt``: (T // blk, max_blocks),
    each block's sequence's table row).  Same per-row semantics as
    :func:`ragged_attention`; rows of blocks with no single sequence are
    unspecified.  Returns (T, Hq, D)."""
    T, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    nblk = T // blk
    k, v = _gather_pages(k_cache, v_cache, blk_bt, k_scale, v_scale, q.dtype, scale_slices)
    S = k.shape[1]
    lens = row_lens.to(q.device).long().reshape(nblk, blk)
    j = torch.arange(S, device=q.device)
    v_ok = j[None, :] < lens.amax(dim=1)[:, None]                 # (nblk, S)
    if sliding_window is not None:
        first = torch.where(lens > 0, lens, torch.full_like(lens, S)).amin(dim=1)
        v_ok = v_ok & (j[None, :] >= first[:, None] - sliding_window)
    v = torch.where(v_ok[:, :, None, None], v, torch.zeros_like(v))
    q_r = q.reshape(nblk, blk, Hkv, G, D)
    scores = torch.einsum("nbhgd,nkhd->nhgbk", q_r.float(), k.float()) * scale
    scores = _softcap(scores, logit_softcap)
    mask = j[None, None, :] < lens[:, :, None]                    # (nblk, blk, S)
    if sliding_window is not None:
        mask = mask & (j[None, None, :] >= lens[:, :, None] - sliding_window)
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("nhgbk,nkhd->nbhgd", probs.to(v.dtype), v)
    return out.reshape(T, Hq, D).to(q.dtype)


def ragged_reference_attention(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, block_tables: torch.Tensor,
                               row_seq: torch.Tensor, row_lens: torch.Tensor,
                               blk_seq: torch.Tensor, meta: torch.Tensor,
                               blk: int, scale: float, *,
                               k_scale: torch.Tensor | None = None,
                               v_scale: torch.Tensor | None = None,
                               sliding_window: int | None = None,
                               logit_softcap: float | None = None,
                               scale_slices: tuple[int, ...] | None = None) -> torch.Tensor:
    """One mixed layer's plain ragged attention, as the JAX package's
    ``_ragged_reference_attn``: prefill blocks take the block-gather path,
    and the first ``meta[0]`` rows (decode rows, row r = sequence r) are
    overlaid with :func:`paged_decode_attention`, the phase-split decode
    math.  row_seq/row_lens: (T,) each row's sequence and position + 1."""
    T = q.shape[0]
    kw = dict(k_scale=k_scale, v_scale=v_scale, sliding_window=sliding_window,
              logit_softcap=logit_softcap, scale_slices=scale_slices)
    out = ragged_blocked_attention(
        q, k_cache, v_cache, block_tables[blk_seq.clamp(min=0).long()],
        row_lens, blk, scale, **kw)
    Bc = min(block_tables.shape[0], T)
    head = paged_decode_attention(
        q[:Bc], k_cache, v_cache, block_tables[row_seq[:Bc].long()],
        row_lens[:Bc], scale, **kw)
    is_dec = torch.arange(Bc, device=q.device) < meta[0].to(q.device)
    out[:Bc] = torch.where(is_dec[:, None, None], head, out[:Bc])
    return out


def ragged_rows(kv_lens: torch.Tensor, q_starts: torch.Tensor,
                q_lens: torch.Tensor, meta: torch.Tensor, blk_seq: torch.Tensor,
                blk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each flat row's (sequence, position + 1) from the mixed layout's
    descriptors, on their device (no host read).  Rows that serve no query
    (decode-region padding, padding blocks, rows past a chunk's ``q_lens``)
    get length 0."""
    B = kv_lens.shape[0]
    T = blk_seq.shape[0] * blk
    t = torch.arange(T, device=kv_lens.device)
    seq = torch.where(t < meta[0], t, blk_seq.long().repeat_interleave(blk))
    s = seq.clamp(0, B - 1)
    i = t - q_starts.long()[s]
    n = q_lens.long()[s]
    valid = (seq >= 0) & (i >= 0) & (i < n)
    lens = torch.where(valid, kv_lens.long()[s] - n + i + 1, torch.zeros_like(i))
    return s.int(), lens.int()


def ragged_paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           kv_lens: torch.Tensor, q_starts: torch.Tensor,
                           q_lens: torch.Tensor, meta: torch.Tensor,
                           blk_seq: torch.Tensor, scale: float, blk: int, *,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           sliding_window: int | None = None,
                           logit_softcap: float | None = None) -> torch.Tensor:
    """The plain version of the ragged kernel's contract
    (``ops/ragged_paged.py``): one flat (T, Hq, D) stream, decode rows
    first (row r = sequence r, ``meta[0]`` of them), then ``blk``-aligned
    prefill chunks; ``blk_seq`` (T // blk,) names each prefill block's
    sequence (-1 elsewhere).  kv_lens/q_starts/q_lens: (B,) per sequence,
    kv_lens counting this step's rows.  Rows that serve no query return
    zeros, as the kernel writes them."""
    row_seq, row_lens = ragged_rows(kv_lens, q_starts, q_lens, meta, blk_seq, blk)
    out = ragged_reference_attention(
        q, k_cache, v_cache, block_tables, row_seq, row_lens, blk_seq, meta,
        blk, scale, k_scale=k_scale, v_scale=v_scale,
        sliding_window=sliding_window, logit_softcap=logit_softcap)
    return torch.where((row_lens > 0)[:, None, None], out, torch.zeros_like(out))


class PadDrop(NamedTuple):
    """Where a write of fixed shape sends each row, found on the device:
    real rows to their slots; padding rows (``PAD_SLOT``, or any slot out
    of range) to the first real row's slot, written with that row's value,
    so the duplicate write changes nothing; with no real row, every row to
    slot 0 with slot 0's own value.  Every shape is fixed and nothing is
    read back to the host, so a CUDA graph can capture the write: the
    counterpart of the JAX ``flat.at[slots].set(new, mode="drop")``."""
    index: torch.Tensor     # (N,) int64 slot each row writes
    keep: torch.Tensor      # (N,) bool real rows
    first: torch.Tensor     # (1,) int64 first real row (0 if none)
    any: torch.Tensor       # (1,) bool some row is real


def pad_drop(slots: torch.Tensor, num_slots: int) -> PadDrop:
    """The :class:`PadDrop` of flat ``slots`` in a cache of ``num_slots``;
    one per step serves every layer's writes.  (``first`` has shape (1,):
    indexing with a 0-d tensor would read it back to the host.)"""
    slots = slots.reshape(-1)
    keep = (slots >= 0) & (slots < num_slots)
    first = torch.argmax(keep.to(torch.uint8)).view(1)
    real = keep[first]
    fill = torch.where(real, slots[first], torch.zeros_like(slots[first]))
    return PadDrop(torch.where(keep, slots, fill).long(), keep, first, real)


def _write_rows(flat: torch.Tensor, new: torch.Tensor, slots: torch.Tensor,
                drop: PadDrop | None) -> None:
    """``new`` (N, ...) into the flat cache ``flat`` (slots, ...), every row
    placed by ``drop`` (made here when None)."""
    new = new.to(flat.dtype)
    if drop is None:
        drop = pad_drop(slots, flat.shape[0])
    fill = torch.where(drop.any, new[drop.first], flat[0])
    keep = drop.keep.view(-1, *([1] * (new.dim() - 1)))
    flat.index_copy_(0, drop.index, torch.where(keep, new, fill))


def write_kv_cache(cache: torch.Tensor, new: torch.Tensor, slots: torch.Tensor,
                   drop: PadDrop | None = None) -> None:
    """Scatter new K or V vectors into the paged cache, in place.

    cache: (num_blocks, block_size, Hkv, D); new: (N, Hkv, D) or
    (B, T, Hkv, D); slots: flat slot ids (block*block_size + offset) with
    the leading shape of ``new``.  ``PAD_SLOT`` entries are dropped: every
    row is written as ``drop`` places it (:func:`pad_drop`, made here if
    None), which reads nothing back to the host.
    """
    num_blocks, block_size, Hkv, D = cache.shape
    _write_rows(cache.view(num_blocks * block_size, Hkv, D),
                new.reshape(-1, Hkv, D), slots.reshape(-1), drop)


def write_kv_scales(scale_cache: torch.Tensor, scales: torch.Tensor,
                    slots: torch.Tensor, drop: PadDrop | None = None) -> None:
    """Scatter per-token scales into the paged (num_blocks, block_size, Hkv)
    scale array, in place; same ``PAD_SLOT`` / ``drop`` rules as
    :func:`write_kv_cache`."""
    nb, bs, Hkv = scale_cache.shape
    _write_rows(scale_cache.view(nb * bs, Hkv), scales.reshape(-1, Hkv),
                slots.reshape(-1), drop)


def write_kv_entry(entry: dict, k: torch.Tensor, v: torch.Tensor,
                   slots: torch.Tensor, drop: PadDrop | None = None) -> dict:
    """Write one layer's new K/V into its cache entry, in place, and return
    the entry.  An entry carrying ``ks``/``vs`` stores int8: values are
    quantized on write and the scales scattered alongside.  ``drop`` as
    :func:`write_kv_cache`; the drop plan is made once for all four
    writes."""
    if drop is None:
        drop = pad_drop(slots, entry["k"].shape[0] * entry["k"].shape[1])
    if "ks" in entry:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        write_kv_cache(entry["k"], qk, slots, drop)
        write_kv_cache(entry["v"], qv, slots, drop)
        write_kv_scales(entry["ks"], sk, slots, drop)
        write_kv_scales(entry["vs"], sv, slots, drop)
    else:
        write_kv_cache(entry["k"], k, slots, drop)
        write_kv_cache(entry["v"], v, slots, drop)
    return entry


def write_mla_entry(entry: dict, latent: torch.Tensor, slots: torch.Tensor,
                    latent_split: int | None = None,
                    drop: PadDrop | None = None) -> dict:
    """Write MLA latent vectors into a k-only cache entry, in place, and
    return the entry: MLA (DeepSeek) caches ONE (latent ⊕ roped-key) vector
    a token as a single kv head and no "v" pages; its decode and chunk
    paths read the "k" pages as both K and V.  latent: (..., D) with no
    head axis.

    An int8 entry ("ks") quantizes on write with TWO absmax scales a
    token, one for the rmsnorm'd latent slice (``:latent_split``) and one
    for the roped-key slice (``latent_split:``): their ranges are
    unrelated, so one shared scale would let a large rope channel crush
    the latent's precision.  The (num_blocks, block_size, 2) scales expand
    back to channels through ``scale_slices`` (:func:`expand_slice_scales`).
    ``drop`` as :func:`write_kv_cache`."""
    lat = latent[..., None, :]                     # the one-head axis
    if drop is None:
        drop = pad_drop(slots, entry["k"].shape[0] * entry["k"].shape[1])
    if "ks" in entry:
        if latent_split is None:
            raise ValueError("int8 MLA cache requires latent_split (the "
                             "kv_lora_rank) for per-slice scales")
        q1, s1 = quantize_kv(lat[..., :latent_split])
        q2, s2 = quantize_kv(lat[..., latent_split:])
        write_kv_cache(entry["k"], torch.cat([q1, q2], dim=-1), slots, drop)
        write_kv_scales(entry["ks"], torch.cat([s1, s2], dim=-1), slots, drop)
    else:
        write_kv_cache(entry["k"], lat, slots, drop)
    return entry


def expand_slice_scales(scales: torch.Tensor,
                        scale_slices: tuple[int, ...]) -> torch.Tensor:
    """(..., n_slices) per-slice scales -> (..., 1, D) channel scales,
    D = sum(scale_slices), broadcastable against (..., Hkv=1, D) pages."""
    per_chan = torch.cat([scales[..., i:i + 1].expand(*scales.shape[:-1], w)
                          for i, w in enumerate(scale_slices)], dim=-1)
    return per_chan[..., None, :]
