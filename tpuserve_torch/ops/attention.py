"""Plain PyTorch attention and KV-cache ops — the port of the reference
ops in ``tpuserve/ops/attention.py``.

These are the semantics the CUDA kernels (``ops/flash_prefill.py``,
``ops/paged_decode.py``) are held to on the card, and the path every op
takes for tensors on the CPU.  Two deliberate differences from the JAX
reference, both matching the kernels:

- V rows outside a row's valid key range are zeroed before P·V.  Cache
  pages made with ``torch.empty`` may hold NaN, and 0 * NaN would poison
  the output even though those probabilities are exactly 0.
- Paged-decode rows with ``seq_len == 0`` (batch padding) return zeros.

Cache writes update the cache tensors in place (the JAX ops return new
arrays); slots equal to ``PAD_SLOT`` are dropped.
"""

from __future__ import annotations

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

    q: (B, T, Hq, D); k, v: (B, T, Hkv, D); prompt_lens: (B,) valid lengths.
    ``sliding_window``: row p attends keys in (p - W, p].  Returns
    (B, T, Hq, D) in q.dtype; scores and softmax in float32.  Rows at or
    past ``prompt_lens`` are unspecified.
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
                           logit_softcap: float | None = None) -> torch.Tensor:
    """Single-token decode attention against a paged KV cache.

    q: (B, Hq, D); k_cache/v_cache: (num_blocks, block_size, Hkv, D);
    block_tables: (B, max_blocks) physical block ids; seq_lens: (B,) tokens
    in cache per sequence, including the one being decoded.
    ``k_scale``/``v_scale``: (num_blocks, block_size, Hkv) float32 scales
    when the cache stores int8 (dequantized into q.dtype).
    ``sliding_window``: attend only the last W cached positions.
    Returns (B, Hq, D) in q.dtype.
    """
    B, Hq, D = q.shape
    _, block_size, Hkv, _ = k_cache.shape
    S = block_tables.shape[1] * block_size
    bt = block_tables.long()
    k = k_cache[bt].reshape(B, S, Hkv, D)
    v = v_cache[bt].reshape(B, S, Hkv, D)
    if k_scale is not None:
        k = dequantize_kv(k, k_scale[bt].reshape(B, S, Hkv), q.dtype)
        v = dequantize_kv(v, v_scale[bt].reshape(B, S, Hkv), q.dtype)
    pos = torch.arange(S, device=q.device)[None, :]
    lens = seq_lens.to(q.device)[:, None]
    valid = pos < lens                                              # (B, S)
    if sliding_window is not None:
        valid = valid & (pos >= lens - sliding_window)
    v = torch.where(valid[:, :, None, None], v, torch.zeros_like(v))
    n_rep = Hq // Hkv
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    scores = _softcap(scores, logit_softcap)
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    # a seq_len == 0 row has every V row zeroed, so it returns zeros
    out = torch.einsum("bhk,bkhd->bhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def keep_rows(slots: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Indices of the non-padding entries of flat ``slots``.  Reads the
    mask back to the host once (a sync on the card); callers that know the
    real rows in advance pass them as ``rows`` instead."""
    keep = (slots >= 0) & (slots < num_slots)
    return torch.nonzero(keep).flatten()


def write_kv_cache(cache: torch.Tensor, new: torch.Tensor, slots: torch.Tensor,
                   rows: torch.Tensor | None = None) -> None:
    """Scatter new K or V vectors into the paged cache, in place.

    cache: (num_blocks, block_size, Hkv, D); new: (N, Hkv, D) or
    (B, T, Hkv, D); slots: flat slot ids (block*block_size + offset) with
    the leading shape of ``new``.  ``PAD_SLOT`` entries are dropped:
    ``rows`` (indices into the flattened ``slots``) names the entries to
    write, or None to find them here.
    """
    num_blocks, block_size, Hkv, D = cache.shape
    flat = cache.view(num_blocks * block_size, Hkv, D)
    slots = slots.reshape(-1)
    new = new.reshape(-1, Hkv, D)
    if rows is None:
        rows = keep_rows(slots, flat.shape[0])
    flat.index_copy_(0, slots[rows].long(), new[rows].to(cache.dtype))


def write_kv_scales(scale_cache: torch.Tensor, scales: torch.Tensor,
                    slots: torch.Tensor, rows: torch.Tensor | None = None) -> None:
    """Scatter per-token scales into the paged (num_blocks, block_size, Hkv)
    scale array, in place; same ``PAD_SLOT`` / ``rows`` rules as
    :func:`write_kv_cache`."""
    nb, bs, Hkv = scale_cache.shape
    flat = scale_cache.view(nb * bs, Hkv)
    slots = slots.reshape(-1)
    scales = scales.reshape(-1, Hkv)
    if rows is None:
        rows = keep_rows(slots, flat.shape[0])
    flat.index_copy_(0, slots[rows].long(), scales[rows].to(scale_cache.dtype))


def write_kv_entry(entry: dict, k: torch.Tensor, v: torch.Tensor,
                   slots: torch.Tensor, rows: torch.Tensor | None = None) -> dict:
    """Write one layer's new K/V into its cache entry, in place, and return
    the entry.  An entry carrying ``ks``/``vs`` stores int8: values are
    quantized on write and the scales scattered alongside."""
    if rows is None:
        rows = keep_rows(slots.reshape(-1),
                          entry["k"].shape[0] * entry["k"].shape[1])
    if "ks" in entry:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        write_kv_cache(entry["k"], qk, slots, rows)
        write_kv_cache(entry["v"], qv, slots, rows)
        write_kv_scales(entry["ks"], sk, slots, rows)
        write_kv_scales(entry["vs"], sv, slots, rows)
    else:
        write_kv_cache(entry["k"], k, slots, rows)
        write_kv_cache(entry["v"], v, slots, rows)
    return entry
