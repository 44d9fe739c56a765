"""Decoder-only transformer for the dense Qwen3/Qwen2/Llama/Phi-3/OPT/Gemma
family — the port of the serving entries of ``tpuserve/models/transformer.py``
(``prefill``, ``decode_step``, ``decode_multi``).

Parameters are the plain tree of ``models/weights.py``.  The functions run
eagerly on the tensors' device.  Unlike the JAX functions, which return a
new cache, they update ``kv_cache`` in place (no second copy of the cache
is ever made) and return it for symmetry.

``attn_impl``: "reference" runs the plain attention in ``ops/attention.py``;
"cuda" runs the kernel wrappers (``ops/flash_prefill.py``,
``ops/paged_decode.py``), which launch the CUDA kernels on CUDA tensors and
use the same plain versions on CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuserve_torch.models.config import ModelConfig
from tpuserve_torch.ops import attention as attn_ops
from tpuserve_torch.ops import rope as rope_ops
from tpuserve_torch.ops import sampling as sampling_ops
from tpuserve_torch.ops.flash_prefill import flash_prefill_attention
from tpuserve_torch.ops.paged_decode import paged_decode_attention

ATTN_IMPLS = ("reference", "cuda")


# --------------------------------------------------------------------------
# Normalisation, projections, MLP
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
            offset: float = 0.0) -> torch.Tensor:
    """``offset``: Gemma stores weights around zero and computes (1 + w)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (scale.float() + offset)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _norm(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps, cfg.norm_weight_offset)
    return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name in ("gelu", "gelu_pytorch_tanh"):
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name}")


def _mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_style == "gated":
        gate = _act(_linear(x, p["gate_proj"]), cfg.act)
        return _linear(gate * _linear(x, p["up_proj"]), p["down_proj"])
    return _linear(_act(_linear(x, p["fc1"]), cfg.act), p["fc2"])


def _attn_residual(out: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    att = _linear(out, lp["o_proj"])
    if cfg.sandwich_norms:
        att = _norm(att, lp["post_attn_norm"], cfg)
    return att


def _mlp_residual(h: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    m = _mlp(_norm(h, lp["mlp_norm"], cfg), lp, cfg)
    if cfg.sandwich_norms:
        m = _norm(m, lp["post_mlp_norm"], cfg)
    return m


def _qkv(h: torch.Tensor, lp: dict, cfg: ModelConfig, positions: torch.Tensor,
         layer_idx: int):
    """h: (..., H) -> q (..., Hq, D), k/v (..., Hkv, D) with qk-norm and
    RoPE (per-layer theta and linear scaling, as ``cfg.layer_rope``)."""
    lead = h.shape[:-1]
    q = _linear(h, lp["q_proj"]).reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = _linear(h, lp["k_proj"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = _linear(h, lp["v_proj"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"]["scale"], cfg.norm_eps, cfg.norm_weight_offset)
        k = rmsnorm(k, lp["k_norm"]["scale"], cfg.norm_eps, cfg.norm_weight_offset)
    if cfg.pos == "rope":
        rotary_dim = int(cfg.head_dim * cfg.partial_rotary_factor)
        theta, scaling = cfg.layer_rope(layer_idx)
        pos = positions
        if scaling != 1.0:
            pos = positions.float() / scaling
        cos, sin = rope_ops.rope_freqs(pos, cfg.head_dim, theta, rotary_dim,
                                       llama3_scaling=cfg.rope_llama3_scaling)
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
    return q, k, v


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    h = params["embed"]["weight"][tokens.long()]
    if cfg.embed_scale_by_sqrt_dim:
        h = h * torch.tensor(cfg.hidden_size ** 0.5, dtype=h.dtype)
    if cfg.pos == "learned":
        h = h + params["pos_embed"]["weight"][positions.long() + cfg.learned_pos_offset]
    return h


def _unembed(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.final_layernorm:
        h = _norm(h, params["final_norm"], cfg)
    if cfg.tie_word_embeddings:
        logits = h @ params["embed"]["weight"].T
    else:
        logits = _linear(h, params["lm_head"])
    logits = logits.float()
    if cfg.final_logit_softcapping:
        cap = cfg.final_logit_softcapping
        logits = cap * torch.tanh(logits / cap)
    return logits


def _check(cfg: ModelConfig, attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    if cfg.is_mla or cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA families are not ported yet "
            "(ROADMAP.md A8, model breadth)")


def _num_slots(kv_cache: list) -> int:
    return kv_cache[0]["k"].shape[0] * kv_cache[0]["k"].shape[1]


# --------------------------------------------------------------------------
# Prefill: full (padded) prompts, write the KV cache, return last logits
# --------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            prompt_lens: torch.Tensor, slot_ids: torch.Tensor, kv_cache: list,
            *, attn_impl: str = "reference"):
    """tokens: (B, T) right-padded prompts; prompt_lens: (B,) int32;
    slot_ids: (B, T) flat cache slots (``PAD_SLOT`` for padding); kv_cache:
    per-layer entries.  Returns (last-token logits (B, V) float32,
    kv_cache)."""
    _check(cfg, attn_impl)
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    rows = attn_ops.keep_rows(slot_ids.reshape(-1), _num_slots(kv_cache))
    h = _embed(params, cfg, tokens, positions)
    scale = cfg.attn_scale
    for li, lp in enumerate(params["layers"]):
        sw = cfg.layer_window(li)
        hn = _norm(h, lp["attn_norm"], cfg)
        q, k, v = _qkv(hn, lp, cfg, positions, li)
        # prefill attends over the FRESH k/v (full precision even when the
        # cache stores int8 — only cache reads see quantization)
        attn_ops.write_kv_entry(kv_cache[li], k, v, slot_ids, rows)
        if attn_impl == "cuda":
            out = flash_prefill_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), prompt_lens,
                scale, sliding_window=sw, logit_softcap=cfg.attn_logit_softcapping)
        else:
            out = attn_ops.prefill_attention(
                q, k, v, prompt_lens, scale, sliding_window=sw,
                logit_softcap=cfg.attn_logit_softcapping)
        h = h + _attn_residual(out.reshape(B, T, cfg.q_size), lp, cfg)
        h = h + _mlp_residual(h, lp, cfg)
    last = torch.clamp(prompt_lens.long() - 1, min=0)
    h_last = h[torch.arange(B, device=h.device), last]
    return _unembed(params, cfg, h_last), kv_cache


# --------------------------------------------------------------------------
# Decode: one token per sequence against the paged cache
# --------------------------------------------------------------------------

def window_slot(block_tables: torch.Tensor, pos: torch.Tensor,
                active: torch.Tensor, block_size: int) -> torch.Tensor:
    """Cache slot of each row's token at ``pos``, computed on the device;
    inactive (padding) rows get ``PAD_SLOT``."""
    page = torch.gather(block_tables, 1, (pos // block_size).long()[:, None])[:, 0]
    slot = page * block_size + pos % block_size
    return torch.where(active, slot, torch.full_like(slot, attn_ops.PAD_SLOT))


def _decode_body(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, slot_ids: torch.Tensor,
                 block_tables: torch.Tensor, seq_lens: torch.Tensor,
                 kv_cache: list, attn_impl: str, rows: torch.Tensor) -> torch.Tensor:
    """Single-token decode trunk: write each row's KV, then attend (so
    ``seq_lens`` includes the token).  Returns logits (B, V) float32."""
    B = tokens.shape[0]
    h = _embed(params, cfg, tokens, positions)                 # (B, H)
    scale = cfg.attn_scale
    attend = (paged_decode_attention if attn_impl == "cuda"
              else attn_ops.paged_decode_attention)
    for li, lp in enumerate(params["layers"]):
        hn = _norm(h, lp["attn_norm"], cfg)
        q, k, v = _qkv(hn, lp, cfg, positions, li)             # (B, H*, D)
        entry = attn_ops.write_kv_entry(kv_cache[li], k, v, slot_ids, rows)
        out = attend(q.contiguous(), entry["k"], entry["v"], block_tables,
                     seq_lens, scale, k_scale=entry.get("ks"),
                     v_scale=entry.get("vs"), sliding_window=cfg.layer_window(li),
                     logit_softcap=cfg.attn_logit_softcapping)
        h = h + _attn_residual(out.reshape(B, cfg.q_size), lp, cfg)
        h = h + _mlp_residual(h, lp, cfg)
    return _unembed(params, cfg, h)


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, slot_ids: torch.Tensor,
                block_tables: torch.Tensor, seq_lens: torch.Tensor,
                kv_cache: list, *, attn_impl: str = "reference"):
    """One decode step.  tokens/positions/slot_ids/seq_lens: (B,) int32;
    block_tables: (B, max_blocks) int32.  Returns (logits (B, V), kv_cache)."""
    _check(cfg, attn_impl)
    rows = attn_ops.keep_rows(slot_ids, _num_slots(kv_cache))
    logits = _decode_body(params, cfg, tokens, positions, slot_ids,
                          block_tables, seq_lens, kv_cache, attn_impl, rows)
    return logits, kv_cache


@torch.no_grad()
def decode_multi(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, block_tables: torch.Tensor,
                 seq_lens: torch.Tensor, active: torch.Tensor,
                 temperature: torch.Tensor, kv_cache: list, *, steps: int,
                 mode: str = "greedy", generators=None,
                 attn_impl: str = "reference"):
    """``steps`` fused decode+sample iterations; each sampled token feeds
    the next iteration on the device, and nothing is read back to the host
    inside the window (the JAX ``lax.scan`` becomes this loop).

    tokens/positions/seq_lens: (B,) int32 first-iteration state as in
    :func:`decode_step`; active: (B,) bool real rows (padding rows never
    write KV); temperature: (B,) float32.  ``mode``: "greedy" or
    "temperature"; the latter draws row ``i``'s noise from
    ``generators[i]`` (None for greedy and padding rows).  Cache slots for
    the whole window must be reserved.  Returns (tokens (B, steps) int32,
    kv_cache)."""
    _check(cfg, attn_impl)
    if mode not in ("greedy", "temperature"):
        raise NotImplementedError(
            f"decode_multi mode {mode!r} is not ported yet (ROADMAP.md A6, "
            "the full sampler)")
    block_size = kv_cache[0]["k"].shape[1]
    # the active rows are fixed for the window: find them once (one read)
    rows = torch.nonzero(active).flatten()
    outs = []
    toks, pos, lens = tokens, positions, seq_lens
    for _ in range(steps):
        slot = window_slot(block_tables, pos, active, block_size)
        logits = _decode_body(params, cfg, toks, pos, slot, block_tables, lens,
                              kv_cache, attn_impl, rows)
        if mode == "greedy":
            nxt = sampling_ops.sample_tokens(logits, mode="greedy")
        else:
            noise = sampling_ops.gumbel_noise(generators, logits.shape[-1],
                                              logits.device)
            nxt = sampling_ops.sample_tokens(logits, temperature,
                                             mode="temperature", gumbel=noise)
        outs.append(nxt)
        toks, pos, lens = nxt, pos + 1, lens + 1
    return torch.stack(outs, dim=1), kv_cache
