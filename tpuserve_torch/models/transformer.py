"""Decoder-only transformer for the Qwen3/Qwen2/Llama/Mistral/Phi-3/OPT/
Gemma families, Qwen3-MoE and DeepSeek's multi-head latent attention (MLA)
— the port of the serving entries of
``tpuserve/models/transformer.py`` (``prefill``, ``prefill_chunk``,
``decode_step``, ``decode_multi``, ``forward_ragged``), speculative
decoding's verify pass (``decode_verify``, ``decode_verify_sampled``) and
its stateless draft (``draft_propose``), and the cache-less trunks behind
embeddings and prompt scoring (``embed_forward``, ``score_prompt``).

Parameters are the plain tree of ``models/weights.py``, in the model's
dtype or with int8 weights (``weights.quantize_params_int8``: an int8
``kernel`` with a float32 per-output-channel ``scale``, stacked experts
with (E, out) scales, the embedding with a scale a vocabulary row), and
with a multi-LoRA stack (``weights.load_lora_stack``: a ``lora`` entry of
stacked factors beside a targeted kernel) selected per row by ``ad`` (B,
n) one-hot adapter weights, all-zero for the base model.  The functions run
eagerly on the tensors' device.  Unlike the JAX functions, which return a
new cache, they update ``kv_cache`` in place (no second copy of the cache
is ever made) and return it for symmetry.

``attn_impl``: "reference" runs the plain attention in ``ops/attention.py``;
"cuda" runs the kernel wrappers (``ops/flash_prefill.py``,
``ops/paged_decode.py``, ``ops/paged_window.py``, ``ops/ragged_paged.py``),
which launch the CUDA kernels on CUDA tensors and use the same plain
versions on CPU tensors.  The verify pass runs the paged window kernel and
the cache-less trunks the flash prefill kernel; the JAX engine keeps all
of them on its plain attention, which the "reference" path reproduces.
Under tensor and expert parallelism (``parallel/``) ``cfg`` is a rank's
(``sharding.rank_config``): its own heads, MLP columns and experts, and
``cfg.comm``, whose sums stand where GSPMD inserted collectives in the JAX
package: after the row-parallel o_proj and down_proj / fc2, in the
vocabulary-parallel embedding, gathering the vocabulary-parallel logits,
and over the MoE experts' partial sums.  The kernels run on the rank's
local heads as they are (``sharding.tp_partitionable``).
MLA runs the plain attention on every path whatever ``attn_impl`` says,
by an explicit branch, as the JAX package runs it: its latent cache has
one head 576 wide and its values are narrower than its keys, shapes no
kernel takes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpuserve_torch.models.config import ModelConfig
from tpuserve_torch.models.weights import param_dtype
from tpuserve_torch.ops import attention as attn_ops
from tpuserve_torch.ops import rope as rope_ops
from tpuserve_torch.ops import sampling as sampling_ops
from tpuserve_torch.ops.flash_prefill import flash_prefill_attention
from tpuserve_torch.ops.paged_decode import paged_decode_attention
from tpuserve_torch.ops.paged_window import paged_window_attention
from tpuserve_torch.ops.ragged_paged import ragged_paged_attention

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


def _linear(x: torch.Tensor, p: dict, ad: torch.Tensor | None = None) -> torch.Tensor:
    if "scale" in p:
        # int8 weight-only: the per-output-channel scale applies after the
        # product, in x's dtype, as the JAX ``_linear``
        y = (x @ p["kernel"].to(x.dtype)) * p["scale"].to(x.dtype)
    else:
        y = x @ p["kernel"]
    if ad is not None and "lora" in p:
        y = y + _lora_delta(x, p["lora"], ad)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _row_linear(x: torch.Tensor, p: dict, cfg: ModelConfig,
                ad: torch.Tensor | None = None) -> torch.Tensor:
    """A row-parallel projection (o_proj, down_proj, fc2).  Under tensor
    parallelism a rank holds a block of the kernel's input rows
    (``parallel/sharding.py``), so its product is a partial sum: summed over
    the rank's tp group (the all-reduce GSPMD inserts after the row-sharded
    product), then the replicated bias adds once."""
    comm = cfg.comm
    if comm is None or comm.tp == 1:
        return _linear(x, p, ad)
    y = comm.tp_sum(_linear(x, {k: v for k, v in p.items() if k != "bias"}, ad))
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _tp_in(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The replicated input of a column-parallel product under tensor
    parallelism: as it is (``RankComm``); under training's autograd
    (``parallel/train.py``) its gradient is summed over the tp group."""
    comm = cfg.comm
    return x if comm is None or comm.tp == 1 else comm.tp_enter(x)


def _lora_delta(x: torch.Tensor, la: dict, ad: torch.Tensor) -> torch.Tensor:
    """Per-row multi-LoRA contribution (``weights.load_lora_stack``'s
    layout), the JAX ``_lora_delta``: ``ad`` (B, n) one-hot adapter weights
    a row (all-zero: the base model) fold the stacked A (n, H, r) and B (n,
    r, W) into per-row (H, r) / (r, W) factors, then the rank-r bottleneck
    applies.  Dense over the adapters: mixed-adapter batches run in one
    step with no gather.  x: (B, H) or (B, T, H)."""
    A = la["A"].to(x.dtype)
    Bm = la["B"].to(x.dtype)
    adx = ad.to(x.dtype)
    Ar = torch.einsum("bn,nhr->bhr", adx, A)
    Br = torch.einsum("bn,nrw->brw", adx, Bm)
    if x.dim() == 2:
        return torch.einsum("bh,bhr,brw->bw", x, Ar, Br)
    return torch.einsum("bth,bhr,brw->btw", x, Ar, Br)


def adapter_rows(adapter: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """(rows, n) one-hot adapter weights from (rows,) int32 adapter
    indices, -1 (all-zero) for the base model, made on the device (the
    step executables stage indices, not the float one-hot)."""
    idx = torch.arange(n, device=adapter.device)
    return (adapter.long()[:, None] == idx[None, :]).to(dtype)

def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name in ("gelu", "gelu_pytorch_tanh"):
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name}")


def _mlp(x: torch.Tensor, p: dict, cfg: ModelConfig,
         ad: torch.Tensor | None = None) -> torch.Tensor:
    # branch on the PARAMS, as the JAX package: DeepSeek keeps its first
    # moe_first_k_dense layers dense inside an MoE model
    if "experts" in p:
        return _moe_mlp(x, p, cfg)
    x = _tp_in(x, cfg)
    if cfg.mlp_style == "gated":
        gate = _act(_linear(x, p["gate_proj"], ad), cfg.act)
        return _row_linear(gate * _linear(x, p["up_proj"], ad), p["down_proj"], cfg, ad)
    return _row_linear(_act(_linear(x, p["fc1"], ad), cfg.act), p["fc2"], cfg, ad)


# An MoE layer runs its experts in groups whose gate, up and activation
# tensors hold at most this many values each (rows x experts x width):
# the transients stay bounded at any batch, and each step's shapes static.
MOE_GROUP_VALUES = 1 << 24


def moe_group(cfg: ModelConfig, rows: int) -> int:
    """Experts one group of an MoE layer runs together for ``rows`` token
    rows: the largest divisor of ``num_experts`` within
    ``MOE_GROUP_VALUES`` (at least 1)."""
    E, width = cfg.num_experts, cfg.expert_intermediate_size
    return next((g for g in range(E, 0, -1)
                 if E % g == 0 and rows * g * width <= MOE_GROUP_VALUES), 1)


def _expert_kernels(ep: dict, e0: int, g: int, dtype: torch.dtype) -> torch.Tensor:
    """Experts ``e0 .. e0 + g`` of a stacked (E, n_in, n_out) projection in
    ``dtype``: int8 kernels (``weights.quantize_params_int8``) dequantized
    by their (E, n_out) scales, one group's copy at a time."""
    w = ep["kernel"][e0:e0 + g]
    if "scale" not in ep:
        return w
    # one kernel: int8 values times the scale promote to ``dtype``
    return w * ep["scale"][e0:e0 + g, None, :].to(dtype)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, in ``jax.lax.top_k``'s order:
    descending, ties to the lower index (a stable sort; ``torch.topk``
    promises no order among ties, and bf16 router logits tie often)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mixture-of-experts MLP, the JAX package's ``_moe_mlp``: a softmax
    (Qwen3-MoE) or sigmoid (DeepSeek-V3) router scores the experts; the
    selection adds the float32 correction bias and may keep only the best
    ``moe_topk_group`` of ``moe_n_group`` groups (V3: a group's top-2 sum,
    V2: its max; the others masked to 0.0, not -inf); the top-k experts'
    unbiased scores, renormalised (``norm_topk_prob``) and scaled
    (``moe_routed_scaling``), weight their gated-MLP outputs; shared
    experts add an always-on MLP.

    Dispatch is dense, as in the JAX package: every expert runs on every
    token, the unchosen ones with weight 0.  The combine weight is folded
    in before the down projection (sum_e c_e (h_e W_e) = sum_e (c_e h_e)
    W_e), so a group of g experts is three products, the last one (T, g I)
    by (g I, H) into a float32 sum, and no (T, E, H) tensor exists; groups
    of ``moe_group`` experts bound the (g, T, I) transients.  int8 experts
    are dequantized a group at a time (:func:`_expert_kernels`), so the
    scale applies before the products, where the JAX package scales their
    outputs: the same values to rounding.

    Under expert parallelism a rank holds ``cfg.num_experts`` (E / ep) of
    the stacked experts, those from ``ep_rank * E / ep``; the router still
    scores all E, and the rank's partial sum is summed over its ep group
    (the JAX package's one psum) before the shared experts add."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])                              # (T, H)
    T = xt.shape[0]
    router = _linear(xt, p["router"]).float()                  # (T, E)
    sigmoid = cfg.moe_scoring == "sigmoid"
    scores = torch.sigmoid(router) if sigmoid else torch.softmax(router, dim=-1)
    choice = scores
    if "router_bias" in p:
        choice = choice + p["router_bias"]["bias"].float()[None, :]
    if cfg.moe_n_group > 1:
        E, G = scores.shape[-1], cfg.moe_n_group
        grouped = choice.reshape(T, G, E // G)
        if sigmoid:
            group_scores = _top_k(grouped, 2)[0].sum(dim=-1)
        else:
            group_scores = grouped.max(dim=-1).values
        _, gidx = _top_k(group_scores, cfg.moe_topk_group)
        gmask = torch.zeros_like(group_scores).scatter_(1, gidx, 1.0)      # (T, G)
        choice = torch.where(gmask[..., None] > 0, grouped, 0.0).reshape(T, E)
    _, topi = _top_k(choice, cfg.num_experts_per_tok)          # (T, k)
    topv = scores.gather(-1, topi)                             # unbiased
    if cfg.norm_topk_prob:
        # HF adds 1e-20 on the sigmoid path (sums are not 1 there)
        topv = topv / (topv.sum(dim=-1, keepdim=True) + (1e-20 if sigmoid else 0.0))
    if cfg.moe_routed_scaling != 1.0:
        topv = topv * cfg.moe_routed_scaling
    combine = torch.zeros_like(scores).scatter_(1, topi, topv).to(xt.dtype)   # (T, E)

    ek = p["experts"]
    E, width = cfg.num_experts, cfg.expert_intermediate_size
    # under expert parallelism these are the rank's E / ep experts, the
    # ep_rank-th block of the router's columns
    off = cfg.comm.ep_rank * E if cfg.comm is not None else 0
    g = moe_group(cfg, T)
    y = torch.zeros((T, shape[-1]), dtype=torch.float32, device=xt.device)
    for e0 in range(0, E, g):
        gate = torch.matmul(xt, _expert_kernels(ek["gate_proj"], e0, g, xt.dtype))  # (g, T, I)
        up = torch.matmul(xt, _expert_kernels(ek["up_proj"], e0, g, xt.dtype))
        act = _act(gate, cfg.act) * up * combine[:, off + e0:off + e0 + g].T[:, :, None]
        down = _expert_kernels(ek["down_proj"], e0, g, xt.dtype).reshape(g * width, -1)
        y += act.transpose(0, 1).reshape(T, g * width) @ down
    if cfg.comm is not None:
        y = cfg.comm.ep_sum(y)       # the JAX package's one psum over ep
    y = y.to(xt.dtype)
    if "shared" in p:
        # DeepSeek's shared experts: a plain gated MLP beside the routed ones
        y = y + _mlp(xt, p["shared"], cfg)
    return y.reshape(shape)


def _attn_residual(out: torch.Tensor, lp: dict, cfg: ModelConfig,
                   ad: torch.Tensor | None = None) -> torch.Tensor:
    att = _row_linear(out, lp["o_proj"], cfg, ad)
    if cfg.sandwich_norms:
        att = _norm(att, lp["post_attn_norm"], cfg)
    return att


def _mlp_residual(h: torch.Tensor, lp: dict, cfg: ModelConfig,
                  ad: torch.Tensor | None = None) -> torch.Tensor:
    m = _mlp(_norm(h, lp["mlp_norm"], cfg), lp, cfg, ad)
    if cfg.sandwich_norms:
        m = _norm(m, lp["post_mlp_norm"], cfg)
    return m


def _qkv(h: torch.Tensor, lp: dict, cfg: ModelConfig, positions: torch.Tensor,
         layer_idx: int, ad: torch.Tensor | None = None):
    """h: (..., H) -> q (..., Hq, D), k/v (..., Hkv, D) with qk-norm and
    RoPE (per-layer theta and linear scaling, as ``cfg.layer_rope``)."""
    lead = h.shape[:-1]
    h = _tp_in(h, cfg)
    q = _linear(h, lp["q_proj"], ad).reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = _linear(h, lp["k_proj"], ad).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = _linear(h, lp["v_proj"], ad).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
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


# --------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek MLA), the JAX package's functions
# --------------------------------------------------------------------------
#
# The cache holds ONE vector a token: the rmsnorm'd kv_lora_rank latent and
# a single shared roped key (cfg.mla_latent_dim wide, one head).  Prefill and
# the cache-less trunks decompress per-head K/V (the naive form); chunks,
# the verify pass, decode and mixed steps run the ABSORBED form: W_UK folds
# into the query and W_UV into the output, so attention runs in latent space
# and the paged op reads the latent pages as both K and V.

def _mla_proj(hn: torch.Tensor, lp: dict, cfg: ModelConfig, positions: torch.Tensor,
              ad: torch.Tensor | None = None):
    """q_nope (..., H, nope), roped q_rope (..., H, rope), and the
    cache-ready latent (..., latent_dim) = rmsnorm(c_kv) ⊕ roped key."""
    if "q_a_proj" in lp:
        cq = rmsnorm(_linear(hn, lp["q_a_proj"], ad), lp["q_a_norm"]["scale"],
                     cfg.norm_eps, cfg.norm_weight_offset)
        q = _linear(cq, lp["q_b_proj"], ad)
    else:
        q = _linear(hn, lp["q_proj"], ad)
    q = q.reshape(*hn.shape[:-1], cfg.num_heads, cfg.head_dim)
    nope = cfg.mla_qk_nope_head_dim
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = _linear(hn, lp["kv_a_proj"], ad)
    c = rmsnorm(ckv[..., :cfg.mla_kv_lora_rank], lp["kv_a_norm"]["scale"],
                cfg.norm_eps, cfg.norm_weight_offset)
    k_rope = ckv[..., cfg.mla_kv_lora_rank:]
    cos, sin = rope_ops.rope_freqs(positions, cfg.mla_qk_rope_head_dim, cfg.rope_theta,
                                   yarn_scaling=cfg.rope_yarn)
    q_rope = rope_ops.apply_rope(q_rope, cos, sin)
    k_rope = rope_ops.apply_rope(k_rope[..., None, :], cos, sin)[..., 0, :]
    return q_nope, q_rope, torch.cat([c, k_rope], dim=-1)


def _mla_kv_b(lp: dict, cfg: ModelConfig, dtype: torch.dtype) -> tuple:
    """kv_b_proj split into W_UK (kv_lora, H, nope) and W_UV (kv_lora, H, v),
    dequantized when the kernel is int8."""
    p = lp["kv_b_proj"]
    w = (p["kernel"] * p["scale"][None].to(dtype) if "scale" in p
         else p["kernel"].to(dtype))
    w = w.reshape(cfg.mla_kv_lora_rank, cfg.num_heads,
                  cfg.mla_qk_nope_head_dim + cfg.mla_v_head_dim)
    return w[..., :cfg.mla_qk_nope_head_dim], w[..., cfg.mla_qk_nope_head_dim:]


def _mla_decompress(latent: torch.Tensor, lp: dict, cfg: ModelConfig, dtype: torch.dtype):
    """Per-head K (..., H, head_dim) and V (..., H, v_dim) from latents
    (..., T, latent_dim): the naive form of the full-sequence paths."""
    w_uk, w_uv = _mla_kv_b(lp, cfg, dtype)
    c = latent[..., :cfg.mla_kv_lora_rank]
    k_nope = torch.einsum("...tc,chn->...thn", c, w_uk)
    v = torch.einsum("...tc,chv->...thv", c, w_uv)
    k_rope = latent[..., None, cfg.mla_kv_lora_rank:].expand(
        *k_nope.shape[:-1], cfg.mla_qk_rope_head_dim)
    return torch.cat([k_nope, k_rope], dim=-1), v


def _mla_naive_qkv(hn: torch.Tensor, lp: dict, cfg: ModelConfig, positions: torch.Tensor,
                   ad: torch.Tensor | None = None):
    """The :func:`_qkv` of the cache-less MLA paths: the full q and the
    decompressed per-head k, v (v ``mla_v_head_dim`` wide)."""
    q_nope, q_rope, latent = _mla_proj(hn, lp, cfg, positions, ad)
    k, v = _mla_decompress(latent, lp, cfg, q_nope.dtype)
    return torch.cat([q_nope, q_rope], dim=-1), k, v


def _mla_absorb_q(q_nope: torch.Tensor, q_rope: torch.Tensor, lp: dict,
                  cfg: ModelConfig) -> torch.Tensor:
    """W_UK folded into the query (q_lat . c == q_nope . k_nope); the roped
    dims ride alongside."""
    w_uk, _ = _mla_kv_b(lp, cfg, q_nope.dtype)
    q_lat = torch.einsum("...hn,chn->...hc", q_nope, w_uk)
    return torch.cat([q_lat, q_rope], dim=-1)


def _mla_unabsorb(out_lat: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """Latent-space attention output -> per-head values through W_UV; only
    the first kv_lora_rank columns are the value contraction, the rope
    tail is dropped."""
    _, w_uv = _mla_kv_b(lp, cfg, out_lat.dtype)
    return torch.einsum("...hc,chv->...hv", out_lat[..., :cfg.mla_kv_lora_rank], w_uv)


def _mla_slices(cfg: ModelConfig) -> tuple[int, int]:
    """The latent cache's int8 scale slices: the latent, then the rope."""
    return (cfg.mla_kv_lora_rank, cfg.mla_qk_rope_head_dim)


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    ids = tokens.long()
    comm = cfg.comm
    vocab_parallel = comm is not None and comm.tp > 1
    if vocab_parallel:
        # a rank holds the tp_rank-th block of the vocabulary's rows: it
        # looks up the ids it holds, zeros elsewhere, and the tp sum fills
        # every row (one non-zero term: exact)
        rows = params["embed"]["weight"].shape[0]
        local = ids - comm.tp_rank * rows
        held = (local >= 0) & (local < rows)
        ids = torch.where(held, local, 0)
    h = params["embed"]["weight"][ids]
    if "scale" in params["embed"]:        # int8: a scale a vocabulary row
        dtype = param_dtype(cfg)
        h = h.to(dtype) * params["embed"]["scale"][ids][..., None].to(dtype)
    if vocab_parallel:
        h = comm.tp_sum(h * held[..., None].to(h.dtype))
    if cfg.embed_scale_by_sqrt_dim:
        h = h * torch.tensor(cfg.hidden_size ** 0.5, dtype=h.dtype)
    if cfg.pos == "learned":
        h = h + params["pos_embed"]["weight"][positions.long() + cfg.learned_pos_offset]
    return h


def _unembed(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.final_layernorm:
        h = _norm(h, params["final_norm"], cfg)
    h = _tp_in(h, cfg)              # vocabulary-parallel: columns of the logits
    if cfg.tie_word_embeddings:
        ew = params["embed"]
        if "scale" in ew:                 # tied int8: a scale a logit column
            # a float32 scale: the product promotes to float32, as in JAX
            logits = (h @ ew["weight"].T.to(h.dtype)) * ew["scale"][None, :]
        else:
            logits = h @ ew["weight"].T
    else:
        logits = _linear(h, params["lm_head"])
    logits = logits.float()
    comm = cfg.comm
    if comm is not None and comm.tp > 1:
        # vocabulary-parallel: this rank's block of columns, gathered to
        # every rank as a sum into a zero-filled full-vocabulary buffer (the
        # logits' all-gather with the one collective gloo's CUDA tensors take)
        part = logits.shape[-1]
        full = logits.new_zeros((*logits.shape[:-1], part * comm.tp))
        full[..., comm.tp_rank * part:(comm.tp_rank + 1) * part] = logits
        logits = comm.tp_sum(full)
    if cfg.final_logit_softcapping:
        cap = cfg.final_logit_softcapping
        logits = cap * torch.tanh(logits / cap)
    return logits


def _check(cfg: ModelConfig, attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")


def _num_slots(kv_cache: list) -> int:
    return kv_cache[0]["k"].shape[0] * kv_cache[0]["k"].shape[1]


# --------------------------------------------------------------------------
# Prefill: full (padded) prompts, write the KV cache, return last logits
# --------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            prompt_lens: torch.Tensor, slot_ids: torch.Tensor, kv_cache: list,
            ad: torch.Tensor | None = None, *, attn_impl: str = "reference",
            microbatches: int = 0):
    """tokens: (B, T) right-padded prompts; prompt_lens: (B,) int32;
    slot_ids: (B, T) flat cache slots (``PAD_SLOT`` for padding); kv_cache:
    per-layer entries; ad: (B, n) adapter weights with a LoRA stack;
    microbatches: a pipeline stage's count (0: auto).
    Returns (last-token logits (B, V) float32, kv_cache)."""
    _check(cfg, attn_impl)
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    n_slots = _num_slots(kv_cache)

    def layers(h, r):
        return _prefill_layers(params, cfg, h, positions[r], prompt_lens[r], slot_ids[r],
                               attn_ops.pad_drop(slot_ids[r], n_slots), kv_cache,
                               attn_impl, None if ad is None else ad[r])

    def last_rows(h, r):
        last = torch.clamp(prompt_lens[r].long() - 1, min=0)
        return h[torch.arange(h.shape[0], device=h.device), last]

    if cfg.stage is None:
        rows = slice(None)
        h_last = last_rows(layers(_embed(params, cfg, tokens, positions), rows), rows)
    else:
        H = cfg.hidden_size
        h_last = cfg.stage.trunk(
            "prefill", B, (T, H), (H,), param_dtype(cfg),
            lambda r: _embed(params, cfg, tokens[r], positions[r]), layers, last_rows,
            microbatches)
        if h_last is None:          # a later stage: stage 0 unembeds
            return None, kv_cache
    return _unembed(params, cfg, h_last), kv_cache


def _prefill_layers(params: dict, cfg: ModelConfig, h: torch.Tensor,
                    positions: torch.Tensor, prompt_lens: torch.Tensor,
                    slot_ids: torch.Tensor, drop, kv_cache: list, attn_impl: str,
                    ad: torch.Tensor | None) -> torch.Tensor:
    """:func:`prefill`'s layer loop over (B, T, H) hidden rows: write each
    layer's KV, attend causally over the fresh prompt K/V."""
    B, T = h.shape[:2]
    scale = cfg.attn_scale
    for li, lp in enumerate(params["layers"]):
        sw = cfg.layer_window(li)
        hn = _norm(h, lp["attn_norm"], cfg)
        if cfg.is_mla:
            # cache the latent; attend naively (decompressed) over the fresh
            # prompt K/V on the plain attention
            q_nope, q_rope, latent = _mla_proj(hn, lp, cfg, positions, ad)
            attn_ops.write_mla_entry(kv_cache[li], latent, slot_ids,
                                     latent_split=cfg.mla_kv_lora_rank, drop=drop)
            k, v = _mla_decompress(latent, lp, cfg, q_nope.dtype)
            out = attn_ops.prefill_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                                             prompt_lens, scale)
            h = h + _attn_residual(out.reshape(B, T, cfg.attn_out_size), lp, cfg, ad)
            h = h + _mlp_residual(h, lp, cfg, ad)
            continue
        q, k, v = _qkv(hn, lp, cfg, positions, li, ad)
        # prefill attends over the FRESH k/v (full precision even when the
        # cache stores int8 — only cache reads see quantization)
        attn_ops.write_kv_entry(kv_cache[li], k, v, slot_ids, drop=drop)
        if attn_impl == "cuda":
            out = flash_prefill_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), prompt_lens,
                scale, sliding_window=sw, logit_softcap=cfg.attn_logit_softcapping)
        else:
            out = attn_ops.prefill_attention(
                q, k, v, prompt_lens, scale, sliding_window=sw,
                logit_softcap=cfg.attn_logit_softcapping)
        h = h + _attn_residual(out.reshape(B, T, cfg.q_size), lp, cfg, ad)
        h = h + _mlp_residual(h, lp, cfg, ad)
    return h


# --------------------------------------------------------------------------
# Chunked prefill: one bounded chunk of a prompt against the cache
# --------------------------------------------------------------------------

def _chunk_trunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 ctx_lens: torch.Tensor, chunk_lens: torch.Tensor,
                 slot_ids: torch.Tensor, block_tables: torch.Tensor,
                 kv_cache: list, attn_impl: str,
                 ad: torch.Tensor | None = None) -> torch.Tensor:
    """Layer loop for cache-relative windows: write the window's KV, then
    attend the cached context plus causally within the window.  Returns
    the final hidden states (B, C, H)."""
    B, C = tokens.shape
    positions = ctx_lens.long()[:, None] + torch.arange(C, device=tokens.device)[None, :]
    drop = attn_ops.pad_drop(slot_ids, _num_slots(kv_cache))
    h = _embed(params, cfg, tokens, positions)
    scale = cfg.attn_scale
    attend = (paged_window_attention if attn_impl == "cuda"
              else attn_ops.chunked_prefill_attention)
    for li, lp in enumerate(params["layers"]):
        hn = _norm(h, lp["attn_norm"], cfg)
        if cfg.is_mla:
            # write the latent; attend ABSORBED against the latent pages
            # (k == v == latent) on the plain attention
            q_nope, q_rope, latent = _mla_proj(hn, lp, cfg, positions, ad)
            entry = attn_ops.write_mla_entry(kv_cache[li], latent, slot_ids,
                                             latent_split=cfg.mla_kv_lora_rank, drop=drop)
            out = attn_ops.chunked_prefill_attention(
                _mla_absorb_q(q_nope, q_rope, lp, cfg), entry["k"], entry["k"],
                block_tables, ctx_lens, chunk_lens, scale, k_scale=entry.get("ks"),
                v_scale=entry.get("ks"), scale_slices=_mla_slices(cfg))
            out = _mla_unabsorb(out, lp, cfg)
        else:
            q, k, v = _qkv(hn, lp, cfg, positions, li, ad)
            entry = attn_ops.write_kv_entry(kv_cache[li], k, v, slot_ids, drop=drop)
            out = attend(q.contiguous(), entry["k"], entry["v"], block_tables,
                         ctx_lens, chunk_lens, scale, k_scale=entry.get("ks"),
                         v_scale=entry.get("vs"), sliding_window=cfg.layer_window(li),
                         logit_softcap=cfg.attn_logit_softcapping)
        h = h + _attn_residual(out.reshape(B, C, cfg.attn_out_size), lp, cfg, ad)
        h = h + _mlp_residual(h, lp, cfg, ad)
    return h


@torch.no_grad()
def prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  ctx_lens: torch.Tensor, chunk_lens: torch.Tensor,
                  slot_ids: torch.Tensor, block_tables: torch.Tensor,
                  kv_cache: list, ad: torch.Tensor | None = None, *,
                  attn_impl: str = "reference"):
    """One chunk of each prompt against the paged cache.  tokens: (B, C)
    right-padded chunk tokens; ctx_lens: (B,) int32 tokens already cached
    before the chunk; chunk_lens: (B,) int32 valid chunk tokens; slot_ids:
    (B, C) flat slots (``PAD_SLOT`` on padding); block_tables: (B,
    max_blocks) int32; ad: (B, n) adapter weights with a LoRA stack.
    Returns (logits (B, V) float32 at each sequence's last valid chunk row
    — meaningful on a prompt's last chunk — and kv_cache)."""
    _check(cfg, attn_impl)
    h = _chunk_trunk(params, cfg, tokens, ctx_lens, chunk_lens, slot_ids,
                     block_tables, kv_cache, attn_impl, ad)
    last = torch.clamp(chunk_lens.long() - 1, min=0)
    h_last = h[torch.arange(h.shape[0], device=h.device), last]
    return _unembed(params, cfg, h_last), kv_cache


# --------------------------------------------------------------------------
# Speculative verify: score a draft window against the cache
# --------------------------------------------------------------------------

@torch.no_grad()
def verify_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  ctx_lens: torch.Tensor, chunk_lens: torch.Tensor,
                  slot_ids: torch.Tensor, block_tables: torch.Tensor,
                  kv_cache: list, *, attn_impl: str = "reference") -> torch.Tensor:
    """The verify pass's (B, K, V) float32 logits: :func:`_chunk_trunk` over
    a draft window (the paged window kernel with ``attn_impl="cuda"``),
    unembedded at every row.  Arguments as :func:`decode_verify`."""
    _check(cfg, attn_impl)
    h = _chunk_trunk(params, cfg, tokens, ctx_lens, chunk_lens, slot_ids,
                     block_tables, kv_cache, attn_impl)
    return _unembed(params, cfg, h)


@torch.no_grad()
def decode_verify(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  ctx_lens: torch.Tensor, chunk_lens: torch.Tensor,
                  slot_ids: torch.Tensor, block_tables: torch.Tensor,
                  kv_cache: list, *, attn_impl: str = "reference"):
    """Verify a speculative draft window in one pass: the chunk trunk, then
    the greedy argmax at EVERY row, ``pred[:, j]`` the model's next token
    after consuming row j (all that greedy acceptance needs).

    tokens: (B, K) = [last sampled, draft_0, ..] (right-padded); ctx_lens:
    (B,) int32 tokens cached before the window; chunk_lens: (B,) int32
    valid rows; slot_ids: (B, K) cache slots (``PAD_SLOT`` on padding);
    block_tables: (B, max_blocks).  Returns (pred (B, K) int32,
    kv_cache)."""
    logits = verify_logits(params, cfg, tokens, ctx_lens, chunk_lens, slot_ids,
                           block_tables, kv_cache, attn_impl=attn_impl)
    return torch.argmax(logits, dim=-1).to(torch.int32), kv_cache


@torch.no_grad()
def decode_verify_sampled(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                          ctx_lens: torch.Tensor, chunk_lens: torch.Tensor,
                          slot_ids: torch.Tensor, block_tables: torch.Tensor,
                          kv_cache: list, keys: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor,
                          min_p: torch.Tensor | None = None, *,
                          attn_impl: str = "reference", noise=None):
    """Verify a draft window under sampling: the trunk of
    :func:`decode_verify`, then rejection-sampling acceptance on the
    device (``sampling.spec_accept_sampled``) of the draft tokens, the
    verify input rows shifted by one.  keys: (B, 2) each row's (salt,
    step) as uint32 values, position j keyed at step + j; ``noise``: the
    acceptance's (u, gumbel), for tests.  ``temperature <= 0`` rows reduce
    to exact greedy acceptance.  Returns (accept (B, K-1) bool, pred (B,
    K) int32, kv_cache)."""
    logits = verify_logits(params, cfg, tokens, ctx_lens, chunk_lens, slot_ids,
                           block_tables, kv_cache, attn_impl=attn_impl)
    keys = keys.to(logits.device).long()
    accept, pred = sampling_ops.spec_accept_sampled(
        logits, tokens[:, 1:], chunk_lens, keys[:, 0] & 0xFFFFFFFF,
        keys[:, 1] & 0xFFFFFFFF, temperature, top_k, top_p, min_p, noise=noise)
    return accept, pred, kv_cache


# --------------------------------------------------------------------------
# Cache-less trunks: embeddings, prompt scoring, draft proposals
# --------------------------------------------------------------------------

def _trunk_layer(h: torch.Tensor, lp: dict, cfg: ModelConfig, positions: torch.Tensor,
                 lens: torch.Tensor, li: int, attn_impl: str) -> torch.Tensor:
    """One layer of the cache-less trunk: (B, T, H) -> (B, T, H)."""
    B, T = h.shape[:2]
    hn = _norm(h, lp["attn_norm"], cfg)
    if cfg.is_mla:
        q, k, v = _mla_naive_qkv(hn, lp, cfg, positions)
    else:
        q, k, v = _qkv(hn, lp, cfg, positions, li)
    sw = cfg.layer_window(li)
    if attn_impl == "cuda" and not cfg.is_mla:
        out = flash_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), lens, cfg.attn_scale,
            sliding_window=sw, logit_softcap=cfg.attn_logit_softcapping)
    else:
        out = attn_ops.prefill_attention(q, k, v, lens, cfg.attn_scale, sliding_window=sw,
                                         logit_softcap=cfg.attn_logit_softcapping)
    h = h + _attn_residual(out.reshape(B, T, cfg.attn_out_size), lp, cfg)
    return h + _mlp_residual(h, lp, cfg)


def _cacheless_trunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                     lens: torch.Tensor, attn_impl: str, *, remat: bool = False) -> torch.Tensor:
    """The layer loop over right-padded (B, T) sequences with causal
    attention among their own tokens and no KV cache (the flash prefill
    kernel with ``attn_impl="cuda"``); ``lens``: (B,) int32 valid lengths.
    Returns the final hidden states (B, T, H), before the final norm.
    ``remat``: under autograd each layer's activations are recomputed in
    the backward pass (``torch.utils.checkpoint``), as ``jax.checkpoint``
    rematerialises."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    lens = lens.to(torch.int32)
    h = _embed(params, cfg, tokens, positions)
    remat = remat and torch.is_grad_enabled()
    if remat:
        from torch.utils.checkpoint import checkpoint
    for li, lp in enumerate(params["layers"]):
        if remat:
            h = checkpoint(_trunk_layer, h, lp, cfg, positions, lens, li, attn_impl,
                           use_reentrant=False)
        else:
            h = _trunk_layer(h, lp, cfg, positions, lens, li, attn_impl)
    return h


POOLINGS = ("mean", "last")


@torch.no_grad()
def embed_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  prompt_lens: torch.Tensor, *, pooling: str = "mean",
                  attn_impl: str = "reference") -> torch.Tensor:
    """Pooled sentence embeddings for /v1/embeddings: the cache-less trunk
    (no KV cache is written, so embedding traffic never touches the
    serving pool), the final norm, pooling over each row's valid positions
    ("mean" or "last"), L2-normalised.  tokens: (B, T) right-padded;
    prompt_lens: (B,).  Returns (B, H) float32."""
    _check(cfg, attn_impl)
    if pooling not in POOLINGS:
        raise ValueError(f"pooling {pooling!r} not in {POOLINGS}")
    B, T = tokens.shape
    h = _cacheless_trunk(params, cfg, tokens, prompt_lens, attn_impl)
    if cfg.final_layernorm:
        h = _norm(h, params["final_norm"], cfg)
    h = h.float()
    lens = prompt_lens.long().to(h.device)
    if pooling == "last":
        pooled = h[torch.arange(B, device=h.device), torch.clamp(lens - 1, min=0)]
    else:
        mask = (torch.arange(T, device=h.device)[None, :] < lens[:, None])[..., None]
        pooled = (h * mask).sum(dim=1) / torch.clamp(lens[:, None], min=1).float()
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)


@torch.no_grad()
def score_prompt(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 prompt_lens: torch.Tensor, *, top_n: int = 0, chunk: int = 16,
                 attn_impl: str = "reference"):
    """Per-position prompt logprobs (OpenAI ``echo`` + ``logprobs``, vLLM
    ``prompt_logprobs``): the cache-less trunk, then the unembedding in
    (B, ``chunk``, V) slices, so the (B, T, V) float32 logits of a page of
    text never exist at once.  tokens: (B, T) right-padded, T a multiple
    of ``chunk``; prompt_lens: (B,).  Returns (chosen (B, T) float32,
    ranks (B, T) int32, top_ids (B, T, top_n) int32, top_lps (B, T, top_n)
    float32): ``chosen[:, i]`` is log p(token i+1 | tokens <= i) and
    ``ranks[:, i]`` its 1-based rank over the whole vocabulary; callers
    shift by one (the first prompt token has no conditional)."""
    _check(cfg, attn_impl)
    B, T = tokens.shape
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    h = _cacheless_trunk(params, cfg, tokens, prompt_lens, attn_impl)
    # next-token targets: position i scores tokens[i + 1]
    nxt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1).long()
    k_eff = min(top_n, cfg.vocab_size) if top_n else 0
    chosen, ranks, top_ids, top_lps = [], [], [], []
    for c in range(0, T, chunk):
        lps = torch.log_softmax(_unembed(params, cfg, h[:, c:c + chunk]), dim=-1)
        ch = torch.gather(lps, -1, nxt[:, c:c + chunk, None])[..., 0]
        chosen.append(ch)
        ranks.append((lps > ch[..., None]).sum(dim=-1).to(torch.int32) + 1)
        if k_eff:
            tl, ti = torch.topk(lps, k_eff, dim=-1)
        else:
            ti = torch.zeros(ch.shape + (0,), dtype=torch.int64, device=ch.device)
            tl = torch.zeros(ch.shape + (0,), dtype=torch.float32, device=ch.device)
        top_ids.append(ti.to(torch.int32))
        top_lps.append(tl)
    return (torch.cat(chosen, dim=1), torch.cat(ranks, dim=1),
            torch.cat(top_ids, dim=1), torch.cat(top_lps, dim=1))


@torch.no_grad()
def draft_propose(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  lens: torch.Tensor, *, k: int, attn_impl: str = "reference") -> torch.Tensor:
    """Stateless draft-model proposal for speculative decoding: the
    cache-less trunk k times, each pass extending every row by its greedy
    next token, unembedding only each row's last position (the full (B,
    T, V) logits would be GBs at serving batches).  No draft KV cache, so
    the draft needs no mirror of the target's block lifecycle.  tokens:
    (B, W + k) the last W context tokens right-padded with k scratch
    slots; lens: (B,) valid context lengths.  Nothing is read back to the
    host, so one CUDA graph captures the k passes.  Returns (B, k) int32
    proposals."""
    _check(cfg, attn_impl)
    B, T = tokens.shape
    rows = torch.arange(B, device=tokens.device)
    cols = torch.arange(T, device=tokens.device)[None, :]
    toks, cur = tokens.clone(), lens.to(torch.int32).clone()
    outs = []
    for _ in range(k):
        h = _cacheless_trunk(params, cfg, toks, cur, attn_impl)
        h_last = h[rows, (cur.long() - 1).clamp(0, T - 1)]
        nxt = torch.argmax(_unembed(params, cfg, h_last), dim=-1).to(torch.int32)
        toks = torch.where(cols == cur[:, None], nxt[:, None], toks)
        cur = cur + 1
        outs.append(nxt)
    return torch.stack(outs, dim=1)


# --------------------------------------------------------------------------
# Decode: one token per sequence against the paged cache
# --------------------------------------------------------------------------

def window_slot(block_tables: torch.Tensor, pos: torch.Tensor,
                active: torch.Tensor, block_size: int) -> torch.Tensor:
    """Cache slot of each row's token at ``pos``, computed on the device;
    inactive (padding) rows get ``PAD_SLOT``.  A page index past the table
    is clamped, as the JAX gather clamps it (only padding rows reach one)."""
    page_idx = (pos // block_size).long().clamp(0, block_tables.shape[1] - 1)
    page = torch.gather(block_tables, 1, page_idx[:, None])[:, 0]
    slot = page * block_size + pos % block_size
    return torch.where(active, slot, torch.full_like(slot, attn_ops.PAD_SLOT))


def _decode_body(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, slot_ids: torch.Tensor,
                 block_tables: torch.Tensor, seq_lens: torch.Tensor,
                 kv_cache: list, attn_impl: str,
                 ad: torch.Tensor | None = None, microbatches: int = 0) -> torch.Tensor:
    """Single-token decode trunk: write each row's KV, then attend (so
    ``seq_lens`` includes the token).  Every row is written, padding rows
    dropped on the device (``attention.pad_drop``), so the trunk reads
    nothing back to the host and a CUDA graph can capture it.  Returns
    logits (B, V) float32."""
    B = tokens.shape[0]
    n_slots = _num_slots(kv_cache)

    def layers(h, r):
        return _decode_layers(params, cfg, h, positions[r], slot_ids[r], block_tables[r],
                              seq_lens[r], attn_ops.pad_drop(slot_ids[r], n_slots),
                              kv_cache, attn_impl, None if ad is None else ad[r])

    if cfg.stage is None:
        h = layers(_embed(params, cfg, tokens, positions), slice(None))     # (B, H)
    else:
        H = cfg.hidden_size
        h = cfg.stage.trunk("decode", B, (H,), (H,), param_dtype(cfg),
                            lambda r: _embed(params, cfg, tokens[r], positions[r]), layers,
                            microbatches=microbatches)
        if h is None:               # a later stage: stage 0 unembeds
            return None
    return _unembed(params, cfg, h)


def _decode_layers(params: dict, cfg: ModelConfig, h: torch.Tensor,
                   positions: torch.Tensor, slot_ids: torch.Tensor,
                   block_tables: torch.Tensor, seq_lens: torch.Tensor, drop,
                   kv_cache: list, attn_impl: str,
                   ad: torch.Tensor | None) -> torch.Tensor:
    """:func:`_decode_body`'s layer loop over (B, H) hidden rows."""
    B = h.shape[0]
    scale = cfg.attn_scale
    attend = (paged_decode_attention if attn_impl == "cuda"
              else attn_ops.paged_decode_attention)
    for li, lp in enumerate(params["layers"]):
        hn = _norm(h, lp["attn_norm"], cfg)
        if cfg.is_mla:
            # absorbed attention straight against the latent pages, on the
            # plain attention: a cached token costs mla_latent_dim values
            q_nope, q_rope, latent = _mla_proj(hn, lp, cfg, positions, ad)
            entry = attn_ops.write_mla_entry(kv_cache[li], latent, slot_ids,
                                             latent_split=cfg.mla_kv_lora_rank, drop=drop)
            out = attn_ops.paged_decode_attention(
                _mla_absorb_q(q_nope, q_rope, lp, cfg), entry["k"], entry["k"],
                block_tables, seq_lens, scale, k_scale=entry.get("ks"),
                v_scale=entry.get("ks"), scale_slices=_mla_slices(cfg))
            out = _mla_unabsorb(out, lp, cfg)
        else:
            q, k, v = _qkv(hn, lp, cfg, positions, li, ad)     # (B, H*, D)
            entry = attn_ops.write_kv_entry(kv_cache[li], k, v, slot_ids, drop=drop)
            out = attend(q.contiguous(), entry["k"], entry["v"], block_tables,
                         seq_lens, scale, k_scale=entry.get("ks"),
                         v_scale=entry.get("vs"), sliding_window=cfg.layer_window(li),
                         logit_softcap=cfg.attn_logit_softcapping)
        h = h + _attn_residual(out.reshape(B, cfg.attn_out_size), lp, cfg, ad)
        h = h + _mlp_residual(h, lp, cfg, ad)
    return h


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, slot_ids: torch.Tensor,
                block_tables: torch.Tensor, seq_lens: torch.Tensor,
                kv_cache: list, ad: torch.Tensor | None = None, *,
                attn_impl: str = "reference", microbatches: int = 0):
    """One decode step.  tokens/positions/slot_ids/seq_lens: (B,) int32;
    block_tables: (B, max_blocks) int32; ad: (B, n) adapter weights with a
    LoRA stack; microbatches as :func:`prefill`.  Returns (logits (B, V),
    kv_cache)."""
    _check(cfg, attn_impl)
    logits = _decode_body(params, cfg, tokens, positions, slot_ids,
                          block_tables, seq_lens, kv_cache, attn_impl, ad, microbatches)
    return logits, kv_cache


DECODE_MODES = ("greedy", "temperature", "full")


@dataclasses.dataclass
class DecodeState:
    """The buffers one decode iteration reads and advances in place
    (:func:`decode_state_step`): the carry of the JAX ``decode_multi``
    scan, kept in tensors of fixed address so that a CUDA graph captured
    over them serves every dispatch of its batch bucket.

    tokens/positions/seq_lens: (B,) int32 input token, its position, and
    the cached tokens including it; active: (B,) int32, nonzero on real
    rows (padding rows never write KV); salt/step: (B,) int32 sampling key
    (uint32 bit patterns; step advances by one each iteration, as the JAX
    ``window_sample`` folds ``+s``); temperature: (B,) float32;
    block_tables: (B, max_blocks) int32, reserved for every position the
    dispatch reaches; out: (B, S) int32 sampled tokens, one column an
    iteration; col: (1,) int32 the next column of ``out`` (the JAX scan's
    ``s``).

    The full mode reads top_k (B,) int32 and top_p/min_p (B,) float32.
    The in-window extras, present together or not at all (``counts`` None):
    counts (B, V) float32 each row's output-token counts, advanced by each
    sampled token; presence/frequency/repetition (B,) float32 penalties;
    bias (B, V) float32 the dense ``logit_bias``; floor_bias (B, V) float32
    the ``min_tokens`` mask, added while ``col < floor_remaining`` (B,)
    int32.  In-window logprobs (``lp_chosen`` None without): lp_chosen (B,
    S) float32, lp_ids (B, S, N) int32 and lp_vals (B, S, N) float32, one
    column an iteration as ``out``.  The grammar-FSM carry (``gstate``
    None without): gstate (B,) int32 each row's FSM state, -1 on unguided
    rows, advanced in place by each sampled token; gmasks (N, ceil(V/32))
    int32 the grammar's packed allow bits a state, gclass (V,) int32 token
    -> class and gnext (N, C) int32 the class transitions
    (``runtime/grammar/fsm.py``).  With a LoRA stack, ``ad`` (B, n) each
    row's adapter weights (None without)."""
    tokens: torch.Tensor
    positions: torch.Tensor
    seq_lens: torch.Tensor
    active: torch.Tensor
    salt: torch.Tensor
    step: torch.Tensor
    temperature: torch.Tensor
    block_tables: torch.Tensor
    out: torch.Tensor
    col: torch.Tensor
    top_k: torch.Tensor | None = None
    top_p: torch.Tensor | None = None
    min_p: torch.Tensor | None = None
    counts: torch.Tensor | None = None
    presence: torch.Tensor | None = None
    frequency: torch.Tensor | None = None
    repetition: torch.Tensor | None = None
    bias: torch.Tensor | None = None
    floor_bias: torch.Tensor | None = None
    floor_remaining: torch.Tensor | None = None
    lp_chosen: torch.Tensor | None = None
    lp_ids: torch.Tensor | None = None
    lp_vals: torch.Tensor | None = None
    gstate: torch.Tensor | None = None
    gmasks: torch.Tensor | None = None
    gclass: torch.Tensor | None = None
    gnext: torch.Tensor | None = None
    ad: torch.Tensor | None = None


def window_extras(logits: torch.Tensor, s: torch.Tensor, state: DecodeState) -> torch.Tensor:
    """One iteration's extras, as the JAX ``window_extras``: penalties from
    the count carry, the dense bias, and the ``min_tokens`` mask while the
    iteration ``s`` (a (1,) tensor, read on the device) is below the row's
    remaining floor.  No-op without the extras."""
    if state.counts is None:
        return logits
    logits = sampling_ops.penalize_from_counts(logits, state.counts, state.presence,
                                               state.frequency, state.repetition)
    logits = logits + state.bias
    return logits + torch.where((s < state.floor_remaining)[:, None], state.floor_bias, 0.0)


def window_count_update(state: DecodeState, nxt: torch.Tensor) -> None:
    """Fold the iteration's sampled tokens into the count carry, in place."""
    if state.counts is not None:
        state.counts.scatter_add_(1, nxt.long()[:, None],
                                  torch.ones((nxt.shape[0], 1), dtype=torch.float32,
                                             device=nxt.device))


def window_guided_mask(logits: torch.Tensor, gstate: torch.Tensor,
                       gmasks: torch.Tensor) -> torch.Tensor:
    """One iteration's grammar-FSM mask, as the JAX ``window_guided_mask``:
    each guided row's packed allow bits, gathered by its current state,
    drop the tokens they forbid to ``NEG_INF``; rows at -1 pass through.
    Applied after the extras and before sampling, as the per-step path."""
    rows = gmasks.index_select(0, gstate.clamp(0, gmasks.shape[0] - 1).long())
    return sampling_ops.apply_token_mask(logits, rows, gstate >= 0)


def window_guided_advance(gstate: torch.Tensor, nxt: torch.Tensor, gclass: torch.Tensor,
                          gnext: torch.Tensor) -> torch.Tensor:
    """Each guided row's next FSM state for its sampled token, through the
    class table (``gnext[state, gclass[token]]``), as the JAX
    ``window_guided_advance``; unguided rows stay -1.  The host replays
    the same table when it emits the token."""
    cls = gclass.index_select(0, nxt.long())
    ns = gnext[gstate.clamp(0, gnext.shape[0] - 1).long(), cls.long()]
    return torch.where(gstate >= 0, ns, gstate)


def window_sample(logits: torch.Tensor, state: DecodeState, mode: str) -> torch.Tensor:
    """One iteration's sampling (the JAX ``window_sample``): greedy,
    temperature, or full with each row's truncation; the sampled modes'
    noise keyed by (salt, step)."""
    if mode == "greedy":
        return sampling_ops.sample_tokens(logits, mode="greedy")
    V = logits.shape[-1]
    return sampling_ops.sample_tokens(
        logits, state.temperature, mode=mode,
        gumbel=lambda: sampling_ops.keyed_gumbel(state.salt, state.step, V),
        top_k=state.top_k, top_p=state.top_p, min_p=state.min_p)


@torch.no_grad()
def decode_state_step(params: dict, cfg: ModelConfig, state: DecodeState,
                      kv_cache: list, *, mode: str = "greedy",
                      attn_impl: str = "reference", microbatches: int = 0) -> torch.Tensor:
    """One fused decode + sample iteration over ``state``, in place, in
    the JAX order: write the token's KV at the slot ``window_slot`` gives
    its position and attend; apply the extras (penalties from the count
    carry, bias, the floor while ``col`` is below it); mask each guided
    row to its grammar state's legal tokens; sample (``mode``:
    "greedy", "temperature" or "full", with each row's keyed noise); write
    the token into column ``col`` of ``out``; advance the FSM states and
    fold the token into the counts;
    take its logprobs and the top ``lp_ids.shape[-1]`` from the logits the
    row sampled from (before temperature); advance token, position,
    length, key step and column.  Nothing is read back to the host.
    Returns the iteration's logits (B, V) float32, extras applied."""
    if mode not in DECODE_MODES:
        raise ValueError(f"decode mode {mode!r} not in {DECODE_MODES}")
    active = state.active != 0
    slot = window_slot(state.block_tables, state.positions, active,
                       kv_cache[0]["k"].shape[1])
    logits = _decode_body(params, cfg, state.tokens, state.positions, slot,
                          state.block_tables, state.seq_lens, kv_cache, attn_impl,
                          state.ad, microbatches)
    if logits is None:
        # a later pipeline stage: stage 0 samples; the positions advance alike
        for t in (state.positions, state.seq_lens, state.step, state.col):
            t.add_(1)
        return None
    logits = window_extras(logits, state.col, state)
    if state.gstate is not None:
        logits = window_guided_mask(logits, state.gstate, state.gmasks)
    nxt = window_sample(logits, state, mode)
    col = state.col.long()
    state.out.index_copy_(1, col, nxt[:, None])
    if state.gstate is not None:
        state.gstate.copy_(window_guided_advance(state.gstate, nxt, state.gclass,
                                                 state.gnext))
    window_count_update(state, nxt)
    if state.lp_chosen is not None:
        chosen, ids, vals = sampling_ops.compute_logprobs(logits, nxt, state.lp_ids.shape[-1])
        state.lp_chosen.index_copy_(1, col, chosen[:, None])
        state.lp_ids.index_copy_(1, col, ids[:, None])
        state.lp_vals.index_copy_(1, col, vals[:, None])
    state.tokens.copy_(nxt)
    state.positions.add_(1)
    state.seq_lens.add_(1)
    state.step.add_(1)
    state.col.add_(1)
    return logits


@torch.no_grad()
def decode_multi(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, block_tables: torch.Tensor,
                 seq_lens: torch.Tensor, active: torch.Tensor,
                 temperature: torch.Tensor, kv_cache: list, *, steps: int,
                 mode: str = "greedy", keys: torch.Tensor | None = None,
                 top_k: torch.Tensor | None = None, top_p: torch.Tensor | None = None,
                 min_p: torch.Tensor | None = None, logprobs_n: int = 0,
                 counts: torch.Tensor | None = None,
                 presence: torch.Tensor | None = None,
                 frequency: torch.Tensor | None = None,
                 repetition: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None,
                 floor_bias: torch.Tensor | None = None,
                 floor_remaining: torch.Tensor | None = None,
                 gstate: torch.Tensor | None = None,
                 gmasks: torch.Tensor | None = None,
                 gclass: torch.Tensor | None = None,
                 gnext: torch.Tensor | None = None,
                 ad: torch.Tensor | None = None,
                 attn_impl: str = "reference", microbatches: int = 0):
    """``steps`` fused decode+sample iterations: :func:`decode_state_step`
    run ``steps`` times over a state made from the arguments (the JAX
    ``lax.scan``; the engine's captured graphs replay the same step).  Each
    sampled token feeds the next iteration on the device, and nothing is
    read back to the host.

    tokens/positions/seq_lens: (B,) int32 first-iteration state as in
    :func:`decode_step`; active: (B,) bool real rows (padding rows never
    write KV); temperature: (B,) float32; keys: (B, 2) per-row sampling
    keys (salt, step) holding uint32 values, the step word advancing by
    one each iteration (zeros if None).  ``mode``: "greedy",
    "temperature" or "full" (``top_k``/``top_p``/``min_p`` (B,) per row;
    disabled where None).  The extras travel together, as in the JAX
    window: ``counts`` (B, V) output-token counts with the (B,)
    ``presence``/``frequency``/``repetition`` penalties, ``bias`` (B, V),
    and ``floor_bias`` (B, V) applied while the iteration is below
    ``floor_remaining`` (B,); those not given are neutral.
    ``logprobs_n``: the chosen token's logprob and the top N a step.
    Guided decoding, as the JAX window: ``gstate`` (B,) int32 each row's
    FSM state (-1 unguided) with the grammar's ``gmasks`` (N, ceil(V/32))
    packed allow bits (int32 or uint32), ``gclass`` (V,) and ``gnext`` (N,
    C) int32; each iteration masks by the current state, then advances it
    by the sampled token.  ``ad``: (B, n) adapter weights with a LoRA
    stack.  Cache slots for the whole window must be
    reserved.  Returns (tokens (B, steps) int32, kv_cache[, (chosen (B,
    steps), ids (B, steps, N), lps (B, steps, N))][, gstate (B,)]), the
    logprobs laid out as the JAX ``window_unpack_lp``, the final FSM
    states when ``gstate`` was given."""
    _check(cfg, attn_impl)
    if mode not in DECODE_MODES:
        raise ValueError(f"decode mode {mode!r} not in {DECODE_MODES}")
    B = tokens.shape[0]
    V = cfg.vocab_size
    dev = tokens.device
    if keys is None:
        keys = torch.zeros((B, 2), dtype=torch.int64, device=dev)
    keys = keys.to(dev).long()
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).clone()   # noqa: E731
    f32 = lambda t, fill: (torch.full((B,), fill, dtype=torch.float32, device=dev)  # noqa: E731
                           if t is None else t.to(device=dev, dtype=torch.float32).clone())
    state = DecodeState(
        tokens=i32(tokens), positions=i32(positions), seq_lens=i32(seq_lens),
        active=i32(active), salt=i32(keys[:, 0] & 0xFFFFFFFF),
        step=i32(keys[:, 1] & 0xFFFFFFFF),
        temperature=temperature.to(device=dev, dtype=torch.float32).clone(),
        block_tables=i32(block_tables),
        out=torch.zeros((B, steps), dtype=torch.int32, device=dev),
        col=torch.zeros((1,), dtype=torch.int32, device=dev),
        top_k=torch.zeros(B, dtype=torch.int32, device=dev) if top_k is None else i32(top_k),
        top_p=f32(top_p, 1.0), min_p=f32(min_p, 0.0), ad=ad)
    if counts is not None:
        zeros = lambda t: (torch.zeros((B, V), dtype=torch.float32, device=dev)  # noqa: E731
                           if t is None else t.to(device=dev, dtype=torch.float32).clone())
        state.counts, state.bias, state.floor_bias = zeros(counts), zeros(bias), zeros(floor_bias)
        state.presence, state.frequency = f32(presence, 0.0), f32(frequency, 0.0)
        state.repetition = f32(repetition, 1.0)
        state.floor_remaining = (torch.zeros(B, dtype=torch.int32, device=dev)
                                 if floor_remaining is None else i32(floor_remaining))
    if logprobs_n:
        state.lp_chosen = torch.zeros((B, steps), dtype=torch.float32, device=dev)
        state.lp_ids = torch.zeros((B, steps, logprobs_n), dtype=torch.int32, device=dev)
        state.lp_vals = torch.zeros((B, steps, logprobs_n), dtype=torch.float32, device=dev)
    if gstate is not None:
        state.gstate = i32(gstate)
        state.gmasks, state.gclass, state.gnext = i32(gmasks), i32(gclass), i32(gnext)
    for _ in range(steps):
        decode_state_step(params, cfg, state, kv_cache, mode=mode, attn_impl=attn_impl,
                          microbatches=microbatches)
    res = (state.out, kv_cache)
    if logprobs_n:
        res += ((state.lp_chosen, state.lp_ids, state.lp_vals),)
    if gstate is not None:
        res += (state.gstate,)
    return res


# --------------------------------------------------------------------------
# Mixed prefill + decode: one flat token stream, no phase split
# --------------------------------------------------------------------------

@torch.no_grad()
def forward_ragged(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, slot_ids: torch.Tensor,
                   row_seq: torch.Tensor, block_tables: torch.Tensor,
                   kv_lens: torch.Tensor, q_starts: torch.Tensor,
                   q_lens: torch.Tensor, meta: torch.Tensor,
                   blk_seq: torch.Tensor, last_rows: torch.Tensor,
                   kv_cache: list, ad: torch.Tensor | None = None, *,
                   ragged_blk: int = 8, attn_impl: str = "reference"):
    """One mixed step over a flat stream of decode rows and prefill-chunk
    rows (the layout of ``ops/ragged_paged.py``).

    tokens/positions/slot_ids/row_seq: (T,) int32 token, cache position,
    flat slot (``PAD_SLOT`` on padding) and sequence of each row;
    block_tables (B, max_blocks) / kv_lens / q_starts / q_lens: (B,) int32
    per sequence (kv_lens counts this step's rows); meta (2,) and blk_seq
    (T // ragged_blk,) describe the block layout; last_rows: (B,) the flat
    row of each sequence's last token, where its logits are taken.  Each
    row's KV is written first, then the row attends its own sequence's
    keys at positions <= its own.  ad: (T, n) each row's adapter weights
    with a LoRA stack (padding rows all-zero).  Returns (logits (B, V)
    float32, kv_cache)."""
    _check(cfg, attn_impl)
    T = tokens.shape[0]
    drop = attn_ops.pad_drop(slot_ids, _num_slots(kv_cache))
    h = _embed(params, cfg, tokens, positions)                 # (T, H)
    scale = cfg.attn_scale
    row_lens = positions + 1
    for li, lp in enumerate(params["layers"]):
        hn = _norm(h, lp["attn_norm"], cfg)
        if cfg.is_mla:
            # absorbed attention against the latent pages, as the chunk and
            # decode trunks, on the plain attention
            q_nope, q_rope, latent = _mla_proj(hn, lp, cfg, positions, ad)
            entry = attn_ops.write_mla_entry(kv_cache[li], latent, slot_ids,
                                             latent_split=cfg.mla_kv_lora_rank, drop=drop)
            out = attn_ops.ragged_reference_attention(
                _mla_absorb_q(q_nope, q_rope, lp, cfg), entry["k"], entry["k"],
                block_tables, row_seq, row_lens, blk_seq, meta, ragged_blk, scale,
                k_scale=entry.get("ks"), v_scale=entry.get("ks"),
                scale_slices=_mla_slices(cfg))
            out = _mla_unabsorb(out, lp, cfg)
            h = h + _attn_residual(out.reshape(T, cfg.attn_out_size), lp, cfg, ad)
            h = h + _mlp_residual(h, lp, cfg, ad)
            continue
        q, k, v = _qkv(hn, lp, cfg, positions, li, ad)         # (T, H*, D)
        entry = attn_ops.write_kv_entry(kv_cache[li], k, v, slot_ids, drop=drop)
        kw = dict(k_scale=entry.get("ks"), v_scale=entry.get("vs"),
                  sliding_window=cfg.layer_window(li),
                  logit_softcap=cfg.attn_logit_softcapping)
        if attn_impl == "cuda":
            out = ragged_paged_attention(
                q.contiguous(), entry["k"], entry["v"], block_tables, kv_lens,
                q_starts, q_lens, meta, blk_seq, scale, ragged_blk, **kw)
        else:
            out = attn_ops.ragged_reference_attention(
                q, entry["k"], entry["v"], block_tables, row_seq, row_lens,
                blk_seq, meta, ragged_blk, scale, **kw)
        h = h + _attn_residual(out.reshape(T, cfg.q_size), lp, cfg, ad)
        h = h + _mlp_residual(h, lp, cfg, ad)
    return _unembed(params, cfg, h[last_rows.long()]), kv_cache


# --------------------------------------------------------------------------
# Plain forward (no cache), with autograd: fine-tuning's trunk
# --------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            seq_lens: torch.Tensor | None = None, *, remat: bool = False) -> torch.Tensor:
    """Causal LM forward over (B, T) tokens -> (B, T, V) float32 logits, the
    JAX ``forward``: the cache-less trunk on the plain attention,
    differentiable (the fine-tuning step, ``parallel/train.py``), each
    layer rematerialised with ``remat``."""
    if seq_lens is None:
        seq_lens = torch.full(tokens.shape[:1], tokens.shape[1], dtype=torch.int32,
                              device=tokens.device)
    return _unembed(params, cfg, _cacheless_trunk(params, cfg, tokens, seq_lens,
                                                  "reference", remat=remat))
