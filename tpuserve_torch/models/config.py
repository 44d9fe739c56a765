"""Model architecture configs and the model registry.

The reference serves models by name only — the architecture lives inside the
vLLM container it deploys (reference: llm-d-deploy.yaml:118 pins
``Qwen/Qwen3-0.6B``; kubernetes-single-node.yaml:15 names Phi-3-mini;
templates/opt-chat-template.yaml targets facebook/opt-1.3b).  Here the
architectures are first-class: one ``ModelConfig`` covers the whole
decoder-only family the framework serves (Qwen3/Qwen2/Llama/Phi-3/OPT), with
per-family presets plus loading from a HuggingFace ``config.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 32768
    # Architecture knobs spanning the supported families.
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    act: str = "silu"                # "silu" | "gelu" | "relu"
    mlp_style: str = "gated"         # "gated" (SwiGLU-style) | "mlp" (2-layer)
    pos: str = "rope"                # "rope" | "learned"
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0
    qk_norm: bool = False            # Qwen3 per-head RMSNorm on q/k
    attention_bias: bool = False     # Qwen2-style bias on q/k/v projections
    mlp_bias: bool = False
    # Gemma traits: RMSNorm computes (1 + weight) — checkpoints store the
    # residual around 0 — and embeddings scale by sqrt(hidden_size).
    norm_weight_offset: float = 0.0
    embed_scale_by_sqrt_dim: bool = False
    # Sliding-window attention (Mistral): each position attends to at most
    # the previous `sliding_window` tokens.  None = full context.  Besides
    # correctness for the family, decode skips whole KV pages outside the
    # window — at 32k context with a 4k window that is 8x fewer KV reads.
    sliding_window: Optional[int] = None
    # Qwen2-style mixed layers: the FIRST this-many layers use full
    # attention, the rest the sliding window (HF max_window_layers).
    # Non-zero disables the rolling-buffer block release — full-attention
    # layers need every position's KV forever.
    full_attention_first_layers: int = 0
    # "first_full" (Qwen2) or "alternate" (Gemma2: even layers sliding,
    # odd layers full) — see layer_window()
    window_pattern: str = "first_full"
    # Explicit per-layer windowed flags (True = sliding), from HF
    # layer_types (Gemma3's 5-local:1-global pattern); overrides
    # window_pattern when set.
    window_layers: Optional[tuple] = None
    # Per-layer rope (Gemma3): WINDOWED layers use this base frequency
    # unscaled; full layers use rope_theta with rope_scaling_factor
    # (linear: positions divided by the factor).
    rope_local_base_freq: Optional[float] = None
    rope_scaling_factor: float = 1.0
    # Llama-3.1 frequency transform: (factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings) — see
    # ops/rope.py rope_freqs.
    rope_llama3_scaling: Optional[tuple] = None
    # YaRN long-context scaling (DeepSeek): (factor, beta_fast, beta_slow,
    # mscale, mscale_all_dim, original_max_position_embeddings) — see
    # ops/rope.py rope_freqs; mscale_all_dim also squares into attn_scale.
    rope_yarn: Optional[tuple] = None
    # Gemma2 traits: tanh softcaps on attention scores / final logits,
    # attention scale from query_pre_attn_scalar instead of head_dim, and
    # sandwich norms (post-attention + pre/post-feedforward layernorms).
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    query_pre_attn_scalar: Optional[int] = None
    sandwich_norms: bool = False
    tie_word_embeddings: bool = True
    learned_pos_offset: int = 0      # OPT stores positions shifted by 2
    final_layernorm: bool = True
    bos_token_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    dtype: str = "bfloat16"
    # Mixture-of-experts (Qwen3-MoE-style): 0 experts = dense MLP.  The
    # router picks num_experts_per_tok experts per token; expert MLPs use
    # moe_intermediate_size (falls back to intermediate_size).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True      # renormalise the top-k router weights
    # DeepSeek MoE extensions (deepseek_v2/v3; HF modeling_deepseek_v3):
    # sigmoid expert scoring with a selection-only correction bias
    # (e_score_correction_bias), grouped top-k (pick topk_group of n_group
    # expert groups, then top-k inside the surviving groups), a scaling
    # factor on the combine weights, always-on shared experts added to the
    # routed output, and the first k layers staying dense.
    moe_scoring: str = "softmax"     # "softmax" (Qwen3) | "sigmoid" (DSv3)
    moe_router_bias: bool = False    # e_score_correction_bias on selection
    moe_n_group: int = 1
    moe_topk_group: int = 1
    moe_routed_scaling: float = 1.0
    moe_shared_experts: int = 0      # shared-expert width multiplier
    moe_first_k_dense: int = 0       # first_k_dense_replace
    # Multi-head latent attention (DeepSeek MLA): K/V are compressed to a
    # kv_lora_rank latent + one shared roped key per token, so the cache
    # stores ONE (kv_lora_rank + qk_rope_head_dim)-wide "head" per token
    # instead of num_heads full K/V pairs — ~10x less KV HBM traffic and
    # capacity, the TPU-first win for decode.  head_dim must equal
    # qk_nope + qk_rope (the q/k attention width); v_head_dim is separate.
    mla_kv_lora_rank: Optional[int] = None   # None = standard attention
    mla_q_lora_rank: Optional[int] = None    # None = direct q projection
    mla_qk_rope_head_dim: int = 64
    mla_v_head_dim: int = 128
    # DeepSeek checkpoints store rope-dim weights channel-INTERLEAVED
    # (GPT-J pairing).  The loader de-interleaves those output channels
    # once at load (models/weights.py _mla_deinterleave), so the forward
    # always runs the NeoX split-half rope — zero runtime cost.
    mla_rope_interleave: bool = True

    def layer_window(self, layer_idx: int) -> Optional[int]:
        """Effective sliding window for one layer — ONE implementation for
        every forward path.  "first_full": the first
        ``full_attention_first_layers`` layers run full attention (Qwen2
        max_window_layers).  "alternate": even layers sliding, odd full
        (Gemma2 layer_types)."""
        if self.sliding_window is None:
            return None
        if self.window_layers is not None:
            return (self.sliding_window if self.window_layers[layer_idx]
                    else None)
        if self.window_pattern == "alternate":
            return self.sliding_window if layer_idx % 2 == 0 else None
        if layer_idx < self.full_attention_first_layers:
            return None
        return self.sliding_window

    def layer_rope(self, layer_idx: int) -> tuple[float, float]:
        """(theta, linear position scaling) for one layer.  Gemma3:
        windowed layers rotate at rope_local_base_freq unscaled; full
        layers at rope_theta with the linear factor.  Families without
        per-layer rope get (rope_theta, rope_scaling_factor) everywhere."""
        if (self.rope_local_base_freq is not None
                and self.layer_window(layer_idx) is not None):
            return self.rope_local_base_freq, 1.0
        return self.rope_theta, self.rope_scaling_factor

    @property
    def uniform_window(self) -> bool:
        """True when EVERY layer is windowed — the rolling-buffer block
        release is only sound then (any full-attention layer needs every
        position's KV forever)."""
        return (self.sliding_window is not None
                and all(self.layer_window(i) is not None
                        for i in range(self.num_layers)))

    @property
    def attn_scale(self) -> float:
        """Attention score scale: Gemma2 uses query_pre_attn_scalar**-0.5
        instead of head_dim**-0.5; under YaRN with mscale_all_dim the
        DeepSeek magnitude correction squares in (HF DeepseekV3Attention)."""
        scale = (self.query_pre_attn_scalar or self.head_dim) ** -0.5
        if self.rope_yarn is not None and self.rope_yarn[4]:
            from tpuserve_torch.ops.rope import yarn_mscale
            m = yarn_mscale(self.rope_yarn[0], self.rope_yarn[4])
            scale *= m * m
        return scale

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def attn_out_size(self) -> int:
        """Width of the attention output fed to o_proj: MLA values are
        mla_v_head_dim wide, not head_dim."""
        return self.num_heads * (self.mla_v_head_dim if self.is_mla
                                 else self.head_dim)

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def expert_intermediate_size(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

    @property
    def is_mla(self) -> bool:
        return self.mla_kv_lora_rank is not None

    @property
    def mla_qk_nope_head_dim(self) -> int:
        """q/k split: head_dim covers nope + rope (matches HF qk_head_dim,
        so attn_scale = head_dim**-0.5 is DeepSeek's scaling)."""
        return self.head_dim - self.mla_qk_rope_head_dim

    @property
    def mla_latent_dim(self) -> int:
        """Width of the single cached vector per token: the compressed KV
        latent plus the shared roped key."""
        return self.mla_kv_lora_rank + self.mla_qk_rope_head_dim

    @property
    def cache_kv_heads(self) -> int:
        """KV-cache head count: MLA stores one latent "head"."""
        return 1 if self.is_mla else self.num_kv_heads

    @property
    def cache_head_dim(self) -> int:
        """KV-cache per-head width: MLA stores the latent vector."""
        return self.mla_latent_dim if self.is_mla else self.head_dim

    def moe_layer_is_dense(self, layer_idx: int) -> bool:
        """DeepSeek first_k_dense_replace: the first k layers keep a dense
        MLP even in MoE models."""
        return bool(self.num_experts) and layer_idx < self.moe_first_k_dense

    @property
    def num_params(self) -> int:
        """Approximate parameter count (embeddings counted once if tied)."""
        h, i, l, v = self.hidden_size, self.intermediate_size, self.num_layers, self.vocab_size
        attn = h * self.q_size + 2 * h * self.kv_size + self.q_size * h
        if self.num_experts:
            mlp = (self.num_experts * 3 * h * self.expert_intermediate_size
                   + h * self.num_experts)
        else:
            mlp = (3 if self.mlp_style == "gated" else 2) * h * i
        embed = v * h * (1 if self.tie_word_embeddings else 2)
        return l * (attn + mlp) + embed


_REGISTRY: dict[str, ModelConfig] = {}


def register_model_config(cfg: ModelConfig, *aliases: str) -> ModelConfig:
    for key in (cfg.name, *aliases):
        _REGISTRY[key.lower()] = cfg
    return cfg


def list_model_configs() -> list[str]:
    return sorted({c.name for c in _REGISTRY.values()})


def get_model_config(name_or_path: str) -> ModelConfig:
    """Resolve a model by registry name, or by a local HF checkpoint dir."""
    key = name_or_path.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    cfg_path = os.path.join(name_or_path, "config.json")
    if os.path.isfile(cfg_path):
        return config_from_hf_json(name_or_path, json.load(open(cfg_path)))
    raise KeyError(
        f"Unknown model {name_or_path!r}; known: {list_model_configs()} "
        "or pass a local checkpoint directory containing config.json"
    )


def config_from_hf_json(name: str, hf: dict) -> ModelConfig:
    """Map a HuggingFace config.json onto ModelConfig for supported families."""
    arch = (hf.get("architectures") or [""])[0].lower()
    mt = hf.get("model_type", "").lower()
    family = mt or arch
    common = dict(
        name=name,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf.get("num_hidden_layers", hf.get("num_layers")),
        num_heads=hf.get("num_attention_heads"),
        max_position_embeddings=hf.get("max_position_embeddings", 32768),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        bos_token_id=hf.get("bos_token_id"),
        eos_token_id=_first(hf.get("eos_token_id")),
    )
    if "opt" in family:
        common["tie_word_embeddings"] = hf.get("tie_word_embeddings", True)
        return ModelConfig(
            intermediate_size=hf["ffn_dim"],
            num_kv_heads=hf["num_attention_heads"],
            head_dim=hf["hidden_size"] // hf["num_attention_heads"],
            norm="layernorm",
            norm_eps=1e-5,
            act="relu",
            mlp_style="mlp",
            pos="learned",
            learned_pos_offset=2,
            attention_bias=True,
            mlp_bias=True,
            **common,
        )
    if family.startswith("deepseek_v") or arch.startswith("deepseekv"):
        # DeepSeek V2/V3 (MLA + DeepSeek-MoE).  head_dim is the q/k
        # attention width (qk_nope + qk_rope = HF qk_head_dim); the cache
        # stores the kv_lora_rank+rope latent instead (cache_head_dim).
        rs = hf.get("rope_scaling") or {}
        yarn = None
        if rs.get("type", rs.get("rope_type")) == "yarn":
            yarn = (rs["factor"], rs.get("beta_fast", 32),
                    rs.get("beta_slow", 1), rs.get("mscale", 1.0),
                    rs.get("mscale_all_dim", 0),
                    rs.get("original_max_position_embeddings",
                           common["max_position_embeddings"]))
        moe = {}
        if hf.get("n_routed_experts"):
            moe = dict(
                num_experts=hf["n_routed_experts"],
                num_experts_per_tok=hf["num_experts_per_tok"],
                moe_intermediate_size=hf["moe_intermediate_size"],
                norm_topk_prob=hf.get("norm_topk_prob", True),
                # V3 checkpoints say scoring_func sigmoid / topk_method
                # noaux_tc; the integrated transformers DeepseekV3Config
                # hardcodes both, so default by generation
                moe_scoring=hf.get(
                    "scoring_func",
                    "sigmoid" if "v3" in family or "v3" in arch
                    else "softmax"),
                moe_router_bias=(hf.get("topk_method") == "noaux_tc"
                                 or ("topk_method" not in hf
                                     and ("v3" in family or "v3" in arch))),
                moe_n_group=hf.get("n_group") or 1,
                moe_topk_group=hf.get("topk_group") or 1,
                moe_routed_scaling=hf.get("routed_scaling_factor", 1.0),
                moe_shared_experts=hf.get("n_shared_experts") or 0,
                moe_first_k_dense=hf.get("first_k_dense_replace", 0),
            )
        return ModelConfig(
            intermediate_size=hf["intermediate_size"],
            num_kv_heads=hf["num_attention_heads"],
            head_dim=hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"],
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_yarn=yarn,
            norm_eps=hf.get("rms_norm_eps", 1e-6),
            attention_bias=hf.get("attention_bias", False),
            mla_kv_lora_rank=hf["kv_lora_rank"],
            mla_q_lora_rank=hf.get("q_lora_rank"),
            mla_qk_rope_head_dim=hf["qk_rope_head_dim"],
            mla_v_head_dim=hf["v_head_dim"],
            mla_rope_interleave=hf.get("rope_interleave", True),
            **moe,
            **common,
        )
    # gemma generations by model_type OR architectures (some configs omit
    # model_type); gemma3 adds per-layer rope scaling etc. — falling
    # through to the llama path would load and SILENTLY mis-serve, so
    # unsupported generations reject loudly
    gemma1 = mt == "gemma" or arch.startswith("gemmafor")
    gemma2 = mt == "gemma2" or arch.startswith("gemma2for")
    # gemma3 TEXT only; the multimodal wrapper (model_type "gemma3", a
    # vision tower + text_config) is rejected loudly below
    gemma3 = mt == "gemma3_text" or arch.startswith("gemma3forcausallm")
    if "gemma" in family and not (gemma1 or gemma2 or gemma3):
        raise ValueError(f"model family {family!r} is not supported yet "
                         "(gemma, gemma2 and gemma3 text are)")
    if gemma3:
        nh = hf["num_attention_heads"]
        lt = hf.get("layer_types")
        if lt:
            window_layers = tuple(t == "sliding_attention" for t in lt)
        else:
            # original-release configs encode the pattern as
            # sliding_window_pattern=p: every p-th layer is global
            pat = hf.get("sliding_window_pattern")
            if not pat:
                raise ValueError("gemma3 configs must carry layer_types "
                                 "or sliding_window_pattern")
            window_layers = tuple(
                (i + 1) % int(pat) != 0
                for i in range(hf["num_hidden_layers"]))
        rs = hf.get("rope_scaling")
        factor = 1.0
        if rs:
            if rs.get("rope_type", rs.get("type", "linear")) != "linear":
                raise ValueError(f"unsupported rope_scaling {rs!r} "
                                 "(linear only)")
            factor = float(rs.get("factor", 1.0))
        common["tie_word_embeddings"] = hf.get("tie_word_embeddings", True)
        return ModelConfig(
            intermediate_size=hf["intermediate_size"],
            num_kv_heads=hf.get("num_key_value_heads", nh),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // nh,
            norm="rmsnorm",
            norm_eps=hf.get("rms_norm_eps", 1e-6),
            norm_weight_offset=1.0,
            embed_scale_by_sqrt_dim=True,
            act=(hf.get("hidden_activation") or hf.get("hidden_act")
                 or "gelu_pytorch_tanh"),
            mlp_style="gated",
            pos="rope",
            rope_theta=hf.get("rope_theta", 1e6),
            rope_local_base_freq=hf.get("rope_local_base_freq", 10000.0),
            rope_scaling_factor=factor,
            qk_norm=True,
            sliding_window=hf.get("sliding_window"),
            window_layers=window_layers,
            query_pre_attn_scalar=hf.get("query_pre_attn_scalar"),
            sandwich_norms=True,
            **common,
        )
    if gemma2:
        nh = hf["num_attention_heads"]
        lt = hf.get("layer_types")
        if lt is not None and any(
                (t == "sliding_attention") != (i % 2 == 0)
                for i, t in enumerate(lt)):
            raise ValueError(
                "gemma2 checkpoints with a non-alternating layer_types "
                f"pattern are not supported yet (got {lt[:6]}...)")
        common["tie_word_embeddings"] = hf.get("tie_word_embeddings", True)
        return ModelConfig(
            intermediate_size=hf["intermediate_size"],
            num_kv_heads=hf.get("num_key_value_heads", nh),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // nh,
            norm="rmsnorm",
            norm_eps=hf.get("rms_norm_eps", 1e-6),
            norm_weight_offset=1.0,
            embed_scale_by_sqrt_dim=True,
            act=(hf.get("hidden_activation") or hf.get("hidden_act")
                 or "gelu_pytorch_tanh"),
            mlp_style="gated",
            pos="rope",
            rope_theta=hf.get("rope_theta", 10000.0),
            sliding_window=hf.get("sliding_window"),
            window_pattern="alternate",
            attn_logit_softcapping=hf.get("attn_logit_softcapping"),
            final_logit_softcapping=hf.get("final_logit_softcapping"),
            query_pre_attn_scalar=hf.get("query_pre_attn_scalar"),
            sandwich_norms=True,
            **common,
        )
    if gemma1:
        # Gemma: llama-shaped weights, but RMSNorm(1 + w), sqrt(hidden)
        # embedding scale, tanh-GELU MLP, tied embeddings, head_dim from
        # config (not hidden/heads)
        nh = hf["num_attention_heads"]
        common["tie_word_embeddings"] = hf.get("tie_word_embeddings", True)
        return ModelConfig(
            intermediate_size=hf["intermediate_size"],
            num_kv_heads=hf.get("num_key_value_heads", nh),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // nh,
            norm="rmsnorm",
            norm_eps=hf.get("rms_norm_eps", 1e-6),
            norm_weight_offset=1.0,
            embed_scale_by_sqrt_dim=True,
            # hidden_activation can be PRESENT as null (GemmaConfig's
            # nullable default) — `or` through to the real fallbacks
            act=(hf.get("hidden_activation") or hf.get("hidden_act")
                 or "gelu_pytorch_tanh"),
            mlp_style="gated",
            pos="rope",
            rope_theta=hf.get("rope_theta", 10000.0),
            **common,
        )
    # Llama / Qwen2 / Qwen3 / Phi-3 all share the rotary+gated-MLP skeleton;
    # the Qwen3-MoE variant swaps the MLP for routed experts.
    nh = hf["num_attention_heads"]
    moe = {}
    if hf.get("num_experts"):
        # We build every layer as MoE; a checkpoint with interleaved dense
        # layers (mlp_only_layers / decoder_sparse_step) would fail at weight
        # load with missing mlp.experts.* keys or, worse, mis-serve.  Reject
        # loudly until per-layer dense/MoE selection is supported.
        if hf.get("mlp_only_layers"):
            raise ValueError(
                "Qwen3-MoE checkpoints with non-empty mlp_only_layers "
                f"(got {hf['mlp_only_layers']}) interleave dense layers, "
                "which this loader does not support yet")
        if hf.get("decoder_sparse_step", 1) != 1:
            raise ValueError(
                "Qwen3-MoE checkpoints with decoder_sparse_step != 1 "
                f"(got {hf['decoder_sparse_step']}) interleave dense layers, "
                "which this loader does not support yet")
        moe = dict(num_experts=hf["num_experts"],
                   num_experts_per_tok=hf.get("num_experts_per_tok", 2),
                   moe_intermediate_size=hf.get("moe_intermediate_size"),
                   norm_topk_prob=hf.get("norm_topk_prob", True))
    return ModelConfig(
        intermediate_size=hf["intermediate_size"],
        num_kv_heads=hf.get("num_key_value_heads", nh),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // nh,
        norm="rmsnorm",
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        act=hf.get("hidden_act", "silu"),
        mlp_style="gated",
        pos="rope",
        rope_theta=hf.get("rope_theta", 10000.0),
        partial_rotary_factor=hf.get("partial_rotary_factor", 1.0),
        qk_norm="qwen3" in family,
        attention_bias="qwen2" in family or hf.get("attention_bias", False),
        rope_llama3_scaling=_rope_scaling(hf),
        **_sliding_window(hf, family),
        **moe,
        **common,
    )


def _rope_scaling(hf: dict):
    """Llama-3.1-style rope_scaling for the llama-family path.  Ignoring
    an unknown scheme would SILENTLY mis-rotate long contexts, so
    anything unrecognized rejects loudly."""
    rs = hf.get("rope_scaling")
    if not rs:
        return None
    rt = rs.get("rope_type", rs.get("type"))
    if rt == "llama3":
        return (float(rs["factor"]), float(rs["low_freq_factor"]),
                float(rs["high_freq_factor"]),
                float(rs["original_max_position_embeddings"]))
    if rt == "default":
        return None
    raise ValueError(f"unsupported rope_scaling {rs!r} for this family "
                     "(llama3 and default are)")


def _sliding_window(hf: dict, family: str) -> dict:
    """Mistral applies its sliding_window whenever set; Qwen2/Qwen3 carry
    the field but gate it behind use_sliding_window (default off) and
    max_window_layers.  Honoring a disabled window would corrupt long-
    context serving for every Qwen checkpoint.

    HF max_window_layers semantics: the FIRST that-many layers use full
    attention, the rest the window — mapped onto
    ``full_attention_first_layers``."""
    sw = hf.get("sliding_window")
    if sw is None:
        return {}
    if not hf.get("use_sliding_window", "mistral" in family):
        return {}
    mwl = hf.get("max_window_layers")
    nl = hf.get("num_hidden_layers", 0)
    if mwl is None:
        if "mistral" in family:
            mwl = 0                       # mistral windows every layer
        else:
            # HF Qwen2Config defaults max_window_layers=28 INDEPENDENT of
            # the layer count; guessing here risks silently windowing
            # layers transformers runs full — demand the field instead
            raise ValueError(
                "use_sliding_window is enabled but max_window_layers is "
                "missing; add it to the config (HF defaults it per-class, "
                "not per-model)")
    if nl and mwl >= nl:
        return {}                         # window never applies
    return {"sliding_window": int(sw),
            "full_attention_first_layers": int(mwl)}


def _first(x):
    if isinstance(x, (list, tuple)):
        return x[0] if x else None
    return x


# --- Presets for the tracked configs (BASELINE.json "configs") -------------

register_model_config(ModelConfig(
    name="Qwen/Qwen3-0.6B",
    vocab_size=151936, hidden_size=1024, intermediate_size=3072,
    num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128,
    max_position_embeddings=40960, rope_theta=1e6, norm_eps=1e-6,
    qk_norm=True, tie_word_embeddings=True,
    bos_token_id=151643, eos_token_id=151645,
), "qwen3-0.6b")

register_model_config(ModelConfig(
    name="Qwen/Qwen2-72B-Instruct",
    vocab_size=152064, hidden_size=8192, intermediate_size=29568,
    num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
    max_position_embeddings=32768, rope_theta=1e6, norm_eps=1e-6,
    attention_bias=True, tie_word_embeddings=False,
    bos_token_id=151643, eos_token_id=151645,
), "qwen2-72b")

register_model_config(ModelConfig(
    name="meta-llama/Meta-Llama-3-8B-Instruct",
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    max_position_embeddings=8192, rope_theta=500000.0, norm_eps=1e-5,
    tie_word_embeddings=False,
    bos_token_id=128000, eos_token_id=128009,
), "llama3-8b")

register_model_config(ModelConfig(
    name="meta-llama/Llama-3.1-8B-Instruct",
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    max_position_embeddings=131072, rope_theta=500000.0, norm_eps=1e-5,
    rope_llama3_scaling=(8.0, 1.0, 4.0, 8192.0),
    tie_word_embeddings=False,
    bos_token_id=128000, eos_token_id=128009,
), "llama31-8b")

register_model_config(ModelConfig(
    name="microsoft/Phi-3-mini-4k-instruct",
    vocab_size=32064, hidden_size=3072, intermediate_size=8192,
    num_layers=32, num_heads=32, num_kv_heads=32, head_dim=96,
    max_position_embeddings=4096, rope_theta=10000.0, norm_eps=1e-5,
    tie_word_embeddings=False,
    bos_token_id=1, eos_token_id=32000,
), "phi3-mini")

register_model_config(ModelConfig(
    name="facebook/opt-1.3b",
    vocab_size=50272, hidden_size=2048, intermediate_size=8192,
    num_layers=24, num_heads=32, num_kv_heads=32, head_dim=64,
    max_position_embeddings=2048, norm="layernorm", norm_eps=1e-5,
    act="relu", mlp_style="mlp", pos="learned", learned_pos_offset=2,
    attention_bias=True, mlp_bias=True, tie_word_embeddings=True,
    bos_token_id=2, eos_token_id=2,
), "opt-1.3b")

register_model_config(ModelConfig(
    name="mistralai/Mistral-7B-Instruct-v0.1",
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    max_position_embeddings=32768, rope_theta=10000.0, norm_eps=1e-5,
    sliding_window=4096, tie_word_embeddings=False,
    bos_token_id=1, eos_token_id=2,
), "mistral-7b")

register_model_config(ModelConfig(
    name="google/gemma-3-4b-text",
    vocab_size=262208, hidden_size=2560, intermediate_size=10240,
    num_layers=34, num_heads=8, num_kv_heads=4, head_dim=256,
    max_position_embeddings=131072, rope_theta=1_000_000.0,
    rope_local_base_freq=10000.0, rope_scaling_factor=8.0,
    norm_eps=1e-6, norm_weight_offset=1.0, embed_scale_by_sqrt_dim=True,
    act="gelu_pytorch_tanh", tie_word_embeddings=True, qk_norm=True,
    sliding_window=1024,
    window_layers=tuple(i % 6 != 5 for i in range(34)),   # 5 local : 1 global
    query_pre_attn_scalar=256, sandwich_norms=True,
    bos_token_id=2, eos_token_id=1,
), "gemma3-4b")

register_model_config(ModelConfig(
    name="google/gemma-2-2b",
    vocab_size=256000, hidden_size=2304, intermediate_size=9216,
    num_layers=26, num_heads=8, num_kv_heads=4, head_dim=256,
    max_position_embeddings=8192, rope_theta=10000.0, norm_eps=1e-6,
    norm_weight_offset=1.0, embed_scale_by_sqrt_dim=True,
    act="gelu_pytorch_tanh", tie_word_embeddings=True,
    sliding_window=4096, window_pattern="alternate",
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    query_pre_attn_scalar=256, sandwich_norms=True,
    bos_token_id=2, eos_token_id=1,
), "gemma2-2b")

register_model_config(ModelConfig(
    name="google/gemma-2b",
    vocab_size=256000, hidden_size=2048, intermediate_size=16384,
    num_layers=18, num_heads=8, num_kv_heads=1, head_dim=256,
    max_position_embeddings=8192, rope_theta=10000.0, norm_eps=1e-6,
    norm_weight_offset=1.0, embed_scale_by_sqrt_dim=True,
    act="gelu_pytorch_tanh", tie_word_embeddings=True,
    bos_token_id=2, eos_token_id=1,
), "gemma-2b")

# Mixture-of-experts family (Qwen3-MoE): routed experts replace the dense
# MLP; serves with expert-parallel sharding over the mesh 'ep' axis.
register_model_config(ModelConfig(
    name="Qwen/Qwen3-30B-A3B",
    vocab_size=151936, hidden_size=2048, intermediate_size=6144,
    num_layers=48, num_heads=32, num_kv_heads=4, head_dim=128,
    max_position_embeddings=40960, rope_theta=1e6, norm_eps=1e-6,
    qk_norm=True, tie_word_embeddings=False,
    num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
    bos_token_id=151643, eos_token_id=151645,
), "qwen3-30b-a3b")

# DeepSeek family (MLA + DeepSeek-MoE).  MLA is the TPU-first long-context
# cache design: one 576-wide latent per token instead of per-head K/V.
register_model_config(ModelConfig(
    name="deepseek-ai/DeepSeek-V2-Lite",
    vocab_size=102400, hidden_size=2048, intermediate_size=10944,
    num_layers=27, num_heads=16, num_kv_heads=16, head_dim=192,
    max_position_embeddings=163840, rope_theta=10000.0,
    rope_yarn=(40.0, 32, 1, 0.707, 0.707, 4096),
    norm_eps=1e-6, tie_word_embeddings=False,
    mla_kv_lora_rank=512, mla_q_lora_rank=None,
    mla_qk_rope_head_dim=64, mla_v_head_dim=128,
    num_experts=64, num_experts_per_tok=6, moe_intermediate_size=1408,
    norm_topk_prob=False, moe_scoring="softmax", moe_routed_scaling=1.0,
    moe_shared_experts=2, moe_first_k_dense=1,
    bos_token_id=100000, eos_token_id=100001,
), "deepseek-v2-lite")

register_model_config(ModelConfig(
    name="deepseek-ai/DeepSeek-V3",
    vocab_size=129280, hidden_size=7168, intermediate_size=18432,
    num_layers=61, num_heads=128, num_kv_heads=128, head_dim=192,
    max_position_embeddings=163840, rope_theta=10000.0,
    rope_yarn=(40.0, 32, 1, 1.0, 1.0, 4096),
    norm_eps=1e-6, tie_word_embeddings=False,
    mla_kv_lora_rank=512, mla_q_lora_rank=1536,
    mla_qk_rope_head_dim=64, mla_v_head_dim=128,
    num_experts=256, num_experts_per_tok=8, moe_intermediate_size=2048,
    norm_topk_prob=True, moe_scoring="sigmoid", moe_router_bias=True,
    moe_n_group=8, moe_topk_group=4, moe_routed_scaling=2.5,
    moe_shared_experts=1, moe_first_k_dense=3,
    bos_token_id=0, eos_token_id=1,
), "deepseek-v3", "deepseek-r1")

# Tiny configs for tests / CPU smoke (one per architectural family).
register_model_config(ModelConfig(
    name="tiny-qwen3",
    vocab_size=512, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    max_position_embeddings=512, rope_theta=1e6,
    qk_norm=True, tie_word_embeddings=True, eos_token_id=1,
))

register_model_config(ModelConfig(
    name="tiny-moe",
    vocab_size=512, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    max_position_embeddings=512, rope_theta=1e6,
    qk_norm=True, tie_word_embeddings=True, eos_token_id=1,
    num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
))

# MLA + V3-style MoE in one tiny config: q-lora, sigmoid+bias grouped
# routing, shared experts, first layer dense.
register_model_config(ModelConfig(
    name="tiny-deepseek",
    vocab_size=512, hidden_size=64, intermediate_size=128,
    num_layers=3, num_heads=4, num_kv_heads=4, head_dim=48,
    max_position_embeddings=512, rope_theta=10000.0,
    tie_word_embeddings=True, eos_token_id=1,
    mla_kv_lora_rank=32, mla_q_lora_rank=24,
    mla_qk_rope_head_dim=16, mla_v_head_dim=32,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
    moe_scoring="sigmoid", moe_router_bias=True,
    moe_n_group=2, moe_topk_group=1, moe_routed_scaling=1.5,
    moe_shared_experts=1, moe_first_k_dense=1,
))

register_model_config(ModelConfig(
    name="tiny-mistral",
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    max_position_embeddings=512, sliding_window=8,
    tie_word_embeddings=False, eos_token_id=1,
    # float32: the windowed tests assert token equality ACROSS impls
    # (reference/pallas/chunked/spec/disagg), and random-init logit gaps
    # (~4e-3) sit below bf16 rounding — bf16 argmax is path-sensitive
    dtype="float32",
))

register_model_config(ModelConfig(
    name="tiny-gemma3",
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=6, num_heads=4, num_kv_heads=2, head_dim=24,
    max_position_embeddings=512, norm_weight_offset=1.0,
    embed_scale_by_sqrt_dim=True, act="gelu_pytorch_tanh",
    tie_word_embeddings=True, qk_norm=True, eos_token_id=1,
    sliding_window=8, window_layers=tuple(i % 6 != 5 for i in range(6)),
    rope_theta=1_000_000.0, rope_local_base_freq=10000.0,
    rope_scaling_factor=8.0, query_pre_attn_scalar=24,
    sandwich_norms=True,
    # float32 for cross-impl token-equality tests (see tiny-mistral)
    dtype="float32",
))

register_model_config(ModelConfig(
    name="tiny-gemma2",
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=24,
    max_position_embeddings=512, norm_weight_offset=1.0,
    embed_scale_by_sqrt_dim=True, act="gelu_pytorch_tanh",
    tie_word_embeddings=True, eos_token_id=1,
    sliding_window=8, window_pattern="alternate",
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    query_pre_attn_scalar=24, sandwich_norms=True,
    # float32 for the cross-impl token-equality tests (see tiny-mistral)
    dtype="float32",
))

register_model_config(ModelConfig(
    name="tiny-gemma",
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=24,
    max_position_embeddings=512, norm_weight_offset=1.0,
    embed_scale_by_sqrt_dim=True, act="gelu_pytorch_tanh",
    tie_word_embeddings=True, eos_token_id=1,
))

register_model_config(ModelConfig(
    name="tiny-llama",
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
    max_position_embeddings=512, tie_word_embeddings=False, eos_token_id=1,
))

register_model_config(ModelConfig(
    name="tiny-opt",
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
    max_position_embeddings=512, norm="layernorm", norm_eps=1e-5,
    act="relu", mlp_style="mlp", pos="learned", learned_pos_offset=2,
    attention_bias=True, mlp_bias=True, tie_word_embeddings=True, eos_token_id=1,
))
