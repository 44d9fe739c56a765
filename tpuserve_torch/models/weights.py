"""Parameters of the port's transformer.

The tree has the JAX package's layout — ``{"embed": {"weight"}, "layers":
[{"q_proj": {"kernel", ...}, ...}], "final_norm": {...}[, "lm_head"]}`` —
with linear kernels stored ``(in, out)``, so the two packages' trees map
leaf for leaf.  Two ways to fill it:

- :func:`params_from_numpy` converts the JAX package's tree given as numpy
  arrays (``jax.tree.map(np.asarray, params)``);
- :func:`init_params` reproduces ``tpuserve.models.weights.init_params``
  draw for draw (same ``np.random.default_rng(seed)``, same order, same
  float32-then-cast rounding), so a run on the card gets the JAX engine's
  exact random weights without importing JAX.

Loading a HuggingFace checkpoint is not ported yet (ROADMAP.md, checkpoint
loading).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuserve_torch.models.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    try:
        return DTYPES[cfg.dtype]
    except KeyError:
        raise NotImplementedError(f"model dtype {cfg.dtype!r} not supported "
                                  f"(one of {sorted(DTYPES)})") from None


def _check_family(cfg: ModelConfig) -> None:
    if cfg.is_mla or cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA families are not ported yet "
            "(ROADMAP.md A8, model breadth)")


def params_from_numpy(tree, cfg: ModelConfig, device) -> dict:
    """The JAX package's parameter tree, as numpy arrays, on ``device`` in
    the model's dtype."""
    _check_family(cfg)
    dtype = param_dtype(cfg)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        arr = np.array(x)                      # a writable host copy
        if arr.dtype.name == "bfloat16":       # ml_dtypes: go through float32
            arr = arr.astype(np.float32)
        return torch.from_numpy(arr).to(dtype).to(device)
    return conv(tree)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random-normal parameters, equal to the JAX package's
    ``init_params(cfg, seed)`` value for value (dense and norm leaves of the
    dense families; MoE and MLA raise)."""
    _check_family(cfg)
    rng = np.random.default_rng(seed)
    dtype = param_dtype(cfg)

    def put(arr) -> torch.Tensor:
        # cast on the host, where the rounding is the one the test pins
        return torch.from_numpy(arr).to(dtype).to(device)

    def dense(n_in, n_out, bias):
        p = {"kernel": put(rng.standard_normal((n_in, n_out), dtype=np.float32)
                           / np.sqrt(n_in))}
        if bias:
            p["bias"] = torch.zeros((n_out,), dtype=dtype, device=device)
        return p

    # Gemma-style norms store (weight - 1): init so the effective gain is 1
    norm_init = 1.0 - cfg.norm_weight_offset

    def norm(n):
        p = {"scale": torch.full((n,), norm_init, dtype=dtype, device=device)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros((n,), dtype=dtype, device=device)
        return p

    h, d = cfg.hidden_size, cfg.head_dim
    layers = []
    for _ in range(cfg.num_layers):
        lp = {
            "attn_norm": norm(h),
            "q_proj": dense(h, cfg.q_size, cfg.attention_bias),
            "k_proj": dense(h, cfg.kv_size, cfg.attention_bias),
            "v_proj": dense(h, cfg.kv_size, cfg.attention_bias),
            "o_proj": dense(cfg.q_size, h,
                            cfg.attention_bias and cfg.pos == "learned"),
            "mlp_norm": norm(h),
        }
        if cfg.qk_norm:
            lp["q_norm"] = {"scale": torch.full((d,), norm_init, dtype=dtype,
                                                device=device)}
            lp["k_norm"] = {"scale": torch.full((d,), norm_init, dtype=dtype,
                                                device=device)}
        if cfg.sandwich_norms:
            lp["post_attn_norm"] = norm(h)
            lp["post_mlp_norm"] = norm(h)
        if cfg.mlp_style == "gated":
            lp["gate_proj"] = dense(h, cfg.intermediate_size, cfg.mlp_bias)
            lp["up_proj"] = dense(h, cfg.intermediate_size, cfg.mlp_bias)
            lp["down_proj"] = dense(cfg.intermediate_size, h, cfg.mlp_bias)
        else:
            lp["fc1"] = dense(h, cfg.intermediate_size, cfg.mlp_bias)
            lp["fc2"] = dense(cfg.intermediate_size, h, cfg.mlp_bias)
        layers.append(lp)

    params = {
        "embed": {"weight": put(rng.standard_normal((cfg.vocab_size, h),
                                                    dtype=np.float32) * 0.02)},
        "layers": layers,
        "final_norm": norm(h),
    }
    if cfg.pos == "learned":
        params["pos_embed"] = {"weight": put(rng.standard_normal(
            (cfg.max_position_embeddings + cfg.learned_pos_offset, h),
            dtype=np.float32) * 0.02)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(h, cfg.vocab_size, False)
    return params


def param_nbytes(params) -> int:
    """Total bytes of a parameter tree's tensors."""
    if isinstance(params, dict):
        return sum(param_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_nbytes(v) for v in params)
    return params.numel() * params.element_size()
