"""Rotary position embeddings (GPT-NeoX split-half convention), the port of
``tpuserve/ops/rope.py``: the same tables and the same float32 arithmetic
on torch tensors."""

from __future__ import annotations

import math

import torch


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN attention-magnitude correction (HF yarn_get_mscale)."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float,
               rotary_dim: int | None = None,
               llama3_scaling: tuple | None = None,
               yarn_scaling: tuple | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape ``positions.shape + (rotary_dim // 2,)`` in
    float32, on ``positions.device``.  ``llama3_scaling`` and
    ``yarn_scaling`` are the Llama-3.1 and YaRN frequency transforms, with
    the same tuples as the JAX package's ``rope_freqs``."""
    rotary_dim = rotary_dim or head_dim
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                             device=dev) / rotary_dim))
    attention_factor = 1.0
    if yarn_scaling is not None:
        factor, beta_fast, beta_slow, mscale, mscale_all_dim, orig_max = \
            yarn_scaling

        def corr_dim(n_rot):
            return (rotary_dim
                    * math.log(orig_max / (n_rot * 2 * math.pi))
                    ) / (2 * math.log(theta))
        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), rotary_dim - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp(
            (torch.arange(rotary_dim // 2, dtype=torch.float32, device=dev) - low)
            / (high - low), 0.0, 1.0)
        inv_freq = (inv_freq / factor) * ramp + inv_freq * (1.0 - ramp)
        if mscale and mscale_all_dim:
            attention_factor = (yarn_mscale(factor, mscale)
                                / yarn_mscale(factor, mscale_all_dim))
        else:
            attention_factor = yarn_mscale(factor)
    if llama3_scaling is not None:
        factor, low_f, high_f, orig_ctx = llama3_scaling
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (orig_ctx / wavelen - low_f) / (high_f - low_f)
        interp = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > orig_ctx / low_f, inv_freq / factor,
            torch.where(wavelen < orig_ctx / high_f, inv_freq, interp))
    angles = positions.to(torch.float32)[..., None] * inv_freq
    if attention_factor != 1.0:
        return (torch.cos(angles) * attention_factor,
                torch.sin(angles) * attention_factor)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., num_heads, head_dim) by cos/sin (..., rotary_dim//2),
    broadcast over the heads axis.  The first ``rotary_dim`` features rotate
    as two halves (NeoX style); any remainder passes through."""
    half = cos.shape[-1]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:2 * half].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    if 2 * half < x.shape[-1]:
        out = torch.cat([out, x[..., 2 * half:]], dim=-1)
    return out
