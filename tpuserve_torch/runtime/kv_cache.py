"""Paged KV cache tensors and sizing — the port of
``tpuserve/runtime/kv_cache.py`` (the tiered-cache page copies are not
ported yet).

Layout per layer: ``{"k", "v"}`` each ``(num_blocks, block_size,
num_kv_heads, head_dim)``, plus ``{"ks", "vs"}`` float32 scales
``(num_blocks, block_size, num_kv_heads)`` when the cache stores int8.
"""

from __future__ import annotations

import dataclasses

import torch

from tpuserve_torch.models.config import ModelConfig

CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    block_size: int = 32
    num_blocks: int = 1024          # 0 = size to the card's free memory
    max_blocks_per_seq: int = 64
    # "bfloat16"/"float32" store raw; "int8" stores symmetric-absmax values
    # plus one float32 scale per (token, kv head)
    dtype: str = "bfloat16"

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def max_model_len(self) -> int:
        return self.block_size * self.max_blocks_per_seq


def bytes_per_block(model_cfg: ModelConfig, cache_cfg: CacheConfig) -> int:
    itemsize = torch.empty((), dtype=CACHE_DTYPES[cache_cfg.dtype]).element_size()
    per_vector = model_cfg.head_dim * itemsize
    if cache_cfg.quantized:
        per_vector += 4                 # one float32 scale per (token, head)
    return (2 * model_cfg.num_layers * cache_cfg.block_size
            * model_cfg.num_kv_heads * per_vector)


def num_blocks_for_budget(model_cfg: ModelConfig, cache_cfg: CacheConfig,
                          free_bytes: int, utilization: float = 0.9) -> int:
    """How many KV blocks fit in ``utilization`` of ``free_bytes`` (device
    memory left after the weights are resident)."""
    budget = int(free_bytes * utilization)
    if budget <= 0:
        raise ValueError("no device memory left for a KV cache; set "
                         "CacheConfig.num_blocks explicitly")
    return max(budget // bytes_per_block(model_cfg, cache_cfg), 16)


def create_kv_cache(model_cfg: ModelConfig, cache_cfg: CacheConfig,
                    device) -> list[dict]:
    """Zero-initialised per-layer ``[{"k", "v"[, "ks", "vs"]}]`` cache."""
    shape = (cache_cfg.num_blocks, cache_cfg.block_size,
             model_cfg.num_kv_heads, model_cfg.head_dim)
    dtype = CACHE_DTYPES[cache_cfg.dtype]
    cache = []
    for _ in range(model_cfg.num_layers):
        entry = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
        if cache_cfg.quantized:
            entry["ks"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
            entry["vs"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        cache.append(entry)
    return cache
