"""Paged KV cache tensors, sizing and the tiered cache's page copies: the
port of ``tpuserve/runtime/kv_cache.py``.

Layout per layer: ``{"k", "v"}`` each ``(num_blocks, block_size,
num_kv_heads, head_dim)``, plus ``{"ks", "vs"}`` float32 scales
``(num_blocks, block_size, num_kv_heads)`` when the cache stores int8.  An
MLA model (DeepSeek) keeps one array, ``{"k"}`` ``(num_blocks,
block_size, 1, mla_latent_dim)``: a token's rmsnorm'd latent and its
shared roped key, read as both K and V; under int8 its ``"ks"`` holds two
scales a token, ``(num_blocks, block_size, 2)``, one for each slice.

``gather_block_pages`` / ``scatter_block_pages`` move whole physical
blocks between the card and the host for the tier store
(``runtime/kv_tiers.py``), every layer and array, keeping the dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    per_vector = model_cfg.cache_head_dim * itemsize
    if cache_cfg.quantized:
        # one float32 scale per (token, head); MLA carries two a token
        # (latent and rope slices)
        per_vector += 8 if model_cfg.is_mla else 4
    # MLA stores ONE latent array, no V pages
    kv_arrays = 1 if model_cfg.is_mla else 2
    return (kv_arrays * model_cfg.num_layers * cache_cfg.block_size
            * model_cfg.cache_kv_heads * per_vector)


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
    """Zero-initialised per-layer ``[{"k", "v"[, "ks", "vs"]}]`` cache
    (``[{"k"[, "ks"]}]`` for MLA)."""
    shape = (cache_cfg.num_blocks, cache_cfg.block_size,
             model_cfg.cache_kv_heads, model_cfg.cache_head_dim)
    dtype = CACHE_DTYPES[cache_cfg.dtype]
    cache = []
    for _ in range(model_cfg.num_layers):
        if model_cfg.is_mla:
            entry = {"k": torch.zeros(shape, dtype=dtype, device=device)}
            if cache_cfg.quantized:
                entry["ks"] = torch.zeros((*shape[:2], 2), dtype=torch.float32,
                                          device=device)
            cache.append(entry)
            continue
        entry = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
        if cache_cfg.quantized:
            entry["ks"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
            entry["vs"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        cache.append(entry)
    return cache


# --------------------------------------------------------------------------
# Card <-> host page copies (the tiered KV cache's data plane).  A block's
# pages travel as one RECORD: every layer's arrays laid end to end, each at
# a 16-byte-aligned offset.  On the host a record is one tensor (pinned
# when the cache is on the card), so a block crosses the bus in one copy;
# on the card the records of a round sit in a fixed staging buffer, filled
# from (or scattered into) the cache by one indexed copy an array.
# --------------------------------------------------------------------------


class BlockPages:
    """One block's pages, the tier store's value: ``record``, the block's
    flat uint8 host record (pinned when it came from the card), read as a
    per-layer list of ``{key: page}`` dicts of views into it.  The views
    are made on first access: a demote that only files the record makes
    none.  ``layout``: the record's (layer, key, dtype, page shape,
    offset, nbytes) entries; ``nbytes``: the pages' bytes, padding
    excluded."""

    __slots__ = ("record", "layout", "nbytes", "_layers")

    def __init__(self, record: torch.Tensor, layout: tuple):
        self.record, self.layout = record, layout
        self.nbytes = sum(e[5] for e in layout)
        self._layers = None

    def _views(self) -> list[dict]:
        if self._layers is None:
            layers = [{} for _ in range(1 + self.layout[-1][0])]
            for li, key, dt, shape, o, nb in self.layout:
                layers[li][key] = self.record[o:o + nb].view(dt).view(shape)
            self._layers = layers
        return self._layers

    def __getitem__(self, i):
        return self._views()[i]

    def __iter__(self):
        return iter(self._views())

    def __len__(self) -> int:
        return 1 + self.layout[-1][0]


class PageStaging:
    """The page copies' staging for one cache: the record layout and a
    ``(rows, record_bytes)`` uint8 buffer on the cache's device, made
    once.  ``rows`` blocks cross per round; a larger batch loops, each
    round ordered behind the last on the device's stream."""

    ALIGN = 16

    def __init__(self, kv_cache: list[dict], rows: int):
        self.device = kv_cache[0]["k"].device
        self.pinned = self.device.type == "cuda"
        layout = []                     # (layer, key, dtype, page shape, offset, nbytes)
        off = 0
        for li, layer in enumerate(kv_cache):
            for key, t in layer.items():
                nb = t[0].numel() * t.element_size()
                layout.append((li, key, t.dtype, tuple(t.shape[1:]), off, nb))
                off += -(-nb // self.ALIGN) * self.ALIGN
        self.layout = tuple(layout)
        self.record_bytes = off
        self.rows = max(1, rows)
        self.buf = torch.empty((self.rows, off), dtype=torch.uint8, device=self.device)
        # each array's pages in the buffer, typed: (rows, *page shape)
        self.views = [(li, key, self.buf[:, o:o + nb].view(dt).view(self.rows, *shape))
                      for li, key, dt, shape, o, nb in self.layout]

    def new_record(self) -> torch.Tensor:
        return torch.empty(self.record_bytes, dtype=torch.uint8, pin_memory=self.pinned)

    def pin_records(self, n: int) -> None:
        """Pin ``n`` host records up front and release them: torch's
        caching host allocator keeps the memory and hands it to the next
        records, so demotes up to that many blocks pin nothing (pinning
        runs at a few GB/s, slower than the copies)."""
        if self.pinned:
            records = [self.new_record() for _ in range(n)]
            del records

    def record_of(self, pages: list[dict]) -> torch.Tensor:
        """``pages`` as one host record: its own when it has one, else
        packed into a new one (pages read back from a spill file), pinned
        here on the calling thread."""
        rec = getattr(pages, "record", None)
        if rec is not None:
            return rec
        rec = self.new_record()
        for li, key, dt, shape, o, nb in self.layout:
            rec[o:o + nb].view(dt).view(shape).copy_(pages[li][key])
        return rec

    def index(self, blocks: list[int]) -> torch.Tensor:
        """The block ids on the device, copied without a host wait."""
        idx = torch.tensor(blocks, dtype=torch.int64, pin_memory=self.pinned)
        return idx.to(self.device, non_blocking=True)


def gather_block_pages(kv_cache: list[dict], blocks: list[int],
                       staging: Optional[PageStaging] = None) -> list[BlockPages]:
    """Copy the given physical blocks' pages to the host: ``out[i]`` is
    ``blocks[i]``'s per-layer ``{key: page}`` list (a ``BlockPages``), the
    value format the tier store files.

    On the device's stream, a round of ``staging.rows`` blocks is one
    indexed copy an array into the staging buffer, then one copy a block
    into its own host record; the host waits once, at the end, for the
    whole batch.  That wait is ordered after every dispatch already queued,
    including one that wrote these pages: the engine drains its evictions
    BEFORE it dispatches the step that could overwrite them."""
    st = staging or PageStaging(kv_cache, len(blocks))
    records = []
    for r0 in range(0, len(blocks), st.rows):
        ids = blocks[r0:r0 + st.rows]
        idx = st.index(ids)
        for li, key, view in st.views:
            view[:len(ids)].copy_(kv_cache[li][key].index_select(0, idx))
        for i in range(len(ids)):
            rec = st.new_record()
            rec.copy_(st.buf[i], non_blocking=st.pinned)
            records.append(rec)
    if st.pinned and records:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return [BlockPages(r, st.layout) for r in records]


def scatter_block_pages(kv_cache: list[dict], blocks: list[int], pages: list[list[dict]],
                        staging: Optional[PageStaging] = None) -> None:
    """Write per-block host pages (the ``gather_block_pages`` format) into
    the cache at ``blocks``, IN PLACE: ``index_copy_`` into the cache's own
    tensors, whose addresses every captured executable holds.

    Dispatch-only: from pinned records the copies are queued on the
    device's stream without a host wait, ordered before any step
    dispatched after this one, so a restore overlaps the step in flight.
    Pages without a pinned record (read back from a spill file) are packed
    into one first, on this thread."""
    st = staging or PageStaging(kv_cache, len(blocks))
    for r0 in range(0, len(blocks), st.rows):
        ids = blocks[r0:r0 + st.rows]
        for i, p in enumerate(pages[r0:r0 + len(ids)]):
            st.buf[i].copy_(st.record_of(p), non_blocking=st.pinned)
        idx = st.index(ids)
        for li, key, view in st.views:
            kv_cache[li][key].index_copy_(0, idx, view[:len(ids)])
