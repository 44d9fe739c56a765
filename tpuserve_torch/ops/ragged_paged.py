"""Ragged paged attention: the wrapper of ``csrc/ragged_paged.cu``, the port
of the TPU kernel in ``tpuserve/ops/pallas_ragged_attention.py``, and the
flat-row block size of the mixed layout (``ragged_block``).

On CPU tensors it runs the plain version
(``attention.ragged_paged_attention``); on CUDA tensors it launches the
kernel or raises — there is no fallback.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from tpuserve_torch.ops import _build, attention
from tpuserve_torch.ops.paged_decode import (check_paged_inputs, kv_dtype_code, num_sms,
                                             ragged_decode_blocks, split_stride, workspace)
from tpuserve_torch.utils import next_power_of_2

LAUNCHES = 0

# The mixed layout's flat-row block on the card: 32 query positions times
# Qwen3's G = 2 query heads a KV head fill exactly one 64-row tile of the
# kernel (4 warps x 16 WMMA rows), and a chunk pads at most 31 rows, under
# 7% of a 512-row step (a 128-row block, the TPU's, pads up to 127).  On
# the CPU it is 8, the JAX package's value off the TPU, so the CPU tests
# lay the stream out as the JAX engine does.
CARD_BLOCK = 32
CPU_BLOCK = 8


def ragged_block(device="cpu") -> int:
    """The flat-row block the mixed engine lays its stream out with (the
    decode region padded to a multiple, prefill chunks aligned to it) and
    the kernel's grid block: one source for both.  ``TPUSERVE_RAGGED_BLOCK``
    overrides the device's default; it must be a power of two, since the
    engine buckets the stream length to powers of two."""
    env = os.environ.get("TPUSERVE_RAGGED_BLOCK")
    if env:
        n = int(env)
        if n < 1 or n & (n - 1):
            raise ValueError(
                f"TPUSERVE_RAGGED_BLOCK={env} must be a power of two "
                "(the flat-token bucket ladder is power-of-two)")
        return n
    return CARD_BLOCK if torch.device(device).type == "cuda" else CPU_BLOCK


def ragged_layout(n_dec: int, takes, blk: int):
    """The block layout of a mixed stream of ``n_dec`` decode rows and
    prefill chunks of ``takes`` rows (descriptor rows n_dec, n_dec + 1, ...
    in that order): the first flat row of each chunk, the stream length T
    (a power of two), ``meta`` and ``blk_seq``."""
    cursor = -(-n_dec // blk) * blk
    starts = []
    for take in takes:
        starts.append(cursor)
        cursor += -(-take // blk) * blk
    T = max(next_power_of_2(max(cursor, 1)), blk)
    blk_seq = np.full((T // blk,), -1, np.int32)
    for si, (take, st) in enumerate(zip(takes, starts), start=n_dec):
        blk_seq[st // blk:(st + -(-take // blk) * blk) // blk] = si
    meta = np.asarray([n_dec, -(-n_dec // blk)], np.int32)
    return starts, T, meta, blk_seq


def ragged_paged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           kv_lens: torch.Tensor, q_starts: torch.Tensor,
                           q_lens: torch.Tensor, meta: torch.Tensor,
                           blk_seq: torch.Tensor, scale: float, blk: int,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           sliding_window: int | None = None,
                           logit_softcap: float | None = None) -> torch.Tensor:
    """q: (T, Hq, D) flat mixed stream; k_cache/v_cache: (num_blocks, page,
    Hkv, D) in q's dtype or int8 with float32 scales (num_blocks, page,
    Hkv); block_tables: (B, max_pages) int32 per sequence; kv_lens /
    q_starts / q_lens: (B,) int32; meta: (2,) int32 [num_decode_rows,
    num_decode_blocks]; blk_seq: (T // blk,) int32.  Layout contract as
    ``attention.ragged_paged_attention``.  Returns (T, Hq, D) in q.dtype;
    rows that serve no query are 0.  Nothing is read back to the host."""
    if q.device.type == "cpu":
        return attention.ragged_paged_attention(
            q, k_cache, v_cache, block_tables, kv_lens, q_starts, q_lens, meta,
            blk_seq, scale, blk, k_scale=k_scale, v_scale=v_scale,
            sliding_window=sliding_window, logit_softcap=logit_softcap)
    T, Hq, D = q.shape
    B = block_tables.shape[0]
    _check(blk > 0 and T % blk == 0, f"T={T} is not a multiple of the block {blk}")
    check_paged_inputs(_check, q, k_cache, v_cache, k_scale, v_scale, block_tables, B,
                       [("kv_lens", kv_lens), ("q_starts", q_starts), ("q_lens", q_lens)])
    for name, t, n in (("meta", meta, 2), ("blk_seq", blk_seq, T // blk)):
        _check(t.dtype == torch.int32 and t.shape == (n,), f"{name} must be int32 ({n},)")
        _check(t.device == q.device and t.is_contiguous(),
               f"{name} must be contiguous on {q.device}")
    _, page, Hkv, _ = k_cache.shape
    max_pages = block_tables.shape[1]
    sms = num_sms(q.device)
    # decode rows are the first meta[0] <= min(B, T) rows; the kernel picks
    # their partitions from meta[0] on the card
    dec_blocks = ragged_decode_blocks(min(B, T), Hkv, max_pages, page, sms)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counters = workspace(q.device, stream, dec_blocks * split_stride(Hq // Hkv, D),
                               B * Hkv)
    out = torch.empty_like(q)
    lib = _build.load("ragged_paged")
    fn = lib.ragged_paged
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    quantized = k_scale is not None
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), kv_lens.data_ptr(), q_starts.data_ptr(),
            q_lens.data_ptr(), meta.data_ptr(), blk_seq.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(),
            T, Hq, Hkv, D, page, max_pages, blk, sms, dec_blocks, float(scale),
            int(sliding_window or 0), float(logit_softcap or 0.0),
            kv_dtype_code(q.dtype), kv_dtype_code(k_cache.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged launch failed: cudaError {rc}")
    global LAUNCHES
    if not _build.tallied("ragged_paged"):
        with _build.LAUNCH_LOCK:
            LAUNCHES += 1
    return out


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"ragged_paged_attention: {msg}")
