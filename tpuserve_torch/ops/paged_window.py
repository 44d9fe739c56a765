"""Paged window attention: the wrapper of ``csrc/paged_window.cu``, the port
of the TPU kernel in ``tpuserve/ops/pallas_chunked_prefill.py``.

On CPU tensors it runs the plain version
(``attention.chunked_prefill_attention``); on CUDA tensors it launches the
kernel or raises — there is no fallback.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpuserve_torch.ops import _build, attention
from tpuserve_torch.ops.paged_decode import check_paged_inputs, kv_dtype_code

LAUNCHES = 0


def paged_window_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           ctx_lens: torch.Tensor, chunk_lens: torch.Tensor,
                           scale: float, k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           sliding_window: int | None = None,
                           logit_softcap: float | None = None) -> torch.Tensor:
    """q: (B, C, Hq, D) window queries; k_cache/v_cache: (num_blocks, page,
    Hkv, D) with the window's K/V already written, in q's dtype or int8
    with float32 ``k_scale``/``v_scale`` (num_blocks, page, Hkv);
    block_tables: (B, max_pages) int32; ctx_lens/chunk_lens: (B,) int32.
    Query row i of sequence b sits at cache position ``ctx_lens[b] + i``.
    Returns (B, C, Hq, D) in q.dtype; rows past chunk_lens are 0."""
    if q.device.type == "cpu":
        return attention.chunked_prefill_attention(
            q, k_cache, v_cache, block_tables, ctx_lens, chunk_lens, scale,
            k_scale=k_scale, v_scale=v_scale, sliding_window=sliding_window,
            logit_softcap=logit_softcap)
    B, C, Hq, D = q.shape
    check_paged_inputs(_check, q, k_cache, v_cache, k_scale, v_scale,
                       block_tables, B, [("ctx_lens", ctx_lens), ("chunk_lens", chunk_lens)])
    out = torch.empty_like(q)
    lib = _build.load("paged_window")
    fn = lib.paged_window
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    quantized = k_scale is not None
    _, page, Hkv, _ = k_cache.shape
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), ctx_lens.data_ptr(), chunk_lens.data_ptr(),
            out.data_ptr(), B, C, Hq, Hkv, D, page, block_tables.shape[1],
            float(scale), int(sliding_window or 0), float(logit_softcap or 0.0),
            kv_dtype_code(q.dtype), kv_dtype_code(k_cache.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_window launch failed: cudaError {rc}")
    global LAUNCHES
    if not _build.tallied("paged_window"):
        with _build.LAUNCH_LOCK:
            LAUNCHES += 1
    return out


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"paged_window_attention: {msg}")
