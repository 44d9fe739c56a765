"""Paged decode attention: the wrapper of ``csrc/paged_decode.cu``, the
port of the TPU kernel in ``tpuserve/ops/pallas_paged_attention.py``.

On CPU tensors it runs the plain version
(``attention.paged_decode_attention``); on CUDA tensors it launches the
kernel or raises — there is no fallback.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpuserve_torch.ops import _build, attention

LAUNCHES = 0
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, scale: float,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           sliding_window: int | None = None,
                           logit_softcap: float | None = None) -> torch.Tensor:
    """q: (B, Hq, D); k_cache/v_cache: (num_blocks, page, Hkv, D) in q's
    dtype, or int8 with float32 ``k_scale``/``v_scale`` (num_blocks, page,
    Hkv); block_tables: (B, max_pages) int32; seq_lens: (B,) int32,
    including the token being decoded.  Returns (B, Hq, D) in q.dtype."""
    if q.device.type == "cpu":
        return attention.paged_decode_attention(
            q, k_cache, v_cache, block_tables, seq_lens, scale, k_scale,
            v_scale, sliding_window, logit_softcap)
    B, Hq, D = q.shape
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dtype in _Q_DTYPES, f"unsupported q dtype {q.dtype}")
    nb, page, Hkv, Dk = k_cache.shape
    _check(v_cache.shape == k_cache.shape and Dk == D,
           "k/v caches must be (num_blocks, page, Hkv, D) with q's D")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _check(Hq % Hkv == 0 and Hq // Hkv <= MAX_GROUP,
           f"Hq={Hq}, Hkv={Hkv}: need Hq % Hkv == 0 and a group <= {MAX_GROUP}")
    quantized = k_cache.dtype == torch.int8
    _check(v_cache.dtype == k_cache.dtype, "k and v caches differ in dtype")
    _check(k_cache.dtype == q.dtype or quantized,
           f"cache dtype {k_cache.dtype} must be q's {q.dtype} or int8")
    _check(quantized == (k_scale is not None) and (k_scale is None) == (v_scale is None),
           "int8 caches need k_scale and v_scale, other caches none")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("block_tables", block_tables), ("seq_lens", seq_lens)]
    if quantized:
        _check(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32
               and k_scale.shape == (nb, page, Hkv) and v_scale.shape == k_scale.shape,
               "scales must be float32 (num_blocks, page, Hkv)")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    _check(block_tables.dtype == torch.int32 and block_tables.dim() == 2
           and block_tables.shape[0] == B, "block_tables must be int32 (B, max_pages)")
    _check(seq_lens.dtype == torch.int32 and seq_lens.shape == (B,),
           "seq_lens must be int32 (B,)")
    for name, t in tensors:
        _check(t.device == q.device, f"{name} is on {t.device}, not {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
           "caches must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _build.load("paged_decode")
    fn = lib.paged_decode
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, page, block_tables.shape[1], float(scale),
            int(sliding_window or 0), float(logit_softcap or 0.0),
            _Q_DTYPES[q.dtype], _KV_DTYPES[k_cache.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"paged_decode_attention: {msg}")
