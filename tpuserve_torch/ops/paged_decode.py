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
_Q_DTYPES = (torch.float32, torch.bfloat16)
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
    B = q.shape[0]
    check_paged_inputs(_check, q, k_cache, v_cache, k_scale, v_scale,
                       block_tables, B, [("seq_lens", seq_lens)])
    Hq, D = q.shape[1:]
    _, page, Hkv, _ = k_cache.shape
    quantized = k_scale is not None
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
            kv_dtype_code(q.dtype), kv_dtype_code(k_cache.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def kv_dtype_code(dtype: torch.dtype) -> int:
    """The kernels' C code of a q or cache dtype (q takes 0 or 1)."""
    return _KV_DTYPES[dtype]


def check_paged_inputs(check, q, k_cache, v_cache, k_scale, v_scale,
                       block_tables, B: int, lens) -> None:
    """The argument checks the paged kernels share (decode, window,
    ragged): q (..., Hq, D) on a CUDA device in float32 or bfloat16; caches
    (num_blocks, page, Hkv, D) in q's dtype, or int8 with float32 scales
    (num_blocks, page, Hkv); block_tables (B, max_pages) int32; each of
    ``lens`` ((name, tensor) pairs) int32 (B,); all contiguous, on q's
    device.  ``check(ok, msg)`` raises the caller's error."""
    Hq, D = q.shape[-2:]
    check(q.device.type == "cuda", f"unsupported device {q.device}")
    check(q.dtype in _Q_DTYPES, f"unsupported q dtype {q.dtype}")
    check(k_cache.dim() == 4, "k/v caches must be (num_blocks, page, Hkv, D)")
    nb, page, Hkv, Dk = k_cache.shape
    check(v_cache.shape == k_cache.shape and Dk == D,
          "k/v caches must be (num_blocks, page, Hkv, D) with q's D")
    check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    check(Hq % Hkv == 0 and Hq // Hkv <= MAX_GROUP,
          f"Hq={Hq}, Hkv={Hkv}: need Hq % Hkv == 0 and a group <= {MAX_GROUP}")
    quantized = k_cache.dtype == torch.int8
    check(v_cache.dtype == k_cache.dtype, "k and v caches differ in dtype")
    check(k_cache.dtype == q.dtype or quantized,
          f"cache dtype {k_cache.dtype} must be q's {q.dtype} or int8")
    check(quantized == (k_scale is not None) and (k_scale is None) == (v_scale is None),
          "int8 caches need k_scale and v_scale, other caches none")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("block_tables", block_tables)] + list(lens)
    if quantized:
        check(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32
              and k_scale.shape == (nb, page, Hkv) and v_scale.shape == k_scale.shape,
              "scales must be float32 (num_blocks, page, Hkv)")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    check(block_tables.dtype == torch.int32 and block_tables.dim() == 2
          and block_tables.shape[0] == B, f"block_tables must be int32 ({B}, max_pages)")
    for name, t in lens:
        check(t.dtype == torch.int32 and t.shape == (B,), f"{name} must be int32 ({B},)")
    for name, t in tensors:
        check(t.device == q.device, f"{name} is on {t.device}, not {q.device}")
        check(t.is_contiguous(), f"{name} must be contiguous")
    check(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
          "caches must be 16-byte aligned")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"paged_decode_attention: {msg}")
