"""Flash prefill attention: the wrapper of ``csrc/flash_prefill.cu``, the
port of the TPU kernel in ``tpuserve/ops/pallas_flash_attention.py``.

On CPU tensors it runs the plain version
(``attention.prefill_attention``); on CUDA tensors it launches the kernel
or raises — there is no fallback.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpuserve_torch.ops import _build, attention

LAUNCHES = 0
HEAD_DIMS = (64, 96, 128, 256)    # 96 runs padded to 128 in the tile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            prompt_lens: torch.Tensor, scale: float,
                            sliding_window: int | None = None,
                            logit_softcap: float | None = None) -> torch.Tensor:
    """q: (B, T, Hq, D); k/v: (B, T, Hkv, D); prompt_lens: (B,) int32.
    Returns (B, T, Hq, D) in q.dtype; rows at or past prompt_lens are
    unspecified."""
    if q.device.type == "cpu":
        return attention.prefill_attention(q, k, v, prompt_lens, scale,
                                           sliding_window, logit_softcap)
    B, T, Hq, D = q.shape
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dtype in _DTYPES, f"unsupported dtype {q.dtype}")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share one dtype")
    _check(k.dim() == 4 and k.shape[:2] == (B, T) and k.shape[3] == D
           and v.shape == k.shape, "k/v must be (B, T, Hkv, D) like q")
    Hkv = k.shape[2]
    _check(Hq % Hkv == 0, f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _check(prompt_lens.dtype == torch.int32 and prompt_lens.shape == (B,),
           "prompt_lens must be int32 (B,)")
    for name, t in (("q", q), ("k", k), ("v", v), ("prompt_lens", prompt_lens)):
        _check(t.device == q.device, f"{name} is on {t.device}, not {q.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
           "q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _build.load("flash_prefill")
    fn = lib.flash_prefill
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), prompt_lens.data_ptr(),
            out.data_ptr(), B, T, Hq, Hkv, D, float(scale),
            int(sliding_window or 0), float(logit_softcap or 0.0),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_prefill launch failed: cudaError {rc}")
    global LAUNCHES
    if not _build.tallied("flash_prefill"):
        with _build.LAUNCH_LOCK:
            LAUNCHES += 1
    return out


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"flash_prefill_attention: {msg}")
