"""Paged decode attention: the wrapper of ``csrc/paged_decode.cu``, the
port of the TPU kernel in ``tpuserve/ops/pallas_paged_attention.py``.

On CPU tensors it runs the plain version
(``attention.paged_decode_attention``); on CUDA tensors it launches the
kernel or raises — there is no fallback.  ``LAUNCHES`` counts kernel
launches.

The kernel is split-K: each sequence's keys are cut into partitions of
whole pages (``decode_splits``, chosen from shapes alone so nothing is read
back from the card), one block a (sequence, KV head, partition), whose
float32 partials the last block to finish merges in the same launch.  The
partials and the merge counters live in a workspace this module keeps per
device and stream (``workspace``); ``ragged_paged.py`` shares it for its
decode rows.  A CUDA graph bakes the workspace's address into its
launches, so ``runtime/graphs.py`` makes the capture stream's workspace
for its largest bucket before any capture (``decode_workspace_size``) and
holds it as long as the graphs live; under capture a workspace never
grows (it raises instead).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuserve_torch.ops import _build, attention

LAUNCHES = 0
HEAD_DIMS = (64, 96, 128, 256)    # 96 runs padded to 128 in the tile
MAX_GROUP = 8
# decode_splits aims at WAVES blocks an SM, with partitions of at least
# MIN_KEYS keys (the kernels' kDecWaves and kDecMinKeys).
WAVES = 8
MIN_KEYS = 128
_Q_DTYPES = (torch.float32, torch.bfloat16)
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (device index, stream) -> (float32 partials, int32 counters), grown as needed
_WORKSPACES: dict = {}


def decode_splits(max_pages: int, page: int, rows: int, Hkv: int,
                  num_sms: int) -> tuple[int, int]:
    """(splits, part_pages): the partitions of a row's ``max_pages x page``
    keys, each ``part_pages`` whole pages, so that ``rows x Hkv x splits``
    blocks give about ``WAVES`` blocks to each of ``num_sms`` SMs, with no
    partition under ``MIN_KEYS`` keys unless the table is shorter (a
    shorter one costs more in fixed work and merging than it saves).  The
    kernels apply the same rule (``decode_splits`` in
    ``csrc/paged_decode.cuh``)."""
    mp = max(max_pages, 1)
    pairs = max(rows * Hkv, 1)
    by_blocks = -(-WAVES * num_sms // pairs)
    by_keys = mp * page // MIN_KEYS
    want = min(max(min(by_blocks, by_keys), 1), mp)
    part_pages = -(-mp // want)
    return -(-mp // part_pages), part_pages


@functools.lru_cache(maxsize=64)
def ragged_decode_blocks(rows: int, Hkv: int, max_pages: int, page: int,
                         num_sms: int) -> int:
    """The ragged kernel's decode part, sized without knowing the decode-row
    count n: the most ``n x Hkv x splits`` items (splits =
    ``decode_splits(max_pages, page, n, Hkv, num_sms)[0]``) over every
    ``n <= rows``, so blocks beyond what some n needs are never launched."""
    return max(n * Hkv * decode_splits(max_pages, page, n, Hkv, num_sms)[0]
               for n in range(rows + 1))


def split_stride(G: int, D: int) -> int:
    """float32 values of one partial record: acc (G x D), m and l (G each),
    padded to 16 bytes (``split_stride`` in ``csrc/paged_decode.cuh``)."""
    return G * D + -(-2 * G // 4) * 4


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_workspace_size(B: int, Hq: int, Hkv: int, D: int, page: int,
                          max_pages: int, sms: int) -> tuple[int, int]:
    """(float32 partials, int32 counters) one paged-decode launch of batch
    ``B`` needs: its partition count depends on shapes alone, so a captured
    launch always needs the same."""
    splits, _ = decode_splits(max_pages, page, B, Hkv, sms)
    return B * Hkv * splits * split_stride(Hq // Hkv, D), B * Hkv


def workspace(device: torch.device, stream: int, n_floats: int, n_counters: int):
    """Scratch for the split-K partials (float32, ``n_floats``) and the
    merge counters (int32 zeros, ``n_counters``; each launch leaves them 0),
    kept per device and CUDA stream (``stream``, its handle): launches on
    one stream run in order, so they can share it.  While the stream is
    capturing a graph it must already be large enough: a buffer made
    there would come from the graph's pool, and a later, larger one would
    free it under the graph."""
    key = (device.index, stream)
    part, counters = _WORKSPACES.get(key, (None, None))
    grow = ((part is None or part.numel() < n_floats)
            or (counters is None or counters.numel() < n_counters))
    if grow and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "paged_decode: the decode workspace must be made before the "
            f"capture ({n_floats} floats, {n_counters} counters needed)")
    if part is None or part.numel() < n_floats:
        part = torch.empty(max(n_floats, 4), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 1), dtype=torch.int32, device=device)
    _WORKSPACES[key] = (part, counters)
    return part, counters


def release_workspace(device: torch.device, stream: int) -> None:
    """Drop the scratch kept for ``stream`` (its owner's graphs are gone)."""
    _WORKSPACES.pop((device.index, stream), None)


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
    max_pages = block_tables.shape[1]
    sms = num_sms(q.device)
    splits, part_pages = decode_splits(max_pages, page, B, Hkv, sms)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counters = workspace(q.device, stream, *decode_workspace_size(
        B, Hq, Hkv, D, page, max_pages, sms))
    quantized = k_scale is not None
    out = torch.empty_like(q)
    lib = _build.load("paged_decode")
    fn = lib.paged_decode
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(),
            B, Hq, Hkv, D, page, max_pages, splits, part_pages, float(scale),
            int(sliding_window or 0), float(logit_softcap or 0.0),
            kv_dtype_code(q.dtype), kv_dtype_code(k_cache.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {rc}")
    global LAUNCHES
    if not _build.tallied("paged_decode"):
        with _build.LAUNCH_LOCK:
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
